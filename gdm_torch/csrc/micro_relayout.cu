// M2: a transpose of a tile held in fast memory, repeated, gdm's
// relayout micro.
//
// Replaces benchmarks/mxu_micro.py::relayout_cost (its pallas_call,
// mxu_micro.py:289): `steps` grid steps, each of which transposes the
// VMEM-resident (rows, lanes) tile x, scaled by 1 + i 1e-12 (exactly 1 in
// float32 and bf16), into the output tile; the result is x^T.  gdm used it
// to price moving an axis between the TPU's sublanes and lanes, the
// relayout a second tensor-core axis in 3D would need (K5's stage 3).
//
// The card's counterpart is a shared-memory transpose.  The function is
// the same: y = x^T (lanes, rows), every one of the `steps` transposes
// done.  (512, 128) float32 is 256 KB, more than a block's 227 KB, so the
// tile is cut into 32 x 32 sub-tiles, one block each, and the steps are
// shared out over G groups of blocks per sub-tile (the wrapper picks G so
// that the card holds about four blocks per SM); only the group that
// holds the last step writes y.
//
// Bound on the card: shared-memory traffic, one read and one write of
// each element a step, steps rows lanes 2 itemsize bytes over the
// shared-memory rate (128 bytes per clock per SM).  With PAD = 0 the
// sub-tile's pitch is 32 elements and a warp's transposed writes fall on
// one bank (a 32-way conflict in float32); PAD = 1 makes the pitch 33 and
// spreads them over all 32 banks.  Both pitches compute the same y.
//
// Design: 32 x 8 threads; the block copies its sub-tile of x to shared
// memory once, then each step reads x row-major (coalesced, conflict-free)
// and writes the scaled values transposed into one of two output
// buffers, alternately, one barrier a step; the step's scale comes from a
// runtime epsilon, and each thread reads back one transposed element a
// step into a sum that is stored only if it equals a runtime sentinel, so
// the compiler can drop no step (about one extra shared read per four
// transposed elements).
#include <cstddef>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int TS = 32;   // sub-tile edge
constexpr int NTY = 8;   // thread rows: 32 x 8 = 256 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int PAD>
__global__ void __launch_bounds__(TS * NTY)
relayout_kernel(const T* __restrict__ x, T* __restrict__ y,
                float* __restrict__ sink, int rows, int lanes, int steps,
                float eps, float sentinel) {
  constexpr int LD = TS + PAD;
  __shared__ T xs[TS * LD];
  __shared__ T ys[2][TS * LD];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int r0 = blockIdx.y * TS;
  const int c0 = blockIdx.x * TS;
  const int groups = gridDim.z;
  const int s_lo = static_cast<int>(static_cast<long long>(blockIdx.z) *
                                    steps / groups);
  const int s_hi = static_cast<int>(static_cast<long long>(blockIdx.z + 1) *
                                    steps / groups);
  for (int r = ty; r < TS; r += NTY) {
    const bool in = r0 + r < rows && c0 + tx < lanes;
    xs[r * LD + tx] =
        in ? x[static_cast<size_t>(r0 + r) * lanes + c0 + tx] : from_f<T>(0.f);
  }
  __syncthreads();
  float acc = 0.0f;
  for (int s = s_lo; s < s_hi; ++s) {
    // gdm's step scale, 1 + i 1e-12 in float32, then in T
    const float scale = to_f(from_f<T>(1.0f + static_cast<float>(s) * eps));
    T* out = ys[s & 1];
#pragma unroll
    for (int r = ty; r < TS; r += NTY)
      out[tx * LD + r] = from_f<T>(to_f(xs[r * LD + tx]) * scale);
    __syncthreads();
    acc += to_f(out[ty * LD + tx]);
  }
  if (acc == sentinel) sink[0] = acc;
  if (s_hi != steps || s_hi == s_lo) return;
  const T* last = ys[(steps - 1) & 1];
  for (int c = ty; c < TS; c += NTY) {
    if (c0 + c < lanes && r0 + tx < rows)
      y[static_cast<size_t>(c0 + c) * rows + r0 + tx] = last[c * LD + tx];
  }
}

template <typename T>
int launch(const void* x, void* y, void* sink, int rows, int lanes,
           int steps, int groups, int pad, void* stream) {
  if (rows < 1 || lanes < 1 || steps < 1 || groups < 1 || groups > steps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(TS, NTY);
  const dim3 grid((lanes + TS - 1) / TS, (rows + TS - 1) / TS, groups);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  float* st = static_cast<float*>(sink);
  if (pad)
    relayout_kernel<T, 1><<<grid, block, 0, s>>>(xt, yt, st, rows, lanes,
                                                  steps, 1e-12f, -1.2345e38f);
  else
    relayout_kernel<T, 0><<<grid, block, 0, s>>>(xt, yt, st, rows, lanes,
                                                  steps, 1e-12f, -1.2345e38f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (lanes, rows) = x^T for x (rows, lanes), after `steps` transposes in
// shared memory shared out over `groups` block groups; pad 1 pads the
// sub-tile pitch by one element.  sink: one float, written never in
// practice.
int gdm_micro_relayout_f32(const void* x, void* y, void* sink, int rows,
                           int lanes, int steps, int groups, int pad,
                           void* stream) {
  return launch<float>(x, y, sink, rows, lanes, steps, groups, pad, stream);
}

int gdm_micro_relayout_bf16(const void* x, void* y, void* sink, int rows,
                            int lanes, int steps, int groups, int pad,
                            void* stream) {
  return launch<__nv_bfloat16>(x, y, sink, rows, lanes, steps, groups, pad,
                               stream);
}

}  // extern "C"
