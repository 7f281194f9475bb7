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
// done, the last one scaled by gdm's 1 + (steps - 1) 1e-12 (the wrapper
// passes that scale, rounded to the tile's type).
//
// Bound on the card: shared-memory traffic, one read and one write of
// each element a step, steps rows lanes 2 itemsize bytes over the
// shared-memory rate (128 bytes per clock per SM).
//
// Design (the launch plan comes from gdm_torch/benchmarks/mxu_micro.py::
// relayout_plan):
// - The tile is cut into E x E sub-tiles of 128-byte rows (E = 32 in
//   float32, 64 in bf16), and each warp owns one at a time in two
//   buffers of its own: step s reads buffer s & 1 and writes the
//   transpose into the other (ping-pong), so a step reads the previous
//   step's output and the chain of steps is its own keep-alive.  Warps
//   sync with __syncwarp only; no block barrier after the set-up.
// - Accesses are 16 bytes a lane.  float32: a lane loads two 4 x 4
//   blocks as four float4 rows each, transposes them in registers and
//   stores four float4 rows each.  bf16: ldmatrix.x4.trans loads four
//   8 x 8 blocks transposed into the fragments, stmatrix.x4 stores them
//   at the transposed block positions.
// - SWZ (relayout_apply's pad=True) XORs each row's 16-byte chunk index
//   with (row / 4) mod 8 in float32 and row mod 8 in bf16, so each
//   quarter-warp's eight 16-byte accesses fall in eight different bank
//   groups, for reads and for writes.  Without it
//   (pad=False) the transposed float32 stores and both bf16 matrix
//   accesses of a quarter-warp hit one bank group: an 8-way conflict.
// - The steps of all sub-tiles, n_sub x steps in all, are cut into
//   blocks x warps contiguous ranges that differ by at most one step
//   (a pair of steps where `steps` is even: every range then starts at
//   an even step), one a warp, with one block of the same warps on each
//   SM: every SM gets the same work.  A range that starts at step s loads its
//   sub-tile from x as x (s even) or x^T (s odd), the state an unbroken
//   chain would have, since every step before the last moves its values
//   unchanged; the warp that runs a sub-tile's last step stores y from
//   its buffer, as is or transposed by the parity of `steps`.  A whole
//   sub-tile of 16-byte rows loads and stores 16 bytes a lane, all
//   loads in flight at once; where its state must be transposed, one
//   unscaled transposing pass beside the steps does it.  Ragged edge
//   sub-tiles go element by element.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int ROW_BYTES = 128;   // a sub-tile row: E elements
constexpr int MAX_WARPS = 16;   // registers: at most 128 a thread

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
struct Tile {
  static constexpr int E = ROW_BYTES / static_cast<int>(sizeof(T));
  static constexpr int BYTES = E * ROW_BYTES;
  // the swizzle XORs a row's chunk index with (row / SHIFT) mod 8: the
  // rows a float32 lane's 4 x 4 block spans share it, the eight rows of
  // one bf16 8 x 8 matrix differ in it
  static constexpr int SHIFT = sizeof(T) == 4 ? 4 : 1;
};

// byte offset of element (i, j) in a sub-tile buffer
template <typename T, bool SWZ>
__device__ __forceinline__ int elem_offset(int i, int j) {
  const int b = j * static_cast<int>(sizeof(T));
  const int chunk = (b >> 4) ^ (SWZ ? (i / Tile<T>::SHIFT) & 7 : 0);
  return i * ROW_BYTES + (chunk << 4) + (b & 15);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One float32 step: dst = src^T (times `scale` if SCALE).  Lane l owns the
// 4 x 4 blocks (a, b) = (l / 8 + 4 h, l % 8), h = 0, 1.
template <bool SWZ, bool SCALE>
__device__ __forceinline__ void step_f32(const unsigned char* src,
                                         unsigned char* dst, int lane,
                                         float scale) {
  float4 r[2][4];
  const int b = lane & 7;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = (lane >> 3) + 4 * h;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[h][i] = *reinterpret_cast<const float4*>(
          src + (4 * a + i) * ROW_BYTES + ((b ^ (SWZ ? a : 0)) << 4));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = (lane >> 3) + 4 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 o;
      o.x = reinterpret_cast<const float*>(&r[h][0])[j];
      o.y = reinterpret_cast<const float*>(&r[h][1])[j];
      o.z = reinterpret_cast<const float*>(&r[h][2])[j];
      o.w = reinterpret_cast<const float*>(&r[h][3])[j];
      if (SCALE) {
        o.x *= scale;
        o.y *= scale;
        o.z *= scale;
        o.w *= scale;
      }
      *reinterpret_cast<float4*>(
          dst + (4 * b + j) * ROW_BYTES + ((a ^ (SWZ ? b : 0)) << 4)) = o;
    }
  }
}

// One bf16 step: dst = src^T (times `scale` if SCALE), 64 x 64.  Matrix
// k of instruction q is the 8 x 8 block (I, J) = (q / 2, 4 (q % 2) + k);
// lane l gives row l % 8 of matrix l / 8: its address in src at (I, J),
// in dst at (J, I).
template <bool SWZ, bool SCALE>
__device__ __forceinline__ void step_bf16(const unsigned char* src,
                                          unsigned char* dst, int lane,
                                          float scale) {
  const int rr = lane & 7;
  const int k = lane >> 3;
  const int x = SWZ ? rr : 0;
  const unsigned s0 = smem_u32(src), d0 = smem_u32(dst);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int I = q >> 1, J = 4 * (q & 1) + k;
    const unsigned sa = s0 + (8 * I + rr) * ROW_BYTES + ((J ^ x) << 4);
    const unsigned da = d0 + (8 * J + rr) * ROW_BYTES + ((I ^ x) << 4);
    unsigned v[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(sa)
        : "memory");
    if (SCALE) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v[m]);
        const float2 f = __bfloat1622float2(h);
        h = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        v[m] = *reinterpret_cast<unsigned*>(&h);
      }
    }
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
        ::"r"(da), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
  }
}

template <typename T, bool SWZ, bool SCALE>
__device__ __forceinline__ void step(const unsigned char* src,
                                     unsigned char* dst, int lane,
                                     float scale) {
  if (sizeof(T) == 4)
    step_f32<SWZ, SCALE>(src, dst, lane, scale);
  else
    step_bf16<SWZ, SCALE>(src, dst, lane, scale);
}

// A whole sub-tile x[r0 .. r0 + E)[c0 .. c0 + E) (row pitch `pitch`
// elements, rows 16-byte aligned) into buf as is: 16-byte loads, all in
// flight before the 16-byte stores.
template <typename T, bool SWZ>
__device__ __forceinline__ void load_vec(unsigned char* buf, const T* x,
                                         size_t pitch, int lane) {
  constexpr int PER = Tile<T>::E * 8 / 32;   // 16-byte chunks a lane
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  uint4 v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int q = lane + 32 * i, row = q >> 3, ch = q & 7;
    v[i] = *reinterpret_cast<const uint4*>(x + row * pitch + V * ch);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int q = lane + 32 * i, row = q >> 3, ch = q & 7;
    *reinterpret_cast<uint4*>(
        buf + row * ROW_BYTES +
        ((ch ^ (SWZ ? (row / Tile<T>::SHIFT) & 7 : 0)) << 4)) = v[i];
  }
}

// buf's rows into y[c0 .. c0 + E)[r0 .. r0 + E) (row pitch `pitch`),
// 16 bytes a store.
template <typename T, bool SWZ>
__device__ __forceinline__ void store_vec(const unsigned char* buf, T* y,
                                          size_t pitch, int lane) {
  constexpr int PER = Tile<T>::E * 8 / 32;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int q = lane + 32 * i, row = q >> 3, ch = q & 7;
    *reinterpret_cast<uint4*>(y + row * pitch + V * ch) =
        *reinterpret_cast<const uint4*>(
            buf + row * ROW_BYTES +
            ((ch ^ (SWZ ? (row / Tile<T>::SHIFT) & 7 : 0)) << 4));
  }
}

template <typename T, bool SWZ>
__global__ void __launch_bounds__(MAX_WARPS * 32)
relayout_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                int lanes, int steps, int sub_cols, long long n_sub,
                float scale, bool vec) {
  constexpr int E = Tile<T>::E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* buf[2] = {smem + 2 * warp * Tile<T>::BYTES,
                           smem + (2 * warp + 1) * Tile<T>::BYTES};
  const long long n_warps = static_cast<long long>(gridDim.x) *
                            (blockDim.x >> 5);
  const long long w = static_cast<long long>(blockIdx.x) *
                      (blockDim.x >> 5) + warp;
  // ranges of whole step pairs where `steps` is even, so that every range
  // starts at an even step, in the state x
  const int pair = steps % 2 == 0 ? 2 : 1;
  const long long total = n_sub * steps / pair;
  long long pos = pair * (w * total / n_warps);
  const long long end = pair * ((w + 1) * total / n_warps);
  // stamps (a stamped copy's build only): warp 0's start, SM, steps,
  // clocks in the steps, end
  const bool stamp = threadIdx.x == 0;
  GDM_STAMP(stamp, 0, gdm_gtimer());
  GDM_STAMP(stamp, 1, static_cast<long long>(gdm_smid()));
  while (pos < end) {
    const long long sub = pos / steps;
    const int s0 = static_cast<int>(pos - sub * steps);
    const int s1 = static_cast<int>(
        min(static_cast<long long>(steps), s0 + (end - pos)));
    const int r0 = static_cast<int>(sub / sub_cols) * E;
    const int c0 = static_cast<int>(sub % sub_cols) * E;
    // whole sub-tiles of 16-byte aligned rows move 16 bytes a lane; a
    // transposing pass, unscaled, makes x^T of x and x of x^T
    const bool fast = vec && r0 + E <= rows && c0 + E <= lanes;
    // the state before step s0: x (s0 even) or x^T (s0 odd) in b0; the
    // steps go b0 -> b1 and swap
    unsigned char* b0 = buf[0];
    unsigned char* b1 = buf[1];
    auto swap = [&]() {
      unsigned char* t = b0;
      b0 = b1;
      b1 = t;
    };
    if (fast) {
      load_vec<T, SWZ>(b0, x + static_cast<size_t>(r0) * lanes + c0, lanes,
                       lane);
      __syncwarp();
      if (s0 & 1) {
        step<T, SWZ, false>(b0, b1, lane, 1.0f);
        __syncwarp();
        swap();
      }
    } else {
      const bool t_in = s0 & 1;
      for (int e = lane; e < E * E; e += 32) {
        const int a = e / E, b = e % E;   // a global row, b its column
        const bool in = r0 + a < rows && c0 + b < lanes;
        const T v = in ? x[static_cast<size_t>(r0 + a) * lanes + c0 + b]
                       : from_f<T>(0.0f);
        *reinterpret_cast<T*>(b0 + (t_in ? elem_offset<T, SWZ>(b, a)
                                         : elem_offset<T, SWZ>(a, b))) = v;
      }
      __syncwarp();
    }
    const long long c_st = GDM_CLOCK();
    const int last = s1 == steps ? s1 - 1 : s1;   // unscaled steps end here
    int s = s0;
    for (; s + 2 <= last; s += 2) {
      step<T, SWZ, false>(b0, b1, lane, 1.0f);
      __syncwarp();
      step<T, SWZ, false>(b1, b0, lane, 1.0f);
      __syncwarp();
    }
    if (s < last) {
      step<T, SWZ, false>(b0, b1, lane, 1.0f);
      __syncwarp();
      swap();
    }
    if (s1 == steps) {
      // the last step, scaled; then y from its output, which holds x^T
      // for odd `steps`
      step<T, SWZ, true>(b0, b1, lane, scale);
      __syncwarp();
      swap();
      GDM_STAMP_ADD(stamp, 3, GDM_CLOCK() - c_st);
      const bool t_out = steps & 1;
      if (fast) {
        if (!t_out) {
          step<T, SWZ, false>(b0, b1, lane, 1.0f);
          __syncwarp();
          swap();
        }
        store_vec<T, SWZ>(b0, y + static_cast<size_t>(c0) * rows + r0, rows,
                          lane);
      } else {
        for (int e = lane; e < E * E; e += 32) {
          const int a = e / E, b = e % E;   // a row of y, b its column
          if (c0 + a < lanes && r0 + b < rows)
            y[static_cast<size_t>(c0 + a) * rows + r0 + b] =
                *reinterpret_cast<const T*>(
                    b0 + (t_out ? elem_offset<T, SWZ>(a, b)
                                : elem_offset<T, SWZ>(b, a)));
        }
      }
    } else {
      GDM_STAMP_ADD(stamp, 3, GDM_CLOCK() - c_st);
    }
    GDM_STAMP_ADD(stamp, 2, s1 - s0);
    pos += s1 - s0;
    __syncwarp();
  }
  GDM_STAMP(stamp, 4, gdm_gtimer());
}

template <typename T>
int launch(const void* x, void* y, int rows, int lanes, int steps,
           float scale, int edge, int warps, int blocks, int smem, int pad,
           void* stream) {
  constexpr int E = Tile<T>::E;
  const int sub_rows = (rows + E - 1) / E, sub_cols = (lanes + E - 1) / E;
  const long long n_sub = static_cast<long long>(sub_rows) * sub_cols;
  // the plan must be the kernel's layout: E x E sub-tiles, two buffers a
  // warp, at most one range a warp
  if (rows < 1 || lanes < 1 || steps < 1 || edge != E || warps < 1 ||
      warps > MAX_WARPS || blocks < 1 ||
      smem != 2 * warps * Tile<T>::BYTES || smem > 232448 ||
      static_cast<long long>(blocks) * warps >
          n_sub * steps / (steps % 2 == 0 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte rows in x and y, both 16-byte aligned
  const bool vec = (lanes * sizeof(T)) % 16 == 0 &&
                   (rows * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto kernel = pad ? relayout_kernel<T, true> : relayout_kernel<T, false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, lanes, steps,
      sub_cols, n_sub, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (lanes, rows) = x^T for x (rows, lanes), after `steps` transposes in
// shared memory, the last scaled by `scale`; the plan (relayout_plan):
// edge x edge sub-tiles, `warps` warps a block, `blocks` blocks, `smem`
// bytes a block; pad 1 swizzles the sub-tile rows against bank conflicts.
int gdm_micro_relayout_f32(const void* x, void* y, int rows, int lanes,
                           int steps, float scale, int edge, int warps,
                           int blocks, int smem, int pad, void* stream) {
  return launch<float>(x, y, rows, lanes, steps, scale, edge, warps, blocks,
                       smem, pad, stream);
}

int gdm_micro_relayout_bf16(const void* x, void* y, int rows, int lanes,
                            int steps, float scale, int edge, int warps,
                            int blocks, int smem, int pad, void* stream) {
  return launch<__nv_bfloat16>(x, y, rows, lanes, steps, scale, edge, warps,
                               blocks, smem, pad, stream);
}

}  // extern "C"
