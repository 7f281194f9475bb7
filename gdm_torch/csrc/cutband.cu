// K1: the 2D stencil-band apply on the padded layout.
//
// Replaces gdm/ops/pallas_cutband.py::make_padded_stencil2 (the TPU
// kernel behind gdm/cut/fastapply.py::fast_stencil_bundle):
//
//   y[i0, i1] = sum_t plane[t][i0, i1] * u[i0 + dy_t, i1 + dx_t]
//
// over the operator's nonzero taps t (at most (2r+1)^2, 81 at p = 3),
// with y = 0 on every guard cell, so the layout is closed under the
// apply and CG can run inside it.
//
// Bound on the card: memory.  Each node reads its T coefficients once
// and u/y cost two more words, about (T + 2) * 4 bytes per node in f32
// against 2T flops, far below the H100's flop-per-byte balance.  At the
// flagship 128^2 size the whole working set (T = 77..81 planes of
// 137 x 140 f32, ~6 MB) sits in the 50 MB L2, so repeated applies run
// at L2 rather than HBM bandwidth.
//
// Design: one thread per output cell, 32 x 8 cells per block.  A block
// first copies its tile of u plus an r-wide halo into shared memory
// (each u value is then read from device memory about once, not T
// times), and the tap offsets into shared memory as flat tile offsets.
// Each thread then accumulates its T taps in a register, reading the
// coefficient planes from device memory: neighbouring threads read
// neighbouring addresses, so every plane read is one coalesced 128-byte
// line per warp, and the shared-memory reads are conflict-free.  Cells
// outside the node block (the ragged edge of 129 = 4 * 32 + 1 nodes,
// the guard rows and the pitch tail) write zeros.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;

template <typename T>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
cutband_apply_kernel(const T* __restrict__ u, const T* __restrict__ planes,
                     const int* __restrict__ offs, T* __restrict__ y,
                     int n_taps, int rows, int pitch, int n0, int n1, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tw = TILE_X + 2 * r;
  const int th = TILE_Y + 2 * r;
  T* tile = reinterpret_cast<T*>(smem);
  int* soff = reinterpret_cast<int*>(tile + th * tw);
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  const int row0 = blockIdx.y * TILE_Y - r;
  const int col0 = blockIdx.x * TILE_X - r;
  for (int k = tid; k < th * tw; k += TILE_X * TILE_Y) {
    const int gy = row0 + k / tw;
    const int gx = col0 + k % tw;
    tile[k] = (gy >= 0 && gy < rows && gx >= 0 && gx < pitch)
                  ? u[static_cast<size_t>(gy) * pitch + gx]
                  : T(0);
  }
  for (int t = tid; t < n_taps; t += TILE_X * TILE_Y) {
    soff[t] = offs[2 * t] * tw + offs[2 * t + 1];
  }
  __syncthreads();

  const int row = blockIdx.y * TILE_Y + threadIdx.y;
  const int col = blockIdx.x * TILE_X + threadIdx.x;
  if (row >= rows || col >= pitch) return;
  const size_t idx = static_cast<size_t>(row) * pitch + col;
  T acc = T(0);
  if (gdm::is_node(row, col, n0, n1, r)) {
    const size_t plane = static_cast<size_t>(rows) * pitch;
    const T* c = planes + idx;
    const T* center = tile + (threadIdx.y + r) * tw + threadIdx.x + r;
    for (int t = 0; t < n_taps; ++t) {
      acc = gdm::fma_(c[t * plane], center[soff[t]], acc);
    }
  }
  y[idx] = acc;
}

template <typename T>
int launch(const void* u, const void* planes, const void* offs, void* y,
           int n_taps, int rows, int pitch, int n0, int n1, int r,
           void* stream) {
  const size_t smem =
      static_cast<size_t>(TILE_Y + 2 * r) * (TILE_X + 2 * r) * sizeof(T) +
      static_cast<size_t>(n_taps) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cutband_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((pitch + TILE_X - 1) / TILE_X, (rows + TILE_Y - 1) / TILE_Y);
  cutband_apply_kernel<T><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(planes),
      static_cast<const int*>(offs), static_cast<T*>(y), n_taps, rows, pitch,
      n0, n1, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gdm_cutband_apply_f32(const void* u, const void* planes, const void* offs,
                          void* y, int n_taps, int rows, int pitch, int n0,
                          int n1, int r, void* stream) {
  return launch<float>(u, planes, offs, y, n_taps, rows, pitch, n0, n1, r,
                       stream);
}

int gdm_cutband_apply_f64(const void* u, const void* planes, const void* offs,
                          void* y, int n_taps, int rows, int pitch, int n0,
                          int n1, int r, void* stream) {
  return launch<double>(u, planes, offs, y, n_taps, rows, pitch, n0, n1, r,
                        stream);
}

const char* gdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
