// Shared helpers of the gdm_torch CUDA kernels.
//
// K1 and K2 work on one padded 2D layout (gdm_torch/ops/cutband.py,
// PaddedLayout): a (rows, pitch) row-major array with rows = n0 + 2r,
// data nodes at [r, r + n0) x [r, r + n1) and zeros everywhere else.
// Coefficient planes are tap-major, (n_taps, rows, pitch), with the tap
// offsets (dy, dx) passed beside them as int32 pairs.
#pragma once

#include <cuda_runtime.h>

namespace gdm {

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_(double a, double b, double c) {
  return ::fma(a, b, c);
}

// One element, global -> shared, asynchronously (cp.async, 4 or 8
// bytes): any address of the element's own alignment; zero-filled when
// !valid (src is then not read).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? static_cast<int>(sizeof(T)) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))), "r"(n));
}

// N elements from 16-byte aligned shared memory into registers, 16
// bytes a load (N a multiple of 16 / sizeof(T)): a band row that every
// lane of a warp reads costs N / 4 (float) or N / 2 (double) broadcast
// loads instead of N.
template <typename T, int N>
__device__ __forceinline__ void load_row16(const T* p, T (&out)[N]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  static_assert(N % V == 0, "load_row16: N must fill whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N; i += V) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
      out[i + 2] = x.z;
      out[i + 3] = x.w;
    } else {
      const double2 x = *reinterpret_cast<const double2*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
    }
  }
}

// Close this thread's group of copies issued since the last commit.
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// True iff the padded-layout cell (row, col) holds a grid node.
__device__ __forceinline__ bool is_node(int row, int col, int n0, int n1,
                                        int r) {
  return row >= r && row < r + n0 && col >= r && col < r + n1;
}

}  // namespace gdm
