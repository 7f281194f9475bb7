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
