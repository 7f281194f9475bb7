// Shared helpers of the gdm_torch CUDA kernels.
//
// Both kernels work on one padded 2D layout (gdm_torch/ops/cutband.py,
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

// True iff the padded-layout cell (row, col) holds a grid node.
__device__ __forceinline__ bool is_node(int row, int col, int n0, int n1,
                                        int r) {
  return row >= r && row < r + n0 && col >= r && col < r + n1;
}

}  // namespace gdm
