// Tensor-map (TMA) copies: a 2D box of a row-major array into shared
// memory by one instruction, and the host's encoding of the tensor map.
// M1's row modes (micro_stage1.cu) and M3 (micro_stream.cu) take them.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace gdm {

// The box of `tm` at (column c0, row c1) into dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tm,
                                            int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// cuTensorMapEncodeTiled, a CUDA driver API entry, found through the
// runtime (no -lcuda at link time); looked up once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(f);
    }
  }
  return fn;
}

// A 2D row-major tensor map of (rows, cols) elements of `type`, boxes of
// box_rows x box_cols, zero fill outside the array.
inline int tensor_map_2d(CUtensorMap* tm, CUtensorMapDataType type,
                         int elem, const void* base, int rows, int cols,
                         int box_rows, int box_cols,
                         CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = encode(
      tm, type, 2, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gdm
