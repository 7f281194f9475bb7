// The wmma band-window product of the float64 DMMA paths of K3f, K0,
// K3/mxu, K3/mxu3, K3p, K3c and K3h (laplace2_fullmxu.cu, laplace2_v1.cu,
// laplace2_mxu.cu, laplace2_hybp.cu, laplace2_mxucol.cu,
// laplace2_hybrid.cu; their float32 paths and K3/mxu3p are on the wgmma
// stages of tc_stage.cuh and tc_strip.cuh), the bf16 split of M1
// (micro_stage1.cu) and the 3xTF32 wmma split that K5 (laplace3_mxu.cu)
// uses.
//
// All of them compute K3's operator  y = A0 U A1^T + B0 U B1^T  from K3's
// (N_d, 2p+1) row-major band tables (band[a][k] = entry (a, a+k-p), zero
// outside the grid) on the contiguous (n0, n1) node array.  A unit owns
// TX = 32 output columns.  Its u tile holds the extended rows and TX + 2p
// columns the outputs read (zeros outside the grid), padded with zero
// rows to a multiple of 16 and with zero columns to the product's depth
// KD, in shared memory with a padded pitch: wmma loads need 32-byte
// aligned pointers, and a row of 1025 float32 nodes is 4100 bytes, so no
// operand is read from device memory directly.
//
// Column stage, the window product: [V | W] = U_tile . C, where C is the
// window's KD x 2TX slice of [A1^T | B1^T]: C[x + t][x] = A1(j0 + x, t),
// C[x + t][TX + x] = B1(j0 + x, t), zero elsewhere, read from K3f's
// cached table (ops/tc_tables.py), so the one-sided stencils of the first
// and last p columns come out exact.
//
// Precision: float32 products run as 3xTF32 on the tensor cores (each
// operand split into hi = tf32(x) and lo = tf32(x - hi); lo.hi + hi.lo +
// hi.hi, float32 accumulation), float64 ones on the DMMA units (m8n8k4,
// IEEE double).  The global TF32 flag plays no part.  In float64 every
// mode runs on the DMMA units, unsplit: gdm split float64 operands to
// float32 only so that its interpret-mode tests ran the bf16x3 code path,
// and the card has no tensor core that takes float32 inputs.
#pragma once

#include <cstddef>

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace gdm {
namespace tc {

using namespace nvcuda;

constexpr int TX = 32;           // output columns per block: one warp
// row pitch of [V | W] and of C (a pitch of 72, whose B-fragment loads
// meet no bank conflict, measured no faster and costs shared memory)
constexpr int LDV = 2 * TX + 4;
constexpr int LDY = TX + 4;      // row pitch of a staged y tile
constexpr int SCR = 256;         // one warp's 16 x 16 scratch tile
constexpr int SMEM_MAX = 232448; // shared memory one H100 block may use

__host__ __device__ constexpr int rnd(int n, int m) {
  return (n + m - 1) / m * m;
}

// an array's share of shared memory in the layouts that mix value types:
// whole 128-byte lines, so every array after it stays aligned
__host__ __device__ constexpr size_t rnd128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// The depths of a 32-column unit's window product at degree P.
template <int P>
struct Tile {
  static constexpr int K = 2 * P + 1;
  static constexpr int UW = TX + 2 * P;    // u columns the unit reads
  static constexpr int KD = rnd(UW, 8);    // depth of the column product
  static constexpr int LDU = KD + 4;       // row pitch of the u tile
};

// hi = tf32(x), lo = tf32(x - hi), element by element: the two fragments
// have one type, so element e of each holds the same matrix entry
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int e = 0; e < hi.num_elements; ++e) {
    const float x = hi.x[e];
    const float h = wmma::__float_to_tf32(x);
    hi.x[e] = h;
    lo.x[e] = wmma::__float_to_tf32(x - h);
  }
}

// A warp's 16 x 16 accumulator: acc += a[0:16, 0:depth] . b[0:depth, 0:16]
// with both operands row-major in shared memory (depth a multiple of 8).
template <typename T>
struct Acc16;

template <>
struct Acc16<float> {
  using FA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                            wmma::row_major>;
  using FB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                            wmma::row_major>;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> f;

  __device__ __forceinline__ void zero() { wmma::fill_fragment(f, 0.0f); }

  __device__ __forceinline__ void add(const float* a, int lda, const float* b,
                                      int ldb, int depth) {
    for (int k0 = 0; k0 < depth; k0 += 8) {
      FA a_hi, a_lo;
      FB b_hi, b_lo;
      wmma::load_matrix_sync(a_hi, a + k0, lda);
      wmma::load_matrix_sync(b_hi, b + static_cast<size_t>(k0) * ldb, ldb);
      split_tf32(a_hi, a_lo);
      split_tf32(b_hi, b_lo);
      // the small terms first
      wmma::mma_sync(f, a_lo, b_hi, f);
      wmma::mma_sync(f, a_hi, b_lo, f);
      wmma::mma_sync(f, a_hi, b_hi, f);
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) const {
    wmma::store_matrix_sync(c, f, ldc, wmma::mem_row_major);
  }
};

template <>
struct Acc16<double> {
  using FA = wmma::fragment<wmma::matrix_a, 8, 8, 4, double, wmma::row_major>;
  using FB = wmma::fragment<wmma::matrix_b, 8, 8, 4, double, wmma::row_major>;
  wmma::fragment<wmma::accumulator, 8, 8, 4, double> f[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(f[i][j], 0.0);
  }

  __device__ __forceinline__ void add(const double* a, int lda,
                                      const double* b, int ldb, int depth) {
    for (int k0 = 0; k0 < depth; k0 += 4) {
      FA fa[2];
      FB fb[2];
      wmma::load_matrix_sync(fa[0], a + k0, lda);
      wmma::load_matrix_sync(fa[1], a + 8 * lda + k0, lda);
      wmma::load_matrix_sync(fb[0], b + static_cast<size_t>(k0) * ldb, ldb);
      wmma::load_matrix_sync(fb[1], b + static_cast<size_t>(k0) * ldb + 8,
                             ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(f[i][j], fa[i], fb[j], f[i][j]);
    }
  }

  __device__ __forceinline__ void store(double* c, int ldc) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c + 8 * i * ldc + 8 * j, f[i][j], ldc,
                                wmma::mem_row_major);
  }
};

using bf16 = __nv_bfloat16;

// hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// Column stage on the tensor cores for rows [r_lo, m) of the tile: the
// 16-row blocks from the one holding r_lo times C's four 16-column
// blocks, shared out over the group's nwarps warps.  The block that
// holds r_lo goes through the warp's scratch tile, so the rows above
// r_lo, which the FMA warps own, are not written.
template <typename T, int P>
__device__ void col_mma(const T* ut, const T* ct, T* vw, T* scratch, int r_lo,
                        int m, int warp, int nwarps, int lane) {
  using G = Tile<P>;
  const int rb0 = r_lo / 16;
  const int tasks = (m / 16 - rb0) * 4;
  for (int task = warp; task < tasks; task += nwarps) {
    const int r0 = (rb0 + task / 4) * 16;
    const int n0 = (task % 4) * 16;
    Acc16<T> acc;
    acc.zero();
    acc.add(ut + r0 * G::LDU, G::LDU, ct + n0, LDV, G::KD);
    if (r0 >= r_lo) {
      acc.store(vw + r0 * LDV + n0, LDV);
    } else {
      acc.store(scratch, 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16;
        if (r >= r_lo) vw[r * LDV + n0 + e % 16] = scratch[e];
      }
      __syncwarp();
    }
  }
}

// Shared memory above 48 KB needs the kernel's opt-in; returns a CUDA
// error code (0 on success).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(SMEM_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace tc
}  // namespace gdm
