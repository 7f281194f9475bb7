// The tensor-core band-window product and the tile stages shared by the
// 2D Laplace schedules K3c and K3h (laplace2_mxucol.cu,
// laplace2_hybrid.cu), the float64 DMMA products of K3f, K0, K3/mxu,
// K3/mxu3 and K3p (laplace2_fullmxu.cu, laplace2_v1.cu, laplace2_mxu.cu,
// laplace2_hybp.cu; their float32 paths and K3/mxu3p are on
// tc_stage.cuh's stage), the bf16 split of M1 (micro_stage1.cu) and the
// 3xTF32 split that K5 (laplace3_mxu.cu) uses too.
//
// All of them compute K3's operator  y = A0 U A1^T + B0 U B1^T  from K3's
// (N_d, 2p+1) row-major band tables (band[a][k] = entry (a, a+k-p), zero
// outside the grid) on the contiguous (n0, n1) node array.  A block owns
// TX = 32 output columns and tile_r output rows.  Its u tile holds the
// tile_r + 2p rows and TX + 2p columns the outputs read (zeros outside
// the grid), padded with zero rows to a multiple of 16 and with zero
// columns to the product's depth KD, in shared memory with a padded
// pitch: wmma loads need 32-byte aligned pointers, and a row of 1025
// float32 nodes is 4100 bytes, so no operand is read from device memory
// directly.
//
// Column stage, the window product: [V | W] = U_tile . C, where C is the
// window's KD x 2TX slice of [A1^T | B1^T]: C[x + t][x] = A1(j0 + x, t),
// C[x + t][TX + x] = B1(j0 + x, t), zero elsewhere.  Built per block from
// the band rows of its own columns (K3p reads K3f's cached table of it),
// so the one-sided stencils of the first and last p columns come out
// exact.  The same C serves the FMA form of the column stage (col_fma),
// which reads its coefficients from the diagonals of C.
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
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
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

// Geometry of a block's tile at degree P with tile_r output rows, in
// elements; every array is a multiple of 32 elements long, so arrays laid
// end to end from a 128-byte aligned base keep every wmma pointer 32-byte
// aligned.  gdm_torch/ops/stencil2.py::tc_smem_bytes mirrors it.
template <int P>
struct Tile {
  static constexpr int K = 2 * P + 1;
  static constexpr int UW = TX + 2 * P;    // u columns the block reads
  static constexpr int KD = rnd(UW, 8);    // depth of the column product
  static constexpr int LDU = KD + 4;       // row pitch of the u tile
  int tile_r;  // output rows
  int t_ext;   // rows of u, V and W the outputs read
  int m;       // t_ext padded to the 16-row blocks of the products
  __host__ __device__ explicit Tile(int tr)
      : tile_r(tr), t_ext(tr + 2 * P), m(rnd(tr + 2 * P, 16)) {}
  __host__ __device__ int u_elems() const { return rnd(m * LDU, 32); }
  __host__ __device__ int c_elems() const { return rnd(KD * LDV, 32); }
  __host__ __device__ int vw_elems() const { return rnd(m * LDV, 32); }
  __host__ __device__ int r_elems() const { return rnd(2 * tile_r * K, 32); }
  // the row windows' pitch: m + 4
  __host__ __device__ int ldw() const { return m + 4; }
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

// C, the window's KD x 2TX slice of [A1^T | B1^T] for columns j0 ..
template <typename T, int P>
__device__ void build_c(T* ct, const T* __restrict__ a1,
                        const T* __restrict__ b1, int j0, int n1, int tid,
                        int nthreads) {
  using G = Tile<P>;
  for (int e = tid; e < G::KD * 2 * TX; e += nthreads) {
    const int w = e / (2 * TX);
    const int col = e % (2 * TX);
    const int x = col % TX;
    const int t = w - x;
    const int j = j0 + x;
    T v = T(0);
    if (t >= 0 && t < G::K && j < n1)
      v = (col < TX ? a1 : b1)[static_cast<size_t>(j) * G::K + t];
    ct[w * LDV + col] = v;
  }
}

// The u tile of output rows i0 .. and columns j0 .., synchronously: rows
// [0, t_ext) x columns [0, UW) from the grid (zeros outside it), the
// padding rows and columns up to m x KD zero.
template <typename T, int P>
__device__ void load_u_tile(T* ut, const T* __restrict__ u, const Tile<P>& g,
                            int i0, int j0, int n0, int n1, int tid,
                            int nthreads) {
  using G = Tile<P>;
  for (int e = tid; e < g.m * G::KD; e += nthreads) {
    const int r = e / G::KD;
    const int c = e % G::KD;
    const int gi = i0 - P + r;
    const int gj = j0 - P + c;
    const bool in = r < g.t_ext && c < G::UW && gi >= 0 && gi < n0 &&
                    gj >= 0 && gj < n1;
    ut[r * G::LDU + c] = in ? u[static_cast<size_t>(gi) * n1 + gj] : T(0);
  }
}

// The A0 and B0 band rows of output rows i0 .., tile_r x K each.
template <typename T, int P>
__device__ void load_row_bands(T* ra, T* rb, const T* __restrict__ a0,
                               const T* __restrict__ b0, int i0, int n0,
                               int tile_r, int tid, int nthreads) {
  constexpr int K = 2 * P + 1;
  for (int e = tid; e < tile_r * K; e += nthreads) {
    const bool in = i0 + e / K < n0;
    ra[e] = in ? a0[static_cast<size_t>(i0) * K + e] : T(0);
    rb[e] = in ? b0[static_cast<size_t>(i0) * K + e] : T(0);
  }
}

// Column stage on the FMA units for rows [r_lo, r_hi) of the tile:
// V[r][x] = sum_t A1(j0 + x, t) U[r][x + t], W with B1; lane x, rows
// row0, row0 + rstep, ..; store(r, V[r][x], W[r][x]) puts them away.
template <typename T, int P, typename Store>
__device__ __forceinline__ void col_fma_to(const T* ut, const T* ct,
                                           int r_lo, int r_hi, int lane,
                                           int row0, int rstep,
                                           Store store) {
  using G = Tile<P>;
  for (int r = r_lo + row0; r < r_hi; r += rstep) {
    const T* row = ut + r * G::LDU + lane;
    T v = T(0);
    T w = T(0);
#pragma unroll
    for (int t = 0; t < G::K; ++t) {
      const T x = row[t];
      const T* c = ct + (lane + t) * LDV + lane;
      v = fma_(c[0], x, v);
      w = fma_(c[TX], x, w);
    }
    store(r, v, w);
  }
}

// The same into [V | W] of pitch LDV.
template <typename T, int P>
__device__ __forceinline__ void col_fma(const T* ut, const T* ct, T* vw,
                                        int r_lo, int r_hi, int lane,
                                        int row0, int rstep) {
  col_fma_to<T, P>(ut, ct, r_lo, r_hi, lane, row0, rstep,
                   [=](int r, T v, T w) {
                     vw[r * LDV + lane] = v;
                     vw[r * LDV + TX + lane] = w;
                   });
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

// Row stage on the FMA units: y[i0 + r][j0 + x] = sum_t A0(i0 + r, t)
// V[r + t][x] + B0(i0 + r, t) W[r + t][x]; lane x, rows row0, row0 +
// rstep, ..
template <typename T, int P>
__device__ __forceinline__ void row_fma(const T* vw, const T* ra, const T* rb,
                                        T* __restrict__ y, int i0, int j0,
                                        int n0, int n1, int tile_r, int lane,
                                        int row0, int rstep) {
  constexpr int K = 2 * P + 1;
  const int j = j0 + lane;
  if (j >= n1) return;
  for (int r = row0; r < tile_r && i0 + r < n0; r += rstep) {
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      acc = fma_(ra[r * K + t], vw[(r + t) * LDV + lane], acc);
      acc = fma_(rb[r * K + t], vw[(r + t) * LDV + TX + lane], acc);
    }
    y[static_cast<size_t>(i0 + r) * n1 + j] = acc;
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

// The switch from a runtime degree to the template instance; every
// schedule takes odd p <= 15, as K3.  The call names the degree P.
#define GDM_TC_DISPATCH_P(p, ...)                                 \
  switch (p) {                                                    \
    case 1: { constexpr int P = 1; return __VA_ARGS__; }          \
    case 3: { constexpr int P = 3; return __VA_ARGS__; }          \
    case 5: { constexpr int P = 5; return __VA_ARGS__; }          \
    case 7: { constexpr int P = 7; return __VA_ARGS__; }          \
    case 9: { constexpr int P = 9; return __VA_ARGS__; }          \
    case 11: { constexpr int P = 11; return __VA_ARGS__; }        \
    case 13: { constexpr int P = 13; return __VA_ARGS__; }        \
    case 15: { constexpr int P = 15; return __VA_ARGS__; }        \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }
