// What K3/mxu, K3/mxu3 (laplace2_mxu.cu) and K3/mxu3p (laplace2_mxu3p.cu)
// share on the stage of tc_stage.cuh: K3's column stage on the FMA units,
// a thread per output column (K3p, laplace2_hybp.cu, takes it too, on
// units of 32 columns), the bf16 hi/lo operands of the bf16x3 row product
// (K3/mxu3, K3/mxu3p) and the epilogue of the transposed row product.
//
// Both kernels take the row stage as y^T = V^T A0w^T + W^T B0w^T: the
// window table [A0w; B0w] holds each output row's window K-major, so its
// two 32-row halves are wgmma's B operands as they are (N = the unit's 32
// output rows), and V^T and W^T (64 output columns by the unit's extended
// rows, K-major) are its A operands, M = 64 output columns.  The column
// stage writes V^T and W^T straight into that layout: a thread owns one
// output column x and a run of consecutive extended rows s, so its
// results for a 16-byte half of a row of the 32-byte swizzled operand
// (four tf32 or eight bf16) go out in one store, and the eight lanes of a
// store phase hit eight distinct halves of the swizzle: no bank conflict.
#pragma once

#include <cuda_bf16.h>

#include "tc_stage.cuh"

namespace gdm {
namespace tcs {

constexpr int CWR = 64;   // output columns of a K3/mxu, K3/mxu3 or K3/mxu3p unit

// A barrier of one warpgroup's NT threads alone (named barrier `id`, 1 ..
// 15; the block's __syncthreads is barrier 0).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(NT) : "memory");
}

// The band rows A1(j, .), B1(j, .) of output column j (zero past the
// grid).
template <typename T, int P>
__device__ __forceinline__ void column_band_rows(const T* __restrict__ a1,
                                                 const T* __restrict__ b1,
                                                 int j, int n1,
                                                 T (&ca)[2 * P + 1],
                                                 T (&cb)[2 * P + 1]) {
  constexpr int K = 2 * P + 1;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    ca[t] = j < n1 ? a1[static_cast<size_t>(j) * K + t] : T(0);
    cb[t] = j < n1 ? b1[static_cast<size_t>(j) * K + t] : T(0);
  }
}

// Bit t set when unit column x + t (tap t of output column x) lies in the
// grid: the taps a thread reads, fixed for the unit.
template <int P, int CW>
__device__ __forceinline__ unsigned tap_mask(int x, const Cols<P, CW>& cols) {
  unsigned m = 0;
#pragma unroll
  for (int t = 0; t < 2 * P + 1; ++t)
    if (x + t >= cols.lo && x + t < cols.hi) m |= 1u << t;
  return m;
}

// The row groups [gb, ge) of thread group g0 of gs when the first mc
// extended rows (a multiple of 4) are cut into groups of four rows and
// shared out evenly, each thread's consecutive.
__device__ __forceinline__ void row_groups(int mc, int g0, int gs, int& gb,
                                           int& ge) {
  const int n = mc / 4;
  const int per = (n + gs - 1) / gs;
  gb = g0 * per < n ? g0 * per : n;
  ge = gb + per < n ? gb + per : n;
}

// True when a unit needs no masks: its first `mc` extended rows and all
// its u columns lie in the grid (the unit's copies then land every row).
template <int P, int CW>
__device__ __forceinline__ bool inner_unit(const Cols<P, CW>& cols, int i0,
                                           int mc, int n0) {
  return cols.lo == 0 && cols.hi == CW + 2 * P && i0 >= P &&
         i0 - P + mc <= n0;
}

// The column sums of output column x at Q consecutive extended rows r0 ..:
// v[q] = sum_t A1(., t) u(r0 + q, x + t), w[q] the same with B1.  EDGE:
// zero for a row at or past `me` or outside the grid (roff < 0) and for
// the taps outside `mask`, with no branch (a row outside reads its landing
// row at offset 0 and selects zeros); else every row and tap is read as
// it landed (inner_unit).  Either way the compiler can issue the loads of
// QB rows (up to 64 values) before their FMAs.
template <typename T, int P, int CW, int Q, bool EDGE>
__device__ __forceinline__ void column_sums(const T* ld, const int* roff,
                                            int r0, int me, int x,
                                            unsigned mask,
                                            const T (&ca)[2 * P + 1],
                                            const T (&cb)[2 * P + 1],
                                            T (&v)[Q], T (&w)[Q]) {
  constexpr int LW = Geom<T, P, CW>::LW;
  constexpr int K = 2 * P + 1;
  constexpr int QB = K * Q <= 64 ? Q : (64 / K > 1 ? 64 / K : 1);
#pragma unroll
  for (int q0 = 0; q0 < Q; q0 += QB) {
    T e[QB][K];
#pragma unroll
    for (int b = 0; b < QB && q0 + b < Q; ++b) {
      const int r = r0 + q0 + b;
      if constexpr (EDGE) {
        const int o = r < me ? roff[r] : -1;
        const unsigned m = o >= 0 ? mask : 0u;
        const T* row = ld + r * LW + (o >= 0 ? o : 0) + x;
#pragma unroll
        for (int t = 0; t < K; ++t) e[b][t] = (m >> t) & 1u ? row[t] : T(0);
      } else {
        const T* row = ld + r * LW + roff[r] + x;
#pragma unroll
        for (int t = 0; t < K; ++t) e[b][t] = row[t];
      }
    }
#pragma unroll
    for (int b = 0; b < QB && q0 + b < Q; ++b) {
      T sv = T(0), sw = T(0);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        sv = fma_(ca[t], e[b][t], sv);
        sw = fma_(cb[t], e[b][t], sw);
      }
      v[q0 + b] = sv;
      w[q0 + b] = sw;
    }
  }
}

// The 64 x 32 float32 accumulator of y^T (row x = an output column, column
// r = an output row; wgmma.cuh's layout, warp w of the group) staged as y:
// stage[r * LDS + x].  A pitch of 4 mod 32 keeps the stores conflict-free.
template <int LDS>
__device__ __forceinline__ void stage_yt(float* stage, const float (&acc)[16],
                                         int warp, int lane) {
  const int x = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        stage[(8 * j + 2 * (lane % 4) + q) * LDS + x + 8 * h] =
            acc[4 * j + 2 * h + q];
}

// The staged rows of a unit (rows r < `rows`, columns c < CW) into y at
// (i0, j0), whole rows coalesced; `warp` of `warps`.
template <typename T, int CW>
__device__ __forceinline__ void store_rows(T* __restrict__ y, const T* stage,
                                           int lds, int i0, int j0, int rows,
                                           int n1, int warp, int warps,
                                           int lane) {
  for (int r = warp; r < rows; r += warps)
#pragma unroll
    for (int c = lane; c < CW; c += 32)
      if (j0 + c < n1)
        y[static_cast<size_t>(i0 + r) * n1 + j0 + c] = stage[r * lds + c];
}

// ---- the bf16 hi/lo operands of the bf16x3 row product ----

// Two floats as bf16 hi (round to nearest even) and lo = bf16(x - hi),
// each pair packed low address first.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The byte offset of extended row k (a multiple of 4) of output column x
// in a 64-row bf16 operand image (32-byte swizzle, k-steps of 16 bf16).
__device__ __forceinline__ int bf16_at(int x, int k) {
  return (k >> 4) * 64 * 32 + x * 32 +
         ((((k >> 3) & 1) ^ ((x >> 2) & 1)) << 4) + ((k & 7) << 1);
}

// Q (4 or 8) column sums of V and W at byte offset `at` of the images
// (V^T hi, lo, W^T hi, lo, `img` bytes apart from `slot`), split into
// bf16: one 8- or 16-byte store an image.
template <int Q>
__device__ __forceinline__ void put_bf16(unsigned char* slot, uint32_t img,
                                         int at, const float (&v)[Q],
                                         const float (&w)[Q]) {
  uint32_t vh[Q / 2], vl[Q / 2], wh[Q / 2], wl[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) {
    split_bf16x2(v[2 * i], v[2 * i + 1], vh[i], vl[i]);
    split_bf16x2(w[2 * i], w[2 * i + 1], wh[i], wl[i]);
  }
  if constexpr (Q == 8) {
    *reinterpret_cast<uint4*>(slot + at) = make_uint4(vh[0], vh[1], vh[2],
                                                      vh[3]);
    *reinterpret_cast<uint4*>(slot + img + at) =
        make_uint4(vl[0], vl[1], vl[2], vl[3]);
    *reinterpret_cast<uint4*>(slot + 2 * img + at) =
        make_uint4(wh[0], wh[1], wh[2], wh[3]);
    *reinterpret_cast<uint4*>(slot + 3 * img + at) =
        make_uint4(wl[0], wl[1], wl[2], wl[3]);
  } else {
    *reinterpret_cast<uint2*>(slot + at) = make_uint2(vh[0], vh[1]);
    *reinterpret_cast<uint2*>(slot + img + at) = make_uint2(vl[0], vl[1]);
    *reinterpret_cast<uint2*>(slot + 2 * img + at) = make_uint2(wh[0], wh[1]);
    *reinterpret_cast<uint2*>(slot + 3 * img + at) = make_uint2(wl[0], wl[1]);
  }
}

// The column stage of a unit into the bf16 images from `slot`: output
// column x at the row groups [gb, ge) of four extended rows, eight rows
// (a 16-byte half of the swizzled row) at a time, four at an odd start or
// end.
template <int P, bool EDGE>
__device__ __forceinline__ void bf16_columns(
    const float* ld, const int* ro, int x, int gb, int ge, unsigned mask,
    const float (&ca)[2 * P + 1], const float (&cb)[2 * P + 1],
    unsigned char* slot, uint32_t img) {
  constexpr int ME = TRB + 2 * P;
  int g = gb;
  if (g < ge && (g & 1)) {
    float v[4], w[4];
    column_sums<float, P, CWR, 4, EDGE>(ld, ro, 4 * g, ME, x, mask, ca, cb,
                                        v, w);
    put_bf16<4>(slot, img, bf16_at(x, 4 * g), v, w);
    ++g;
  }
  for (; g + 2 <= ge; g += 2) {
    float v[8], w[8];
    column_sums<float, P, CWR, 8, EDGE>(ld, ro, 4 * g, ME, x, mask, ca, cb,
                                        v, w);
    put_bf16<8>(slot, img, bf16_at(x, 4 * g), v, w);
  }
  if (g < ge) {
    float v[4], w[4];
    column_sums<float, P, CWR, 4, EDGE>(ld, ro, 4 * g, ME, x, mask, ca, cb,
                                        v, w);
    put_bf16<4>(slot, img, bf16_at(x, 4 * g), v, w);
  }
}

}  // namespace tcs
}  // namespace gdm
