// The strip stage that K3p (laplace2_hybp.cu), K3c (laplace2_mxucol.cu)
// and K3h (laplace2_hybrid.cu) share.  A unit is one tile of tile_r
// output rows (the last one ragged) of a 32-column strip, its extended
// rows ME = rows + 2p; the plan (ops/tc_tables.py) numbers the units
// strip-major and gives each persistent block an even run of one strip's
// tiles, so the strip's band columns and C table serve every unit the
// block takes.  Here:
//   * K3's row stage on the FMA units (row_stage): a thread per output
//     column walks blocks of RB output rows with V and W of RB + 2p rows
//     in registers and each row's A0 and B0 coefficients by 16-byte loads
//     of the padded band rows (ops/tc_tables.py's band_rows), and stores
//     y coalesced;
//   * K3's column stage on the FMA units for extended rows [0, vf) of a
//     unit (fma_rows; tc_rows.cuh's column_sums);
//   * the column stage of rows [lo, ME) as a window product on the tensor
//     cores, [V | W] = U . C, with u as wgmma's A operand in registers
//     (col_product, K3c and K3h): a thread loads its A fragments straight
//     from the landed u rows and splits them into tf32 hi and lo in
//     registers, so nothing is written back to shared memory for the
//     product and no async-proxy fence is needed; B is C's K-major image,
//     which is C^T's rows (K3f's cached C^T as 64 rows by KD, hi then lo,
//     32-byte swizzled, brought in once a run by one bulk copy).  Chains
//     of 3xTF32 wgmma m64n64k8 take 64 extended rows each; rows past ME
//     are zero in the A fragments and are not stored.  Float64 runs the
//     same rows on the DMMA units (tc_window.cuh's col_mma) from K3f's
//     float64 C table through a u piece of 32 rows (col_product_f64).
#pragma once

#include "tc_rows.cuh"
#include "tc_window.cuh"

// Clock stamps of the tensor warpgroup's thread 0 (thread NT): slot += the
// clocks since t, t restarts (empty in the kernels' own build).
#define GDM_STRIP_PHASE(slot, t)                                     \
  do {                                                               \
    GDM_STAMP_ADD(threadIdx.x == NT, slot, GDM_CLOCK() - (t));       \
    (t) = GDM_CLOCK();                                               \
  } while (0)

namespace gdm {
namespace tcs {

constexpr int SW = TX;   // columns of a strip

// The layout of a K3c (PIPE: pipelined, two [V | W] slots) or K3h block
// of type T at degree P with tiles of tile_r rows (byte offsets from a
// 1024-byte aligned base): the float32 B image of C^T (hi, lo) or the
// float64 u piece (and K3h's DMMA scratch tiles), the [V | W] slots, two
// landing slots of u rows, the float32 band-row slots (K3c three, since
// its row stage runs a unit behind the copies; K3h two), the landing
// offsets of the two warpgroups, the mbarriers.  ops/tc_tables.py's
// strip_layout mirrors it.
template <typename T, int P, bool PIPE>
struct CGeom {
  static constexpr int K = 2 * P + 1;
  static constexpr int UW = SW + 2 * P;      // u columns a unit reads
  static constexpr int KD = rnd(UW, 8);      // ... padded to k-steps
  static constexpr int KS = KD / 8;          // k-steps of a chain
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int LW = Geom<T, P, SW>::LW;   // landing row pitch
  static constexpr int KP = rnd(K, VEC);     // a band row's pitch
  // [V | W]'s pitch: 8 mod 32 words in float32, so the accumulators'
  // float2 stores meet no bank conflict; col_mma's 2 SW + 4 in float64
  static constexpr int LDV = sizeof(T) == 4 ? 2 * SW + 8 : gdm::tc::LDV;
  static constexpr int LDU = KD + 4;         // the float64 u piece's pitch
  static constexpr int RB = P <= 5 ? 8 : 4;  // output rows a row block
  static constexpr int UCH = 32;             // rows of the float64 u piece
  static constexpr int NVW = PIPE ? 2 : 1;
  static constexpr int NBAND = PIPE ? 3 : 2;
  static constexpr unsigned CIMG = 2 * 64 * KD * 4;   // the B image, bytes
  int tile_r, cap;
  size_t vw, land, bands, roff, bars, total;
  __host__ __device__ explicit CGeom(int tr) : tile_r(tr) {
    // rows of a slot: the row stage reads rnd(rows, RB) + 2p of them; the
    // float64 products write whole 16-row blocks
    cap = rnd(rnd(tr, RB) + 2 * P, sizeof(T) == 4 ? 8 : 16);
    const size_t op = sizeof(T) == 4
                          ? CIMG
                          : 8 * UCH * LDU + (PIPE ? 0 : 4 * gdm::tc::SCR * 8);
    vw = gdm::tc::rnd128(op);
    land = vw + NVW * vw_slot();
    bands = land + 2 * land_slot();
    roff = bands + (sizeof(T) == 4 ? NBAND * band_slot() : 0);
    bars = roff + gdm::tc::rnd128(4 * 2 * cap);
    total = bars + 128 + ALIGN;
  }
  __host__ __device__ size_t vw_slot() const {
    return gdm::tc::rnd128(sizeof(T) * cap * LDV);
  }
  __host__ __device__ size_t land_slot() const {
    return gdm::tc::rnd128(sizeof(T) * cap * LW);
  }
  __host__ __device__ size_t band_slot() const {
    return gdm::tc::rnd128(sizeof(T) * rnd(tile_r, RB) * 2 * KP);
  }
};

// Run k (first tile t0, count tiles) of a strip's n_tiles tiles cut into
// segs even runs, the longer runs last (K3c, K3h): a strip's last tile is
// its ragged one (a single row at 2^k + 1 nodes), so the run that holds
// it also takes an extra tile, and no run holds one more full tile than
// another where the ragged tile is small.
__device__ __forceinline__ void strip_run(int n_tiles, int segs, int k,
                                          int& t0, int& count) {
  gdm::part(n_tiles, segs, segs - 1 - k, t0, count);
  t0 = n_tiles - t0 - count;
}

// A barrier of both warpgroups' 2 NT threads (named barrier `id`).
__device__ __forceinline__ void block_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * NT) : "memory");
}

// A plan's launch checks: tiles of tile_r >= 1 rows, n_tiles of them,
// segs runs of tiles a strip (1 .. n_tiles), a block a (strip, run),
// shared memory within a block.
inline bool strip_plan_ok(int n0, int n1, int tile_r, int n_tiles, int segs,
                          int grid, size_t smem) {
  if (tile_r < 1 || n0 < 1 || n1 < 1) return false;
  const int strips = (n1 + SW - 1) / SW;
  return n_tiles == (n0 + tile_r - 1) / tile_r && segs >= 1 &&
         segs <= n_tiles && grid == strips * segs &&
         smem <= static_cast<size_t>(SMEM_MAX);
}

// Issue a warpgroup's share of the 16-byte cp.async copies of a unit
// (tile i0, `rows` rows) of strip j0 (thread t of the group): its u rows
// [r0, r1) (of its rows + 2p extended rows) into those rows of the
// landing slot `land` and, where `bands` is given, in float32 also its A0
// and B0 band rows (2 KP a row, contiguous in the padded table rb_img);
// then one arrival on `landed` once this thread's copies land.
template <typename T, int P>
__device__ __forceinline__ void issue_unit(T* land, T* bands,
                                           const T* __restrict__ u,
                                           const T* __restrict__ rb_img,
                                           int i0, int rows, int j0, int n0,
                                           int n1, int t, int r0, int r1,
                                           unsigned long long* landed) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int KP = rnd(2 * P + 1, VEC);
  if (r1 > r0)
    issue_u_rows<T, P, SW>(land + r0 * Geom<T, P, SW>::LW, u, i0 + r0, j0, n0,
                           n1, t, r1 - r0);
  if constexpr (sizeof(T) == 4) {
    if (bands != nullptr) {
      const T* src = rb_img + static_cast<size_t>(i0) * 2 * KP;
      for (int e = t; e < rows * 2 * KP / VEC; e += NT)
        copy16(bands + e * VEC, src + e * VEC);
    }
  }
  copies_arrive(landed);
}

// The row stage of a unit: y[i0 + r][j0 + lane] = sum_t A0(i0 + r, t)
// V[r + t] + sum_t B0(i0 + r, t) W[r + t] for the unit's `rows` rows,
// blocks of RB rows shared out over WARPS warps, V and W of a block's
// RB + 2p rows in registers ([V | W] at pitch LDV), each row's
// coefficients (the padded band rows: A0's KP, then B0's) by 16-byte
// loads.
template <typename T, int P, int LDV, int WARPS>
__device__ __forceinline__ void row_stage(const T* vw, const T* bands,
                                          T* __restrict__ y, int i0,
                                          int rows, int j0, int n1, int warp,
                                          int lane) {
  constexpr int K = 2 * P + 1;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int KP = rnd(K, VEC);
  constexpr int RB = P <= 5 ? 8 : 4;
  constexpr int NV = RB + 2 * P;
  const int j = j0 + lane;
  for (int r0 = warp * RB; r0 < rows; r0 += WARPS * RB) {
    T v[NV], w[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      v[q] = vw[(r0 + q) * LDV + lane];
      w[q] = vw[(r0 + q) * LDV + SW + lane];
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      // a row past the unit reads the first row's coefficients
      const T* c = bands + (r0 + k < rows ? r0 + k : 0) * 2 * KP;
      T ca[KP], cb[KP];
#pragma unroll
      for (int e = 0; e < KP; e += VEC) {
        if constexpr (sizeof(T) == 4) {
          const float4 a = *reinterpret_cast<const float4*>(c + e);
          const float4 b = *reinterpret_cast<const float4*>(c + KP + e);
          ca[e] = a.x, ca[e + 1] = a.y, ca[e + 2] = a.z, ca[e + 3] = a.w;
          cb[e] = b.x, cb[e + 1] = b.y, cb[e + 2] = b.z, cb[e + 3] = b.w;
        } else {
          const double2 a = *reinterpret_cast<const double2*>(c + e);
          const double2 b = *reinterpret_cast<const double2*>(c + KP + e);
          ca[e] = a.x, ca[e + 1] = a.y;
          cb[e] = b.x, cb[e + 1] = b.y;
        }
      }
      T sa = T(0), sb = T(0);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        sa = gdm::fma_(ca[t], v[k + t], sa);
        sb = gdm::fma_(cb[t], w[k + t], sb);
      }
      if (r0 + k < rows && j < n1)
        y[static_cast<size_t>(i0 + r0 + k) * n1 + j] = sa + sb;
    }
  }
}

// The FMA column stage of a unit's extended rows [0, vf) into the [V | W]
// slot (pitch LDV): output column x, blocks of four rows shared out over
// WARPS warps.
template <typename T, int P, int LDV, int WARPS, bool EDGE>
__device__ __forceinline__ void fma_rows(const T* ld, const int* roff,
                                         T* vw, int vf, int me, int x,
                                         unsigned mask,
                                         const T (&ca)[2 * P + 1],
                                         const T (&cb)[2 * P + 1],
                                         int warp) {
  for (int s0 = 4 * warp; s0 < vf; s0 += 4 * WARPS) {
    T v[4], w[4];
    column_sums<T, P, SW, 4, EDGE>(ld, roff, s0, me, x, mask, ca, cb, v, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (s0 + q < vf) {
        vw[(s0 + q) * LDV + x] = v[q];
        vw[(s0 + q) * LDV + SW + x] = w[q];
      }
    }
  }
}

// The tensor column rows [lo, me) of a unit in float32, one warpgroup
// (warp 0 .. 3 of it): per 64 extended rows from lo, the A fragments of
// every k-step (rows c0 + 16 warp + lane / 4 (+ 8), columns 8 kk + lane %
// 4 (+ 4): wgmma.cuh's WgmmaTf32RS) read from the landed rows (zero past
// me or outside the grid) and split into tf32 hi and lo in registers,
// then one chain of 3xTF32 m64n64k8 products against C^T's B image at
// shared address `cimg` (hi, then lo 4 x 64 x KD bytes on), and the
// accumulators, [V | W] of those rows, stored as float2 into the slot
// (pitch LDV).  !EDGE: a unit whose extended rows and u columns all lie
// in the grid (every landing offset >= 0), so only the padding columns
// past SW + 2p, in the last k-step, read as zero.  Clock stamps of the
// tensor warpgroup's thread 0 (thread NT of the block; empty in the
// kernels' own build): slot 8 the A loads and splits, 15 the products, 14
// the stores, from `tc`.
template <int P, int LDV, bool EDGE>
__device__ __forceinline__ void col_product(const float* ld, const int* ro,
                                            float* vw, int lo, int me,
                                            const Cols<P, SW>& cols,
                                            uint32_t cimg, int warp,
                                            int lane, long long& tc) {
  constexpr int LW = Geom<float, P, SW>::LW;
  constexpr int KS = rnd(SW + 2 * P, 8) / 8;
  constexpr uint32_t LO = 4 * 64 * KS * 8;
  for (int c0 = lo; c0 < me; c0 += 64) {
    const int ra = c0 + 16 * warp + lane / 4;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      const int o = r < me ? ro[r] : -1;
      const float* row = ld + (o >= 0 ? r * LW + o : 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = 8 * kk + lane % 4 + 4 * q;
          bool in;
          if constexpr (EDGE)
            in = o >= 0 && c >= cols.lo && c < cols.hi;
          else
            in = r < me && (kk < KS - 1 || c < SW + 2 * P);
          const float x = in ? row[c] : 0.f;
          const float hi = tf32_rna(x);
          ah[kk][h + 2 * q] = __float_as_uint(hi);
          al[kk][h + 2 * q] = __float_as_uint(tf32_rna(x - hi));
        }
    }
    GDM_STRIP_PHASE(8, tc);
    float acc[32];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma3rs<64>(acc, ah[kk], al[kk], cimg + kk * 64 * 32,
                 cimg + LO + kk * 64 * 32, kk == 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(acc);
    GDM_STRIP_PHASE(15, tc);
    // acc: row ra (+ 8) of [V | W], columns 8 j + 2 (lane % 4) (+ 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = ra + 8 * h;
      if (s < me) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(vw + s * LDV + 8 * j + 2 * (lane % 4)) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    GDM_STRIP_PHASE(14, tc);
  }
}

// The tensor column rows [lo, me) of a unit in float64, one warpgroup
// (thread t, warp 0 .. 3 of it, group barrier 1): pieces of UCH rows from
// the 16-row block that holds lo copied from the landed rows into the u
// piece `ut` (pitch KD + 4, zeros past me or outside the grid), then DMMA
// against C (K3f's float64 table, row-major, in device memory) by
// tc_window.cuh's col_mma, the block that holds lo through the warp's
// scratch tile (`scr`, only read when lo is not a multiple of 16).
template <int P>
__device__ __forceinline__ void col_product_f64(const double* ld,
                                                const int* ro, double* vw,
                                                double* ut, double* scr,
                                                const double* ctab, int lo,
                                                int me,
                                                const Cols<P, SW>& cols,
                                                int t, int warp, int lane) {
  constexpr int KD = rnd(SW + 2 * P, 8);
  constexpr int LDU = KD + 4;
  constexpr int UCH = 32;
  const int m = rnd(me, 16);
  const int b0 = lo / 16 * 16;
  for (int b = b0; b < m; b += UCH) {
    const int e = b + UCH < m ? b + UCH : m;
    if (b > b0) group_sync(1);   // the last piece's products are done
    for (int i = t; i < (e - b) * KD; i += NT) {
      const int r = b + i / KD;
      const int c = i % KD;
      ut[(r - b) * LDU + c] =
          r < me ? landed<double, P, SW>(ld, ro, r, c, cols) : 0.0;
    }
    group_sync(1);
    gdm::tc::col_mma<double, P>(ut - static_cast<size_t>(b) * LDU, ctab, vw,
                                scr + warp * gdm::tc::SCR, lo > b ? lo : b, e,
                                warp, NT / 32, lane);
  }
}

}  // namespace tcs
}  // namespace gdm
