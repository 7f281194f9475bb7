// K3/mxu3p: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with
// K3's column stage on the FMA units and the row stage as a bf16x3 window
// product on the tensor cores, one unit's products under the next unit's
// column stage.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2's
// ``kernel_mxu3p`` (rows="mxu3p", gdm's 2D default on its TPU: step i
// issues tile i-1's three bf16 row products Bhi Zhi + Bhi Zlo + Blo Zhi,
// Z = [V; W] split into bf16 hi and lo, before tile i's column rolls, so
// the matrix unit drains under the roll loop).  Same operator, band tables
// and contiguous (n0, n1) node array as K3 (laplace2.cu); any four factor
// bands (cut/fastapply.py's split apply takes it as its default).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 and 40 us at 4096^2,
// p = 3, float32).  The design's own floor is its tensor work: a unit of
// 32 rows by 64 columns at p = 3 takes six bf16 chains of m64n32k16 over
// its window depth of 48, 2 x 3 x 2 x 64 x 32 x 48 flops, 0.66 GFLOP at
// 1025^2 (0.7 us at 989 TFLOP/s of bf16).
//
// Design (float32; tc_stage.cuh and tc_rows.cuh hold the shared stage): a
// persistent block of two warpgroups walks its units (row unit k of at
// most 32 rows, a column block of 64 columns) as K3/mxu's block does, its
// warpgroups joined by mbarriers only, no block-wide barrier after the
// set-up:
//   warpgroup 0 issues the 16-byte cp.async copies of unit n + 1's u rows
//     into the other of two landing slots and runs unit n's column stage
//     (a thread per output column, eight extended rows at a time), writes
//     V^T and W^T split into bf16 hi and lo (round to nearest even,
//     cvt.rn.bf16) into operand slot n % 2, and arrives on that slot's
//     "full" barrier; it waits on the slot's "empty" barrier first;
//   warpgroup 1 waits on "full", runs the bf16x3 product y^T = V^T A0w^T
//     + W^T B0w^T (tc_rows.cuh; wgmma m64n32k16, three chains a half of the
//     window, the window table's bf16 hi and lo images built once per
//     Bands2 and row units on the device (ops/tc_tables.py) and
//     bulk-copied in when the row unit changes), arrives on
//     "empty", stages y^T in one of two buffers and stores whole rows of y
//     coalesced (a named barrier of its own warpgroup between).
// So unit n's products and stores run under unit n + 1's column stage
// and copies.  A block takes 105 KB of shared memory at p = 3, so two
// share an SM.
//
// Float64: gdm splits nothing (its interpret-mode tests split float64
// into float32 hi and lo); the card's product is DMMA, unsplit, as K3/mxu's
// float64 kernel (laplace2_mxu.cu) runs it, which this entry launches.
#include "tc_rows.cuh"

extern "C" int gdm_laplace2_mxu_apply_f64(const void* u, const void* a1,
                                          const void* b1, const void* win,
                                          const void* ru, void* y, int p,
                                          int n0, int n1, int trb, int cw,
                                          int n_ru, int grid, void* stream);
extern "C" int gdm_laplace2_mxu_occupancy(int p, int f64, int cw, int* out);

namespace {

using namespace gdm::tcs;
namespace wg = gdm::wg;

constexpr int CW = CWR;

// Shared-memory layout (byte offsets): two operand slots (V^T hi, lo, W^T
// hi, lo, each 64 rows by the window depth MB in bf16), the window [A0w;
// B0w] (hi, lo), two staged y, two landing slots and their offsets, the
// mbarriers.
template <int P>
struct Smem {
  using G = Geom<float, P, CW>;
  static constexpr int ME = TRB + 2 * P;   // extended rows a unit reads
  static constexpr int MC = rnd(ME, 4);    // ... that the column stage writes
  static constexpr int MB = rnd(ME, 16);   // the window depth (k-steps of 16)
  static constexpr int LDS = CW + 4;
  static constexpr int LW = G::LW;
  static constexpr size_t IMG = 2 * 64 * MB;   // a 64-row bf16 image
  static constexpr size_t SLOT = line(4 * IMG);
  static constexpr size_t LAND = line(4 * MC * LW);
  static constexpr size_t STAGE = line(4 * TRB * LDS);
  static constexpr size_t slots = 0;
  static constexpr size_t win = slots + 2 * SLOT;
  static constexpr size_t stage = win + line(2 * IMG);
  static constexpr size_t land = stage + 2 * STAGE;
  static constexpr size_t roff = land + 2 * LAND;
  static constexpr size_t bars = roff + line(2 * 4 * MC);
  static constexpr size_t total = bars + line(5 * 8) + ALIGN;
};

// Clock stamps of warpgroup 0 (thread 0) and 1 (thread NT): slot += the
// clocks since t, t restarts (empty in the kernels' own build).
#define GDM_MXU3P_PHASE(who, slot, t)                                 \
  do {                                                                \
    GDM_STAMP_ADD(threadIdx.x == (who), slot, GDM_CLOCK() - (t));     \
    (t) = GDM_CLOCK();                                                \
  } while (0)

template <int P>
__global__ void __launch_bounds__(2 * NT, P <= 7 ? 2 : 1)
k3mxu3p_kernel(const float* __restrict__ u, const float* __restrict__ a1,
               const float* __restrict__ b1,
               const unsigned short* __restrict__ win_img,
               const int* __restrict__ ru, float* __restrict__ y, int n0,
               int n1, int n_cb, int units) {
  using L = Smem<P>;
  constexpr int ME = L::ME;
  constexpr int MC = L::MC;
  constexpr int MB = L::MB;
  constexpr int LDS = L::LDS;
  constexpr uint32_t IMG = L::IMG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + L::bars);
  unsigned long long* full = bars;        // [2]
  unsigned long long* empty = bars + 2;   // [2]
  unsigned long long* wbar = bars + 4;

  const int tid = threadIdx.x;
  int ub, count;
  gdm::part(units, gridDim.x, blockIdx.x, ub, count);
  if (count == 0) return;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());
  GDM_STAMP(tid == 0, 11, count);
  long long tc = GDM_CLOCK();

  float* land = reinterpret_cast<float*>(smem + L::land);
  int* roff = reinterpret_cast<int*>(smem + L::roff);
  if (tid < NT) {   // the first unit's u rows, ahead of the set-up
    const int k = ub / n_cb;
    const int j0 = (ub % n_cb) * CW;
    issue_u_rows<float, P, CW, MC>(land, u, ru[2 * k], j0, n0, n1, tid);
    row_offsets<float, P, MC>(roff, u, ru[2 * k], j0, n0, n1, tid);
    gdm::commit_group();
  }
  // set-up: the operand slots' rows past the column stage's (in the last
  // k-step of each image) stay zero
  for (int e = tid; e < 8 * 64 * 2; e += 2 * NT) {
    const int i = e / (64 * 2);   // image i % 4 of slot i / 4
    reinterpret_cast<float4*>(smem + L::slots + (i / 4) * L::SLOT +
                              (i % 4) * IMG + (MB / 16 - 1) * 64 * 32)[e % 128] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) {
    for (int b = 0; b < 4; ++b) gdm::bar_init(bars + b, NT);
    gdm::bar_init(wbar, 1);
    gdm::bar_init_fence();
  }
  wg::fence_async_smem();
  __syncthreads();
  GDM_STAMP(tid == 0, 2, clock64());
  tc = GDM_CLOCK();

  if (tid < NT) {
    // ---- warpgroup 0: copies and the column stage ----
    const int x = tid % CW;
    int gb, ge;
    row_groups(MC, tid / CW, NT / CW, gb, ge);
    for (int n = 0; n < count; ++n) {
      const int unit = ub + n;
      const int j0 = (unit % n_cb) * CW;
      const int s = n & 1;
      const float* ld = land + s * (L::LAND / 4);
      const int* ro = roff + s * MC;
      // the column's band rows, in flight through the wait
      float ca[2 * P + 1], cb[2 * P + 1];
      column_band_rows<float, P>(a1, b1, j0 + x, n1, ca, cb);
      const Cols<P, CW> cols(j0, n1);
      const bool inner = inner_unit<P, CW>(cols, ru[2 * (unit / n_cb)], MC,
                                           n0);
      const unsigned mask = tap_mask<P, CW>(x, cols);
      // unit n has landed; every thread is done with unit n - 1's slot
      gdm::wait_group<0>();
      group_sync(1);
      GDM_MXU3P_PHASE(0, 3, tc);
      if (n + 1 < count) {
        const int nk = (unit + 1) / n_cb;
        const int nj0 = ((unit + 1) % n_cb) * CW;
        issue_u_rows<float, P, CW, MC>(
            land + (s ^ 1) * (L::LAND / 4), u, ru[2 * nk], nj0, n0, n1, tid);
        row_offsets<float, P, MC>(roff + (s ^ 1) * MC, u, ru[2 * nk], nj0, n0,
                                  n1, tid);
      }
      gdm::commit_group();
      if (n >= 2) gdm::bar_wait(empty + s, ((n >> 1) + 1) & 1);
      GDM_MXU3P_PHASE(0, 4, tc);
      unsigned char* slot = smem + L::slots + s * L::SLOT;
      if (inner)
        bf16_columns<P, false>(ld, ro, x, gb, ge, mask, ca, cb, slot, IMG);
      else
        bf16_columns<P, true>(ld, ro, x, gb, ge, mask, ca, cb, slot, IMG);
      wg::fence_async_smem();
      gdm::bar_arrive(full + s);
      GDM_MXU3P_PHASE(0, 5, tc);
    }
    gdm::wait_group<0>();
    GDM_STAMP(tid == 0, 9, clock64());
  } else {
    // ---- warpgroup 1: the bf16x3 products and the epilogue ----
    const int t = tid - NT;
    const int warp = t / 32;
    const int lane = t % 32;
    unsigned char* win = smem + L::win;
    const uint32_t s_win = gdm::smem_addr(win);
    const uint32_t s_slots = gdm::smem_addr(smem + L::slots);
    float* stage = reinterpret_cast<float*>(smem + L::stage);
    int k_have = -1;
    unsigned loads = 0;
    for (int n = 0; n < count; ++n) {
      const int unit = ub + n;
      const int k = unit / n_cb;
      const int j0 = (unit % n_cb) * CW;
      const int s = n & 1;
      if (k != k_have) {
        // every thread of the group is past its products of the old window
        if (t == 0) {
          gdm::bar_arrive_expect_tx(wbar, 2 * IMG);
          gdm::bulk_copy(win, win_img + static_cast<size_t>(k) * IMG, 2 * IMG,
                         wbar);
        }
        gdm::bar_wait(wbar, loads & 1);
        ++loads;
        k_have = k;
        GDM_MXU3P_PHASE(NT, 12, tc);
      }
      gdm::bar_wait(full + s, (n >> 1) & 1);
      GDM_MXU3P_PHASE(NT, 6, tc);
      float acc[16];
      const uint32_t a0 = s_slots + s * static_cast<uint32_t>(L::SLOT);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MB / 16; ++kk) {
        const uint32_t a = a0 + kk * 64 * 32;   // V^T's chunk
        const uint32_t b = s_win + kk * 64 * 32;   // [A0w; B0w]'s chunk
        // V^T A0w^T, then W^T B0w^T: hi hi, lo hi, hi lo
        wg::WgmmaBf16D32::mma(acc, wg::sw32_desc(a), wg::sw32_desc(b),
                              kk > 0);
        wg::WgmmaBf16D32::mma(acc, wg::sw32_desc(a + IMG), wg::sw32_desc(b),
                              1);
        wg::WgmmaBf16D32::mma(acc, wg::sw32_desc(a), wg::sw32_desc(b + IMG),
                              1);
        const uint32_t aw = a + 2 * IMG;
        const uint32_t bw = b + 32 * 32;
        wg::WgmmaBf16D32::mma(acc, wg::sw32_desc(aw), wg::sw32_desc(bw), 1);
        wg::WgmmaBf16D32::mma(acc, wg::sw32_desc(aw + IMG), wg::sw32_desc(bw),
                              1);
        wg::WgmmaBf16D32::mma(acc, wg::sw32_desc(aw), wg::sw32_desc(bw + IMG),
                              1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::hold(acc);
      gdm::bar_arrive(empty + s);
      GDM_MXU3P_PHASE(NT, 7, tc);
      float* st = stage + s * (L::STAGE / 4);
      stage_yt<LDS>(st, acc, warp, lane);
      group_sync(2);
      store_rows<float, CW>(y, st, LDS, ru[2 * k], j0, ru[2 * k + 1], n1,
                            warp, NT / 32, lane);
      GDM_MXU3P_PHASE(NT, 8, tc);
    }
    GDM_STAMP(tid == NT, 13, clock64());
    GDM_STAMP(tid == NT, 10, gdm_gtimer());   // the block ends with it
  }
  (void)tc;
}

template <int P>
int launch_p(const void* u, const void* a1, const void* b1, const void* win,
             const int* ru, void* y, int n0, int n1, int trb, int cw,
             int n_ru, int grid, cudaStream_t stream) {
  const size_t smem = Smem<P>::total;
  const int n_cb = (n1 + CW - 1) / CW;
  const int units = n_ru * n_cb;
  if (cw != CW || !plan_ok(trb, units, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(k3mxu3p_kernel<P>, smem);
  if (e != 0) return e;
  k3mxu3p_kernel<P><<<grid, 2 * NT, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(a1),
      static_cast<const float*>(b1),
      static_cast<const unsigned short*>(win), ru, static_cast<float*>(y),
      n0, n1, n_cb, units);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* u, const void* a1, const void* b1, const void* win,
           const void* ru, void* y, int p, int n0, int n1, int trb, int cw,
           int n_ru, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ru);
  GDM_TCS_DISPATCH15(p, (launch_p<P>(u, a1, b1, win, r, y, n0, n1, trb, cw,
                                     n_ru, grid, s)))
}

template <int P>
int occupancy_p(int* out) {
  const size_t smem = Smem<P>::total;
  const int e = allow_smem(k3mxu3p_kernel<P>, smem);
  if (e != 0) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k3mxu3p_kernel<P>, 2 * NT, smem));
}

int occupancy_f32(int p, int* out) {
  GDM_TCS_DISPATCH15(p, occupancy_p<P>(out))
}

}  // namespace

extern "C" {

// u, the band rows A1 and B1, the bf16 window table (hi then lo images a
// row unit) and the row units of the plan (ops/tc_tables.py), y; the
// plan's rows a row unit (trb), columns a unit (cw, 64), row units and
// blocks; a plan off the kernel's layout is refused
// (cudaErrorInvalidValue).
int gdm_laplace2_mxu3p_apply_f32(const void* u, const void* a1,
                                 const void* b1, const void* win,
                                 const void* ru, void* y, int p, int n0,
                                 int n1, int trb, int cw, int n_ru, int grid,
                                 void* stream) {
  return launch(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru, grid,
                stream);
}

// float64: K3/mxu's DMMA kernel, from its float64 window table
int gdm_laplace2_mxu3p_apply_f64(const void* u, const void* a1,
                                 const void* b1, const void* win,
                                 const void* ru, void* y, int p, int n0,
                                 int n1, int trb, int cw, int n_ru, int grid,
                                 void* stream) {
  return gdm_laplace2_mxu_apply_f64(u, a1, b1, win, ru, y, p, n0, n1, trb, cw,
                                    n_ru, grid, stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64, K3/mxu's) one SM
// holds; cw must be 64 in float32.
int gdm_laplace2_mxu3p_occupancy(int p, int f64, int cw, int* out) {
  if (f64) return gdm_laplace2_mxu_occupancy(p, 1, cw, out);
  if (cw != CW) return static_cast<int>(cudaErrorInvalidValue);
  return occupancy_f32(p, out);
}

}  // extern "C"
