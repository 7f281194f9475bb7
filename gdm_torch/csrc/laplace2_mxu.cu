// K3/mxu and K3/mxu3: the 2D separable band apply  y = A0 U A1^T + B0 U
// B1^T  with K3's column stage on the FMA units and the row stage as one
// window product on the tensor cores: 3xTF32 (K3/mxu) or bf16x3 (K3/mxu3).
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2's
// ``kernel_mxu`` (rows="mxu": the column rolls V = U A1^T, W = U B1^T over
// the extended tile, then the row stage Bcat . [V; W] as one dense-banded
// product at HIGHEST precision) and ``kernel_mxu3`` (rows="mxu3": the same
// product as bf16x3, each operand split into bf16 hi and lo, hi hi + lo hi
// + hi lo with float32 accumulation; not pipelined across tiles, which is
// K3/mxu3p, laplace2_mxu3p.cu).  Same operator, band tables and
// contiguous (n0, n1) node array as K3 (laplace2.cu).
//
// Bound on the card: K3's (memory, 8 bytes of u and y per node in
// float32: 2.51 us at 1024^2 p = 3).  The design's own floor is its
// tensor work: a unit of 32 rows by 64 columns at p = 3 takes two 3xTF32
// chains of m64n32k8 over its 40-row window, 2 x 3 x 2 x 64 x 32 x 40
// flops, 0.55 GFLOP at 1025^2 (1.1 us at 495 TFLOP/s of tf32); K3/mxu3's
// six bf16 chains of m64n32k16 over a depth of 48, 0.66 GFLOP (0.7 us at
// 989 TFLOP/s of bf16); the FMA work of both is K3's column stage over the
// 38 extended rows of a unit.
//
// Design (float32; tc_stage.cuh and tc_rows.cuh hold the shared stage): a
// persistent block of one warpgroup walks its units (row unit k of at most
// 32 rows, column block cb of CW columns), a serial chain a unit:
//   the landed u rows (16-byte cp.async, issued two units ahead into a
//     ring of three landing slots where two blocks an SM still fit, else
//     one unit ahead into two);
//   the column stage on the FMA units, a thread per output column x with
//     its A1 and B1 band rows in registers, four extended rows at a time:
//     V[s][x] and W[s][x] split once (tf32 hi and lo, or bf16 hi and lo
//     rounded to nearest even) and stored as 16-byte halves (8-byte ones
//     at a bf16 run's odd end) of the product's K-major A operands V^T and
//     W^T;
//   the row stage y^T = V^T A0w^T + W^T B0w^T (tc_rows.cuh): the cached
//     window table's two halves are the B operands as they are (the tf32
//     table for K3/mxu, the bf16 one K3/mxu3p reads too for K3/mxu3), the
//     product over the unit's window depth only: rnd(32 + 2p, 8) rows in
//     two 3xTF32 chains of wgmma m64n32k8 (40 at p = 3), or rnd(32 + 2p,
//     16) in six bf16 chains of m64n32k16 (48);
//   the epilogue: y^T staged transposed in shared memory, whole rows of y
//     stored coalesced; a new window, one bulk copy completing on an
//     mbarrier, once the row product is done and only when the row unit
//     changes.
// No table entry is built or split in the kernel.  A unit is CW = 64
// columns wide, wgmma's M (ops/tc_tables.py, COLS).  A block takes 107 KB
// (K3/mxu) or 83 KB (K3/mxu3) of shared memory at p = 3, so two share an
// SM.
//
// Float64: the DMMA units (wmma m8n8k4, tc_window.cuh's Acc16<double>)
// take the row product A0w V + B0w W, unsplit, from the float64 window
// table, in the same persistent walk with the same column stage.  K3/mxu3
// and K3/mxu3p (laplace2_mxu3p.cu) run this float64 kernel too: every
// float64 row product is DMMA, unsplit.
#include "tc_rows.cuh"
#include "tc_window.cuh"

namespace {

using namespace gdm::tcs;
namespace wg = gdm::wg;

constexpr int CW = CWR;

// The column stage of a unit into V^T and W^T, split into tf32 hi and lo
// (lo's image `lo` floats after hi's): output column x at the row groups
// [gb, ge) of four extended rows, eight rows at a time.
template <int P, bool EDGE>
__device__ __forceinline__ void tf32_columns(
    const float* ld, const int* roff, int x, int gb, int ge, unsigned mask,
    const float (&ca)[2 * P + 1], const float (&cb)[2 * P + 1], float* vdst,
    float* wdst, int lo) {
  constexpr int ME = TRB + 2 * P;
  int g = gb;
  for (; g + 2 <= ge; g += 2) {
    float v[8], w[8];
    column_sums<float, P, CW, 8, EDGE>(ld, roff, 4 * g, ME, x, mask, ca, cb,
                                       v, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float vh[4] = {v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
      const float wh[4] = {w[4 * h], w[4 * h + 1], w[4 * h + 2], w[4 * h + 3]};
      split4(vdst, vdst + lo, wg::sw32_offset(x, 4 * (g + h), 64) / 4, vh);
      split4(wdst, wdst + lo, wg::sw32_offset(x, 4 * (g + h), 64) / 4, wh);
    }
  }
  if (g < ge) {
    float v[4], w[4];
    column_sums<float, P, CW, 4, EDGE>(ld, roff, 4 * g, ME, x, mask, ca, cb,
                                       v, w);
    split4(vdst, vdst + lo, wg::sw32_offset(x, 4 * g, 64) / 4, v);
    split4(wdst, wdst + lo, wg::sw32_offset(x, 4 * g, 64) / 4, w);
  }
}

// The float32 row product's two forms.  Both read the window [A0w; B0w]
// (64 rows, hi's image then lo's) and write the A operands V^T hi, V^T lo,
// W^T hi, W^T lo (64 rows each), every image IMG bytes, in the 32-byte
// swizzled K-major layout: k-steps of KS elements, a chunk of 64 rows x
// 32 bytes a k-step, B0w's half of a window chunk 1024 bytes in.
// Tf32: K3/mxu, 3xTF32 (tf32 hi/lo, wgmma m64n32k8) over the window depth
// D = rnd(32 + 2p, 8), the cached tf32 window table.
template <int P>
struct Tf32 {
  static constexpr int KS = 8;
  static constexpr int D = rnd(TRB + 2 * P, 8);
  static constexpr uint32_t IMG = 4 * 64 * D;

  template <bool EDGE>
  __device__ __forceinline__ static void columns(
      const float* ld, const int* roff, int x, int gb, int ge, unsigned mask,
      const float (&ca)[2 * P + 1], const float (&cb)[2 * P + 1],
      unsigned char* aop) {
    tf32_columns<P, EDGE>(ld, roff, x, gb, ge, mask, ca, cb,
                          reinterpret_cast<float*>(aop),
                          reinterpret_cast<float*>(aop + 2 * IMG), IMG / 4);
  }

  __device__ __forceinline__ static void product(float (&acc)[16],
                                                 uint32_t a0, uint32_t b0) {
#pragma unroll
    for (int kk = 0; kk < D / KS; ++kk) {
      const uint32_t a = a0 + kk * 64 * 32;
      const uint32_t b = b0 + kk * 64 * 32;
      mma3<32>(acc, a, a + IMG, b, b + IMG, kk == 0);
      mma3<32>(acc, a + 2 * IMG, a + 3 * IMG, b + 1024, b + 1024 + IMG,
               false);
    }
  }
};

// Bf16x3: K3/mxu3, bf16 hi/lo (round to nearest even) and the three
// products hi hi + lo hi + hi lo (wgmma m64n32k16) over the window depth
// D = rnd(32 + 2p, 16), the cached bf16 window table (K3/mxu3p's).
template <int P>
struct Bf16x3 {
  static constexpr int KS = 16;
  static constexpr int D = rnd(TRB + 2 * P, 16);
  static constexpr uint32_t IMG = 2 * 64 * D;

  template <bool EDGE>
  __device__ __forceinline__ static void columns(
      const float* ld, const int* roff, int x, int gb, int ge, unsigned mask,
      const float (&ca)[2 * P + 1], const float (&cb)[2 * P + 1],
      unsigned char* aop) {
    bf16_columns<P, EDGE>(ld, roff, x, gb, ge, mask, ca, cb, aop, IMG);
  }

  __device__ __forceinline__ static void product(float (&acc)[16],
                                                 uint32_t a0, uint32_t b0) {
    using W = wg::WgmmaBf16D32;
#pragma unroll
    for (int kk = 0; kk < D / KS; ++kk) {
      const uint32_t a = a0 + kk * 64 * 32;   // V^T's chunk
      const uint32_t b = b0 + kk * 64 * 32;   // [A0w; B0w]'s chunk
      // V^T A0w^T, then W^T B0w^T: hi hi, lo hi, hi lo
      W::mma(acc, wg::sw32_desc(a), wg::sw32_desc(b), kk > 0);
      W::mma(acc, wg::sw32_desc(a + IMG), wg::sw32_desc(b), 1);
      W::mma(acc, wg::sw32_desc(a), wg::sw32_desc(b + IMG), 1);
      const uint32_t aw = a + 2 * IMG;
      const uint32_t bw = b + 1024;
      W::mma(acc, wg::sw32_desc(aw), wg::sw32_desc(bw), 1);
      W::mma(acc, wg::sw32_desc(aw + IMG), wg::sw32_desc(bw), 1);
      W::mma(acc, wg::sw32_desc(aw), wg::sw32_desc(bw + IMG), 1);
    }
  }
};

// Shared-memory layout of a float32 block (byte offsets): the split
// window [A0w; B0w], the split A operands V^T and W^T, staged y, NL
// landing slots, the landing offsets and the window's mbarrier.  NL is
// three (u copies two units ahead) where the block still leaves room for
// its BLOCKS an SM, else two.
template <int P, typename R>
struct Smem32 {
  using G = Geom<float, P, CW>;
  static constexpr int ME = TRB + 2 * P;   // extended rows a unit reads
  static constexpr int MC = rnd(ME, 4);    // ... that the column stage writes
  static constexpr int LDS = CW + 4;       // pitch of staged y
  static constexpr int BLOCKS = 2;
  static constexpr size_t WIN = 2 * R::IMG;                 // hi, lo
  static constexpr size_t LAND = line(G::land_bytes);
  static constexpr size_t TAIL = line(rnd(4 * MC, 8) + 8) + ALIGN;
  static constexpr size_t win = 0;
  static constexpr size_t aop = win + line(WIN);
  static constexpr size_t stage = aop + line(4 * R::IMG);
  static constexpr size_t land = stage + line(4 * TRB * LDS);
  static constexpr int NL =
      (land + 3 * LAND + TAIL + 1024) * BLOCKS <= 233472 ? 3 : 2;
  static constexpr size_t roff = land + NL * LAND;
  static constexpr size_t bar = roff + rnd(4 * MC, 8);
  static constexpr size_t total = roff + TAIL;
};

template <int P, typename R>
__global__ void __launch_bounds__(NT, 2)
k3mxu_f32_kernel(const float* __restrict__ u, const float* __restrict__ a1,
                 const float* __restrict__ b1,
                 const unsigned char* __restrict__ win_img,
                 const int* __restrict__ ru, float* __restrict__ y, int n0,
                 int n1, int n_cb, int units) {
  using L = Smem32<P, R>;
  constexpr int MC = L::MC;
  constexpr int LDS = L::LDS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  unsigned char* win = smem + L::win;
  unsigned char* aop = smem + L::aop;
  float* stage = reinterpret_cast<float*>(smem + L::stage);
  float* land = reinterpret_cast<float*>(smem + L::land);
  constexpr int LAND = L::LAND / 4;   // a slot, in floats
  constexpr int AHEAD = L::NL - 1;    // units the copies run ahead
  int* roff = reinterpret_cast<int*>(smem + L::roff);
  unsigned long long* wbar =
      reinterpret_cast<unsigned long long*>(smem + L::bar);
  const uint32_t s_win = gdm::smem_addr(win);
  const uint32_t s_aop = gdm::smem_addr(aop);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int ub, count;
  gdm::part(units, gridDim.x, blockIdx.x, ub, count);
  if (count == 0) return;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());
  GDM_STAMP(tid == 0, 11, count);
  long long tc = GDM_CLOCK();

  // the first units' u rows (a copy group each), then zeros for the
  // block's life (the operands' rows past the column stage's, in their
  // last k-step), then the first window by one bulk copy
  for (int a = 0; a < AHEAD; ++a) {
    if (a < count) {
      issue_u_rows<float, P, CW, MC>(land + a * LAND, u,
                                     ru[2 * ((ub + a) / n_cb)],
                                     ((ub + a) % n_cb) * CW, n0, n1, tid);
    }
    gdm::commit_group();
  }
  for (int i = 0; i < 4; ++i)
    zero_smem(aop + i * R::IMG + (R::D / R::KS - 1) * 64 * 32, 64 * 32, tid);
  if (tid == 0) {
    gdm::bar_init(wbar, 1);
    gdm::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    gdm::bar_arrive_expect_tx(wbar, L::WIN);
    gdm::bulk_copy(win, win_img + static_cast<size_t>(ub / n_cb) * L::WIN,
                   L::WIN, wbar);
  }
  unsigned wloads = 1;    // windows asked for
  bool wpending = true;   // the last one not yet waited for
  // the thread's output column and its groups of four extended rows
  const int x = tid % CW;
  int gb, ge;
  row_groups(MC, tid / CW, NT / CW, gb, ge);
  GDM_STAMP(tid == 0, 2, clock64());
  tc = GDM_CLOCK();

  for (int n = 0; n < count; ++n) {
    const int unit = ub + n;
    const int k = unit / n_cb;
    const int j0 = (unit % n_cb) * CW;
    const int i0 = ru[2 * k];
    const int rows = ru[2 * k + 1];
    const bool more = n + 1 < count;
    const int nk = (unit + 1) / n_cb;
    const float* ld = land + (n % L::NL) * LAND;
    if (n + AHEAD < count) {
      const int ahead = unit + AHEAD;
      issue_u_rows<float, P, CW, MC>(land + ((n + AHEAD) % L::NL) * LAND, u,
                                     ru[2 * (ahead / n_cb)],
                                     (ahead % n_cb) * CW, n0, n1, tid);
    }
    gdm::commit_group();
    GDM_TCS_PHASE(12, tc);
    float ca[2 * P + 1], cb[2 * P + 1];
    column_band_rows<float, P>(a1, b1, j0 + x, n1, ca, cb);
    row_offsets<float, P, MC>(roff, u, i0, j0, n0, n1, tid);
    gdm::wait_group<AHEAD>();
    GDM_TCS_PHASE(7, tc);
    __syncthreads();
    GDM_TCS_PHASE(3, tc);

    // the column stage into V^T and W^T, split
    const Cols<P, CW> cols(j0, n1);
    if (inner_unit<P, CW>(cols, i0, MC, n0)) {
      R::template columns<false>(ld, roff, x, gb, ge, 0u, ca, cb, aop);
    } else {
      R::template columns<true>(ld, roff, x, gb, ge, tap_mask<P, CW>(x, cols),
                                ca, cb, aop);
    }
    wg::fence_async_smem();
    __syncthreads();
    GDM_TCS_PHASE(4, tc);

    // the row stage over the unit's window depth
    if (wpending) {
      gdm::bar_wait(wbar, (wloads - 1) & 1);
      wpending = false;
    }
    float acc[16];
    wg::wgmma_fence();
    R::product(acc, s_aop, s_win);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(acc);
    GDM_TCS_PHASE(5, tc);
    stage_yt<LDS>(stage, acc, warp, lane);
    __syncthreads();
    GDM_TCS_PHASE(6, tc);
    if (more && nk != k) {   // every thread is past its product
      if (tid == 0) {
        gdm::bar_arrive_expect_tx(wbar, L::WIN);
        gdm::bulk_copy(win, win_img + static_cast<size_t>(nk) * L::WIN,
                       L::WIN, wbar);
      }
      ++wloads;
      wpending = true;
    }
    store_rows<float, CW>(y, stage, LDS, i0, j0, rows, n1, warp, NT / 32,
                          lane);
    GDM_TCS_PHASE(8, tc);
  }
  gdm::wait_group<0>();
  GDM_STAMP(tid == 0, 9, clock64());
  GDM_STAMP(tid == 0, 10, gdm_gtimer());
  (void)tc;
}

// ---- float64: DMMA from the unsplit window table ----

template <int P>
struct Smem64 {
  using G = Geom<double, P, CW>;
  static constexpr int ME = TRB + 2 * P;
  static constexpr int LDV = 2 * CW + 4;   // [V | W], a row an extended row
  static constexpr int LDW = G::M + 4;
  static constexpr int LDY = CW + 4;
  static constexpr size_t vw = 0;
  static constexpr size_t win = vw + line(8 * G::M * LDV);
  static constexpr size_t ys = win + line(8 * G::WR * LDW);
  static constexpr size_t land = ys + line(8 * TRB * LDY);
  static constexpr size_t roff = land + line(G::land_bytes);
  static constexpr size_t total = roff + line(4 * G::M) + ALIGN;
};

template <int P>
__global__ void __launch_bounds__(NT, 1)
k3mxu_f64_kernel(const double* __restrict__ u, const double* __restrict__ a1,
                 const double* __restrict__ b1,
                 const double* __restrict__ win_img,
                 const int* __restrict__ ru, double* __restrict__ y, int n0,
                 int n1, int n_cb, int units) {
  using L = Smem64<P>;
  using G = typename L::G;
  using gdm::tc::Acc16;
  constexpr int M = G::M;
  constexpr int ME = L::ME;
  constexpr int LDV = L::LDV;
  constexpr int LDW = L::LDW;
  constexpr int LDY = L::LDY;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  double* vw = reinterpret_cast<double*>(smem + L::vw);
  double* win = reinterpret_cast<double*>(smem + L::win);
  double* ys = reinterpret_cast<double*>(smem + L::ys);
  double* land = reinterpret_cast<double*>(smem + L::land);
  int* roff = reinterpret_cast<int*>(smem + L::roff);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int x = tid % CW;
  int ub, count;
  gdm::part(units, gridDim.x, blockIdx.x, ub, count);
  int k_have = -1;
  for (int n = 0; n < count; ++n) {
    const int unit = ub + n;
    const int k = unit / n_cb;
    const int j0 = (unit % n_cb) * CW;
    const int i0 = ru[2 * k];
    const int rows = ru[2 * k + 1];
    issue_u_rows<double, P, CW, ME>(land, u, i0, j0, n0, n1, tid);
    if (k != k_have) {
      copy_image(win, win_img + static_cast<size_t>(k) * G::WR * LDW,
                 8 * G::WR * LDW, tid);
      k_have = k;
    }
    gdm::commit_group();
    double ca[2 * P + 1], cb[2 * P + 1];
    column_band_rows<double, P>(a1, b1, j0 + x, n1, ca, cb);
    row_offsets<double, P, ME>(roff, u, i0, j0, n0, n1, tid);
    gdm::wait_group<0>();
    __syncthreads();
    // the column stage: [V | W] row s, zero past the extended rows
    const unsigned mask = tap_mask<P, CW>(x, Cols<P, CW>(j0, n1));
    for (int s = tid / CW; s < M; s += NT / CW) {
      double v[1], w[1];
      column_sums<double, P, CW, 1, true>(land, roff, s, ME, x, mask, ca, cb,
                                          v, w);
      vw[s * LDV + x] = v[0];
      vw[s * LDV + CW + x] = w[0];
    }
    __syncthreads();
    // rows: y = A0w V + B0w W, 16 x 16 blocks shared by the warps
    constexpr int CB = CW / 16;
    for (int task = warp; task < (rnd(rows, 16) / 16) * CB; task += NT / 32) {
      const int r0 = (task / CB) * 16;
      const int c0 = (task % CB) * 16;
      Acc16<double> acc;
      acc.zero();
      acc.add(win + r0 * LDW, LDW, vw + c0, LDV, M);
      acc.add(win + (TRB + r0) * LDW, LDW, vw + CW + c0, LDV, M);
      acc.store(ys + r0 * LDY + c0, LDY);
    }
    __syncthreads();
    store_rows<double, CW>(y, ys, LDY, i0, j0, rows, n1, warp, NT / 32, lane);
  }
}

// The kernels by form: F32<Tf32> (K3/mxu), F32<Bf16x3> (K3/mxu3), F64
// (both in float64).
template <template <int> class R>
struct F32 {};
struct F64 {};

template <typename K>
struct Kernels;

template <template <int> class R>
struct Kernels<F32<R>> {
  template <int P>
  static auto fn() { return k3mxu_f32_kernel<P, R<P>>; }
  template <int P>
  static constexpr size_t smem() { return Smem32<P, R<P>>::total; }
  template <int P>
  static void run(int grid, size_t smem, cudaStream_t stream, const void* u,
                  const void* a1, const void* b1, const void* win,
                  const int* ru, void* y, int n0, int n1, int n_cb,
                  int units) {
    fn<P>()<<<grid, NT, smem, stream>>>(
        static_cast<const float*>(u), static_cast<const float*>(a1),
        static_cast<const float*>(b1),
        static_cast<const unsigned char*>(win), ru, static_cast<float*>(y),
        n0, n1, n_cb, units);
  }
};

template <>
struct Kernels<F64> {
  template <int P>
  static auto fn() { return k3mxu_f64_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem64<P>::total; }
  template <int P>
  static void run(int grid, size_t smem, cudaStream_t stream, const void* u,
                  const void* a1, const void* b1, const void* win,
                  const int* ru, void* y, int n0, int n1, int n_cb,
                  int units) {
    fn<P>()<<<grid, NT, smem, stream>>>(
        static_cast<const double*>(u), static_cast<const double*>(a1),
        static_cast<const double*>(b1), static_cast<const double*>(win), ru,
        static_cast<double*>(y), n0, n1, n_cb, units);
  }
};

template <typename K, int P>
int launch_p(const void* u, const void* a1, const void* b1, const void* win,
             const int* ru, void* y, int n0, int n1, int trb, int cw,
             int n_ru, int grid, cudaStream_t stream) {
  const size_t smem = Kernels<K>::template smem<P>();
  const int n_cb = (n1 + CW - 1) / CW;
  const int units = n_ru * n_cb;
  if (cw != CW || !plan_ok(trb, units, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(Kernels<K>::template fn<P>(), smem);
  if (e != 0) return e;
  Kernels<K>::template run<P>(grid, smem, stream, u, a1, b1, win, ru, y, n0,
                              n1, n_cb, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch(const void* u, const void* a1, const void* b1, const void* win,
           const void* ru, void* y, int p, int n0, int n1, int trb, int cw,
           int n_ru, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ru);
  GDM_TCS_DISPATCH15(p, (launch_p<K, P>(u, a1, b1, win, r, y, n0, n1, trb,
                                        cw, n_ru, grid, s)))
}

template <typename K, int P>
int occupancy_p(int* out) {
  return gdm::tcs::occupancy(Kernels<K>::template fn<P>(),
                             Kernels<K>::template smem<P>(), out);
}

template <typename K>
int occupancy_of(int p, int cw, int* out) {
  if (cw != CW) return static_cast<int>(cudaErrorInvalidValue);
  GDM_TCS_DISPATCH15(p, occupancy_p<K, P>(out))
}

}  // namespace

extern "C" {

// u, the band rows A1 and B1, the window table and the row units of the
// plan (ops/tc_tables.py), y; the plan's rows a row unit (trb), columns a
// unit (cw, 64), row units and blocks; a plan off the kernel's layout is
// refused (cudaErrorInvalidValue).  K3/mxu reads the tf32 window table,
// K3/mxu3 the bf16 one (hi then lo images a row unit); both read the
// float64 table in float64.
int gdm_laplace2_mxu_apply_f32(const void* u, const void* a1, const void* b1,
                               const void* win, const void* ru, void* y,
                               int p, int n0, int n1, int trb, int cw,
                               int n_ru, int grid, void* stream) {
  return launch<F32<Tf32>>(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru,
                           grid, stream);
}

int gdm_laplace2_mxu_apply_f64(const void* u, const void* a1, const void* b1,
                               const void* win, const void* ru, void* y,
                               int p, int n0, int n1, int trb, int cw,
                               int n_ru, int grid, void* stream) {
  return launch<F64>(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru, grid,
                     stream);
}

int gdm_laplace2_mxu3_apply_f32(const void* u, const void* a1,
                                const void* b1, const void* win,
                                const void* ru, void* y, int p, int n0,
                                int n1, int trb, int cw, int n_ru, int grid,
                                void* stream) {
  return launch<F32<Bf16x3>>(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru,
                             grid, stream);
}

int gdm_laplace2_mxu3_apply_f64(const void* u, const void* a1,
                                const void* b1, const void* win,
                                const void* ru, void* y, int p, int n0,
                                int n1, int trb, int cw, int n_ru, int grid,
                                void* stream) {
  return launch<F64>(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru, grid,
                     stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) one SM holds;
// cw must be 64.
int gdm_laplace2_mxu_occupancy(int p, int f64, int cw, int* out) {
  return f64 ? occupancy_of<F64>(p, cw, out)
             : occupancy_of<F32<Tf32>>(p, cw, out);
}

int gdm_laplace2_mxu3_occupancy(int p, int f64, int cw, int* out) {
  return f64 ? occupancy_of<F64>(p, cw, out)
             : occupancy_of<F32<Bf16x3>>(p, cw, out);
}

}  // extern "C"
