// K3/mxu: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with K3's
// column stage on the FMA units and the row stage as one window product
// on the tensor cores.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2's
// ``kernel_mxu`` (rows="mxu": the column rolls V = U A1^T, W = U B1^T over
// the extended tile, then the row stage Bcat . [V; W] as one dense-banded
// product at HIGHEST precision).  Same operator, band tables and
// contiguous (n0, n1) node array as K3 (laplace2.cu).
//
// Bound on the card: K3's (memory, 8 bytes of u and y per node in
// float32: 2.51 us at 1024^2 p = 3).  The design's own floor is its
// tensor work: a unit of 32 rows by 64 columns at p = 3 takes two 3xTF32
// chains of m64n32k8 over its 40-row window, 2 x 3 x 2 x 64 x 32 x 40
// flops, 0.55 GFLOP at 1025^2 (1.1 us at 495 TFLOP/s of tf32); its FMA
// work is K3's column stage over the 38 extended rows of a unit.
//
// Design (float32; tc_stage.cuh and tc_rows.cuh hold the shared stage): a
// persistent block of one warpgroup walks its units (row unit k of at most
// 32 rows, column block cb of CW columns), a serial chain a unit:
//   the landed u rows (16-byte cp.async, issued two units ahead into a
//     ring of three landing slots where two blocks an SM still fit, else
//     one unit ahead into two);
//   the column stage on the FMA units, a thread per output column x with
//     its A1 and B1 band rows in registers, four extended rows at a time:
//     V[s][x] and W[s][x] split once into tf32 hi and lo and stored as
//     16-byte halves of the product's K-major A operands V^T and W^T;
//   the row stage y^T = V^T A0w^T + W^T B0w^T (tc_rows.cuh): the cached
//     window table's two halves are the B operands as they are, two 3xTF32
//     chains of wgmma m64n32k8 into one accumulator over the unit's window
//     depth M = rnd(32 + 2p, 8) only (40 at p = 3);
//   the epilogue: y^T staged transposed in shared memory, whole rows of y
//     stored coalesced; a new window, one bulk copy completing on an
//     mbarrier, once the row product is done and only when the row unit
//     changes.
// No table entry is built or split in the kernel.  A unit is CW = 64
// columns wide, wgmma's M (ops/tc_tables.py, COLS).  A block takes 107 KB
// of shared memory at p = 3, so two share an SM.
//
// Float64: the DMMA units (wmma m8n8k4, tc_window.cuh's Acc16<double>)
// take the row product A0w V + B0w W, unsplit, from the float64 window
// table, in the same persistent walk with the same column stage.  K3/mxu3p
// (laplace2_mxu3p.cu) runs this float64 kernel too: both are DMMA
// products, unsplit.
#include "tc_rows.cuh"
#include "tc_window.cuh"

namespace {

using namespace gdm::tcs;
namespace wg = gdm::wg;

constexpr int CW = CWR;

// Shared-memory layout of a float32 block (byte offsets): the split
// window [A0w; B0w], the split A operands V^T and W^T, staged y, NL
// landing slots, the landing offsets and the window's mbarrier.  NL is
// three (u copies two units ahead) where the block still leaves room for
// its BLOCKS an SM, else two.
template <int P>
struct Smem32 {
  using G = Geom<float, P, CW>;
  static constexpr int ME = TRB + 2 * P;   // extended rows a unit reads
  static constexpr int MC = rnd(ME, 4);    // ... that the column stage writes
  static constexpr int LDS = CW + 4;       // pitch of staged y
  static constexpr int BLOCKS = 2;
  static constexpr size_t OPND = line(2 * 4 * 64 * G::M);   // hi, lo
  static constexpr size_t WIN = 2 * 4 * G::WR * G::M;       // hi, lo
  static constexpr size_t LAND = line(G::land_bytes);
  static constexpr size_t TAIL = line(rnd(4 * MC, 8) + 8) + ALIGN;
  static constexpr size_t win = 0;
  static constexpr size_t aop = win + line(WIN);
  static constexpr size_t stage = aop + 2 * OPND;
  static constexpr size_t land = stage + line(4 * TRB * LDS);
  static constexpr int NL =
      (land + 3 * LAND + TAIL + 1024) * BLOCKS <= 233472 ? 3 : 2;
  static constexpr size_t roff = land + NL * LAND;
  static constexpr size_t bar = roff + rnd(4 * MC, 8);
  static constexpr size_t total = roff + TAIL;
};

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

template <int P>
__global__ void __launch_bounds__(NT, 2)
k3mxu_f32_kernel(const float* __restrict__ u, const float* __restrict__ a1,
                 const float* __restrict__ b1,
                 const float* __restrict__ win_img, const int* __restrict__ ru,
                 float* __restrict__ y, int n0, int n1, int n_cb, int units) {
  using L = Smem32<P>;
  using G = typename L::G;
  constexpr int M = G::M;
  constexpr int ME = L::ME;
  constexpr int MC = L::MC;
  constexpr int WR = G::WR;
  constexpr int LDS = L::LDS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  float* win = reinterpret_cast<float*>(smem + L::win);
  float* aop = reinterpret_cast<float*>(smem + L::aop);
  float* stage = reinterpret_cast<float*>(smem + L::stage);
  float* land = reinterpret_cast<float*>(smem + L::land);
  constexpr int LAND = L::LAND / 4;   // a slot, in floats
  constexpr int AHEAD = L::NL - 1;    // units the copies run ahead
  int* roff = reinterpret_cast<int*>(smem + L::roff);
  unsigned long long* wbar =
      reinterpret_cast<unsigned long long*>(smem + L::bar);
  const uint32_t s_win = gdm::smem_addr(win);
  const uint32_t s_aop = gdm::smem_addr(aop);
  constexpr uint32_t WIN_LO = 4 * WR * M;   // lo's image after hi's (bytes)
  constexpr uint32_t A_LO = 4 * 64 * M;
  constexpr uint32_t B0W = 32 * 32;         // B0w's half of a window chunk
  constexpr uint32_t W_OP = L::OPND;        // W^T's operand after V^T's

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
    zero_smem(aop + (i / 2) * (L::OPND / 4) + (i % 2) * (A_LO / 4) +
                  (M / 8 - 1) * 64 * 8,
              64 * 32, tid);
  if (tid == 0) {
    gdm::bar_init(wbar, 1);
    gdm::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    gdm::bar_arrive_expect_tx(wbar, L::WIN);
    gdm::bulk_copy(win, win_img + static_cast<size_t>(ub / n_cb) * 2 * WR * M,
                   L::WIN, wbar);
  }
  unsigned wloads = 1;    // windows asked for
  bool wpending = true;   // the last one not yet waited for
  // the thread's output column, its groups of four extended rows, and
  // where V^T's and W^T's entries of the column go
  const int x = tid % CW;
  int gb, ge;
  row_groups(MC, tid / CW, NT / CW, gb, ge);
  float* vdst = aop;
  float* wdst = aop + L::OPND / 4;
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
      tf32_columns<P, false>(ld, roff, x, gb, ge, 0u, ca, cb, vdst, wdst,
                             A_LO / 4);
    } else {
      tf32_columns<P, true>(ld, roff, x, gb, ge, tap_mask<P, CW>(x, cols), ca,
                            cb, vdst, wdst, A_LO / 4);
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
#pragma unroll
    for (int kk = 0; kk < M / 8; ++kk) {
      const uint32_t a = s_aop + kk * 64 * 32;
      const uint32_t b = s_win + kk * WR * 32;
      mma3<32>(acc, a, a + A_LO, b, b + WIN_LO, kk == 0);
      mma3<32>(acc, a + W_OP, a + W_OP + A_LO, b + B0W, b + B0W + WIN_LO,
               false);
    }
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
        gdm::bulk_copy(win, win_img + static_cast<size_t>(nk) * 2 * WR * M,
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

template <typename T>
struct Kernels;

template <>
struct Kernels<float> {
  template <int P>
  static auto fn() { return k3mxu_f32_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem32<P>::total; }
};

template <>
struct Kernels<double> {
  template <int P>
  static auto fn() { return k3mxu_f64_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem64<P>::total; }
};

template <typename T, int P>
int launch_p(const void* u, const void* a1, const void* b1, const void* win,
             const int* ru, void* y, int n0, int n1, int trb, int cw,
             int n_ru, int grid, cudaStream_t stream) {
  const size_t smem = Kernels<T>::template smem<P>();
  const int n_cb = (n1 + CW - 1) / CW;
  const int units = n_ru * n_cb;
  if (cw != CW || !plan_ok(trb, units, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = Kernels<T>::template fn<P>();
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a1),
      static_cast<const T*>(b1), static_cast<const T*>(win), ru,
      static_cast<T*>(y), n0, n1, n_cb, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a1, const void* b1, const void* win,
           const void* ru, void* y, int p, int n0, int n1, int trb, int cw,
           int n_ru, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ru);
  GDM_TCS_DISPATCH15(p, (launch_p<T, P>(u, a1, b1, win, r, y, n0, n1, trb,
                                        cw, n_ru, grid, s)))
}

template <typename T, int P>
int occupancy_p(int* out) {
  return gdm::tcs::occupancy(Kernels<T>::template fn<P>(),
                             Kernels<T>::template smem<P>(), out);
}

template <typename T>
int occupancy_of(int p, int* out) {
  GDM_TCS_DISPATCH15(p, occupancy_p<T, P>(out))
}

}  // namespace

extern "C" {

// u, the band rows A1 and B1, the window table and the row units of the
// plan (ops/tc_tables.py), y; the plan's rows a row unit (trb), columns a
// unit (cw, 64), row units and blocks; a plan off the kernel's layout is
// refused (cudaErrorInvalidValue).
int gdm_laplace2_mxu_apply_f32(const void* u, const void* a1, const void* b1,
                               const void* win, const void* ru, void* y,
                               int p, int n0, int n1, int trb, int cw,
                               int n_ru, int grid, void* stream) {
  return launch<float>(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru, grid,
                       stream);
}

int gdm_laplace2_mxu_apply_f64(const void* u, const void* a1, const void* b1,
                               const void* win, const void* ru, void* y,
                               int p, int n0, int n1, int trb, int cw,
                               int n_ru, int grid, void* stream) {
  return launch<double>(u, a1, b1, win, ru, y, p, n0, n1, trb, cw, n_ru,
                        grid, stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) one SM holds;
// cw must be 64.
int gdm_laplace2_mxu_occupancy(int p, int f64, int cw, int* out) {
  if (cw != CW) return static_cast<int>(cudaErrorInvalidValue);
  return f64 ? occupancy_of<double>(p, out) : occupancy_of<float>(p, out);
}

}  // extern "C"
