// K0: gdm's v1 2D Laplace  y = A0 U A1^T + B0 U B1^T, rows first.
//
// Replaces gdm/ops/pallas_stencil.py::make_padded_laplace (the v1 fused
// TPU kernel: the row sweeps as one dense-banded product per tile at
// HIGHEST precision, [ts; tm] = B_i . uw, then the column sweeps as
// 2(2p+1) lane rolls; odd p <= 7, since its row halo is 8).  gdm builds
// it for the Laplace only, (A0, A1, B0, B1) = (S0, M1, M0, S1); the
// kernel takes K3's band tables and contiguous (n0, n1) node array
// (laplace2.cu), and runs K3's stages the other way round:
//   rows:    [ts; tm] = [A0w; B0w] . U_ext on the tensor cores (3xTF32 in
//            float32, gdm's HIGHEST; DMMA in float64);
//   columns: y[r][x] = sum_t A1(j0 + x, t) ts[r][x + t]
//                     + B1(j0 + x, t) tm[r][x + t] on the FMA units.
//
// Bound on the card: K3's (memory, 8 bytes of u and y per node in
// float32: 2.51 us at 1024^2 p = 3).  The design's own floor is its
// tensor work: a unit of 32 x 32 outputs at p = 3 takes 2 x 64 x 40 x 40
// x 3 flops, 0.67 GFLOP at 1025^2, 1.4 us at 495 TFLOP/s of tf32.
//
// Design (float32; tc_stage.cuh holds the shared stage): a persistent
// block of one warpgroup walks its units (row unit k, column block cb).
// The row product's A operand is the unit's stacked window [A0w; B0w]
// (the table's, copied band by band once a row unit), its B operand the
// u tile with K along the rows: the split pass that turns the landed u
// rows into hi and lo writes them transposed (row c, a u column, holds
// the u rows along K), so no operand needs a transpose.  wgmma m64nNk8
// (N = the 32 + 2p u columns padded to 8) takes the 64-row window (A0w's
// 32 rows over B0w's) into one accumulator; ts and tm go to shared memory
// as float32 (in U's place, once read), and the column FMAs (a lane per
// output column, its A1 and B1 band rows in registers) store y coalesced.
// The next unit's u rows are copied in while this one's products run, a
// new window once the row product is done.  A block takes 49 KB of shared
// memory at p = 3, so four blocks share an SM.
//
// Float64: the DMMA units (wmma m8n8k4, tc_window.cuh's Acc16<double>)
// take the row product, unsplit, from the float64 window table, with the
// same persistent walk, u copies and column FMAs.
#include "tc_stage.cuh"
#include "tc_window.cuh"

namespace {

using namespace gdm::tcs;
namespace wg = gdm::wg;

// Shared-memory layout of a float32 block (byte offsets); NP u columns
// padded to k-steps, LDP the pitch of ts and tm, which take the U
// operand's place once the row product has read it.
template <int P>
struct Smem32 {
  using G = Geom<float, P>;
  static constexpr int NP = G::KD;
  static constexpr int LDP = NP + 4;
  static constexpr size_t win = 0;
  static constexpr size_t uop = win + line(2 * 4 * G::WR * G::M);
  static constexpr size_t ts = uop;
  static_assert(4 * G::WR * LDP <= 2 * 4 * NP * G::M, "ts, tm fit U's place");
  static constexpr size_t land = uop + line(2 * 4 * NP * G::M);
  static constexpr size_t roff = land + 2 * line(G::land_bytes);
  static constexpr size_t total = roff + line(4 * G::M) + ALIGN;
};

// The column stage: y[i0 + r][j0 + x] = sum_t A1(j0 + x, t) ts[r][x + t]
// + B1(j0 + x, t) tm[r][x + t] (rows r = warp, warp + 4, ..) with the
// column's band rows ca, cb in registers.
template <typename T, int P>
__device__ __forceinline__ void columns(const T* ts, const T* tm, int ldp,
                                        const T (&ca)[2 * P + 1],
                                        const T (&cb)[2 * P + 1],
                                        T* __restrict__ y, int i0, int j0,
                                        int rows, int n1, int warp,
                                        int lane) {
  const int j = j0 + lane;
  if (j >= n1) return;
  // two rows at a time, the A1 and B1 sums of each apart: four
  // independent chains of FMAs
  for (int r = warp; r < rows; r += 2 * (NT / 32)) {
    const int r2 = r + NT / 32 < rows ? r + NT / 32 : r;
    T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
#pragma unroll
    for (int t = 0; t < 2 * P + 1; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = h ? r2 : r;
        acc[h][0] = gdm::fma_(ca[t], ts[rr * ldp + lane + t], acc[h][0]);
        acc[h][1] = gdm::fma_(cb[t], tm[rr * ldp + lane + t], acc[h][1]);
      }
    }
    y[static_cast<size_t>(i0 + r) * n1 + j] = acc[0][0] + acc[0][1];
    y[static_cast<size_t>(i0 + r2) * n1 + j] = acc[1][0] + acc[1][1];
  }
}

// The band rows A1(j0 + lane, .), B1(j0 + lane, .) (zero past the grid).
template <typename T, int P>
__device__ __forceinline__ void column_bands(const T* __restrict__ a1,
                                             const T* __restrict__ b1,
                                             int j0, int n1, int lane,
                                             T (&ca)[2 * P + 1],
                                             T (&cb)[2 * P + 1]) {
  constexpr int K = 2 * P + 1;
  const int j = j0 + lane;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    ca[t] = j < n1 ? a1[static_cast<size_t>(j) * K + t] : T(0);
    cb[t] = j < n1 ? b1[static_cast<size_t>(j) * K + t] : T(0);
  }
}

template <int P>
__global__ void __launch_bounds__(NT, 4)
k0_f32_kernel(const float* __restrict__ u, const float* __restrict__ a1,
              const float* __restrict__ b1,
              const float* __restrict__ win_img, const int* __restrict__ ru,
              float* __restrict__ y, int n0, int n1, int n_cb, int units) {
  using G = Geom<float, P>;
  using L = Smem32<P>;
  constexpr int M = G::M;
  constexpr int WR = G::WR;
  constexpr int NP = L::NP;
  constexpr int LDP = L::LDP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  float* win = reinterpret_cast<float*>(smem + L::win);
  float* uop = reinterpret_cast<float*>(smem + L::uop);
  float* ts = reinterpret_cast<float*>(smem + L::ts);
  float* tm = ts + TRB * LDP;
  float* land = reinterpret_cast<float*>(smem + L::land);
  constexpr int LAND = line(G::land_bytes) / 4;   // a slot, in floats
  int* roff = reinterpret_cast<int*>(smem + L::roff);
  const uint32_t s_win = gdm::smem_addr(win);
  const uint32_t s_uop = gdm::smem_addr(uop);
  constexpr uint32_t WIN_LO = 4 * WR * M;   // lo's image after hi's
  constexpr uint32_t UOP_LO = 4 * NP * M;

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

  // the window buffer keeps zeros off the band for the block's life
  zero_smem(win, L::uop - L::win, tid);
  __syncthreads();
  {
    const int k = ub / n_cb;
    issue_u_rows<float, P>(land, u, ru[2 * k], (ub % n_cb) * TX, n0, n1,
                           tid);
    copy_band_halves<P>(win, win_img + static_cast<size_t>(k) * 2 * WR * M,
                        WR, M, TRB, tid);
    gdm::commit_group();
  }
  GDM_STAMP(tid == 0, 2, clock64());
  tc = GDM_CLOCK();

  for (int n = 0; n < count; ++n) {
    const int unit = ub + n;
    const int k = unit / n_cb;
    const int j0 = (unit % n_cb) * TX;
    const int i0 = ru[2 * k];
    const int rows = ru[2 * k + 1];
    const bool more = n + 1 < count;
    const int nk = (unit + 1) / n_cb;
    const float* ld = land + (n & 1) * LAND;
    if (more) {
      issue_u_rows<float, P>(land + ((n + 1) & 1) * LAND, u, ru[2 * nk],
                             ((unit + 1) % n_cb) * TX, n0, n1, tid);
    }
    gdm::commit_group();
    float ca[2 * P + 1], cb[2 * P + 1];
    column_bands<float, P>(a1, b1, j0, n1, lane, ca, cb);
    row_offsets<float, P>(roff, u, i0, j0, n0, n1, tid);
    gdm::wait_group<1>();   // (a landed window is fenced with the split)
    __syncthreads();
    GDM_TCS_PHASE(3, tc);

    // U's K-major operand: row c (a u column) holds the u rows along K; a
    // warp fills 16 rows of a k-step chunk, 32 bytes a row, two lanes a row
    const Cols<P> cols(j0, n1);
    for (int e = tid; e < NP * (M / 4); e += NT) {
      const int ch = e / (2 * NP);
      const int c = (e / 2) % NP;
      const int r = 8 * ch + 4 * (e % 2);
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = landed<float, P>(ld, roff, r + q, c, cols);
      split4(uop, uop + UOP_LO / 4, wg::sw32_offset(c, r, NP) / 4, x);
    }
    wg::fence_async_smem();
    __syncthreads();
    GDM_TCS_PHASE(4, tc);

    // rows: acc = [A0w; B0w] . U, ts in rows < 32, tm in the rest
    float acc[NP / 2];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < M / 8; ++kk) {
      const uint32_t a = s_win + kk * WR * 32;
      const uint32_t bu = s_uop + kk * NP * 32;
      mma3<NP>(acc, a, a + WIN_LO, bu, bu + UOP_LO, kk == 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(acc);
    __syncthreads();
    GDM_TCS_PHASE(5, tc);
    if (more && nk != k) {
      copy_band_halves<P>(win, win_img + static_cast<size_t>(nk) * 2 * WR * M,
                          WR, M, TRB, tid);
    }
    gdm::commit_group();

    // ts (warps 0, 1) and tm (warps 2, 3) in U's place
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = 16 * warp + lane / 4 + 8 * h;
      float* dst = g < TRB ? ts + g * LDP : tm + (g - TRB) * LDP;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * (lane % 4)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    __syncthreads();
    GDM_TCS_PHASE(6, tc);
    columns<float, P>(ts, tm, LDP, ca, cb, y, i0, j0, rows, n1, warp, lane);
    GDM_TCS_PHASE(7, tc);
  }
  gdm::wait_group<0>();
  GDM_STAMP(tid == 0, 9, clock64());
  GDM_STAMP(tid == 0, 10, gdm_gtimer());
  (void)tc;
}

// ---- float64: DMMA from the unsplit window table ----

template <int P>
struct Smem64 {
  using G = Geom<double, P>;
  static constexpr int NP = rnd(G::UW, 16);   // the DMMA blocks' columns
  static constexpr int LDP = NP + 4;
  static constexpr int LDW = G::M + 4;
  static constexpr size_t ut = 0;
  static constexpr size_t win = ut + line(8 * G::M * LDP);
  static constexpr size_t ts = win + line(8 * G::WR * LDW);
  static constexpr size_t land = ts + line(8 * G::WR * LDP);
  static constexpr size_t roff = land + line(G::land_bytes);
  static constexpr size_t total = roff + line(4 * G::M) + ALIGN;
};

template <int P>
__global__ void __launch_bounds__(NT, 1)
k0_f64_kernel(const double* __restrict__ u, const double* __restrict__ a1,
              const double* __restrict__ b1,
              const double* __restrict__ win_img, const int* __restrict__ ru,
              double* __restrict__ y, int n0, int n1, int n_cb, int units) {
  using G = Geom<double, P>;
  using L = Smem64<P>;
  using gdm::tc::Acc16;
  constexpr int M = G::M;
  constexpr int NP = L::NP;
  constexpr int LDP = L::LDP;
  constexpr int LDW = L::LDW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  double* ut = reinterpret_cast<double*>(smem + L::ut);
  double* win = reinterpret_cast<double*>(smem + L::win);
  double* ts = reinterpret_cast<double*>(smem + L::ts);
  double* tm = ts + TRB * LDP;
  double* land = reinterpret_cast<double*>(smem + L::land);
  int* roff = reinterpret_cast<int*>(smem + L::roff);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int ub, count;
  gdm::part(units, gridDim.x, blockIdx.x, ub, count);
  int k_have = -1;
  for (int n = 0; n < count; ++n) {
    const int unit = ub + n;
    const int k = unit / n_cb;
    const int j0 = (unit % n_cb) * TX;
    const int i0 = ru[2 * k];
    const int rows = ru[2 * k + 1];
    issue_u_rows<double, P>(land, u, i0, j0, n0, n1, tid);
    if (k != k_have) {
      copy_image(win, win_img + static_cast<size_t>(k) * G::WR * LDW,
                 8 * G::WR * LDW, tid);
      k_have = k;
    }
    gdm::commit_group();
    double ca[2 * P + 1], cb[2 * P + 1];
    column_bands<double, P>(a1, b1, j0, n1, lane, ca, cb);
    row_offsets<double, P>(roff, u, i0, j0, n0, n1, tid);
    gdm::wait_group<0>();
    __syncthreads();
    const Cols<P> cols(j0, n1);
    for (int e = tid; e < M * NP; e += NT) {
      const int r = e / NP;
      const int c = e % NP;
      ut[r * LDP + c] = landed<double, P>(land, roff, r, c, cols);
    }
    __syncthreads();
    // rows: ts = A0w . U, tm = B0w . U, 16 x 16 blocks shared by the warps
    constexpr int CB = NP / 16;
    const int per = (rnd(rows, 16) / 16) * CB;
    for (int task = warp; task < 2 * per; task += NT / 32) {
      const int part = task / per;
      const int rem = task % per;
      const int r0 = (rem / CB) * 16;
      const int c0 = (rem % CB) * 16;
      Acc16<double> acc;
      acc.zero();
      acc.add(win + (part * TRB + r0) * LDW, LDW, ut + c0, LDP, M);
      acc.store((part ? tm : ts) + r0 * LDP + c0, LDP);
    }
    __syncthreads();
    columns<double, P>(ts, tm, LDP, ca, cb, y, i0, j0, rows, n1, warp, lane);
    __syncthreads();
  }
}

template <typename T>
struct Kernels;

template <>
struct Kernels<float> {
  template <int P>
  static auto fn() { return k0_f32_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem32<P>::total; }
};

template <>
struct Kernels<double> {
  template <int P>
  static auto fn() { return k0_f64_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem64<P>::total; }
};

template <typename T, int P>
int launch_p(const void* u, const void* a1, const void* b1, const void* win,
             const int* ru, void* y, int n0, int n1, int trb, int n_ru,
             int grid, cudaStream_t stream) {
  const size_t smem = Kernels<T>::template smem<P>();
  const int n_cb = (n1 + TX - 1) / TX;
  const int units = n_ru * n_cb;
  if (!plan_ok(trb, units, grid, smem))
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

// odd p <= 7, as gdm's K0 (its row halo H = 8 >= p)
template <typename T>
int launch(const void* u, const void* a1, const void* b1, const void* win,
           const void* ru, void* y, int p, int n0, int n1, int trb,
           int n_ru, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ru);
  GDM_TCS_DISPATCH7(p, launch_p<T, P>(u, a1, b1, win, r, y, n0, n1, trb,
                                       n_ru, grid, s))
}

template <typename T>
int occupancy_of(int p, int* out) {
  GDM_TCS_DISPATCH7(p, gdm::tcs::occupancy(Kernels<T>::template fn<P>(),
                                           Kernels<T>::template smem<P>(),
                                           out))
}

}  // namespace

extern "C" {

int gdm_laplace2_v1_apply_f32(const void* u, const void* a1, const void* b1,
                              const void* win, const void* ru, void* y, int p,
                              int n0, int n1, int trb, int n_ru, int grid,
                              void* stream) {
  return launch<float>(u, a1, b1, win, ru, y, p, n0, n1, trb, n_ru, grid,
                       stream);
}

int gdm_laplace2_v1_apply_f64(const void* u, const void* a1, const void* b1,
                              const void* win, const void* ru, void* y, int p,
                              int n0, int n1, int trb, int n_ru, int grid,
                              void* stream) {
  return launch<double>(u, a1, b1, win, ru, y, p, n0, n1, trb, n_ru, grid,
                        stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) one SM holds.
int gdm_laplace2_v1_occupancy(int p, int f64, int* out) {
  return f64 ? occupancy_of<double>(p, out) : occupancy_of<float>(p, out);
}

}  // extern "C"
