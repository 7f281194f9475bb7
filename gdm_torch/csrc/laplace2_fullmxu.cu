// K3f: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with both
// stages on the tensor cores.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_fullmxu (the
// TPU schedule with the column stage as per-block banded products and the
// row stage as the dense product Bcat . [V; W]; no solve dispatch routes
// to it, in gdm or here).  Same operator, band tables and contiguous
// (n0, n1) node array as K3 (laplace2.cu).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 p = 3 in float32).
// Both stages are dense window products, so the design's own floor is
// its tensor work: a unit of 32 x 32 outputs at p = 3 takes 2 x 64 x 40 x
// 40 x 3 (column stage) + 2 x 2 x 64 x 32 x 40 x 3 (row stage, two 64-row
// products of which each keeps half) flops, 1.7 GFLOP at 1025^2, 3.5 us
// at 495 TFLOP/s of tf32.
//
// Design (float32; tc_stage.cuh holds the shared stage): a persistent
// block of one warpgroup walks its units (row unit k, column block cb).
//   column stage: [V | W]^T (64 x M) = C^T (64 x KD) . U^T (KD x M): M =
//     2 x 32 rows of wgmma, the unit's M u rows as N; C^T, the table's,
//     comes as wgmma A fragments in registers (one 16-byte load a thread
//     a k-step and part, in flight through the u split), the row-major u
//     tile is U^T's K-major operand, split once into hi and lo as it
//     leaves the landing slot;
//   the accumulators, split into hi and lo, are stored as the K-major B
//     operands V (32 x M) and W of the row stage;
//   row stage: y = A0w . V + B0w . W over the stacked 64-row window
//     [A0w; B0w] in shared memory, which takes both operands, in two
//     accumulators whose useful halves (A0w . V, B0w . W) meet in shared
//     memory (V's and W's place, once read);
// each product as 3xTF32 (three wgmma chains of m64nNk8).  The next
// unit's u rows are copied in while this one's products run, a new
// window once the row product is done.  A block takes 69 KB of shared
// memory at p = 3, so three blocks share an SM and hide each other's
// splits and epilogues.
//
// Float64: wgmma has no float64 shape, so the DMMA units (wmma m8n8k4,
// tc_window.cuh's Acc16<double>) take both products, unsplit, from the
// float64 tables: the column stage as [V | W] = U_tile . C, the row stage
// as A0w . V + B0w . W, the same persistent walk and u copies.
#include "tc_stage.cuh"
#include "tc_window.cuh"

namespace {

using namespace gdm::tcs;
namespace wg = gdm::wg;

// Shared-memory layout of a float32 block (byte offsets; C^T is held in
// registers).
template <int P>
struct Smem32 {
  using G = Geom<float, P>;
  static constexpr size_t win = 0;
  static constexpr size_t uop = win + line(2 * 4 * G::WR * G::M);
  static constexpr size_t vop = uop + line(2 * 4 * G::M * G::KD);
  static constexpr size_t wop = vop + line(2 * 4 * 32 * G::M);
  static constexpr size_t land = wop + line(2 * 4 * 32 * G::M);
  static constexpr size_t stage = vop;   // y staged once V, W are read
  static_assert(4 * 2 * 32 * 33 <= land - vop, "y fits V's and W's place");
  static constexpr size_t roff = land + 2 * line(G::land_bytes);
  static constexpr size_t total = roff + line(4 * G::M) + ALIGN;
};

template <int P>
__global__ void __launch_bounds__(NT, 3)
k3f_f32_kernel(const float* __restrict__ u, const float* __restrict__ win_img,
               const float* __restrict__ ct_img, const int* __restrict__ ru,
               float* __restrict__ y, int n0, int n1, int n_cb, int units) {
  using G = Geom<float, P>;
  using L = Smem32<P>;
  constexpr int M = G::M;
  constexpr int KD = G::KD;
  constexpr int WR = G::WR;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  float* win = reinterpret_cast<float*>(smem + L::win);
  float* uop = reinterpret_cast<float*>(smem + L::uop);
  float* vop = reinterpret_cast<float*>(smem + L::vop);
  float* wop = reinterpret_cast<float*>(smem + L::wop);
  float* land = reinterpret_cast<float*>(smem + L::land);
  constexpr int LAND = line(G::land_bytes) / 4;   // a slot, in floats
  float* stage = reinterpret_cast<float*>(smem + L::stage);
  int* roff = reinterpret_cast<int*>(smem + L::roff);
  const uint32_t s_win = gdm::smem_addr(win);
  const uint32_t s_uop = gdm::smem_addr(uop);
  const uint32_t s_vop = gdm::smem_addr(vop);
  const uint32_t s_wop = gdm::smem_addr(wop);
  constexpr uint32_t WIN_LO = 4 * WR * M;   // lo's image after hi's
  constexpr uint32_t UOP_LO = 4 * M * KD;
  constexpr uint32_t VW_LO = 4 * 32 * M;

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
    const int nj0 = ((unit + 1) % n_cb) * TX;
    const float* ld = land + (n & 1) * LAND;
    if (more) {
      issue_u_rows<float, P>(land + ((n + 1) & 1) * LAND, u, ru[2 * nk],
                             nj0, n0, n1, tid);
    }
    gdm::commit_group();
    // C^T's A fragments of this column block (hi, lo), in flight through
    // the u split
    uint32_t cfr[KD / 8][2][4];
    {
      const uint4* src = reinterpret_cast<const uint4*>(
                             ct_img + static_cast<size_t>(j0 / TX) *
                                          (KD / 8) * 2 * 4 * NT) +
                         tid;
#pragma unroll
      for (int kk = 0; kk < KD / 8; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 v = __ldg(src + (2 * kk + h) * NT);
          cfr[kk][h][0] = v.x;
          cfr[kk][h][1] = v.y;
          cfr[kk][h][2] = v.z;
          cfr[kk][h][3] = v.w;
        }
    }
    row_offsets<float, P>(roff, u, i0, j0, n0, n1, tid);
    gdm::wait_group<1>();   // (a landed window is fenced with the split)
    __syncthreads();
    GDM_TCS_PHASE(3, tc);

    // U^T's K-major operand: a warp fills 16 rows (u rows) of a k-step
    // chunk, 32 bytes a row, two lanes a row
    const Cols<P> cols(j0, n1);
    for (int e = tid; e < M * (KD / 4); e += NT) {
      const int ch = e / (2 * M);
      const int r = (e / 2) % M;
      const int c = 8 * ch + 4 * (e % 2);
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = landed<float, P>(ld, roff, r, c + q, cols);
      split4(uop, uop + UOP_LO / 4, wg::sw32_offset(r, c, M) / 4, x);
    }
    wg::fence_async_smem();
    __syncthreads();
    GDM_TCS_PHASE(4, tc);

    // column stage: acc1 = [V | W]^T, 64 x M
    float acc1[M / 2];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 8; ++kk) {
      const uint32_t b = s_uop + kk * M * 32;
      mma3rs<M>(acc1, cfr[kk][0], cfr[kk][1], b, b + UOP_LO, kk == 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(acc1);
    __syncthreads();
    GDM_TCS_PHASE(5, tc);

    // V and W, split, as the row stage's K-major B operands: row x of V
    // holds V[s][x] along s
    {
      float* dst = warp < 2 ? vop : wop;
      const int x0 = 16 * (warp % 2) + lane / 4;
#pragma unroll
      for (int j = 0; j < M / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + 8 * h;
          const int s = 8 * j + 2 * (lane % 4);
          const int at = wg::sw32_offset(x, s, 32) / 4;
          const float v0 = acc1[4 * j + 2 * h];
          const float v1 = acc1[4 * j + 2 * h + 1];
          const float h0 = tf32_rna(v0);
          const float h1 = tf32_rna(v1);
          *reinterpret_cast<float2*>(dst + at) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(dst + VW_LO / 4 + at) =
              make_float2(tf32_rna(v0 - h0), tf32_rna(v1 - h1));
        }
      }
    }
    wg::fence_async_smem();
    __syncthreads();
    GDM_TCS_PHASE(6, tc);

    // row stage over the unit's M extended rows
    float acc[16];
    float acc_w[16];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < M / 8; ++kk) {
      const uint32_t a = s_win + kk * WR * 32;
      const uint32_t v = s_vop + kk * 32 * 32;
      const uint32_t w = s_wop + kk * 32 * 32;
      mma3<32>(acc, a, a + WIN_LO, v, v + VW_LO, kk == 0);
      mma3<32>(acc_w, a, a + WIN_LO, w, w + VW_LO, kk == 0);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::hold(acc);
    wg::hold(acc_w);
    __syncthreads();
    GDM_TCS_PHASE(7, tc);
    if (more && nk != k) {
      copy_band_halves<P>(win, win_img + static_cast<size_t>(nk) * 2 * WR * M,
                          WR, M, TRB, tid);
    }
    gdm::commit_group();

    // y: A0w . V is rows r < 32 of acc, B0w . W rows 32 + r of acc_w
    // (accumulator row 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane %
    // 4) (+ 1)); they meet in V's and W's place and every warp stores
    // whole rows
    const int r0 = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          stage[(r0 + 8 * h) * 33 + 8 * j + 2 * (lane % 4) + q] =
              warp < 2 ? acc[4 * j + 2 * h + q] : acc_w[4 * j + 2 * h + q];
    __syncthreads();
    if (j0 + lane < n1) {
      for (int r = warp; r < rows; r += NT / 32)
        y[static_cast<size_t>(i0 + r) * n1 + j0 + lane] =
            stage[r * 33 + lane] + stage[(32 + r) * 33 + lane];
    }
    GDM_TCS_PHASE(8, tc);
  }
  gdm::wait_group<0>();
  GDM_STAMP(tid == 0, 9, clock64());
  GDM_STAMP(tid == 0, 10, gdm_gtimer());
  (void)tc;
}

// ---- float64: DMMA from the unsplit tables ----

template <int P>
struct Smem64 {
  using G = Geom<double, P>;
  using T = gdm::tc::Tile<P>;
  static constexpr int LDU = T::LDU;
  static constexpr int LDV = gdm::tc::LDV;
  static constexpr int LDW = G::M + 4;
  static constexpr size_t ut = 0;
  static constexpr size_t ct = ut + line(8 * G::M * LDU);
  static constexpr size_t vw = ct + line(8 * G::KD * LDV);
  static constexpr size_t win = vw + line(8 * G::M * LDV);
  static constexpr size_t land = win + line(8 * G::WR * LDW);
  static constexpr size_t roff = land + line(G::land_bytes);
  static constexpr size_t total = roff + line(4 * G::M) + ALIGN;
};

template <int P>
__global__ void __launch_bounds__(NT, 1)
k3f_f64_kernel(const double* __restrict__ u,
               const double* __restrict__ win_img,
               const double* __restrict__ ct_img, const int* __restrict__ ru,
               double* __restrict__ y, int n0, int n1, int n_cb, int units) {
  using G = Geom<double, P>;
  using L = Smem64<P>;
  using gdm::tc::Acc16;
  constexpr int M = G::M;
  constexpr int LDU = L::LDU;
  constexpr int LDV = L::LDV;
  constexpr int LDW = L::LDW;
  constexpr int LDY = gdm::tc::LDY;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  double* ut = reinterpret_cast<double*>(smem + L::ut);
  double* ctab = reinterpret_cast<double*>(smem + L::ct);
  double* vw = reinterpret_cast<double*>(smem + L::vw);
  double* win = reinterpret_cast<double*>(smem + L::win);
  double* land = reinterpret_cast<double*>(smem + L::land);
  int* roff = reinterpret_cast<int*>(smem + L::roff);
  double* ys = ut;  // the y tile, once the column product has read U

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int ub, count;
  gdm::part(units, gridDim.x, blockIdx.x, ub, count);
  int k_have = -1;
  for (int n = 0; n < count; ++n) {
    const int unit = ub + n;
    const int k = unit / n_cb;
    const int cb = unit % n_cb;
    const int j0 = cb * TX;
    const int i0 = ru[2 * k];
    const int rows = ru[2 * k + 1];
    issue_u_rows<double, P>(land, u, i0, j0, n0, n1, tid);
    copy_image(ctab, ct_img + static_cast<size_t>(cb) * G::KD * LDV,
               8 * G::KD * LDV, tid);
    if (k != k_have) {
      copy_image(win, win_img + static_cast<size_t>(k) * G::WR * LDW,
                 8 * G::WR * LDW, tid);
      k_have = k;
    }
    gdm::commit_group();
    row_offsets<double, P>(roff, u, i0, j0, n0, n1, tid);
    gdm::wait_group<0>();
    __syncthreads();
    const Cols<P> cols(j0, n1);
    for (int e = tid; e < M * G::KD; e += NT) {
      const int r = e / G::KD;
      const int c = e % G::KD;
      ut[r * LDU + c] = landed<double, P>(land, roff, r, c, cols);
    }
    __syncthreads();
    gdm::tc::col_mma<double, P>(ut, ctab, vw, nullptr, 0, M, warp, NT / 32,
                                lane);
    __syncthreads();
    const double* aw = win;
    const double* bw = win + TRB * LDW;
    for (int task = warp; task < (rnd(rows, 16) / 16) * 2; task += NT / 32) {
      const int r0 = (task / 2) * 16;
      const int c0 = (task % 2) * 16;
      Acc16<double> acc;
      acc.zero();
      acc.add(aw + r0 * LDW, LDW, vw + c0, LDV, M);
      acc.add(bw + r0 * LDW, LDW, vw + TX + c0, LDV, M);
      acc.store(ys + r0 * LDY + c0, LDY);
    }
    __syncthreads();
    const int j = j0 + lane;
    if (j < n1) {
      for (int r = warp; r < rows; r += NT / 32)
        y[static_cast<size_t>(i0 + r) * n1 + j] = ys[r * LDY + lane];
    }
    __syncthreads();
  }
}

template <typename T>
struct Kernels;

template <>
struct Kernels<float> {
  template <int P>
  static auto fn() { return k3f_f32_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem32<P>::total; }
};

template <>
struct Kernels<double> {
  template <int P>
  static auto fn() { return k3f_f64_kernel<P>; }
  template <int P>
  static constexpr size_t smem() { return Smem64<P>::total; }
};

template <typename T, int P>
int launch_p(const void* u, const void* win, const void* ct, const int* ru,
             void* y, int n0, int n1, int trb, int n_ru, int grid,
             cudaStream_t stream) {
  const size_t smem = Kernels<T>::template smem<P>();
  const int n_cb = (n1 + TX - 1) / TX;
  const int units = n_ru * n_cb;
  if (!plan_ok(trb, units, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = Kernels<T>::template fn<P>();
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(win),
      static_cast<const T*>(ct), ru, static_cast<T*>(y), n0, n1, n_cb, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* win, const void* ct, const void* ru,
           void* y, int p, int n0, int n1, int trb, int n_ru, int grid,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ru);
  GDM_TCS_DISPATCH15(p, launch_p<T, P>(u, win, ct, r, y, n0, n1, trb, n_ru,
                                        grid, s))
}

template <typename T>
int occupancy_of(int p, int* out) {
  GDM_TCS_DISPATCH15(p, gdm::tcs::occupancy(Kernels<T>::template fn<P>(),
                                            Kernels<T>::template smem<P>(),
                                            out))
}

}  // namespace

extern "C" {

int gdm_laplace2_fullmxu_apply_f32(const void* u, const void* win,
                                   const void* ct, const void* ru, void* y,
                                   int p, int n0, int n1, int trb, int n_ru,
                                   int grid, void* stream) {
  return launch<float>(u, win, ct, ru, y, p, n0, n1, trb, n_ru, grid,
                       stream);
}

int gdm_laplace2_fullmxu_apply_f64(const void* u, const void* win,
                                   const void* ct, const void* ru, void* y,
                                   int p, int n0, int n1, int trb, int n_ru,
                                   int grid, void* stream) {
  return launch<double>(u, win, ct, ru, y, p, n0, n1, trb, n_ru, grid,
                        stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) one SM holds.
int gdm_laplace2_fullmxu_occupancy(int p, int f64, int* out) {
  return f64 ? occupancy_of<double>(p, out) : occupancy_of<float>(p, out);
}

}  // extern "C"
