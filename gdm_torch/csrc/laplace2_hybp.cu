// K3p: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with the
// column stage split by rows between the FMA units and the tensor cores,
// pipelined across the tiles of a column strip.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_hybp (its
// pallas_call at :2483: rows [0, vpu_rows) of each extended tile take the
// column stage as lane rolls on the VPU, rows [vpu_rows, T_ext) as banded
// window products U . C on the MXU; tile i's products are issued before
// tile i's VPU rows and tile i-1's row stage, so the matrix unit drains
// under them; no solve dispatch routes to it, in gdm or here).  Same
// operator, band tables and contiguous (n0, n1) node array as K3
// (laplace2.cu).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 and 40 us at 4096^2,
// p = 3, float32).  The design's own floor is its FMA work, K3's column
// stage on vpu_rows of each tile's tile_r + 2p extended rows and K3's row
// stage, with the rest of the column stage as 3xTF32 products: at 1025^2
// p = 3 with the default split (48 of 70 rows on the FMA units) one chunk
// of 32 rows a tile (22 of them real), 3 x 2 x 64 x 32 x 40 flops, 0.28
// GFLOP of tensor work (0.56 us at 495 TFLOP/s of tf32).
//
// Design (float32; tc_stage.cuh, tc_rows.cuh and tc_strip.cuh hold the
// shared stage: the row stage, the FMA rows and the plan's checks are
// tc_strip.cuh's, shared with K3c and K3h).
// A unit is one tile of tile_r output rows (the last one ragged) of a
// 32-column strip, its extended rows ME = rows + 2p; the plan
// (ops/tc_tables.py) numbers the units strip-major and gives each
// persistent block an even run of one strip's tiles, so the strip's band
// columns and C^T stay in registers for every unit the block takes.  Two
// warpgroups, joined by mbarriers only (no block-wide barrier after the
// set-up):
//   warpgroup 1 (the tensor warpgroup) issues unit n + 1's 16-byte
//     cp.async copies (its u rows into a ring of three landing slots, its
//     A0 and B0 band rows from the cached padded band table into the
//     slot's band rows), whose landing completes the slot's "landed"
//     barrier (cp.async.mbarrier.arrive); then, for unit n, splits the
//     landed rows [vpu_rows, ME) once into tf32 hi and lo as the 32-byte
//     swizzled K-major B operand (32 rows a chunk) and runs [V | W]^T =
//     C^T U^T as 3xTF32 wgmma m64n32k8 chains, C^T as A fragments in
//     registers from K3f's cached table, and writes V and W into the
//     unit's [V | W] slot (two slots), then arrives on the slot's "full";
//   warpgroup 0 (the FMA warpgroup) runs unit n's column stage on rows
//     [0, vpu_rows) (a thread per output column, A1 and B1 of its column
//     in registers, four rows at a time; tc_rows.cuh) into the same slot,
//     then the row stage of unit n - 1 once its "full" completes: a thread
//     per output column walks blocks of RB output rows with V and W of
//     RB + 2p rows in registers and each row's A0 and B0 coefficients by
//     16-byte loads (K3's row stage), stores y coalesced, and arrives on
//     that slot's "empty".
// The tensor warpgroup waits on "empty" (unit n - 2's row stage done)
// before it refills the slots unit n - 2 used.  So unit n's tensor rows
// run under unit n's FMA rows and unit n - 1's row stage, as in gdm.
// vpu_rows = 0 puts every row on the tensor cores, >= ME every row on the
// FMA units.  A block takes 108 KB of shared memory at p = 3 with tiles
// of 64 rows, so two share an SM.  (Measured on an H100, both warpgroups
// are latency-bound: four FMA warps a block hold the row stage and the
// FMA rows, and the tensor warpgroup's u split and copy issue take as
// long as its share of the rows would on the FMA units;
// scripts/torch_k3mxu3_k3p_breakdown.py prints the phases.)
//
// Float64: the same pipeline, the tensor rows on the DMMA units (wmma
// m8n8k4, tc_window.cuh's col_mma) from K3f's float64 C table, unsplit,
// through a u tile of those rows; the row stage reads its band rows from
// the cached table in device memory (no band slots, so a block fits the
// tiles gdm's cases take).
#include "tc_strip.cuh"

namespace {

using namespace gdm::tcs;
namespace wg = gdm::wg;

using gdm::tc::rnd128;

// The geometry of degree P and type T with tiles of tile_r rows; the
// shared-memory layout (byte offsets from a 1024-byte aligned base): the
// float32 chunk operand U^T (hi, lo; the float64 u tile and the DMMA
// warps' scratch tiles), two [V | W] slots, three landing slots of u rows,
// three slots of band rows (float32; float64 reads them from the table),
// the two warpgroups' landing offsets, the mbarriers.  ops/tc_tables.py's
// hybp_layout mirrors it.
template <typename T, int P>
struct HGeom {
  static constexpr int K = 2 * P + 1;
  static constexpr int UW = SW + 2 * P;      // u columns a unit reads
  static constexpr int KD = rnd(UW, 8);      // ... padded to k-steps
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int LW = Geom<T, P, SW>::LW;   // landing row pitch
  static constexpr int KP = rnd(K, VEC);     // a band row's pitch
  static constexpr int LDV = gdm::tc::LDV;   // [V | W]'s pitch, 2 SW + 4
  static constexpr int LDU = KD + 4;         // the float64 u tile's pitch
  static constexpr int RB = P <= 5 ? 8 : 4;  // output rows a row block
  static constexpr int NCH = 32;             // tensor rows a chunk
  int tile_r, cap;
  size_t uop, vw, land, bands, roff, bars, total;
  __host__ __device__ explicit HGeom(int tr) : tile_r(tr) {
    cap = rnd(rnd(tr, RB) + 2 * P, 16);   // rows of a slot
    const size_t op = sizeof(T) == 4
                          ? 2 * 4 * NCH * KD
                          : 8 * cap * LDU + 4 * gdm::tc::SCR * 8;
    uop = 0;
    vw = rnd128(op);
    land = vw + 2 * vw_slot();
    bands = land + 3 * land_slot();
    roff = bands + (sizeof(T) == 4 ? 3 * band_slot() : 0);
    bars = roff + rnd128(4 * 2 * 2 * cap);
    total = bars + 128 + ALIGN;
  }
  __host__ __device__ size_t vw_slot() const {
    return rnd128(sizeof(T) * cap * LDV);
  }
  __host__ __device__ size_t land_slot() const {
    return rnd128(sizeof(T) * cap * LW);
  }
  __host__ __device__ size_t band_slot() const {
    return rnd128(sizeof(T) * rnd(tile_r, RB) * 2 * KP);
  }
};

// Clock stamps of the FMA warpgroup (thread 0) and the tensor warpgroup
// (thread NT): slot += the clocks since t, t restarts (empty in the
// kernels' own build).
#define GDM_K3P_PHASE(who, slot, t)                                   \
  do {                                                                \
    GDM_STAMP_ADD(threadIdx.x == (who), slot, GDM_CLOCK() - (t));     \
    (t) = GDM_CLOCK();                                                \
  } while (0)

template <typename T, int P>
__global__ void __launch_bounds__(2 * NT, P <= 7 ? 2 : 1)
k3p_kernel(const T* __restrict__ u, const T* __restrict__ a1,
           const T* __restrict__ b1, const T* __restrict__ ct_img,
           const T* __restrict__ rb_img, T* __restrict__ y, int n0, int n1,
           int tile_r, int vpu_rows, int n_tiles, int segs) {
  using G = HGeom<T, P>;
  constexpr int LDV = G::LDV;
  constexpr int KP = G::KP;
  const G g(tile_r);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + g.bars);
  unsigned long long* lbar = bars;        // [3]: "landed"
  unsigned long long* full = bars + 3;    // [2]
  unsigned long long* empty = bars + 5;   // [2]
  T* vws = reinterpret_cast<T*>(smem + g.vw);
  T* lands = reinterpret_cast<T*>(smem + g.land);
  T* bandss = reinterpret_cast<T*>(smem + g.bands);
  int* roffs = reinterpret_cast<int*>(smem + g.roff);
  const size_t vw_n = g.vw_slot() / sizeof(T);
  const size_t land_n = g.land_slot() / sizeof(T);
  const size_t band_n = g.band_slot() / sizeof(T);

  const int tid = threadIdx.x;
  const int cb = blockIdx.x / segs;   // the block's strip
  const int j0 = cb * SW;
  int t0, count;
  gdm::part(n_tiles, segs, blockIdx.x % segs, t0, count);
  if (count == 0) return;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());
  GDM_STAMP(tid == 0, 11, count);
  long long tc = GDM_CLOCK();
  if (tid == 0) {
    for (int b = 0; b < 7; ++b) gdm::bar_init(bars + b, NT);
    gdm::bar_init_fence();
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 2, clock64());
  tc = GDM_CLOCK();

  if (tid >= NT) {
    // ---- the tensor warpgroup: copies and the tensor column rows ----
    const int t = tid - NT;
    const int warp = t / 32;
    const int lane = t % 32;
    int* roff = roffs + 2 * g.cap;
    // unit m's copies into slot m % 3: u rows, then the band rows (2 KP a
    // row, contiguous in the padded table), completing "landed"
    auto issue = [&](int m) {
      const int s = m % 3;
      const int i0 = (t0 + m) * tile_r;
      const int rows = min(tile_r, n0 - i0);
      issue_u_rows<T, P, SW>(lands + s * land_n, u, i0, j0, n0, n1, t,
                             rows + 2 * P);
      if constexpr (sizeof(T) == 4) {
        const T* src = rb_img + static_cast<size_t>(i0) * 2 * KP;
        T* dst = bandss + s * band_n;
        for (int e = t; e < rows * 2 * KP / G::VEC; e += NT)
          copy16(dst + e * G::VEC, src + e * G::VEC);
      }
      copies_arrive(lbar + s);
    };
    issue(0);
    // C^T's A fragments of the strip (hi, lo), for every unit (float32)
    constexpr int KS = sizeof(T) == 4 ? G::KD / 8 : 1;
    uint32_t cfr[KS][2][4];
    if constexpr (sizeof(T) == 4) {
      const uint4* src = reinterpret_cast<const uint4*>(
                             ct_img + static_cast<size_t>(cb) * KS * 2 * 4 *
                                          NT) +
                         t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 v = __ldg(src + (2 * kk + h) * NT);
          cfr[kk][h][0] = v.x;
          cfr[kk][h][1] = v.y;
          cfr[kk][h][2] = v.z;
          cfr[kk][h][3] = v.w;
        }
    }
    const Cols<P, SW> cols(j0, n1);
    for (int n = 0; n < count; ++n) {
      const int i0 = (t0 + n) * tile_r;
      const int me = min(tile_r, n0 - i0) + 2 * P;
      const int vf = min(vpu_rows, me);
      if (n >= 2) gdm::bar_wait(empty + (n & 1), ((n >> 1) + 1) & 1);
      GDM_K3P_PHASE(NT, 12, tc);
      if (n + 1 < count) issue(n + 1);
      GDM_K3P_PHASE(NT, 13, tc);
      int* ro = roff + (n & 1) * g.cap;
      row_offsets<T, P>(ro, u, i0, j0, n0, n1, t, me);
      gdm::bar_wait(lbar + n % 3, (n / 3) & 1);
      group_sync(1);
      GDM_K3P_PHASE(NT, 7, tc);
      const T* ld = lands + (n % 3) * land_n;
      T* vw = vws + (n & 1) * vw_n;
      if constexpr (sizeof(T) == 4) {
        float* uop = reinterpret_cast<float*>(smem + g.uop);
        const uint32_t s_uop = gdm::smem_addr(uop);
        constexpr uint32_t UOP_LO = 4 * G::NCH * G::KD;
        for (int sb = vf; sb < me; sb += G::NCH) {
          if (sb > vf) group_sync(1);   // the last chunk's products are done
          // U^T's K-major operand: tensor rows sb .. sb + 32, 32 bytes a
          // row a k-step chunk, two lanes a row
          for (int e = t; e < G::NCH * (G::KD / 4); e += NT) {
            const int ch = e / (2 * G::NCH);
            const int r = (e / 2) % G::NCH;
            const int c = 8 * ch + 4 * (e % 2);
            float x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              x[q] = sb + r < me ? landed<float, P, SW>(ld, ro, sb + r,
                                                        c + q, cols)
                                 : 0.f;
            split4(uop, uop + UOP_LO / 4,
                   wg::sw32_offset(r, c, G::NCH) / 4, x);
          }
          wg::fence_async_smem();
          group_sync(1);
          GDM_K3P_PHASE(NT, 8, tc);
          float acc[16];
          wg::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const uint32_t b = s_uop + kk * G::NCH * 32;
            mma3rs<32>(acc, cfr[kk][0], cfr[kk][1], b, b + UOP_LO, kk == 0);
          }
          wg::wgmma_commit();
          wg::wgmma_wait<0>();
          wg::hold(acc);
          GDM_K3P_PHASE(NT, 14, tc);
          // acc = [V | W]^T: row X = 16 warp + lane / 4 (+ 8) is [V | W]'s
          // column, column n = 8 j + 2 (lane % 4) (+ 1) extended row sb + n
          const int xr = 16 * warp + lane / 4;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int s = sb + 8 * j + 2 * (lane % 4) + q;
                if (s < me) vw[s * LDV + xr + 8 * h] = acc[4 * j + 2 * h + q];
              }
          GDM_K3P_PHASE(NT, 15, tc);
        }
      } else {
        // float64: the tensor rows' 16-row blocks as a u tile, then DMMA
        // against C from K3f's float64 table, the block that holds vf
        // through the warp's scratch tile (col_mma)
        if (vf < me) {
          double* ut = reinterpret_cast<double*>(smem + g.uop);
          double* scr = ut + static_cast<size_t>(g.cap) * G::LDU;
          const int r16 = vf / 16 * 16;
          const int m = rnd(me, 16);
          for (int e = t; e < (m - r16) * G::KD; e += NT) {
            const int r = r16 + e / G::KD;
            const int c = e % G::KD;
            ut[(r - r16) * G::LDU + c] =
                r < me ? landed<double, P, SW>(ld, ro, r, c, cols) : 0.0;
          }
          group_sync(1);
          GDM_K3P_PHASE(NT, 8, tc);
          gdm::tc::col_mma<double, P>(
              ut - static_cast<size_t>(r16) * G::LDU,
              ct_img + static_cast<size_t>(cb) * G::KD * LDV, vw,
              scr + warp * gdm::tc::SCR, vf, m, warp, NT / 32, lane);
          GDM_K3P_PHASE(NT, 14, tc);
        }
      }
      gdm::bar_arrive(full + (n & 1));
    }
  } else {
    // ---- the FMA warpgroup: the FMA column rows and the row stage ----
    const int warp = tid / 32;
    const int x = tid % 32;
    int* roff = roffs;
    T ca[2 * P + 1], cbv[2 * P + 1];
    column_band_rows<T, P>(a1, b1, j0 + x, n1, ca, cbv);
    const Cols<P, SW> cols(j0, n1);
    const unsigned mask = tap_mask<P, SW>(x, cols);
    const bool inner_cols = cols.lo == 0 && cols.hi == SW + 2 * P;
    for (int n = 0; n <= count; ++n) {
      if (n < count) {
        const int i0 = (t0 + n) * tile_r;
        const int me = min(tile_r, n0 - i0) + 2 * P;
        const int vf = min(vpu_rows, me);
        int* ro = roff + (n & 1) * g.cap;
        row_offsets<T, P>(ro, u, i0, j0, n0, n1, tid, rnd(vf, 4));
        gdm::bar_wait(lbar + n % 3, (n / 3) & 1);
        group_sync(2);   // and every thread is past unit n - 1's row stage
        GDM_K3P_PHASE(0, 3, tc);
        const T* ld = lands + (n % 3) * land_n;
        T* vw = vws + (n & 1) * vw_n;
        if (inner_cols && i0 >= P && i0 - P + me <= n0)
          fma_rows<T, P, LDV, 4, false>(ld, ro, vw, vf, me, x, mask, ca, cbv,
                                       warp);
        else
          fma_rows<T, P, LDV, 4, true>(ld, ro, vw, vf, me, x, mask, ca, cbv,
                                      warp);
        GDM_K3P_PHASE(0, 4, tc);
      } else {
        group_sync(2);   // the last unit's FMA rows are written
      }
      if (n >= 1) {
        const int m = n - 1;
        const int i0 = (t0 + m) * tile_r;
        gdm::bar_wait(full + (m & 1), (m >> 1) & 1);
        GDM_K3P_PHASE(0, 5, tc);
        // float64 reads the band rows from the table itself
        const T* bands = sizeof(T) == 4
                             ? bandss + (m % 3) * band_n
                             : rb_img + static_cast<size_t>(i0) * 2 * KP;
        row_stage<T, P, LDV, 4>(vws + (m & 1) * vw_n, bands, y, i0,
                                min(tile_r, n0 - i0), j0, n1, warp, x);
        gdm::bar_arrive(empty + (m & 1));
        GDM_K3P_PHASE(0, 6, tc);
      }
    }
    GDM_STAMP(tid == 0, 9, clock64());
    GDM_STAMP(tid == 0, 10, gdm_gtimer());
  }
  (void)tc;
}

template <typename T, int P>
int launch_p(const void* u, const void* a1, const void* b1, const void* ct,
             const void* rb, void* y, int n0, int n1, int tile_r,
             int vpu_rows, int n_tiles, int segs, int grid,
             cudaStream_t stream) {
  const size_t smem = HGeom<T, P>(tile_r).total;
  if (vpu_rows < 0 ||
      !strip_plan_ok(n0, n1, tile_r, n_tiles, segs, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(k3p_kernel<T, P>, smem);
  if (e != 0) return e;
  k3p_kernel<T, P><<<grid, 2 * NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a1),
      static_cast<const T*>(b1), static_cast<const T*>(ct),
      static_cast<const T*>(rb), static_cast<T*>(y), n0, n1, tile_r,
      vpu_rows, n_tiles, segs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a1, const void* b1, const void* ct,
           const void* rb, void* y, int p, int n0, int n1, int tile_r,
           int vpu_rows, int n_tiles, int segs, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GDM_TCS_DISPATCH15(p, (launch_p<T, P>(u, a1, b1, ct, rb, y, n0, n1, tile_r,
                                        vpu_rows, n_tiles, segs, grid, s)))
}

template <typename T, int P>
int occupancy_p(int tile_r, int* out) {
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = HGeom<T, P>(tile_r).total;
  const int e = allow_smem(k3p_kernel<T, P>, smem);
  if (e != 0) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k3p_kernel<T, P>, 2 * NT, smem));
}

template <typename T>
int occupancy_of(int p, int tile_r, int* out) {
  GDM_TCS_DISPATCH15(p, occupancy_p<T, P>(tile_r, out))
}

}  // namespace

extern "C" {

// u, the band rows A1 and B1, K3f's C table of the 32-column strips
// (float32: C^T's split fragment images; float64: C row-major), the
// padded band-row table (A0's and B0's rows at a pitch of 2 KP) of the
// plan (ops/tc_tables.py), y; the tile's rows, vpu_rows, the tiles, runs
// of tiles a strip and blocks; a plan off the kernel's layout is refused
// (cudaErrorInvalidValue).
int gdm_laplace2_hybp_apply_f32(const void* u, const void* a1, const void* b1,
                                const void* ct, const void* rb, void* y,
                                int p, int n0, int n1, int tile_r,
                                int vpu_rows, int n_tiles, int segs, int grid,
                                void* stream) {
  return launch<float>(u, a1, b1, ct, rb, y, p, n0, n1, tile_r, vpu_rows,
                       n_tiles, segs, grid, stream);
}

int gdm_laplace2_hybp_apply_f64(const void* u, const void* a1, const void* b1,
                                const void* ct, const void* rb, void* y,
                                int p, int n0, int n1, int tile_r,
                                int vpu_rows, int n_tiles, int segs, int grid,
                                void* stream) {
  return launch<double>(u, a1, b1, ct, rb, y, p, n0, n1, tile_r, vpu_rows,
                        n_tiles, segs, grid, stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) with tiles of
// tile_r rows one SM holds.
int gdm_laplace2_hybp_occupancy(int p, int f64, int tile_r, int* out) {
  return f64 ? occupancy_of<double>(p, tile_r, out)
             : occupancy_of<float>(p, tile_r, out);
}

}  // extern "C"
