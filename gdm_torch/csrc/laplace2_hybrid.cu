// K3h: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with the
// column stage split by rows between the FMA units and the tensor cores.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_hybrid (its
// pallas_call at :1550: rows [0, vpu_rows) of each extended tile take the
// column stage as lane rolls on the VPU, the rest as banded window
// products on the MXU, then the row stage on the VPU, one tile after the
// other; gdm records that its TPU compiler serialised the two units,
// pallas_stencil2.py:1354-1360; no solve dispatch routes to it, in gdm or
// here).  Same operator, band tables and contiguous (n0, n1) node array
// as K3 (laplace2.cu).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 and 40 us at 4096^2,
// p = 3, float32).  The design's own floor is its FMA work, K3's column
// stage on vpu_rows of each tile's tile_r + 2p extended rows and K3's row
// stage, with the rest of the column stage as 3xTF32 products: at 1025^2
// p = 3 with the default split (48 of 70 rows on the FMA units) one chain
// of 64 rows a tile (22 of them real), 3 x 2 x 64 x 64 x 40 flops, 0.55
// GFLOP of tf32 issued (1.1 us at 495 TFLOP/s), about a third of it on
// real rows.
//
// Design (float32; tc_strip.cuh holds the shared stage).  Units are K3p's
// (laplace2_hybp.cu): one tile of a 32-column strip, each persistent
// block an even run of one strip's tiles (the longer runs last,
// strip_run); unlike K3p, the block's two warpgroups work on one unit at
// a time, as gdm's K3h does:
//   once unit n's copies have landed, each warpgroup issues its share of
//     unit n + 1's 16-byte cp.async copies into the other of two slots,
//     whose landing completes that slot's "landed" barrier: the FMA
//     warpgroup the u rows [vr, ME) and the padded band rows, the tensor
//     warpgroup the u rows [0, vr), so the copies' issue goes mostly to
//     the warpgroup with the fewer column rows;
//   warpgroup 1 (the tensor warpgroup) brings in the strip's C^T B image
//     once by one bulk copy, then runs rows [vr, ME) of unit n's column
//     stage as 3xTF32 wgmma m64n64k8 chains with u as the A operand in
//     registers, split from the landed rows (col_product: A rows outside
//     [vr, ME) are zero and never stored, so no row the FMA warpgroup owns
//     is written);
//   warpgroup 0 (the FMA warpgroup) runs rows [0, vr) by K3's FMA column
//     stage (a thread per output column, A1 and B1 of its column in
//     registers, four rows at a time; fma_rows);
//   a named barrier of both (bar.sync, 256 threads) joins them, all 8
//     warps run the row stage (row_stage) and store y coalesced, and a
//     second named barrier ends the unit before its [V | W] slot and
//     landing offsets are reused.
// vpu_rows = 0 puts every row on the tensor cores, >= ME every row on the
// FMA units.  A block takes 80 KB of shared memory at p = 3 with tiles of
// 64 rows.
//
// Float64: the same structure, the tensor rows on the DMMA units (wmma
// m8n8k4, tc_window.cuh's col_mma) from K3f's float64 C table, unsplit,
// through a u piece of 32 rows, the 16-row block that holds vr through a
// warp's scratch tile; the row stage reads its band rows from the cached
// table in device memory.
#include "tc_strip.cuh"

namespace {

using namespace gdm::tcs;

// Clock stamps of the FMA warpgroup (thread 0) and the tensor warpgroup
// (thread NT): slot += the clocks since t, t restarts (empty in the
// kernels' own build).
#define GDM_K3H_PHASE(who, slot, t)                                   \
  do {                                                                \
    GDM_STAMP_ADD(threadIdx.x == (who), slot, GDM_CLOCK() - (t));     \
    (t) = GDM_CLOCK();                                                \
  } while (0)

template <typename T, int P>
__global__ void __launch_bounds__(2 * NT, P <= 7 ? 2 : 1)
k3h_kernel(const T* __restrict__ u, const T* __restrict__ a1,
           const T* __restrict__ b1, const T* __restrict__ ct_img,
           const T* __restrict__ rb_img, T* __restrict__ y, int n0, int n1,
           int tile_r, int vpu_rows, int n_tiles, int segs) {
  using G = CGeom<T, P, false>;
  constexpr int LDV = G::LDV;
  const G g(tile_r);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + g.bars);
  unsigned long long* lbar = bars;       // [2]: "landed"
  unsigned long long* cbar = bars + 2;   // the B image
  T* vw = reinterpret_cast<T*>(smem + g.vw);
  T* lands = reinterpret_cast<T*>(smem + g.land);
  T* bandss = reinterpret_cast<T*>(smem + g.bands);
  int* roffs = reinterpret_cast<int*>(smem + g.roff);
  const size_t land_n = g.land_slot() / sizeof(T);
  const size_t band_n = g.band_slot() / sizeof(T);

  const int tid = threadIdx.x;
  const int cb = blockIdx.x / segs;   // the block's strip
  const int j0 = cb * SW;
  int t0, count;
  strip_run(n_tiles, segs, blockIdx.x % segs, t0, count);
  if (count == 0) return;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());
  GDM_STAMP(tid == 0, 11, count);
  long long tc = GDM_CLOCK();
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) gdm::bar_init(lbar + b, 2 * NT);
    gdm::bar_init(cbar, 1);
    gdm::bar_init_fence();
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 2, clock64());
  tc = GDM_CLOCK();

  const bool tensor = tid >= NT;
  const int t = tid % NT;
  const int warp = t / 32;
  const int lane = t % 32;
  const Cols<P, SW> cols(j0, n1);
  // the FMA warpgroup's band columns: A1 and B1 of output column j0 + lane
  T ca[2 * P + 1], cbv[2 * P + 1];
  unsigned mask = 0;
  if (!tensor) {
    column_band_rows<T, P>(a1, b1, j0 + lane, n1, ca, cbv);
    mask = tap_mask<P, SW>(lane, cols);
  }
  const bool inner_cols = cols.lo == 0 && cols.hi == SW + 2 * P;
  // each warpgroup issues the copies of the other's rows of unit m: the
  // FMA warpgroup the u rows [vf, me) and the band rows, the tensor
  // warpgroup the u rows [0, vf)
  auto issue = [&](int m) {
    const int i0 = (t0 + m) * tile_r;
    const int rows = min(tile_r, n0 - i0);
    const int vf = min(vpu_rows, rows + 2 * P);
    issue_unit<T, P>(lands + (m & 1) * land_n,
                     tensor ? nullptr : bandss + (m & 1) * band_n, u, rb_img,
                     i0, rows, j0, n0, n1, t, tensor ? 0 : vf,
                     tensor ? vf : rows + 2 * P, lbar + (m & 1));
  };
  if constexpr (sizeof(T) == 4) {
    if (tid == NT) {
      gdm::bar_arrive_expect_tx(cbar, G::CIMG);
      gdm::bulk_copy(smem, ct_img + static_cast<size_t>(cb) * G::CIMG / 4,
                     G::CIMG, cbar);
    }
  }
  issue(0);
  for (int n = 0; n < count; ++n) {
    const int i0 = (t0 + n) * tile_r;
    const int rows = min(tile_r, n0 - i0);
    const int me = rows + 2 * P;
    const int vf = min(vpu_rows, me);
    const T* ld = lands + (n & 1) * land_n;
    if (tensor) {
      // ---- the tensor warpgroup: the copies and rows [vf, me) ----
      int* ro = roffs + g.cap;
      row_offsets<T, P>(ro, u, i0, j0, n0, n1, t, me);
      gdm::bar_wait(lbar + (n & 1), (n >> 1) & 1);
      group_sync(1);
      GDM_K3H_PHASE(NT, 7, tc);
      if (n + 1 < count) issue(n + 1);
      GDM_K3H_PHASE(NT, 13, tc);
      if (vf < me) {
        if constexpr (sizeof(T) == 4) {
          gdm::bar_wait(cbar, 0);
          const uint32_t cimg = gdm::smem_addr(smem);
          if (inner_cols && i0 >= P && i0 - P + me <= n0)
            col_product<P, LDV, false>(ld, ro, vw, vf, me, cols, cimg, warp,
                                       lane, tc);
          else
            col_product<P, LDV, true>(ld, ro, vw, vf, me, cols, cimg, warp,
                                      lane, tc);
        } else {
          double* ut = reinterpret_cast<double*>(smem);
          col_product_f64<P>(ld, ro, vw, ut, ut + G::UCH * G::LDU,
                             ct_img + static_cast<size_t>(cb) * G::KD *
                                          gdm::tc::LDV,
                             vf, me, cols, t, warp, lane);
          GDM_K3H_PHASE(NT, 15, tc);
        }
      }
    } else {
      // ---- the FMA warpgroup: rows [0, vf) ----
      int* ro = roffs;
      row_offsets<T, P>(ro, u, i0, j0, n0, n1, t, rnd(vf, 4));
      gdm::bar_wait(lbar + (n & 1), (n >> 1) & 1);
      group_sync(2);
      if (n + 1 < count) issue(n + 1);
      GDM_K3H_PHASE(0, 3, tc);
      if (inner_cols && i0 >= P && i0 - P + me <= n0)
        fma_rows<T, P, LDV, 4, false>(ld, ro, vw, vf, me, lane, mask, ca, cbv,
                                      warp);
      else
        fma_rows<T, P, LDV, 4, true>(ld, ro, vw, vf, me, lane, mask, ca, cbv,
                                     warp);
      GDM_K3H_PHASE(0, 4, tc);
    }
    block_sync(3);   // the unit's [V | W] is whole
    if (!tensor) GDM_K3H_PHASE(0, 5, tc);
    // float64 reads the band rows from the table itself
    const T* bands = sizeof(T) == 4
                         ? bandss + (n & 1) * band_n
                         : rb_img + static_cast<size_t>(i0) * 2 * G::KP;
    row_stage<T, P, LDV, 8>(vw, bands, y, i0, rows, j0, n1, tid / 32, lane);
    block_sync(4);   // every read of the slot is done
    if (tensor)
      GDM_K3H_PHASE(NT, 12, tc);
    else
      GDM_K3H_PHASE(0, 6, tc);
  }
  if constexpr (sizeof(T) == 4) {
    if (tensor) gdm::bar_wait(cbar, 0);
  }
  GDM_STAMP(tid == 0, 9, clock64());
  GDM_STAMP(tid == 0, 10, gdm_gtimer());
  (void)tc;
}

template <typename T, int P>
int launch_p(const void* u, const void* a1, const void* b1, const void* ct,
             const void* rb, void* y, int n0, int n1, int tile_r,
             int vpu_rows, int n_tiles, int segs, int grid,
             cudaStream_t stream) {
  const size_t smem = CGeom<T, P, false>(tile_r).total;
  if (vpu_rows < 0 ||
      !strip_plan_ok(n0, n1, tile_r, n_tiles, segs, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(k3h_kernel<T, P>, smem);
  if (e != 0) return e;
  k3h_kernel<T, P><<<grid, 2 * NT, smem, stream>>>(
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
  const size_t smem = CGeom<T, P, false>(tile_r).total;
  const int e = allow_smem(k3h_kernel<T, P>, smem);
  if (e != 0) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k3h_kernel<T, P>, 2 * NT, smem));
}

template <typename T>
int occupancy_of(int p, int tile_r, int* out) {
  GDM_TCS_DISPATCH15(p, occupancy_p<T, P>(tile_r, out))
}

}  // namespace

extern "C" {

// u, the band rows A1 and B1, the strip's C table (float32: C^T's B
// images, hi then lo, 32-byte swizzled K-major, 64 rows by KD; float64:
// K3f's C row-major), the padded band-row table (A0's and B0's rows at a
// pitch of 2 KP) of the plan (ops/tc_tables.py), y; the tile's rows,
// vpu_rows, the tiles, runs of tiles a strip and blocks; a plan off the
// kernel's layout is refused (cudaErrorInvalidValue).
int gdm_laplace2_hybrid_apply_f32(const void* u, const void* a1,
                                  const void* b1, const void* ct,
                                  const void* rb, void* y, int p, int n0,
                                  int n1, int tile_r, int vpu_rows,
                                  int n_tiles, int segs, int grid,
                                  void* stream) {
  return launch<float>(u, a1, b1, ct, rb, y, p, n0, n1, tile_r, vpu_rows,
                       n_tiles, segs, grid, stream);
}

int gdm_laplace2_hybrid_apply_f64(const void* u, const void* a1,
                                  const void* b1, const void* ct,
                                  const void* rb, void* y, int p, int n0,
                                  int n1, int tile_r, int vpu_rows,
                                  int n_tiles, int segs, int grid,
                                  void* stream) {
  return launch<double>(u, a1, b1, ct, rb, y, p, n0, n1, tile_r, vpu_rows,
                        n_tiles, segs, grid, stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) with tiles of
// tile_r rows one SM holds.
int gdm_laplace2_hybrid_occupancy(int p, int f64, int tile_r, int* out) {
  return f64 ? occupancy_of<double>(p, tile_r, out)
             : occupancy_of<float>(p, tile_r, out);
}

}  // extern "C"
