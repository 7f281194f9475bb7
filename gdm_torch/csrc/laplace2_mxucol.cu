// K3c: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with the
// column stage on the tensor cores and K3's row stage on the FMA units,
// pipelined across the tiles of a column strip.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_mxucol (its
// pallas_call at :2210: the column stage as banded window products on
// the MXU, the row stage on the VPU, tile i - 1's row stage issued while
// tile i's products drain; no solve dispatch routes to it, in gdm or
// here).  Same operator, band tables and contiguous (n0, n1) node array
// as K3 (laplace2.cu).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 and 40 us at 4096^2,
// p = 3, float32).  The design's own floors are its FMA row stage (K3's,
// 4(2p + 1) flops an output) and its tensor work: the whole extended tile
// as [V | W] = U . C, 3 x 2 x 64 x 64 x KD flops for each 64 extended
// rows, two chains a tile of 64 rows at p = 3 (70 extended rows): 0.55
// GFLOP of tf32 at 1025^2 (1.1 us at 495 TFLOP/s).
//
// Design (float32; tc_strip.cuh holds the shared stage).  Units are K3p's
// (laplace2_hybp.cu): one tile of a 32-column strip, each persistent
// block an even run of one strip's tiles (the longer runs last,
// strip_run).  Two warpgroups, joined by mbarriers only (no block-wide
// barrier after the set-up):
//   warpgroup 1 (the tensor warpgroup) brings in the strip's C^T B image
//     once by one bulk copy; per unit n, once unit n's copies have landed,
//     issues unit n + 1's 16-byte cp.async copies (its u rows into the
//     other of two landing slots, its padded A0 and B0 band rows into one
//     of three band slots), whose landing completes that slot's "landed"
//     barrier; then runs the whole extended tile's column stage as 3xTF32
//     wgmma m64n64k8 chains with u as the A operand in registers, split
//     from the landed rows (col_product), writes V and W into the unit's
//     [V | W] slot (two slots) and arrives on its "full";
//   warpgroup 0 (the FMA warpgroup) runs unit n - 1's row stage once its
//     "full" completes (a thread per output column, V and W of RB + 2p
//     rows in registers, the band rows by 16-byte loads; row_stage),
//     stores y coalesced and arrives on that slot's "empty".
// The tensor warpgroup waits on "empty" (unit n - 2's row stage done)
// before it reuses the [V | W] and band slots unit n - 2 took.  So unit
// n's products run under unit n - 1's row stage, as in gdm.  A block
// takes 107 KB of shared memory at p = 3 with tiles of 64 rows, so two
// share an SM.
//
// Float64: the same pipeline, the products on the DMMA units (wmma
// m8n8k4, tc_window.cuh's col_mma) from K3f's float64 C table, unsplit,
// through a u piece of 32 rows; the row stage reads its band rows from
// the cached table in device memory.
#include "tc_strip.cuh"

namespace {

using namespace gdm::tcs;

// Clock stamps of the FMA warpgroup (thread 0) and the tensor warpgroup
// (thread NT): slot += the clocks since t, t restarts (empty in the
// kernels' own build).
#define GDM_K3C_PHASE(who, slot, t)                                   \
  do {                                                                \
    GDM_STAMP_ADD(threadIdx.x == (who), slot, GDM_CLOCK() - (t));     \
    (t) = GDM_CLOCK();                                                \
  } while (0)

template <typename T, int P>
__global__ void __launch_bounds__(2 * NT, P <= 7 ? 2 : 1)
k3c_kernel(const T* __restrict__ u, const T* __restrict__ ct_img,
           const T* __restrict__ rb_img, T* __restrict__ y, int n0, int n1,
           int tile_r, int n_tiles, int segs) {
  using G = CGeom<T, P, true>;
  constexpr int LDV = G::LDV;
  const G g(tile_r);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~static_cast<uintptr_t>(ALIGN - 1));
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + g.bars);
  unsigned long long* lbar = bars;        // [2]: "landed"
  unsigned long long* full = bars + 2;    // [2]
  unsigned long long* empty = bars + 4;   // [2]
  unsigned long long* cbar = bars + 6;    // the B image
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
  strip_run(n_tiles, segs, blockIdx.x % segs, t0, count);
  if (count == 0) return;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());
  GDM_STAMP(tid == 0, 11, count);
  long long tc = GDM_CLOCK();
  if (tid == 0) {
    for (int b = 0; b < 6; ++b) gdm::bar_init(bars + b, NT);
    gdm::bar_init(cbar, 1);
    gdm::bar_init_fence();
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 2, clock64());
  tc = GDM_CLOCK();

  if (tid >= NT) {
    // ---- the tensor warpgroup: copies and the column stage ----
    const int t = tid - NT;
    const int warp = t / 32;
    const int lane = t % 32;
    auto issue = [&](int m) {
      const int i0 = (t0 + m) * tile_r;
      const int rows = min(tile_r, n0 - i0);
      issue_unit<T, P>(lands + (m & 1) * land_n, bandss + (m % 3) * band_n,
                       u, rb_img, i0, rows, j0, n0, n1, t, 0, rows + 2 * P,
                       lbar + (m & 1));
    };
    if constexpr (sizeof(T) == 4) {
      if (t == 0) {
        gdm::bar_arrive_expect_tx(cbar, G::CIMG);
        gdm::bulk_copy(smem, ct_img + static_cast<size_t>(cb) * G::CIMG / 4,
                       G::CIMG, cbar);
      }
    }
    issue(0);
    const Cols<P, SW> cols(j0, n1);
    const bool inner_cols = cols.lo == 0 && cols.hi == SW + 2 * P;
    for (int n = 0; n < count; ++n) {
      const int i0 = (t0 + n) * tile_r;
      const int me = min(tile_r, n0 - i0) + 2 * P;
      if (n >= 2) gdm::bar_wait(empty + (n & 1), ((n >> 1) + 1) & 1);
      GDM_K3C_PHASE(NT, 12, tc);
      int* ro = roffs + (n & 1) * g.cap;
      row_offsets<T, P>(ro, u, i0, j0, n0, n1, t, me);
      gdm::bar_wait(lbar + (n & 1), (n >> 1) & 1);
      group_sync(1);   // and every thread is past unit n - 1's products
      GDM_K3C_PHASE(NT, 7, tc);
      if (n + 1 < count) issue(n + 1);
      GDM_K3C_PHASE(NT, 13, tc);
      const T* ld = lands + (n & 1) * land_n;
      T* vw = vws + (n & 1) * vw_n;
      if constexpr (sizeof(T) == 4) {
        gdm::bar_wait(cbar, 0);
        const uint32_t cimg = gdm::smem_addr(smem);
        if (inner_cols && i0 >= P && i0 - P + me <= n0)
          col_product<P, LDV, false>(ld, ro, vw, 0, me, cols, cimg, warp,
                                     lane, tc);
        else
          col_product<P, LDV, true>(ld, ro, vw, 0, me, cols, cimg, warp,
                                    lane, tc);
      } else {
        col_product_f64<P>(ld, ro, vw, reinterpret_cast<double*>(smem),
                           nullptr,
                           ct_img + static_cast<size_t>(cb) * G::KD *
                                        gdm::tc::LDV,
                           0, me, cols, t, warp, lane);
        GDM_K3C_PHASE(NT, 15, tc);
      }
      gdm::bar_arrive(full + (n & 1));
    }
    if constexpr (sizeof(T) == 4) gdm::bar_wait(cbar, 0);
  } else {
    // ---- the FMA warpgroup: the row stage ----
    const int warp = tid / 32;
    const int x = tid % 32;
    for (int m = 0; m < count; ++m) {
      const int i0 = (t0 + m) * tile_r;
      gdm::bar_wait(full + (m & 1), (m >> 1) & 1);
      GDM_K3C_PHASE(0, 5, tc);
      // float64 reads the band rows from the table itself
      const T* bands = sizeof(T) == 4
                           ? bandss + (m % 3) * band_n
                           : rb_img + static_cast<size_t>(i0) * 2 * G::KP;
      row_stage<T, P, LDV, 4>(vws + (m & 1) * vw_n, bands, y, i0,
                              min(tile_r, n0 - i0), j0, n1, warp, x);
      gdm::bar_arrive(empty + (m & 1));
      GDM_K3C_PHASE(0, 6, tc);
    }
    GDM_STAMP(tid == 0, 9, clock64());
    GDM_STAMP(tid == 0, 10, gdm_gtimer());
  }
  (void)tc;
}

template <typename T, int P>
int launch_p(const void* u, const void* ct, const void* rb, void* y, int n0,
             int n1, int tile_r, int n_tiles, int segs, int grid,
             cudaStream_t stream) {
  const size_t smem = CGeom<T, P, true>(tile_r).total;
  if (!strip_plan_ok(n0, n1, tile_r, n_tiles, segs, grid, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(k3c_kernel<T, P>, smem);
  if (e != 0) return e;
  k3c_kernel<T, P><<<grid, 2 * NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(ct),
      static_cast<const T*>(rb), static_cast<T*>(y), n0, n1, tile_r,
      n_tiles, segs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* ct, const void* rb, void* y, int p,
           int n0, int n1, int tile_r, int n_tiles, int segs, int grid,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GDM_TCS_DISPATCH15(p, (launch_p<T, P>(u, ct, rb, y, n0, n1, tile_r,
                                        n_tiles, segs, grid, s)))
}

template <typename T, int P>
int occupancy_p(int tile_r, int* out) {
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = CGeom<T, P, true>(tile_r).total;
  const int e = allow_smem(k3c_kernel<T, P>, smem);
  if (e != 0) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k3c_kernel<T, P>, 2 * NT, smem));
}

template <typename T>
int occupancy_of(int p, int tile_r, int* out) {
  GDM_TCS_DISPATCH15(p, occupancy_p<T, P>(tile_r, out))
}

}  // namespace

extern "C" {

// u, the strip's C table (float32: C^T's B images, hi then lo, 32-byte
// swizzled K-major, 64 rows by KD; float64: K3f's C row-major), the
// padded band-row table (A0's and B0's rows at a pitch of 2 KP) of the
// plan (ops/tc_tables.py), y; the tile's rows, the tiles, runs of tiles
// a strip and blocks; a plan off the kernel's layout is refused
// (cudaErrorInvalidValue).
int gdm_laplace2_mxucol_apply_f32(const void* u, const void* ct,
                                  const void* rb, void* y, int p, int n0,
                                  int n1, int tile_r, int n_tiles, int segs,
                                  int grid, void* stream) {
  return launch<float>(u, ct, rb, y, p, n0, n1, tile_r, n_tiles, segs, grid,
                       stream);
}

int gdm_laplace2_mxucol_apply_f64(const void* u, const void* ct,
                                  const void* rb, void* y, int p, int n0,
                                  int n1, int tile_r, int n_tiles, int segs,
                                  int grid, void* stream) {
  return launch<double>(u, ct, rb, y, p, n0, n1, tile_r, n_tiles, segs,
                        grid, stream);
}

// Blocks of the built kernel (f64: 0 float32, 1 float64) with tiles of
// tile_r rows one SM holds.
int gdm_laplace2_mxucol_occupancy(int p, int f64, int tile_r, int* out) {
  return f64 ? occupancy_of<double>(p, tile_r, out)
             : occupancy_of<float>(p, tile_r, out);
}

}  // extern "C"
