// K3p: K3h's split column stage pipelined across the tiles of a column
// strip, for y = A0 U A1^T + B0 U B1^T.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_hybp (the
// TPU schedule that issues tile i's MXU column products before tile i's
// VPU rows and tile i-1's row stage; no solve dispatch routes to it, in
// gdm or here).  Same operator, band tables and contiguous (n0, n1) node
// array as K3 (laplace2.cu).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 and 40 us at 4096^2,
// p = 3, float32).
//
// Design: one wave of persistent blocks (as many as fit on the SMs at
// once, as K3s).  A block owns a 32-column strip and a segment of its
// rows, a whole number of tiles of tile_r rows, and marches down it.  The
// warps are specialised.  In step s the MMA warps (4-7) run tile s's
// window product on rows [vpu_rows, tile_r + 2p) of its extended tile,
// while the FMA warps (0-3) run tile s's K3 column FMAs on rows
// [0, vpu_rows) and then tile s-1's row stage.  V and W are double
// buffered, so tile s-1's row stage reads the buffer tile s does not
// write; one barrier per step.  Tile s+1's u rows and A0/B0 rows arrive
// meanwhile through K3s's element-wise cp.async copies (zero-filled
// outside the grid, any row length) into a second u slot and a third
// band slot.  The strip's C slice is built once.
#include <algorithm>

#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_hybp_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                     const T* __restrict__ a1, const T* __restrict__ b0,
                     const T* __restrict__ b1, T* __restrict__ y, int n0,
                     int n1, int tile_r, int vpu_rows, int seg_rows) {
  using G = Tile<P>;
  constexpr int K = G::K;
  const G g(tile_r);
  extern __shared__ __align__(128) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T* us = base;                           // 2 u tiles
  T* rs = us + 2 * g.u_elems();           // 3 slots of A0 / B0 rows
  T* vws = rs + 3 * g.r_elems();          // 2 [V | W] buffers
  T* ct = vws + 2 * g.vw_elems();
  T* scr = ct + g.c_elems();              // NW / 2 scratch tiles

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * TX;
  const int seg_lo = blockIdx.y * seg_rows;
  const int seg_hi = min(seg_lo + seg_rows, n0);
  const int n_tiles = (seg_hi - seg_lo + tile_r - 1) / tile_r;
  const int vr = min(vpu_rows, g.t_ext);

  // tile s's u rows into u slot s % 2, its band rows into slot s % 3
  auto issue = [&](int s) {
    const int i0 = seg_lo + s * tile_r;
    T* ut = us + (s % 2) * g.u_elems();
    for (int e = tid; e < g.t_ext * G::UW; e += NT) {
      const int r = e / G::UW;
      const int c = e % G::UW;
      const int gi = i0 - P + r;
      const int gj = j0 - P + c;
      const bool in = gi >= 0 && gi < n0 && gj >= 0 && gj < n1;
      gdm::copy_async(ut + r * G::LDU + c,
                      in ? u + static_cast<size_t>(gi) * n1 + gj : u, in);
    }
    T* ra = rs + (s % 3) * g.r_elems();
    for (int e = tid; e < tile_r * K; e += NT) {
      const bool in = i0 + e / K < n0;
      const size_t at = in ? static_cast<size_t>(i0) * K + e : 0;
      gdm::copy_async(ra + e, a0 + at, in);
      gdm::copy_async(ra + tile_r * K + e, b0 + at, in);
    }
  };

  issue(0);
  gdm::commit_group();
  // the copies never write the padding of the u slots: zero it once
  for (int e = tid; e < 2 * g.m * G::KD; e += NT) {
    const int slot = e / (g.m * G::KD);
    const int r = (e / G::KD) % g.m;
    const int c = e % G::KD;
    if (r >= g.t_ext || c >= G::UW)
      us[slot * g.u_elems() + r * G::LDU + c] = T(0);
  }
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);

  const bool fma_warp = warp < NW / 2;
  const int gw = fma_warp ? warp : warp - NW / 2;  // warp within its group
  for (int s = 0; s <= n_tiles; ++s) {
    // tile s has landed; the barrier also ends step s - 1, so its u slot,
    // band slot and [V | W] buffer may be refilled
    gdm::wait_group<0>();
    __syncthreads();
    if (s + 1 < n_tiles) issue(s + 1);
    gdm::commit_group();
    const T* ut = us + (s % 2) * g.u_elems();
    T* vw = vws + (s % 2) * g.vw_elems();
    if (fma_warp) {
      if (s < n_tiles)
        col_fma<T, P>(ut, ct, vw, 0, vr, lane, gw, NW / 2);
      if (s > 0) {
        const T* ra = rs + ((s - 1) % 3) * g.r_elems();
        row_fma<T, P>(vws + ((s - 1) % 2) * g.vw_elems(), ra,
                      ra + tile_r * K, y, seg_lo + (s - 1) * tile_r, j0, n0,
                      n1, tile_r, lane, gw, NW / 2);
      }
    } else if (s < n_tiles && vr < g.t_ext) {
      col_mma<T, P>(ut, ct, vw, scr + gw * SCR, vr, g.m, gw, NW / 2, lane);
    }
  }
  gdm::wait_group<0>();
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             int vpu_rows, cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem =
      sizeof(T) * (2 * g.u_elems() + 3 * g.r_elems() + 2 * g.vw_elems() +
                   g.c_elems() + NW / 2 * SCR);
  cudaError_t e = static_cast<cudaError_t>(
      allow_smem(laplace2_hybp_kernel<T, P>, smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, laplace2_hybp_kernel<T, P>, NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave: each strip's tiles split into as many segments as still fit
  // the SMs at once, never below one tile per segment
  const int strips = (n1 + TX - 1) / TX;
  const int tiles = (n0 + tile_r - 1) / tile_r;
  const int want = sms * (per_sm > 0 ? per_sm : 1);
  int segs = std::max(1, std::min(want / strips, tiles));
  const int seg_tiles = (tiles + segs - 1) / segs;
  segs = (tiles + seg_tiles - 1) / seg_tiles;
  const dim3 grid(strips, segs);
  laplace2_hybp_kernel<T, P><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, tile_r,
      vpu_rows, seg_tiles * tile_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int tile_r,
           int vpu_rows, void* stream) {
  if (tile_r < 1 || vpu_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GDM_TC_DISPATCH_P(p, launch_p<T, P>(u, a0, a1, b0, b1, y, n0, n1, tile_r,
                                      vpu_rows, s))
}

}  // namespace

extern "C" {

int gdm_laplace2_hybp_apply_f32(const void* u, const void* a0, const void* a1,
                                const void* b0, const void* b1, void* y,
                                int p, int n0, int n1, int tile_r,
                                int vpu_rows, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, vpu_rows,
                       stream);
}

int gdm_laplace2_hybp_apply_f64(const void* u, const void* a0, const void* a1,
                                const void* b0, const void* b1, void* y,
                                int p, int n0, int n1, int tile_r,
                                int vpu_rows, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, vpu_rows,
                        stream);
}

}  // extern "C"
