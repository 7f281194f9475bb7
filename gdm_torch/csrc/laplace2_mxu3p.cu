// K3/mxu3p: K3/mxu3 pipelined across the tiles of a column strip, for
// y = A0 U A1^T + B0 U B1^T.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2's
// ``kernel_mxu3p`` (rows="mxu3p", gdm's 2D default on its TPU: step i
// issues tile i-1's bf16x3 row products before tile i's column rolls, so
// the matrix unit drains under the roll loop).  Same operator, band
// tables and contiguous (n0, n1) node array as K3 (laplace2.cu); the
// row product is K3/mxu3's (laplace2_mxurows.cu): bf16x3 in float32,
// DMMA unsplit in float64 (tc_window.cuh).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 and 40 us at 4096^2,
// p = 3, float32).
//
// Design: one wave of persistent blocks (as many as fit on the SMs at
// once, as K3p, laplace2_hybp.cu).  A block owns a 32-column strip and a
// segment of its rows, a whole number of tiles of tile_r rows, and
// marches down it.  The warps are specialised.  In step s the FMA warps
// (0-3) run tile s's column FMAs over its extended tile, writing [V | W]
// as bf16 hi/lo into slot s % 2, and write tile s's A0/B0 band entries
// into that slot's row windows (zeroed once: only the band changes from
// tile to tile); meanwhile the MMA warps (4-7) run tile s-1's row product
// from slot (s-1) % 2 and store its y through a per-warp 16 x 16 scratch
// tile.  One barrier per step.  Tile s+1's u rows arrive meanwhile
// through K3p's element-wise cp.async copies into a second u slot.  The
// strip's C slice is built once.
#include <algorithm>
#include <type_traits>

#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

template <typename T, int P>
using Ops = RowOperands<T, P, std::is_same<T, float>::value>;

template <typename T, int P>
size_t smem_bytes(const Tile<P>& g) {
  return 2 * rnd128(sizeof(T) * g.u_elems()) +
         rnd128(sizeof(T) * g.c_elems()) + 2 * Ops<T, P>::bytes(g) +
         rnd128(sizeof(T) * (NW / 2) * SCR);
}

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_mxu3p_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                      const T* __restrict__ a1, const T* __restrict__ b0,
                      const T* __restrict__ b1, T* __restrict__ y, int n0,
                      int n1, int tile_r, int seg_rows) {
  using G = Tile<P>;
  const G g(tile_r);
  const size_t u_bytes = rnd128(sizeof(T) * g.u_elems());
  const size_t ops_bytes = Ops<T, P>::bytes(g);
  extern __shared__ __align__(128) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);                     // 2 u tiles
  T* ct = reinterpret_cast<T*>(smem + 2 * u_bytes);
  unsigned char* ops_base = smem + 2 * u_bytes + rnd128(sizeof(T) *
                                                        g.c_elems());
  const Ops<T, P> ops0(ops_base, g);                      // 2 slots
  const Ops<T, P> ops1(ops_base + ops_bytes, g);
  T* scr = reinterpret_cast<T*>(ops_base + 2 * ops_bytes);  // NW / 2 tiles

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * TX;
  const int seg_lo = blockIdx.y * seg_rows;
  const int seg_hi = min(seg_lo + seg_rows, n0);
  const int n_tiles = (seg_hi - seg_lo + tile_r - 1) / tile_r;
  const int rows = rnd(tile_r, 16);

  // tile s's u rows into u slot s % 2
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
  };

  issue(0);
  gdm::commit_group();
  // the copies never write the padding of the u slots, the band writes
  // never the rest of the row windows: zero both once
  for (int e = tid; e < 2 * g.m * G::KD; e += NT) {
    const int slot = e / (g.m * G::KD);
    const int r = (e / G::KD) % g.m;
    const int c = e % G::KD;
    if (r >= g.t_ext || c >= G::UW)
      us[slot * g.u_elems() + r * G::LDU + c] = T(0);
  }
  unsigned* words = reinterpret_cast<unsigned*>(ops_base);
  for (size_t e = tid; e < 2 * ops_bytes / sizeof(unsigned); e += NT)
    words[e] = 0u;
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);

  const bool fma_warp = warp < NW / 2;
  const int gw = fma_warp ? warp : warp - NW / 2;  // warp within its group
  for (int s = 0; s <= n_tiles; ++s) {
    // tile s has landed; the barrier also ends step s - 1, so its u slot
    // and its operand slot may be refilled
    gdm::wait_group<0>();
    __syncthreads();
    if (s + 1 < n_tiles) issue(s + 1);
    gdm::commit_group();
    if (fma_warp) {
      if (s < n_tiles) {
        const Ops<T, P>& ops = (s % 2) ? ops1 : ops0;
        const T* ut = us + (s % 2) * g.u_elems();
        // rows t_ext .. m of the u tile are zero, so V and W are there too
        col_fma_to<T, P>(ut, ct, 0, g.m, lane, gw, NW / 2,
                         [&](int r, T v, T w) { ops.set_vw(r, lane, v, w); });
        row_window_bands<T, P>(a0, b0, tile_r, seg_lo + s * tile_r, n0, tid,
                               NT / 2, [&](int r, int c, T a, T b) {
                                 ops.set_window(r, c, a, b);
                               });
      }
    } else if (s > 0) {
      const Ops<T, P>& ops = ((s - 1) % 2) ? ops1 : ops0;
      const int i0 = seg_lo + (s - 1) * tile_r;
      T* sc = scr + gw * SCR;
      for (int task = gw; task < (rows / 16) * 2; task += NW / 2) {
        const int r0 = (task / 2) * 16;
        const int c0 = (task % 2) * 16;
        ops.product(r0, c0, sc, 16);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = r0 + e / 16;
          const int j = j0 + c0 + e % 16;
          if (r < tile_r && i0 + r < n0 && j < n1)
            y[static_cast<size_t>(i0 + r) * n1 + j] = sc[e];
        }
        __syncwarp();
      }
    }
  }
  gdm::wait_group<0>();
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem = smem_bytes<T, P>(g);
  cudaError_t e = static_cast<cudaError_t>(
      allow_smem(laplace2_mxu3p_kernel<T, P>, smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, laplace2_mxu3p_kernel<T, P>, NT, smem);
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
  laplace2_mxu3p_kernel<T, P><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, tile_r,
      seg_tiles * tile_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int tile_r,
           void* stream) {
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GDM_TC_DISPATCH_P(p, launch_p<T, P>(u, a0, a1, b0, b1, y, n0, n1, tile_r,
                                      s))
}

}  // namespace

extern "C" {

int gdm_laplace2_mxu3p_apply_f32(const void* u, const void* a0,
                                 const void* a1, const void* b0,
                                 const void* b1, void* y, int p, int n0,
                                 int n1, int tile_r, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

int gdm_laplace2_mxu3p_apply_f64(const void* u, const void* a0,
                                 const void* a1, const void* b0,
                                 const void* b1, void* y, int p, int n0,
                                 int n1, int tile_r, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

}  // extern "C"
