// K3/mxu3: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with
// K3's column stage on the FMA units and the row stage as one window
// product per tile on the tensor cores.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2's
// ``kernel_mxu3`` (rows="mxu3": the row stage as one dense-banded product
// as bf16x3), a body behind K3's pallas_call.  Same operator, band tables
// and contiguous (n0, n1) node array as K3 (laplace2.cu).  This file holds
// K3/mxu3's entries only (K3/mxu, the same design with the product as
// 3xTF32, moved to laplace2_mxu.cu on the stage of tc_stage.cuh); its
// kernel keeps both instantiations: bf16x3 in float32 (about 16 bits of
// each operand, tc_window.cuh) and the DMMA product, unsplit, in float64.
//
// Bound on the card: K3's (memory, 8 bytes of u and y per node in
// float32: 2.51 us at 1024^2).  The row product's depth is the extended
// tile (tile_r + 2p rounded to 16), so it costs about 4 (tile_r + 2p)
// flops per output against the band's 4 (2p + 1) (3x that for 3xTF32 and
// bf16x3): the price of taking the row stage off the FMA units, on units
// that are otherwise idle.
//
// Design: one block of 8 warps owns tile_r output rows and 32 columns
// (K3f's block).  It loads the u tile (tile_r + 2p rows, 32 + 2p columns,
// zeros outside the grid), builds C from its columns' A1/B1 band rows
// and the row windows from its rows' A0/B0 band rows (split to bf16
// hi/lo as they are written, for K3/mxu3 in float32); all 8 warps run the
// column FMAs over the extended tile, writing [V | W] (split the same
// way); after one barrier the warps share the 16 x 16 blocks of the row
// product, whose result goes through shared memory (the u tile's space)
// to coalesced stores.
#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

// BF16X3: the row product as bf16x3 (K3/mxu3 in float32 only)
template <typename T, int P, bool BF16X3>
size_t smem_bytes(const Tile<P>& g) {
  return rnd128(sizeof(T) * g.u_elems()) + rnd128(sizeof(T) * g.c_elems()) +
         RowOperands<T, P, BF16X3>::bytes(g);
}

template <typename T, int P, bool BF16X3>
__global__ void __launch_bounds__(NT)
laplace2_mxurows_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                        const T* __restrict__ a1, const T* __restrict__ b0,
                        const T* __restrict__ b1, T* __restrict__ y, int n0,
                        int n1, int tile_r) {
  using Ops = RowOperands<T, P, BF16X3>;
  const Tile<P> g(tile_r);
  const int rows = rnd(tile_r, 16);
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t u_bytes = rnd128(sizeof(T) * g.u_elems());
  T* ut = reinterpret_cast<T*>(smem);
  T* ct = reinterpret_cast<T*>(smem + u_bytes);
  const Ops ops(smem + u_bytes + rnd128(sizeof(T) * g.c_elems()), g);
  T* ys = ut;  // the y tile, once the column stage has read the u tile

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * tile_r;
  const int j0 = blockIdx.x * TX;

  load_u_tile<T, P>(ut, u, g, i0, j0, n0, n1, tid, NT);
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);
  build_row_windows<T, P>(a0, b0, g, i0, n0, tid, NT,
                          [&](int r, int s, T a, T b) {
                            ops.set_window(r, s, a, b);
                          });
  __syncthreads();
  // rows t_ext .. m of the u tile are zero, so V and W are there too
  col_fma_to<T, P>(ut, ct, 0, g.m, lane, warp, NW,
                   [&](int r, T v, T w) { ops.set_vw(r, lane, v, w); });
  __syncthreads();

  for (int task = warp; task < (rows / 16) * 2; task += NW) {
    const int r0 = (task / 2) * 16;
    const int c0 = (task % 2) * 16;
    ops.product(r0, c0, ys + r0 * LDY + c0, LDY);
  }
  __syncthreads();
  const int j = j0 + lane;
  if (j >= n1) return;
  for (int r = warp; r < tile_r && i0 + r < n0; r += NW)
    y[static_cast<size_t>(i0 + r) * n1 + j] = ys[r * LDY + lane];
}

template <typename T, int P, bool BF16X3>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem = smem_bytes<T, P, BF16X3>(g);
  const int e = allow_smem(laplace2_mxurows_kernel<T, P, BF16X3>, smem);
  if (e != 0) return e;
  const dim3 grid((n1 + TX - 1) / TX, (n0 + tile_r - 1) / tile_r);
  laplace2_mxurows_kernel<T, P, BF16X3><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, tile_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BF16X3>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int tile_r,
           void* stream) {
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GDM_TC_DISPATCH_P(p, launch_p<T, P, BF16X3>(u, a0, a1, b0, b1, y, n0, n1,
                                              tile_r, s))
}

}  // namespace

extern "C" {

int gdm_laplace2_mxu3_apply_f32(const void* u, const void* a0, const void* a1,
                                const void* b0, const void* b1, void* y,
                                int p, int n0, int n1, int tile_r,
                                void* stream) {
  return launch<float, true>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

// float64: the DMMA product, unsplit
int gdm_laplace2_mxu3_apply_f64(const void* u, const void* a0, const void* a1,
                                const void* b0, const void* b1, void* y,
                                int p, int n0, int n1, int tile_r,
                                void* stream) {
  return launch<double, false>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r,
                               stream);
}

}  // extern "C"
