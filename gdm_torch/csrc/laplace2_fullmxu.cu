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
// Both stages become dense window products on the tensor cores: the
// column stage as K3c's ([V | W] = U_tile . C), the row stage as
// y_tile = A0w . V + B0w . W over the tile's row windows of A0 and B0
// (tc_window.cuh).
// The row product's depth is the extended tile, so it costs about
// 4 (tile_r + 2p) flops per output (3x for 3xTF32) against the band's
// 4(2p+1): the price of taking the row stage off the FMA units.
//
// Design: one block of 8 warps owns tile_r output rows and 32 columns.
// It loads the u tile, builds C from its columns' A1/B1 band rows and the
// row windows from its rows' A0/B0 band rows, each entry taken from its
// own row's band (the one-sided rows at the grid's edges included); the
// warps share the 16 x 16 blocks of the column product, then of the row
// product, whose result goes through shared memory (the u tile's space)
// to coalesced stores.
#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_fullmxu_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                        const T* __restrict__ a1, const T* __restrict__ b0,
                        const T* __restrict__ b1, T* __restrict__ y, int n0,
                        int n1, int tile_r) {
  const Tile<P> g(tile_r);
  const int rows = rnd(tile_r, 16);
  const int ldw = g.ldw();
  extern __shared__ __align__(128) unsigned char smem[];
  T* ut = reinterpret_cast<T*>(smem);
  T* ct = ut + g.u_elems();
  T* vw = ct + g.c_elems();
  T* aw = vw + g.vw_elems();
  T* bw = aw + rows * ldw;
  T* ys = ut;  // the y tile, once the column product has read the u tile

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * tile_r;
  const int j0 = blockIdx.x * TX;

  load_u_tile<T, P>(ut, u, g, i0, j0, n0, n1, tid, NT);
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);
  build_row_windows<T, P>(a0, b0, g, i0, n0, tid, NT,
                          [=](int r, int s, T a, T b) {
                            aw[r * ldw + s] = a;
                            bw[r * ldw + s] = b;
                          });
  __syncthreads();
  col_mma<T, P>(ut, ct, vw, nullptr, 0, g.m, warp, NW, lane);
  __syncthreads();

  // row stage: y[r0:r0+16, n0:n0+16] = A0w[r0 rows] . V + B0w[r0 rows] . W
  for (int task = warp; task < (rows / 16) * 2; task += NW) {
    const int r0 = (task / 2) * 16;
    const int c0 = (task % 2) * 16;
    Acc16<T> acc;
    acc.zero();
    acc.add(aw + r0 * ldw, ldw, vw + c0, LDV, g.m);
    acc.add(bw + r0 * ldw, ldw, vw + TX + c0, LDV, g.m);
    acc.store(ys + r0 * LDY + c0, LDY);
  }
  __syncthreads();
  const int j = j0 + lane;
  if (j >= n1) return;
  for (int r = warp; r < tile_r && i0 + r < n0; r += NW)
    y[static_cast<size_t>(i0 + r) * n1 + j] = ys[r * LDY + lane];
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem =
      sizeof(T) * (g.u_elems() + g.c_elems() + g.vw_elems() + g.w_elems());
  const int e = allow_smem(laplace2_fullmxu_kernel<T, P>, smem);
  if (e != 0) return e;
  const dim3 grid((n1 + TX - 1) / TX, (n0 + tile_r - 1) / tile_r);
  laplace2_fullmxu_kernel<T, P><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, tile_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int tile_r,
           void* stream) {
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GDM_TC_DISPATCH_P(p, launch_p<T, P>(u, a0, a1, b0, b1, y, n0, n1, tile_r, s))
}

}  // namespace

extern "C" {

int gdm_laplace2_fullmxu_apply_f32(const void* u, const void* a0,
                                   const void* a1, const void* b0,
                                   const void* b1, void* y, int p, int n0,
                                   int n1, int tile_r, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

int gdm_laplace2_fullmxu_apply_f64(const void* u, const void* a0,
                                   const void* a1, const void* b0,
                                   const void* b1, void* y, int p, int n0,
                                   int n1, int tile_r, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

}  // extern "C"
