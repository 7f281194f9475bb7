// K3c: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with the
// column stage on the tensor cores and K3's row stage on the FMA units.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_mxucol (the
// TPU schedule that moves the column stage onto the MXU as per-block
// banded products; no solve dispatch routes to it, in gdm or here).  Same
// operator, band tables and contiguous (n0, n1) node array as K3
// (laplace2.cu); the tile stages are in tc_window.cuh.
//
// Bound on the card: the same function as K3, so the same bound: 8 bytes
// of u and y per node in float32 against 8(2p+1) flops of the band form,
// memory-bound (2.51 us at 1024^2).  K3's column stage is two FMAs and a
// shared-memory load per tap and output; here it is a dense window
// product, [V | W] = U_tile . C with C the (32 + 2p, rounded to 8) x 64
// slice of [A1^T | B1^T], so the tensor cores do about 2 KD 64 / 32 flops
// per output row and column (3x that for 3xTF32): more flops than the
// band form, on units that are otherwise idle.
//
// Design: one block of 8 warps owns tile_r output rows and 32 columns;
// it loads the u tile (tile_r + 2p rows, 32 + 2p columns, zeros outside
// the grid) and the tile's A0/B0 band rows, builds C from its columns'
// A1/B1 band rows, and its warps share the 16 x 16 blocks of the window
// product.  After one barrier all 8 warps run the row stage as K3.
#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_mxucol_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                       const T* __restrict__ a1, const T* __restrict__ b0,
                       const T* __restrict__ b1, T* __restrict__ y, int n0,
                       int n1, int tile_r) {
  const Tile<P> g(tile_r);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ut = reinterpret_cast<T*>(smem);
  T* ct = ut + g.u_elems();
  T* vw = ct + g.c_elems();
  T* ra = vw + g.vw_elems();
  T* rb = ra + tile_r * Tile<P>::K;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * tile_r;
  const int j0 = blockIdx.x * TX;

  load_u_tile<T, P>(ut, u, g, i0, j0, n0, n1, tid, NT);
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);
  load_row_bands<T, P>(ra, rb, a0, b0, i0, n0, tile_r, tid, NT);
  __syncthreads();
  col_mma<T, P>(ut, ct, vw, nullptr, 0, g.m, warp, NW, lane);
  __syncthreads();
  row_fma<T, P>(vw, ra, rb, y, i0, j0, n0, n1, tile_r, lane, warp, NW);
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem =
      sizeof(T) * (g.u_elems() + g.c_elems() + g.vw_elems() + g.r_elems());
  const int e = allow_smem(laplace2_mxucol_kernel<T, P>, smem);
  if (e != 0) return e;
  const dim3 grid((n1 + TX - 1) / TX, (n0 + tile_r - 1) / tile_r);
  laplace2_mxucol_kernel<T, P><<<grid, NT, smem, stream>>>(
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

int gdm_laplace2_mxucol_apply_f32(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, int tile_r, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

int gdm_laplace2_mxucol_apply_f64(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, int tile_r, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

}  // extern "C"
