// K3h: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T  with the
// column stage split by rows between the FMA units and the tensor cores.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_hybrid (the
// TPU schedule that splits the column stage by rows between the VPU and
// the MXU; no solve dispatch routes to it, in gdm or here).  Same
// operator, band tables and contiguous (n0, n1) node array as K3
// (laplace2.cu).
//
// Bound on the card: K3's (memory, 2.51 us at 1024^2 p = 3 in float32).
// The split is meant to let both units work at once; on this card they
// overlap only if different warps issue them, so the warps are
// specialised: with 0 < vpu_rows < tile_r + 2p, warps 0-3 run K3's
// shared-operand FMAs on rows [0, vpu_rows) of the extended tile and
// warps 4-7 K3c's window product on the rest, and one barrier joins them
// before the row stage, which all 8 warps run on the FMA units.  With
// vpu_rows = 0 all 8 warps run the product, with vpu_rows >= tile_r + 2p
// all 8 run the FMAs.  The 16-row block of the product that holds row
// vpu_rows goes through a warp's scratch tile, so the FMA warps' rows are
// never written twice.  gdm records that its TPU compiler serialised the
// two units (pallas_stencil2.py:1354-1360).
#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_hybrid_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                       const T* __restrict__ a1, const T* __restrict__ b0,
                       const T* __restrict__ b1, T* __restrict__ y, int n0,
                       int n1, int tile_r, int vpu_rows) {
  const Tile<P> g(tile_r);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ut = reinterpret_cast<T*>(smem);
  T* ct = ut + g.u_elems();
  T* vw = ct + g.c_elems();
  T* ra = vw + g.vw_elems();
  T* rb = ra + tile_r * Tile<P>::K;
  T* scr = ra + g.r_elems();  // NW / 2 scratch tiles of the MMA warps

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * tile_r;
  const int j0 = blockIdx.x * TX;
  const int vr = min(vpu_rows, g.t_ext);

  load_u_tile<T, P>(ut, u, g, i0, j0, n0, n1, tid, NT);
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);
  load_row_bands<T, P>(ra, rb, a0, b0, i0, n0, tile_r, tid, NT);
  __syncthreads();
  if (vr == 0) {
    col_mma<T, P>(ut, ct, vw, scr, 0, g.m, warp, NW, lane);
  } else if (vr >= g.t_ext) {
    col_fma<T, P>(ut, ct, vw, 0, g.t_ext, lane, warp, NW);
  } else if (warp < NW / 2) {
    col_fma<T, P>(ut, ct, vw, 0, vr, lane, warp, NW / 2);
  } else {
    const int mw = warp - NW / 2;
    col_mma<T, P>(ut, ct, vw, scr + mw * SCR, vr, g.m, mw, NW / 2, lane);
  }
  __syncthreads();
  row_fma<T, P>(vw, ra, rb, y, i0, j0, n0, n1, tile_r, lane, warp, NW);
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             int vpu_rows, cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem = sizeof(T) * (g.u_elems() + g.c_elems() + g.vw_elems() +
                                   g.r_elems() + NW / 2 * SCR);
  const int e = allow_smem(laplace2_hybrid_kernel<T, P>, smem);
  if (e != 0) return e;
  const dim3 grid((n1 + TX - 1) / TX, (n0 + tile_r - 1) / tile_r);
  laplace2_hybrid_kernel<T, P><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, tile_r,
      vpu_rows);
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

int gdm_laplace2_hybrid_apply_f32(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, int tile_r, int vpu_rows,
                                  void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, vpu_rows,
                       stream);
}

int gdm_laplace2_hybrid_apply_f64(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, int tile_r, int vpu_rows,
                                  void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, vpu_rows,
                        stream);
}

}  // extern "C"
