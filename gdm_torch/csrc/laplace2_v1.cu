// K0: gdm's v1 2D Laplace  y = A0 U A1^T + B0 U B1^T, rows first.
//
// Replaces gdm/ops/pallas_stencil.py::make_padded_laplace (the v1 fused
// TPU kernel: the row sweeps as one dense-banded product per tile at
// HIGHEST precision, [ts; tm] = B_i . uw, then the column sweeps as
// 2(2p+1) lane rolls; odd p <= 7, since its row halo is 8).  gdm builds
// it for the Laplace only, (A0, A1, B0, B1) = (S0, M1, M0, S1); the
// kernel takes K3's band tables and contiguous (n0, n1) node array
// (laplace2.cu), and runs K3's stages the other way round:
//   rows:    ts = A0w . U_ext, tm = B0w . U_ext on the tensor cores
//            (3xTF32 in float32, gdm's HIGHEST; DMMA in float64);
//   columns: y[r][x] = sum_t A1(j0 + x, t) ts[r][x + t]
//                     + B1(j0 + x, t) tm[r][x + t] on the FMA units.
//
// Bound on the card: K3's (memory, 8 bytes of u and y per node in
// float32: 2.51 us at 1024^2 p = 3).  The row product's depth is the
// extended tile, so it costs about 2 (tile_r + 2p) (32 + 2p) / 32 flops
// per output and product against the band's 2(2p+1), on units that are
// otherwise idle; its N side is the u tile's 32 + 2p columns rounded to
// 16, since the columns come second and need the halo.
//
// Design: one block of 8 warps owns tile_r output rows and 32 columns.
// It loads the u tile (tile_r + 2p rows and 32 + 2p columns, zeros
// outside the grid) with its columns padded to 16, builds the row
// windows A0w, B0w of its rows (tc_window.cuh, K3f's) and C from its
// columns' A1/B1 band rows; the warps share the 16 x 16 blocks of
// [ts; tm], which land in shared memory; after one barrier each warp runs
// the column FMAs for its rows, a lane per column, with coalesced stores.
#include "tc_window.cuh"

namespace {

using namespace gdm::tc;

template <typename T, int P>
struct V1Smem {
  // the u tile's columns, padded to the 16-column blocks of the row
  // product, and the pitch of the u tile and of ts, tm
  static constexpr int NP = rnd(Tile<P>::UW, 16);
  static constexpr int LDP = NP + 4;
  size_t u, w, c, t, total;  // byte offsets of U, A0w/B0w, C, ts/tm
  __host__ __device__ explicit V1Smem(const Tile<P>& g) {
    const size_t rows = rnd(g.tile_r, 16);
    const size_t wb = rnd128(sizeof(T) * rows * g.ldw());
    const size_t tb = rnd128(sizeof(T) * rows * LDP);
    u = 0;
    w = rnd128(sizeof(T) * g.m * LDP);
    c = w + 2 * wb;
    t = c + rnd128(sizeof(T) * g.c_elems());
    total = t + 2 * tb;
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_v1_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                   const T* __restrict__ a1, const T* __restrict__ b0,
                   const T* __restrict__ b1, T* __restrict__ y, int n0,
                   int n1, int tile_r) {
  using G = Tile<P>;
  using Smem = V1Smem<T, P>;
  constexpr int K = G::K;
  constexpr int NP = Smem::NP;
  constexpr int LDP = Smem::LDP;
  const G g(tile_r);
  const int rows = rnd(tile_r, 16);
  const int ldw = g.ldw();
  const Smem L(g);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ut = reinterpret_cast<T*>(smem + L.u);
  T* aw = reinterpret_cast<T*>(smem + L.w);
  T* bw = aw + (L.c - L.w) / (2 * sizeof(T));
  T* ct = reinterpret_cast<T*>(smem + L.c);
  T* ts = reinterpret_cast<T*>(smem + L.t);
  T* tm = ts + (L.total - L.t) / (2 * sizeof(T));

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = blockIdx.y * tile_r;
  const int j0 = blockIdx.x * TX;

  for (int e = tid; e < g.m * NP; e += NT) {
    const int r = e / NP;
    const int c = e % NP;
    const int gi = i0 - P + r;
    const int gj = j0 - P + c;
    const bool in = r < g.t_ext && c < G::UW && gi >= 0 && gi < n0 &&
                    gj >= 0 && gj < n1;
    ut[r * LDP + c] = in ? u[static_cast<size_t>(gi) * n1 + gj] : T(0);
  }
  build_row_windows<T, P>(a0, b0, g, i0, n0, tid, NT,
                          [=](int r, int s, T a, T b) {
                            aw[r * ldw + s] = a;
                            bw[r * ldw + s] = b;
                          });
  build_c<T, P>(ct, a1, b1, j0, n1, tid, NT);
  __syncthreads();

  // rows: ts = A0w . U, tm = B0w . U, 16 x 16 blocks shared by the warps
  constexpr int CB = NP / 16;
  const int per = (rows / 16) * CB;
  for (int task = warp; task < 2 * per; task += NW) {
    const bool second = task >= per;
    const int rem = task % per;
    const int r0 = (rem / CB) * 16;
    const int c0 = (rem % CB) * 16;
    Acc16<T> acc;
    acc.zero();
    acc.add((second ? bw : aw) + r0 * ldw, ldw, ut + c0, LDP, g.m);
    acc.store((second ? tm : ts) + r0 * LDP + c0, LDP);
  }
  __syncthreads();

  // columns on the FMA units, a lane per output column
  const int j = j0 + lane;
  if (j >= n1) return;
  for (int r = warp; r < tile_r && i0 + r < n0; r += NW) {
    const T* rs = ts + r * LDP + lane;
    const T* rm = tm + r * LDP + lane;
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const T* c = ct + (lane + t) * LDV + lane;
      acc = gdm::fma_(c[0], rs[t], acc);
      acc = gdm::fma_(c[TX], rm[t], acc);
    }
    y[static_cast<size_t>(i0 + r) * n1 + j] = acc;
  }
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int tile_r,
             cudaStream_t stream) {
  const Tile<P> g(tile_r);
  const size_t smem = V1Smem<T, P>(g).total;
  const int e = allow_smem(laplace2_v1_kernel<T, P>, smem);
  if (e != 0) return e;
  const dim3 grid((n1 + TX - 1) / TX, (n0 + tile_r - 1) / tile_r);
  laplace2_v1_kernel<T, P><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, tile_r);
  return static_cast<int>(cudaGetLastError());
}

// odd p <= 7, as gdm's K0 (its row halo H = 8 >= p)
template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int tile_r,
           void* stream) {
  if (tile_r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_p<T, 1>(u, a0, a1, b0, b1, y, n0, n1, tile_r, s);
    case 3: return launch_p<T, 3>(u, a0, a1, b0, b1, y, n0, n1, tile_r, s);
    case 5: return launch_p<T, 5>(u, a0, a1, b0, b1, y, n0, n1, tile_r, s);
    case 7: return launch_p<T, 7>(u, a0, a1, b0, b1, y, n0, n1, tile_r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_laplace2_v1_apply_f32(const void* u, const void* a0, const void* a1,
                              const void* b0, const void* b1, void* y, int p,
                              int n0, int n1, int tile_r, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

int gdm_laplace2_v1_apply_f64(const void* u, const void* a0, const void* a1,
                              const void* b0, const void* b1, void* y, int p,
                              int n0, int n1, int tile_r, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, tile_r, stream);
}

}  // extern "C"
