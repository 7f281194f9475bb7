// K3: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2 (its
// pallas_call at :566, the float32-exact body kernel_vpu at :197), the
// TPU kernel behind gdm/ops/fast.py::best_field_laplace, which carries
// the CG operator and every multigrid level of the uncut Poisson solve.
// The default bands are the GD Laplace (A0, A1, B0, B1) = (S0, M1, M0,
// S1); any four banded factors may be given.  Each factor is a (N_d,
// 2p+1) row-major band table with band[a][k] = entry (a, a+k-p), zero
// where a+k-p falls outside [0, N_d), so reading zeros beyond the grid
// edge is exact.  U and y are the contiguous (n0, n1) node array: no
// guard rows and no lane padding (the TPU kernel padded both for its
// aligned DMAs).
//
// Bound on the card: at 1025^2, p = 3, each output costs 8(2p+1) = 56
// flops against 8 bytes of u and y in float32, about 7 flops per byte,
// well below the H100's flop-per-byte balance, so the floor is memory:
// 8.4 MB per apply, 2.5 us at 3.35 TB/s (less when the applies repeat
// and u stays in the 50 MB L2).  In practice a launch is bound by its
// blocks' latency (copy the tile, one barrier, compute, store) and by
// how many blocks the card holds at once: below 513^2 the grid cannot
// fill the card, and the old 32 x 32 tile body took two waves at 1025^2
// (1089 blocks of 256 threads, 1056 resident).
//
// Design: one block of NTY = 4 warps owns a tile of t2 <= 32 columns
// (one a lane) and t0 <= 4 rs rows, and each warp a row segment of rs
// rows of it (rs = 2, 4 or 8, a template parameter).  The block copies
// the tile of U with a p-wide halo (zeros outside the grid) and the tile
// rows' A0 and B0 band rows into shared memory with cp.async, one
// barrier.  Then lane c of a warp walks down column c of its segment:
// for each of its rs + 2p rows of U it runs the column stage,
// V[r][c] = sum_t A1[c][t] U[r][c + t - p] and W with B1, and keeps the
// values in registers; each output row of the segment then takes its
// row stage from them, y[i][c] = sum_t A0[i][t] V[i + t - p][c] +
// sum_t B0[i][t] W[i + t - p][c] (the A0 and B0 sums apart, then added,
// as the plain twin does; the band rows come as 16-byte broadcast
// loads).  V and W never go through shared memory, so the old body's
// second barrier and its V/W round trip are gone; each warp recomputes
// the 2p halo rows of its segment instead (rs + 2p rows for rs
// outputs).  A1 and B1 of the lane's column stay in registers for
// p <= 7 and in shared memory above, where rs is 2 (a thread keeps
// 2(2p + 1 + rs) values of V and W; ptxas reports no spill).
//
// The launch plan comes from Python, gdm_torch/ops/stencil2.py::k3_plan:
// (ntr, ntc) tiles along rows and columns, each axis split evenly (a
// tile holds the floor or the ceiling of n / tiles, so a 2^k + 1 count
// makes no sliver tile one column wide), and rs: 8 while the grid keeps
// 32768 threads busy (1025^2: 33 x 33 tiles of 32 x 32, all resident at
// once with nine blocks an SM, which __launch_bounds__ asks for in
// float32 at p <= 3), 2 at 257^2 and below (tiles of 8 rows, so that
// more SMs work on the small levels).
//
// Loads: the row pitch n1 * 4 bytes is not a multiple of 16 for odd n1,
// so neither TMA tiled tensor maps nor 16-byte vector loads can describe
// a tile row; a warp copies each row of the tile with 4-byte cp.async,
// lane c to column c (and c + 32 for the halo), each instruction up to
// 128 contiguous bytes, zero-filled outside the grid.  The degree p is a
// template parameter (odd p <= 15), so the tap loops unroll.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int TX = 32;    // columns of a tile: one warp's lanes
constexpr int NTY = 4;    // warps per block: row segments of a tile
constexpr int NT = TX * NTY;
constexpr int SMEM_BLOCK = 232448;

template <typename T, int P, int RS>
struct Geom {
  static constexpr int K = 2 * P + 1;
  static constexpr int KP = (K + 3) / 4 * 4;   // band row pitch: 16-byte loads
  static constexpr int TY = NTY * RS;          // rows of a tile
  static constexpr int UW = TX + 2 * P;        // pitch of the u tile
  static constexpr int UH = TY + 2 * P;
  static constexpr int RA = UH * UW;           // TY x KP: A0 rows, then B0
  static constexpr bool COEF_REGS = P <= 7;    // A1, B1 in registers
  static constexpr int CS = RA + 2 * TY * KP;  // 2K x TX: A1, B1 above p = 7
  static constexpr size_t BYTES =
      sizeof(T) * (CS + (COEF_REGS ? 0 : 2 * K * TX));
  static_assert(BYTES <= SMEM_BLOCK, "K3 tile exceeds an H100 block's smem");
  // float32 at p <= 3, the solves' case: registers for nine blocks of 128
  // threads on an SM (56 a thread), so that 1025^2 (1089 tiles) runs in
  // one wave on 132 SMs
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 && P <= 3 ? 9 : 1;
};

template <typename T, int P, int RS>
__global__ void __launch_bounds__(NT, (Geom<T, P, RS>::MIN_BLOCKS))
laplace2_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                const T* __restrict__ a1, const T* __restrict__ b0,
                const T* __restrict__ b1, T* __restrict__ y, int n0, int n1,
                int ntr, int ntc) {
  using G = Geom<T, P, RS>;
  constexpr int K = G::K;
  constexpr int KP = G::KP;
  constexpr int UW = G::UW;
  constexpr int NV = RS + 2 * P;  // rows of V and W a thread keeps
  extern __shared__ __align__(16) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);  // UH x UW: the u tile with its halo
  T* ra_s = us + G::RA;                // TY x KP: the tile rows' A0 bands
  T* rb_s = ra_s + G::TY * KP;         // TY x KP: B0
  T* cs = us + G::CS;                  // 2K x TX: A1, B1 when not in registers
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the tile: rows [i0, i0 + t0), columns [j0, j0 + t2), even splits
  const int tr = blockIdx.x / ntc;
  const int tc = blockIdx.x - tr * ntc;
  int base = n0 / ntr;
  int rem = n0 - base * ntr;
  const int i0 = tr * base + min(tr, rem);
  const int t0 = base + (tr < rem ? 1 : 0);
  base = n1 / ntc;
  rem = n1 - base * ntc;
  const int j0 = tc * base + min(tc, rem);
  const int t2 = base + (tc < rem ? 1 : 0);

  // the u tile, a row per warp at a time: the lane's columns lane and
  // lane + 32 of the t2 + 2p in use, zero outside the grid
  const int uw = t2 + 2 * P;
  const int gj = j0 - P + lane;
  const bool col0 = lane < uw;
  const bool in0 = gj >= 0 && gj < n1;
  const bool col1 = lane + 32 < uw;
  const bool in1 = gj + 32 < n1;
  for (int r = warp; r < t0 + 2 * P; r += NTY) {
    const int gi = i0 - P + r;
    const bool row = gi >= 0 && gi < n0;
    const T* src = u + static_cast<size_t>(row ? gi : 0) * n1 + gj;
    if (col0)
      gdm::copy_async(us + r * UW + lane, row && in0 ? src : u, row && in0);
    if (col1)
      gdm::copy_async(us + r * UW + lane + 32, row && in1 ? src + 32 : u,
                      row && in1);
  }
  // the tile rows' A0 and B0 bands, contiguous in the tables
  for (int e = threadIdx.x; e < t0 * K; e += NT) {
    const int k = e / K;
    const int t = e - k * K;
    const size_t at = static_cast<size_t>(i0) * K + e;
    gdm::copy_async(ra_s + k * KP + t, a0 + at, true);
    gdm::copy_async(rb_s + k * KP + t, b0 + at, true);
  }
  gdm::commit_group();
  // A1 and B1 of the lane's column, while the copies fly
  const bool live = lane < t2;
  const size_t at = static_cast<size_t>(j0 + (live ? lane : 0)) * K;
  T ca[G::COEF_REGS ? K : 1], cb[G::COEF_REGS ? K : 1];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const T va = live ? a1[at + t] : T(0);
    const T vb = live ? b1[at + t] : T(0);
    if constexpr (G::COEF_REGS) {
      ca[t] = va;
      cb[t] = vb;
    } else if (warp == 0) {
      cs[t * TX + lane] = va;
      cs[(K + t) * TX + lane] = vb;
    }
  }
  gdm::wait_group<0>();
  __syncthreads();

  // warp w: output rows r0 .. r0 + rs of the tile
  const int r0 = warp * RS;
  if (r0 >= t0) return;
  const int rs = min(RS, t0 - r0);
  // column stage down the lane's column: V[q] = sum_t A1[c][t] U[r0 + q][c
  // + t] (tile coordinates, halo included), W with B1, all in registers
  T v[NV], w[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    T a = T(0);
    T b = T(0);
    if (q < rs + 2 * P) {
      const T* row = us + (r0 + q) * UW + lane;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const T x = row[t];
        if constexpr (G::COEF_REGS) {
          a = gdm::fma_(ca[t], x, a);
          b = gdm::fma_(cb[t], x, b);
        } else {
          a = gdm::fma_(cs[t * TX + lane], x, a);
          b = gdm::fma_(cs[(K + t) * TX + lane], x, b);
        }
      }
    }
    v[q] = a;
    w[q] = b;
  }
  // row stage: y[i][c] = sum_t A0[i][t] V[i + t - p][c] + B0[i][t] W[...],
  // the A0 and B0 sums apart, then added
  T* yc = y + static_cast<size_t>(i0 + r0) * n1 + j0 + lane;
#pragma unroll
  for (int k = 0; k < RS; ++k) {
    if (k < rs) {
      T ra[KP], rb[KP];
      gdm::load_row16(ra_s + (r0 + k) * KP, ra);
      gdm::load_row16(rb_s + (r0 + k) * KP, rb);
      T acc_a = T(0);
      T acc_b = T(0);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        acc_a = gdm::fma_(ra[t], v[k + t], acc_a);
        acc_b = gdm::fma_(rb[t], w[k + t], acc_b);
      }
      if (live) yc[static_cast<size_t>(k) * n1] = acc_a + acc_b;
    }
  }
}

// the kernel's shared memory above 48 KB and the SM's whole carveout for
// shared memory (once per kernel and process)
template <typename T, int P, int RS>
int prepare() {
  static int err = -1;
  if (err < 0) {
    cudaError_t e = cudaFuncSetAttribute(
        laplace2_kernel<T, P, RS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Geom<T, P, RS>::BYTES));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(laplace2_kernel<T, P, RS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    err = static_cast<int>(e);
  }
  return err;
}

template <typename T, int P, int RS>
int launch_prs(const void* u, const void* a0, const void* a1, const void* b0,
               const void* b1, void* y, int n0, int n1, int ntr, int ntc,
               cudaStream_t stream) {
  const int err = prepare<T, P, RS>();
  if (err != 0) return err;
  laplace2_kernel<T, P, RS><<<ntr * ntc, NT, Geom<T, P, RS>::BYTES, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, ntr, ntc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int ntr, int ntc,
             int rs, cudaStream_t stream) {
  if constexpr (P > 7) {  // 2(2p + 1 + rs) live values a thread: rs = 2 only
    if (rs != 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch_prs<T, P, 2>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc,
                               stream);
  } else {
    switch (rs) {
      case 2: return launch_prs<T, P, 2>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, stream);
      case 4: return launch_prs<T, P, 4>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, stream);
      case 8: return launch_prs<T, P, 8>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

// (ntr, ntc): the plan's tiles along rows and columns; rs: output rows a
// thread (a tile is NTY rs rows by at most 32 columns)
template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int ntr, int ntc,
           int rs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntr < 1 || ntr > n0 || ntc < 1 || ntc > n1 ||
      (n1 + ntc - 1) / ntc > TX || (n0 + ntr - 1) / ntr > NTY * rs ||
      static_cast<long long>(ntr) * ntc > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p) {
    case 1: return launch_p<T, 1>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 3: return launch_p<T, 3>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 5: return launch_p<T, 5>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 7: return launch_p<T, 7>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 9: return launch_p<T, 9>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 11: return launch_p<T, 11>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 13: return launch_p<T, 13>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    case 15: return launch_p<T, 15>(u, a0, a1, b0, b1, y, n0, n1, ntr, ntc, rs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// blocks of the kernel an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T, int P, int RS>
int occupancy(int* blocks) {
  const int err = prepare<T, P, RS>();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, laplace2_kernel<T, P, RS>, NT, Geom<T, P, RS>::BYTES));
}

template <typename T>
int occupancy_t(int rs, int* blocks) {
  switch (rs) {
    case 2: return occupancy<T, 3, 2>(blocks);
    case 4: return occupancy<T, 3, 4>(blocks);
    case 8: return occupancy<T, 3, 8>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_laplace2_apply_f32(const void* u, const void* a0, const void* a1,
                           const void* b0, const void* b1, void* y, int p,
                           int n0, int n1, int ntr, int ntc, int rs,
                           void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, ntr, ntc, rs,
                       stream);
}

int gdm_laplace2_apply_f64(const void* u, const void* a0, const void* a1,
                           const void* b0, const void* b1, void* y, int p,
                           int n0, int n1, int ntr, int ntc, int rs,
                           void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, ntr, ntc, rs,
                        stream);
}

// blocks per SM of K3 at p = 3 (the solves' degree) with rs rows a thread
int gdm_laplace2_occupancy(int rs, int f64, int* blocks) {
  return f64 ? occupancy_t<double>(rs, blocks)
             : occupancy_t<float>(rs, blocks);
}

}  // extern "C"
