// K5: the 3D GD Laplace apply with the plane coupling on the tensor cores
//
//   y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace3_mxu (:1599;
// its pallas_call at :1946), the 3D kernel gdm's dispatch
// best_padded_laplace takes while N0 + 2p <= 512: every 3D size a card
// holds in practice, the uncut Poisson CG operator and its multigrid
// levels included.  Same operator, band tables (N_d, 2p+1 row-major,
// band[a][k] = entry (a, a+k-p), zero outside the grid) and contiguous
// (n0, n1, n2) node array as K4 (laplace3.cu).
//
// Stages, as gdm's K5:
//   stage 1 (axis 2): A = U M2^T, B = U S2^T     band sums
//   stage 2 (axis 1): P = M1 A,  T = S1 A + M1 B band sums
//   stage 3 (axis 0): y = [S0 | M0] [P ; T]      a matrix product on the
//                                                tensor cores
// gdm puts axis 0 on the TPU's 128 lanes and multiplies by the whole
// dense (2 N0 x N0) coupling; here the t0 <= 16 output planes of a block
// need only the window of t0 + 2p planes around them, so a block
// multiplies a 16 x 2(16 + 2p) slice of [S0 | M0] by the window's
// [P ; T].
//
// Precision class: float32 runs the product as 3xTF32 (each operand
// split into hi = tf32(x) and lo = tf32(x - hi); hi.hi + hi.lo + lo.hi
// with float32 accumulation), the card's form of gdm's bf16x3; float64
// runs it on the DMMA units (m8n8k4, IEEE double).  Stages 1-2 run in
// the working precision on the FMA units.
//
// Bound on the card: the same function as K4; at 161^3, p = 3, about
// 14(2p+1) = 98 flops per output of the band form against 8 bytes of u
// and y in float32, so memory bounds it: 33 MB per apply, 10 us at 3.35
// TB/s.  What a block spends its time on instead: stages 1-2 on its
// window, (t0 + 2p)(t1 + 2p) rows of 2(2p+1) FMAs and (t0 + 2p) t1 rows
// of 3(2p+1), one shared-memory read per stage-1 tap; the copies of
// those (t0 + 2p)(t1 + 2p)(t2 + 2p) nodes of u, 4 bytes a lane; and the
// window product, 3 TF32 products of a 16 x 2(16 + 2p) slice by 256
// columns per block, which at 161^3 is no small share: the tensor cores
// multiply the whole band window, 2(16 + 2p) deep, where each output
// needs 2(2p + 1) terms.  Small levels are bound by a block's latency:
// set-up loads, one or two planes a warp, one barrier, the product.
//
// Design: one block, 8 warps, owns one box of the output: t0 <= 16
// planes (axis 0), t1 <= 8 rows (axis 1) and t2 <= 32 columns (axis 2),
// and walks nothing: there is no march along axis 0.  Warp w takes the
// window's planes w, w + 8, w + 16, ...; for each it copies the plane's
// (t1 + 2p) x (t2 + 2p) u tile into its own shared-memory slot, and lane
// c runs stage 1 down column c (the t1 + 2p values of A and B stay in
// registers) and then stage 2 on them (its band rows as 16-byte
// broadcast loads), writing the column's P and T into the window's
// [P ; T] in shared memory.  The warps work on different planes at the
// same time with no barrier between them (a warp waits only for its own
// copies, __syncwarp); one block barrier after the set-up, one before
// the product.  Then warp w multiplies the C slice by the 32 columns of
// tile row w (wmma fragments) and stores that row of every output plane
// straight from its staged result.  Per warp, `NS` slots (1, 2 or 3),
// all issued before the block's set-up: with more than one, the next
// planes' copies are in flight while the warp computes this one; with
// one, the block's shared memory fits three blocks on an SM at p = 3 in
// float32, and the other blocks' warps hide the copies.
//
// The launch plan (tiles, slots) comes from Python,
// gdm_torch/ops/stencil3.py::k5_plan, and the box extents from an even
// split of each axis into the plan's number of tiles: every block holds
// the floor or the ceiling of n / tiles along each axis, so the +1 node
// of a 2^k + 1 count widens a neighbour's box instead of launching a box
// one node wide (the old launcher's sliver tiles).  Small levels take
// smaller boxes, so that 65^3 and 33^3 launch a block for each SM.
//
// Loads: the node array keeps gdm's contiguous layout, whose row pitch
// n2 * 4 bytes is not a multiple of 16 for odd n2, so neither TMA tiled
// tensor maps (16-byte global strides) nor 16-byte vector loads can
// describe a tile.  A warp copies each row of a tile with 4-byte
// cp.async, lane c to column c (and c + 32 for the halo): each
// instruction takes up to 128 contiguous bytes, zero-filled outside the
// grid.  (Bulk copies of whole rows, rounded out to 16 bytes, would read
// the neighbouring rows' nodes where the halo needs zeros and past the
// array's ends; the small levels, where they would fit one plane range,
// are bound by latency, not by the copies.)
// The degree p is a template parameter (odd p <= 7), so the tap loops
// unroll.
#include <cstddef>
#include <type_traits>

#include <mma.h>

#include "common.cuh"
#include "tc_window.cuh"

namespace {

using namespace nvcuda;
using gdm::tc::split_tf32;

constexpr int TX = 32;         // columns per box (axis 2): one warp's lanes
constexpr int TY = 8;          // rows per box (axis 1): one per warp
constexpr int NW = 8;          // warps per block
constexpr int NT = 32 * NW;
constexpr int T0 = 16;         // planes per box (axis 0): the product's rows
constexpr int NC = TY * TX;    // columns of the product
constexpr int LDP = NC + 8;    // row pitch of [P ; T] and of the y stage
constexpr int SMEM_SM = 233472;  // shared memory of an H100 SM, bytes

constexpr int rnd32(int n) { return (n + 31) / 32 * 32; }
constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int imin(int a, int b) { return a < b ? a : b; }

template <typename T, int P, int NS>
struct Geom {
  static constexpr int K = 2 * P + 1;
  static constexpr int W = T0 + 2 * P;             // planes in a window
  static constexpr int KD = (2 * W + 7) / 8 * 8;   // depth of the product
  static constexpr int LDC = KD + 8;               // row pitch of the C slice
  static constexpr int UW = TX + 2 * P;
  static constexpr int UH = TY + 2 * P;
  static constexpr int USZ = rnd32(UH * UW);       // one u slot
  // offsets in elements of T; every array starts on 32 elements, so
  // every wmma pointer is 32-byte aligned
  static constexpr int PT = 0;                     // KD x LDP: [P ; T]
  static constexpr int CT = PT + rnd32(KD * LDP);  // T0 x LDC: C slice
  static constexpr int US = CT + rnd32(T0 * LDC);  // NW x NS u slots, later
                                                   // the T0 x LDP y stage
  static constexpr int KP = (K + 3) / 4 * 4;       // band row pitch
  static constexpr int C1M = US + rnd32(imax(NW * NS * USZ, T0 * LDP));
  static constexpr int C1S = C1M + rnd32(TY * KP);  // TY x KP: S1 rows
  static constexpr size_t BYTES = sizeof(T) * (C1S + rnd32(TY * KP));
  static constexpr bool FITS = BYTES <= 232448;  // an H100 block's smem
  // blocks an SM holds by shared memory (1 KB reserved per block), at
  // most 3: the register budget __launch_bounds__ asks for
  static constexpr int MIN_BLOCKS =
      imax(1, imin(3, SMEM_SM / static_cast<int>(BYTES + 1024)));
};

// ys[0:T0, warp's 32 columns] = ct[0:T0, 0:KD] . pt[0:KD, warp's columns]
template <typename T, int P, int NS>
__device__ __forceinline__ void window_product(const T* ct, const T* pt,
                                               T* ys, int warp) {
  using G = Geom<T, P, NS>;
  const int n0 = warp * 32;
  if constexpr (std::is_same<T, float>::value) {
    using FA = wmma::fragment<wmma::matrix_a, 16, 16, 8,
                              wmma::precision::tf32, wmma::row_major>;
    using FB = wmma::fragment<wmma::matrix_b, 16, 16, 8,
                              wmma::precision::tf32, wmma::row_major>;
    wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < G::KD; k0 += 8) {
      FA a_hi, a_lo;
      wmma::load_matrix_sync(a_hi, ct + k0, G::LDC);
      split_tf32(a_hi, a_lo);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        FB b_hi, b_lo;
        wmma::load_matrix_sync(b_hi, pt + k0 * LDP + n0 + 16 * f, LDP);
        split_tf32(b_hi, b_lo);
        // the small terms first
        wmma::mma_sync(acc[f], a_lo, b_hi, acc[f]);
        wmma::mma_sync(acc[f], a_hi, b_lo, acc[f]);
        wmma::mma_sync(acc[f], a_hi, b_hi, acc[f]);
      }
    }
    wmma::store_matrix_sync(ys + n0, acc[0], LDP, wmma::mem_row_major);
    wmma::store_matrix_sync(ys + n0 + 16, acc[1], LDP, wmma::mem_row_major);
  } else {
    using FA = wmma::fragment<wmma::matrix_a, 8, 8, 4, double,
                              wmma::row_major>;
    using FB = wmma::fragment<wmma::matrix_b, 8, 8, 4, double,
                              wmma::row_major>;
    wmma::fragment<wmma::accumulator, 8, 8, 4, double> acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[m][n], 0.0);
#pragma unroll
    for (int k0 = 0; k0 < G::KD; k0 += 4) {
      FA a[2];
      wmma::load_matrix_sync(a[0], ct + k0, G::LDC);
      wmma::load_matrix_sync(a[1], ct + 8 * G::LDC + k0, G::LDC);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FB b;
        wmma::load_matrix_sync(b, pt + k0 * LDP + n0 + 8 * n, LDP);
        wmma::mma_sync(acc[0][n], a[0], b, acc[0][n]);
        wmma::mma_sync(acc[1][n], a[1], b, acc[1][n]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(ys + 8 * m * LDP + n0 + 8 * n, acc[m][n],
                                LDP, wmma::mem_row_major);
  }
}

// box b of an axis of n nodes cut into nt boxes: [start, start + size)
__device__ __forceinline__ void box(int n, int nt, int b, int& start,
                                    int& size) {
  const int base = n / nt;
  const int rem = n - base * nt;
  start = b * base + min(b, rem);
  size = base + (b < rem ? 1 : 0);
}

template <typename T, int P, int NS>
__global__ void __launch_bounds__(NT, (Geom<T, P, NS>::MIN_BLOCKS))
laplace3_mxu_kernel(const T* __restrict__ u, const T* __restrict__ s0,
                    const T* __restrict__ m0, const T* __restrict__ s1,
                    const T* __restrict__ m1, const T* __restrict__ s2,
                    const T* __restrict__ m2, T* __restrict__ y, int n0,
                    int n1, int n2) {
  using G = Geom<T, P, NS>;
  constexpr int K = G::K;
  constexpr int KP = G::KP;
  constexpr int W = G::W;
  constexpr int KD = G::KD;
  constexpr int UW = G::UW;
  constexpr int UH = G::UH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T* pt = base + G::PT;
  T* ct = base + G::CT;
  T* ys = base + G::US;
  T* c1m = base + G::C1M;
  T* c1s = base + G::C1S;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int a0, t0, i1_0, t1, i2_0, t2;
  box(n0, gridDim.z, blockIdx.z, a0, t0);
  box(n1, gridDim.y, blockIdx.y, i1_0, t1);
  box(n2, gridDim.x, blockIdx.x, i2_0, t2);
  const size_t plane = static_cast<size_t>(n1) * n2;
  const int wa = t0 + 2 * P;  // window planes in use
  const int uh = t1 + 2 * P;  // u tile rows in use
  const int uw = t2 + 2 * P;  // u tile columns in use
  T* slots = base + G::US + warp * NS * G::USZ;

  // window plane j's u tile into slot s, asynchronously, a row at a
  // time: the lane's columns lane and lane + 32 of the t2 + 2p in use;
  // nothing for a plane outside the window or the grid (uniform across
  // the warp)
  const int gc = i2_0 - P + lane;
  const bool col0 = lane < uw;
  const bool in0 = gc >= 0 && gc < n2;
  const bool col1 = lane + 32 < uw;
  const bool in1 = gc + 32 < n2;
  auto issue = [&](int j, int s) {
    const int q = a0 - P + j;
    if (j >= wa || q < 0 || q >= n0) return;
    const T* uq = u + static_cast<size_t>(q) * plane + gc;
    T* dst = slots + s * G::USZ + lane;
    for (int r = 0; r < uh; ++r) {
      const int g1 = i1_0 - P + r;
      const bool row = g1 >= 0 && g1 < n1;
      const T* src = uq + static_cast<size_t>(row ? g1 : 0) * n2;
      if (col0)
        gdm::copy_async(dst + r * UW, row && in0 ? src : u, row && in0);
      if (col1)
        gdm::copy_async(dst + r * UW + 32, row && in1 ? src + 32 : u,
                        row && in1);
    }
  };

  // this warp's first NS planes in flight before the set-up
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    issue(warp + NW * s, s);
    gdm::commit_group();
  }

  // C slice: column j (< W) of row i is S0(a0 + i, a0 - p + j), column
  // W + j the same entry of M0; zero off the band and below row t0
#pragma unroll
  for (int e = tid; e < T0 * KD; e += NT) {
    const int i = e / KD;
    const int col = e - i * KD;
    T v = T(0);
    if (col < 2 * W && i < t0) {
      const bool mass = col >= W;
      const int k = (mass ? col - W : col) - i;
      if (k >= 0 && k < K)
        v = (mass ? m0 : s0)[static_cast<size_t>(a0 + i) * K + k];
    }
    ct[i * G::LDC + col] = v;
  }
  // stage 2's band rows, at a pitch of KP (16-byte loads)
#pragma unroll
  for (int e = tid; e < TY * KP; e += NT) {
    const int r = e / KP;
    const int t = e - r * KP;
    const bool in = r < t1 && t < K;
    const size_t at = static_cast<size_t>(i1_0 + r) * K + t;
    c1m[e] = in ? m1[at] : T(0);
    c1s[e] = in ? s1[at] : T(0);
  }
  // the depth padding rows of [P ; T] stay zero
#pragma unroll
  for (int e = tid; e < (KD - 2 * W) * LDP; e += NT) pt[2 * W * LDP + e] = T(0);
  // lane's column of the stage-1 bands
  T m2r[K], s2r[K];
  {
    const bool in = lane < t2;
    const size_t at = static_cast<size_t>(i2_0 + (in ? lane : 0)) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      m2r[t] = in ? m2[at + t] : T(0);
      s2r[t] = in ? s2[at + t] : T(0);
    }
  }
  __syncthreads();  // C slice and stage-2 rows in place

  // stages 1-2, one window plane per warp at a time
  int k = 0;
  for (int j = warp; j < W; j += NW, ++k) {
    gdm::wait_group<NS - 1>();  // plane j's copies have landed
    __syncwarp();
    const int q = a0 - P + j;
    T* pr = pt + j * LDP + lane;        // P rows: pr[r * TX]
    T* tr = pt + (W + j) * LDP + lane;  // T rows
    if (j >= wa || q < 0 || q >= n0) {  // uniform across the warp
#pragma unroll
      for (int r = 0; r < TY; ++r) {
        pr[r * TX] = T(0);
        tr[r * TX] = T(0);
      }
    } else if (lane < t2) {
      const T* slot = slots + (k % NS) * G::USZ + lane;
      // stage 1: A[r] = sum_t M2[c][t] U[r][c + t], B with S2
      T av[UH], bv[UH];
#pragma unroll
      for (int r = 0; r < UH; ++r) {
        T a = T(0);
        T b = T(0);
        if (r < uh) {
          const T* row = slot + r * UW;
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const T x = row[t];
            a = gdm::fma_(m2r[t], x, a);
            b = gdm::fma_(s2r[t], x, b);
          }
        }
        av[r] = a;
        bv[r] = b;
      }
      // stage 2: P = M1 A, T = S1 A + M1 B
#pragma unroll
      for (int r = 0; r < TY; ++r) {
        T pv = T(0);
        T tv = T(0);
        if (r < t1) {
          T cm[KP], cs[KP];
          gdm::load_row16(c1m + r * KP, cm);
          gdm::load_row16(c1s + r * KP, cs);
#pragma unroll
          for (int t = 0; t < K; ++t) {
            pv = gdm::fma_(cm[t], av[r + t], pv);
            tv = gdm::fma_(cs[t], av[r + t], tv);
            tv = gdm::fma_(cm[t], bv[r + t], tv);
          }
        }
        pr[r * TX] = pv;
        tr[r * TX] = tv;
      }
    }
    __syncwarp();  // every lane is done with the slot before its refill
    issue(j + NW * NS, k % NS);
    gdm::commit_group();
  }
  gdm::wait_group<0>();
  __syncthreads();  // [P ; T] complete; the u slots become the y stage

  // stage 3: warp w owns tile row w (the product's columns 32w ..)
  if (warp < t1) {
    window_product<T, P, NS>(ct, pt, ys, warp);
    __syncwarp();
    if (lane < t2) {
      T* yb = y + static_cast<size_t>(a0) * plane +
              static_cast<size_t>(i1_0 + warp) * n2 + i2_0 + lane;
      const T* yr = ys + warp * TX + lane;
      for (int i = 0; i < t0; ++i)
        yb[static_cast<size_t>(i) * plane] = yr[i * LDP];
    }
  }
}

// the kernel's shared memory above 48 KB, and the SM's whole carveout
// for shared memory, so that MIN_BLOCKS blocks fit an SM
// (once per kernel and process)
template <typename T, int P, int NS>
int prepare() {
  static int err = -1;
  if (err < 0) {
    cudaError_t e = cudaFuncSetAttribute(
        laplace3_mxu_kernel<T, P, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Geom<T, P, NS>::BYTES));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(laplace3_mxu_kernel<T, P, NS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    err = static_cast<int>(e);
  }
  return err;
}

// blocks of the kernel an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
template <typename T, int P, int NS>
int occupancy(int* blocks) {
  const int err = prepare<T, P, NS>();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, laplace3_mxu_kernel<T, P, NS>, NT, Geom<T, P, NS>::BYTES));
}

template <typename T, int P, int NS>
int launch_pn(const void* u, const void* s0, const void* m0, const void* s1,
              const void* m1, const void* s2, const void* m2, void* y, int n0,
              int n1, int n2, const dim3& grid, cudaStream_t stream) {
  constexpr size_t smem = Geom<T, P, NS>::BYTES;
  static_assert(Geom<T, P, NS>::FITS, "K5 box exceeds an H100 block's smem");
  const int err = prepare<T, P, NS>();
  if (err != 0) return err;
  laplace3_mxu_kernel<T, P, NS><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(s0),
      static_cast<const T*>(m0), static_cast<const T*>(s1),
      static_cast<const T*>(m1), static_cast<const T*>(s2),
      static_cast<const T*>(m2), static_cast<T*>(y), n0, n1, n2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_p(const void* u, const void* s0, const void* m0, const void* s1,
             const void* m1, const void* s2, const void* m2, void* y, int n0,
             int n1, int n2, const dim3& grid, int slots,
             cudaStream_t stream) {
  if (slots == 1)
    return launch_pn<T, P, 1>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, grid,
                              stream);
  if constexpr (Geom<T, P, 2>::FITS) {
    if (slots == 2)
      return launch_pn<T, P, 2>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,
                                grid, stream);
  }
  if constexpr (Geom<T, P, 3>::FITS) {
    if (slots == 3)
      return launch_pn<T, P, 3>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,
                                grid, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// grid (nt2, nt1, nt0): the plan's number of boxes along axes 2, 1, 0;
// each box must fit TX x TY x T0
template <typename T>
int launch(const void* u, const void* s0, const void* m0, const void* s1,
           const void* m1, const void* s2, const void* m2, void* y, int p,
           int n0, int n1, int n2, int nt0, int nt1, int nt2, int slots,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fits = [](int n, int nt, int most) {
    return nt >= 1 && nt <= n && (n + nt - 1) / nt <= most && nt <= 65535;
  };
  if (!fits(n0, nt0, T0) || !fits(n1, nt1, TY) || !fits(n2, nt2, TX))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nt2, nt1, nt0);
  switch (p) {
    case 1: return launch_p<T, 1>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,
                                  grid, slots, s);
    case 3: return launch_p<T, 3>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,
                                  grid, slots, s);
    case 5: return launch_p<T, 5>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,
                                  grid, slots, s);
    case 7: return launch_p<T, 7>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,
                                  grid, slots, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int occupancy_t(int slots, int* blocks) {
  switch (slots) {
    case 1: return occupancy<T, 3, 1>(blocks);
    case 2: return occupancy<T, 3, 2>(blocks);
    case 3: return occupancy<T, 3, 3>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// blocks per SM of K5 at p = 3 (the solves' degree) with ``slots``
int gdm_laplace3_mxu_occupancy(int slots, int f64, int* blocks) {
  return f64 ? occupancy_t<double>(slots, blocks)
             : occupancy_t<float>(slots, blocks);
}

int gdm_laplace3_mxu_apply_f32(const void* u, const void* s0, const void* m0,
                               const void* s1, const void* m1, const void* s2,
                               const void* m2, void* y, int p, int n0, int n1,
                               int n2, int nt0, int nt1, int nt2, int slots,
                               void* stream) {
  return launch<float>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, nt0, nt1,
                       nt2, slots, stream);
}

int gdm_laplace3_mxu_apply_f64(const void* u, const void* s0, const void* m0,
                               const void* s1, const void* m1, const void* s2,
                               const void* m2, void* y, int p, int n0, int n1,
                               int n2, int nt0, int nt1, int nt2, int slots,
                               void* stream) {
  return launch<double>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, nt0,
                        nt1, nt2, slots, stream);
}

}  // extern "C"
