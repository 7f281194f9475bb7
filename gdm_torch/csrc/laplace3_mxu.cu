// K5: the 3D GD Laplace apply with the plane coupling on the tensor cores
//
//   y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace3_mxu (the 3D
// kernel gdm's dispatch best_padded_laplace takes while N0 + 2p <= 512:
// every 3D size a card holds in practice, the uncut Poisson CG operator
// and its multigrid levels included).  Same operator, band tables
// (N_d, 2p+1 row-major, band[a][k] = entry (a, a+k-p), zero outside the
// grid) and contiguous (n0, n1, n2) node array as K4 (laplace3.cu).
//
// Stages, as gdm's K5:
//   stage 1 (axis 2): A = U M2^T, B = U S2^T     band sums
//   stage 2 (axis 1): P = M1 A,  T = S1 A + M1 B band sums
//   stage 3 (axis 0): y = [S0 | M0] [P ; T]      a matrix product on the
//                                                tensor cores
// gdm puts axis 0 on the TPU's 128 lanes and multiplies by the whole
// dense (2 W0 x W0) coupling; here output planes a .. a+16 need only the
// window of planes [a-p, a+16+p), so a block multiplies a 16 x 2(16+2p)
// slice of [S0 | M0], rebuilt per window, by the window's [P ; T].
//
// Precision class: float32 runs the product as 3xTF32 (each operand
// split into hi = tf32(x) and lo = tf32(x - hi); hi.hi + hi.lo + lo.hi
// with float32 accumulation), the card's form of gdm's bf16x3; float64
// runs it on the DMMA units (m8n8k4, IEEE double).  Stages 1-2 run in
// the working precision on the FMA units.
//
// Bound on the card: the same function as K4; at 160^3, p = 3, about
// 14(2p+1) = 98 flops per output of the band form against 8 bytes of u
// and y in float32, so memory bounds it: 33 MB per apply, 10 us at 3.35
// TB/s.  The dense window product does 2 * 2(16+2p) flops per output
// per split product (3x at float32) on the tensor cores, about 1.2 GFLOP
// of TF32 at 161^3 (2.4 us at 495 TFLOP/s), so it stays under that
// bound; what the design keeps down is the shared-memory traffic of
// stages 1-2, as in K4.
//
// Design: a block owns a TY x TX (8 x 32) column of nodes along axes 1
// and 2 and marches along axis 0 over a chunk of planes (a multiple of
// 16).  For each plane it takes the u tile with a p-wide halo on axes 1
// and 2 from a two-slot cp.async ring (the next plane's tile is in flight
// while the block computes this one), runs stages 1-2 and writes P and T
// into a ring of W = 16 + 2p plane slots, the rows of the product's right
// operand [P ; T] (2W rows padded with zeros to a multiple of 8, 256
// columns).  Every 16 planes, once the ring holds the window of the next
// 16 output planes, the block builds the window's slice of [S0 | M0]
// with its columns in ring order,
// the 8 warps each take 32 columns of the product (wmma fragments), and
// the result goes through shared memory to coalesced stores.  The tile
// is sized at float64, where the ring alone is 135 KB at p = 7; the
// degree p is a template parameter (odd p <= 7), so the tap loops
// unroll.
#include <cstddef>
#include <type_traits>

#include <mma.h>

#include "common.cuh"
#include "tc_window.cuh"

namespace {

using namespace nvcuda;
using gdm::tc::split_tf32;

constexpr int TX = 32;         // nodes along axis 2 per block: one warp
constexpr int TY = 8;          // nodes along axis 1 per block
constexpr int NTY = 8;         // thread rows: 32 x 8 = 256 threads, 8 warps
constexpr int NT = TX * NTY;
constexpr int T0 = 16;         // output planes per tensor-core product
constexpr int NC = TY * TX;    // columns of the product
constexpr int LDP = NC + 8;    // row pitch of [P ; T] and of the y stage

constexpr int rnd32(int n) { return (n + 31) / 32 * 32; }

template <typename T, int P>
struct Geom {
  static constexpr int K = 2 * P + 1;
  static constexpr int W = T0 + 2 * P;             // planes in a window
  static constexpr int KD = (2 * W + 7) / 8 * 8;   // depth of the product
  static constexpr int LDC = KD + 8;               // row pitch of the C slice
  static constexpr int UW = TX + 2 * P;
  static constexpr int UH = TY + 2 * P;
  // offsets in elements of T; every array starts on 32 elements, so
  // every wmma pointer is 32-byte aligned
  static constexpr int PT = 0;                     // KD x LDP: [P ; T] ring
  static constexpr int YS = PT + rnd32(KD * LDP);  // T0 x LDP: y stage
  static constexpr int CT = YS + rnd32(T0 * LDP);  // T0 x LDC: C slice
  static constexpr int USZ = rnd32(UH * UW);
  static constexpr int US = CT + rnd32(T0 * LDC);  // 2 x UH x UW: u tiles
  static constexpr int AS = US + 2 * USZ;          // UH x TX: A
  static constexpr int BS = AS + rnd32(UH * TX);   // UH x TX: B
  static constexpr int C2M = BS + rnd32(UH * TX);  // K x TX: M2 rows
  static constexpr int C2S = C2M + rnd32(K * TX);  // K x TX: S2 rows
  static constexpr int C1M = C2S + rnd32(K * TX);  // TY x K: M1 rows
  static constexpr int C1S = C1M + rnd32(TY * K);  // TY x K: S1 rows
  static constexpr size_t BYTES = sizeof(T) * (C1S + rnd32(TY * K));
  static_assert(BYTES <= 232448, "K5 tile exceeds an H100 block's smem");
};

// ys[0:T0, warp's 32 columns] = ct[0:T0, 0:KD] . pt[0:KD, warp's columns]
template <typename T, int P>
__device__ __forceinline__ void window_product(const T* ct, const T* pt,
                                               T* ys, int warp) {
  using G = Geom<T, P>;
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

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace3_mxu_kernel(const T* __restrict__ u, const T* __restrict__ s0,
                    const T* __restrict__ m0, const T* __restrict__ s1,
                    const T* __restrict__ m1, const T* __restrict__ s2,
                    const T* __restrict__ m2, T* __restrict__ y, int n0,
                    int n1, int n2, int chunk) {
  using G = Geom<T, P>;
  constexpr int K = G::K;
  constexpr int W = G::W;
  constexpr int KD = G::KD;
  constexpr int UW = G::UW;
  constexpr int UH = G::UH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T* pt = base + G::PT;
  T* ys = base + G::YS;
  T* ct = base + G::CT;
  T* us = base + G::US;  // two slots: plane q in slot (q - q_lo + P) & 1
  T* as = base + G::AS;
  T* bs = base + G::BS;
  T* c2m = base + G::C2M;
  T* c2s = base + G::C2S;
  T* c1m = base + G::C1M;
  T* c1s = base + G::C1S;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int warp = tid / 32;
  const int i1_0 = blockIdx.y * TY;
  const int i2_0 = blockIdx.x * TX;
  const int q_lo = blockIdx.z * chunk;          // first output plane
  const int q_hi = min(q_lo + chunk, n0);       // one past the last
  const int n_groups = (q_hi - q_lo + T0 - 1) / T0;
  const size_t plane = static_cast<size_t>(n1) * n2;

  for (int k = tid; k < K * TX; k += NT) {
    const int t = k / TX;
    const int j = i2_0 + k % TX;
    const bool in = j < n2;
    c2m[k] = in ? m2[static_cast<size_t>(j) * K + t] : T(0);
    c2s[k] = in ? s2[static_cast<size_t>(j) * K + t] : T(0);
  }
  for (int k = tid; k < TY * K; k += NT) {
    const bool in = i1_0 + k / K < n1;
    c1m[k] = in ? m1[static_cast<size_t>(i1_0) * K + k] : T(0);
    c1s[k] = in ? s1[static_cast<size_t>(i1_0) * K + k] : T(0);
  }
  // the depth padding rows of [P ; T] stay zero
  for (int k = tid; k < (KD - 2 * W) * LDP; k += NT) pt[2 * W * LDP + k] = T(0);

  // the u tile of plane q (with its p-wide halo on axes 1 and 2) into
  // dst, asynchronously; nothing for a plane outside the grid
  auto issue = [&](int q, T* dst) {
    if (q < 0 || q >= n0) return;  // uniform across the block
    const T* uq = u + static_cast<size_t>(q) * plane;
    for (int k = tid; k < UH * UW; k += NT) {
      const int g1 = i1_0 - P + k / UW;
      const int g2 = i2_0 - P + k % UW;
      const bool in = g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2;
      gdm::copy_async(dst + k, in ? uq + static_cast<size_t>(g1) * n2 + g2
                                  : u, in);
    }
  };

  // plane q sits in ring slot (q - (q_lo - P)) mod W; output group g
  // (planes q_lo + 16g ..) is ready once plane q_lo + 16(g+1) + P - 1 is in
  int slot = 0;
  int group = 0;
  const int q_end = q_lo + n_groups * T0 + P;
  issue(q_lo - P, us);
  gdm::commit_group();
  for (int q = q_lo - P; q < q_end; ++q) {
    const bool inside = q >= 0 && q < n0;  // uniform across the block
    const int half = (q - q_lo + P) & 1;
    // the next plane's tile goes into the slot plane q - 1 left; every
    // thread finished reading it before the barrier after its stage 1
    if (q + 1 < q_end) issue(q + 1, us + (1 - half) * G::USZ);
    gdm::commit_group();
    gdm::wait_group<1>();  // plane q's copies have landed
    __syncthreads();

    // stage 1: A[r][c] = sum_t M2[j][t] U[r][c + t], B with S2
    if (inside) {
      for (int r = ty; r < UH; r += NTY) {
        const T* row = us + half * G::USZ + r * UW + tx;
        T a = T(0);
        T b = T(0);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const T x = row[t];
          a = gdm::fma_(c2m[t * TX + tx], x, a);
          b = gdm::fma_(c2s[t * TX + tx], x, b);
        }
        as[r * TX + tx] = a;
        bs[r * TX + tx] = b;
      }
    }
    __syncthreads();

    // stage 2: P = M1 A, T = S1 A + M1 B into rows slot and W + slot
    for (int r = ty; r < TY; r += NTY) {
      T pv = T(0);
      T tv = T(0);
      if (inside) {
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const T a = as[(r + t) * TX + tx];
          const T b = bs[(r + t) * TX + tx];
          const T cm = c1m[r * K + t];
          pv = gdm::fma_(cm, a, pv);
          tv = gdm::fma_(c1s[r * K + t], a, tv);
          tv = gdm::fma_(cm, b, tv);
        }
      }
      pt[slot * LDP + r * TX + tx] = pv;
      pt[(W + slot) * LDP + r * TX + tx] = tv;
    }
    if (++slot == W) slot = 0;

    // stage 3 for output group `group` once its window is in the ring
    if (q == q_lo + (group + 1) * T0 + P - 1) {
      const int a0 = q_lo + group * T0;
      const int rot = (group * T0) % W;  // ring slot of plane a0 - P
      // C slice: column s (< W) of row i is S0(a0 + i, plane in slot s),
      // column W + s the same entry of M0; zero off the band
      for (int e = tid; e < T0 * KD; e += NT) {
        const int i = e / KD;
        const int col = e % KD;
        T v = T(0);
        if (col < 2 * W && a0 + i < n0) {
          const bool mass = col >= W;
          int jj = (mass ? col - W : col) - rot;  // plane - (a0 - P)
          if (jj < 0) jj += W;
          const int k = jj - i;
          if (k >= 0 && k < K)
            v = (mass ? m0 : s0)[static_cast<size_t>(a0 + i) * K + k];
        }
        ct[i * G::LDC + col] = v;
      }
      __syncthreads();
      window_product<T, P>(ct, pt, ys, warp);
      __syncthreads();
      for (int e = tid; e < T0 * NC; e += NT) {
        const int i = a0 + e / NC;
        const int c = e % NC;
        const int g1 = i1_0 + c / TX;
        const int g2 = i2_0 + c % TX;
        if (i < q_hi && g1 < n1 && g2 < n2)
          y[static_cast<size_t>(i) * plane + static_cast<size_t>(g1) * n2 +
            g2] = ys[(e / NC) * LDP + c];
      }
      ++group;
    }
  }
  gdm::wait_group<0>();
}

template <typename T, int P>
int launch_p(const void* u, const void* s0, const void* m0, const void* s1,
             const void* m1, const void* s2, const void* m2, void* y, int n0,
             int n1, int n2, cudaStream_t stream) {
  constexpr size_t smem = Geom<T, P>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace3_mxu_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the longest chunk of planes (a multiple of 16) that still gives about
  // four blocks per SM of an H100 (132 SMs); each chunk runs stages 1-2
  // on 2p extra planes
  const int cols = ((n2 + TX - 1) / TX) * ((n1 + TY - 1) / TY);
  const int candidates[] = {64, 32};
  int chunk = 16;
  for (int c : candidates) {
    if (cols * ((n0 + c - 1) / c) >= 4 * 132) {
      chunk = c;
      break;
    }
  }
  const dim3 block(TX, NTY);
  const dim3 grid((n2 + TX - 1) / TX, (n1 + TY - 1) / TY,
                  (n0 + chunk - 1) / chunk);
  laplace3_mxu_kernel<T, P><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(s0),
      static_cast<const T*>(m0), static_cast<const T*>(s1),
      static_cast<const T*>(m1), static_cast<const T*>(s2),
      static_cast<const T*>(m2), static_cast<T*>(y), n0, n1, n2, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* s0, const void* m0, const void* s1,
           const void* m1, const void* s2, const void* m2, void* y, int p,
           int n0, int n1, int n2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_p<T, 1>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, s);
    case 3: return launch_p<T, 3>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, s);
    case 5: return launch_p<T, 5>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, s);
    case 7: return launch_p<T, 7>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_laplace3_mxu_apply_f32(const void* u, const void* s0, const void* m0,
                               const void* s1, const void* m1, const void* s2,
                               const void* m2, void* y, int p, int n0, int n1,
                               int n2, void* stream) {
  return launch<float>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, stream);
}

int gdm_laplace3_mxu_apply_f64(const void* u, const void* s0, const void* m0,
                               const void* s1, const void* m1, const void* s2,
                               const void* m2, void* y, int p, int n0, int n1,
                               int n2, void* stream) {
  return launch<double>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, stream);
}

}  // extern "C"
