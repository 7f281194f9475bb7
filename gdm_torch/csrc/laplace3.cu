// K4: the 3D GD Laplace apply
//
//   y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace3 (gdm's 3D
// Laplace kernel; the port runs it for every 3D operator apply of the
// uncut Poisson solve and its multigrid levels).  The six factors are
// (N_d, 2p+1) row-major band tables, band[a][k] = entry (a, a+k-p), zero
// outside the grid, so zero halos are exact.  U and y are the contiguous
// (n0, n1, n2) node array; the TPU kernel's fused-row layout, 128-lane
// padding and plane-aligned halos are not needed here.
//
// The three stages and their shared intermediates are those of the TPU
// kernel (pallas_stencil2.py:843-856):
//   stage 1 (axis 2): A = U M2^T, B = U S2^T  (one shifted read feeds both)
//   stage 2 (axis 1): P = M1 A,  T = S1 A + M1 B
//   stage 3 (axis 0): y = S0 P + M0 T
//
// Bound on the card: at 160^3, p = 3, about 14(2p+1) = 98 flops per
// output against 8 bytes of u and y in float32; the floor is memory
// (33 MB per apply, 10 us at 3.35 TB/s), and shared-memory traffic of
// the ~6(2p+1) tap reads per output is what the design keeps down.
//
// Design: a block owns a TY x TX (16 x 32) column of outputs along axes
// 1 and 2 and marches along axis 0 over a chunk of planes.  For each
// plane q it loads the u plane tile with a p-wide halo on axes 1 and 2
// into shared memory, computes A and B on the TY + 2p halo rows (stage
// 1), then P and T on the TY rows (stage 2) into a ring of 2p+1 plane
// slots.  Once the ring holds planes q-2p .. q it writes output plane
// q - p (stage 3).  A chunk of c planes computes stages 1-2 on c + 2p
// planes.  Planes outside the grid are zero and skip stages 1-2.  A warp
// spans 32 neighbouring nodes of axis 2, so global reads and writes are
// coalesced.  The degree p is a template parameter (odd p <= 7), so the
// tap loops unroll.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int TX = 32;   // outputs along axis 2 per block: one warp wide
constexpr int TY = 16;   // outputs along axis 1 per block
constexpr int NTY = 8;   // thread rows: 32 x 8 = 256 threads

template <typename T, int P>
constexpr size_t smem_bytes() {
  constexpr int K = 2 * P + 1;
  constexpr int UW = TX + 2 * P;
  constexpr int UH = TY + 2 * P;
  return sizeof(T) * (UH * UW + 2 * UH * TX + 2 * K * TY * TX + 2 * K * TX +
                      2 * TY * K);
}

template <typename T, int P>
__global__ void __launch_bounds__(TX * NTY)
laplace3_kernel(const T* __restrict__ u, const T* __restrict__ s0,
                const T* __restrict__ m0, const T* __restrict__ s1,
                const T* __restrict__ m1, const T* __restrict__ s2,
                const T* __restrict__ m2, T* __restrict__ y, int n0, int n1,
                int n2, int chunk) {
  constexpr int K = 2 * P + 1;
  constexpr int UW = TX + 2 * P;
  constexpr int UH = TY + 2 * P;
  extern __shared__ __align__(16) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);  // UH x UW: u plane tile
  T* as = us + UH * UW;                // UH x TX: A
  T* bs = as + UH * TX;                // UH x TX: B
  T* pr = bs + UH * TX;                // K x TY x TX: ring of P planes
  T* tr = pr + K * TY * TX;            // K x TY x TX: ring of T planes
  T* c2m = tr + K * TY * TX;           // K x TX: M2 rows of the tile
  T* c2s = c2m + K * TX;               // K x TX: S2
  T* c1m = c2s + K * TX;               // TY x K: M1 rows of the tile
  T* c1s = c1m + TY * K;               // TY x K: S1

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int i1_0 = blockIdx.y * TY;
  const int i2_0 = blockIdx.x * TX;
  const int q_lo = blockIdx.z * chunk;          // first output plane
  const int q_hi = min(q_lo + chunk, n0);       // one past the last
  const size_t plane = static_cast<size_t>(n1) * n2;

  for (int k = tid; k < K * TX; k += TX * NTY) {
    const int t = k / TX;
    const int j = i2_0 + k % TX;
    const bool in = j < n2;
    c2m[k] = in ? m2[static_cast<size_t>(j) * K + t] : T(0);
    c2s[k] = in ? s2[static_cast<size_t>(j) * K + t] : T(0);
  }
  for (int k = tid; k < TY * K; k += TX * NTY) {
    const bool in = i1_0 + k / K < n1;
    c1m[k] = in ? m1[static_cast<size_t>(i1_0) * K + k] : T(0);
    c1s[k] = in ? s1[static_cast<size_t>(i1_0) * K + k] : T(0);
  }

  for (int q = q_lo - P; q < q_hi + P; ++q) {
    const int slot = (q - q_lo + P) % K;
    const bool inside = q >= 0 && q < n0;  // uniform across the block
    if (inside) {
      const T* uq = u + static_cast<size_t>(q) * plane;
      for (int k = tid; k < UH * UW; k += TX * NTY) {
        const int g1 = i1_0 - P + k / UW;
        const int g2 = i2_0 - P + k % UW;
        us[k] = (g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2)
                    ? uq[static_cast<size_t>(g1) * n2 + g2]
                    : T(0);
      }
    }
    __syncthreads();

    // stage 1: A[r][c] = sum_t M2[j][t] U[r][c + t], B with S2
    if (inside) {
      for (int r = ty; r < UH; r += NTY) {
        const T* row = us + r * UW + tx;
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

    // stage 2: P = M1 A, T = S1 A + M1 B into ring slot `slot`
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
      pr[(slot * TY + r) * TX + tx] = pv;
      tr[(slot * TY + r) * TX + tx] = tv;
    }
    __syncthreads();

    // stage 3: the ring holds planes q-2P .. q; write output plane q - P
    const int i = q - P;
    if (i >= q_lo) {
      const int j = i2_0 + tx;
      const int first = (i - q_lo) % K;  // slot of plane i - P
      for (int r = ty; r < TY; r += NTY) {
        if (j >= n2 || i1_0 + r >= n1) break;
        T acc = T(0);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          int sl = first + t;
          if (sl >= K) sl -= K;
          acc = gdm::fma_(s0[static_cast<size_t>(i) * K + t],
                          pr[(sl * TY + r) * TX + tx], acc);
          acc = gdm::fma_(m0[static_cast<size_t>(i) * K + t],
                          tr[(sl * TY + r) * TX + tx], acc);
        }
        y[static_cast<size_t>(i) * plane +
          static_cast<size_t>(i1_0 + r) * n2 + j] = acc;
      }
    }
  }
}

template <typename T, int P>
int launch_p(const void* u, const void* s0, const void* m0, const void* s1,
             const void* m1, const void* s2, const void* m2, void* y, int n0,
             int n1, int n2, int planes, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, P>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace3_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the chunk of planes a block marches over: ``planes`` when given (gdm's
  // tile_planes), else the longest chunk that still gives about four
  // blocks per SM of an H100 (132 SMs); short chunks recompute stages
  // 1-2 on 2p extra planes each
  const int cols = ((n2 + TX - 1) / TX) * ((n1 + TY - 1) / TY);
  const int candidates[] = {64, 32, 16};
  int chunk = 8;
  for (int c : candidates) {
    if (cols * ((n0 + c - 1) / c) >= 4 * 132) {
      chunk = c;
      break;
    }
  }
  if (planes > 0) chunk = planes;
  const dim3 block(TX, NTY);
  const dim3 grid((n2 + TX - 1) / TX, (n1 + TY - 1) / TY,
                  (n0 + chunk - 1) / chunk);
  laplace3_kernel<T, P><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(s0),
      static_cast<const T*>(m0), static_cast<const T*>(s1),
      static_cast<const T*>(m1), static_cast<const T*>(s2),
      static_cast<const T*>(m2), static_cast<T*>(y), n0, n1, n2, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* s0, const void* m0, const void* s1,
           const void* m1, const void* s2, const void* m2, void* y, int p,
           int n0, int n1, int n2, int planes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1:
      return launch_p<T, 1>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, planes,
                            s);
    case 3:
      return launch_p<T, 3>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, planes,
                            s);
    case 5:
      return launch_p<T, 5>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, planes,
                            s);
    case 7:
      return launch_p<T, 7>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2, planes,
                            s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_laplace3_apply_f32(const void* u, const void* s0, const void* m0,
                           const void* s1, const void* m1, const void* s2,
                           const void* m2, void* y, int p, int n0, int n1,
                           int n2, int planes, void* stream) {
  return launch<float>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, planes,
                     stream);
}

int gdm_laplace3_apply_f64(const void* u, const void* s0, const void* m0,
                           const void* s1, const void* m1, const void* s2,
                           const void* m2, void* y, int p, int n0, int n1,
                           int n2, int planes, void* stream) {
  return launch<double>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, planes,
                     stream);
}

}  // extern "C"
