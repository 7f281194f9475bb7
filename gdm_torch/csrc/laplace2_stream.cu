// K3s: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T, streamed.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2_stream (K3's
// operator with the row tiles streamed through an automatic pipeline;
// no solve dispatch routes to it, in gdm or in the port).  Same band
// tables and contiguous (n0, n1) node array as K3 (laplace2.cu): each
// factor is a (N_d, 2p+1) row-major band table, band[a][k] = entry
// (a, a+k-p), zero outside the grid, so zero halos are exact.
//
// Bound on the card: 8 bytes of u and y per node in float32 against
// 8(2p+1) = 56 flops at p = 3, so memory bounds it: at 4096^2 (134 MB
// per apply, more than the 50 MB L2) 40 us at 3.35 TB/s.  Where K3
// loads each tile and then computes it, K3s keeps the next tiles'
// copies in flight while it computes, and reads every row of u once
// (K3 reads 2p halo rows again per 32-row tile).
//
// Precision class: band sums in the working precision on the FMA units,
// as K3 and gdm's f32-exact rows="vpu" (not gdm's bf16x3 row products).
//
// Design: one wave of persistent blocks (as many as fit on the SMs at
// once).  A block owns a 32-column strip and a segment of its rows, and
// marches down the segment in 32-row tiles.  The u rows of the coming
// tiles, with the p-column halo, and the tiles' A0/B0 rows arrive
// through a ring of three shared-memory slots filled by cp.async, one
// commit group per tile, two groups in flight while the block computes.
// Element-wise 4- or 8-byte copies, zero-filled outside the grid, take
// any row length: a row of 1025 float32 nodes is not 16-byte aligned.
// The column stage (V = U A1^T, W = U B1^T) runs once per u row as it
// arrives, into a ring of 32 + 2p (V, W) rows; the row stage (y = A0 V +
// B0 W) then writes the tile.  The strip's A1/B1 columns are loaded
// once.  A block loads its own halo rows: there is no separate halo
// input and no skewed grid (both existed because Pallas tiles must be
// disjoint).  The degree p is a template parameter (odd p <= 15).
#include <algorithm>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int TX = 32;   // strip width: one warp
constexpr int TR = 32;   // rows per tile
constexpr int NTY = 8;   // thread rows: 32 x 8 = 256 threads
constexpr int NT = TX * NTY;
constexpr int NS = 3;    // slots of the copy ring

template <typename T, int P>
struct Geom {
  static constexpr int K = 2 * P + 1;
  static constexpr int UW = TX + 2 * P;          // u row with its halo
  static constexpr int VR = TR + 2 * P;          // rows of the V/W ring
  static constexpr int SLOT = TR * UW + 2 * TR * K;  // u rows, A0, B0 rows
  static constexpr int RING = 0;
  static constexpr int VS = RING + NS * SLOT;    // VR x TX
  static constexpr int WS = VS + VR * TX;        // VR x TX
  static constexpr int CA = WS + VR * TX;        // K x TX: A1 columns
  static constexpr int CB = CA + K * TX;         // K x TX: B1 columns
  static constexpr size_t BYTES = sizeof(T) * (CB + K * TX);
  static_assert(2 * P <= TR, "the leading halo must fit one slot");
  static_assert(BYTES <= 232448, "K3s ring exceeds an H100 block's smem");
};

template <typename T, int P>
__global__ void __launch_bounds__(NT)
laplace2_stream_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                       const T* __restrict__ a1, const T* __restrict__ b0,
                       const T* __restrict__ b1, T* __restrict__ y, int n0,
                       int n1, int seg_rows) {
  using G = Geom<T, P>;
  constexpr int K = G::K;
  constexpr int UW = G::UW;
  constexpr int VR = G::VR;
  extern __shared__ __align__(16) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T* ring = base + G::RING;
  T* vs = base + G::VS;
  T* ws = base + G::WS;
  T* ca = base + G::CA;
  T* cb = base + G::CB;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int j0 = blockIdx.x * TX;
  const int seg_lo = blockIdx.y * seg_rows;
  const int seg_hi = min(seg_lo + seg_rows, n0);
  const int n_tiles = (seg_hi - seg_lo + TR - 1) / TR;
  // load 0 brings the 2p rows above the segment's first output row and
  // below it; load k >= 1 the u rows that complete output tile k - 1
  // (rows seg_lo + p + (k-1) TR ..) and that tile's A0/B0 rows.  Row
  // seg_lo - p + j of u feeds row j (mod VR) of the V/W ring.
  const int n_loads = n_tiles + 1;

  auto issue = [&](int k) {
    T* st = ring + (k % NS) * G::SLOT;
    const int row0 = k == 0 ? seg_lo - P : seg_lo + P + (k - 1) * TR;
    const int rows = k == 0 ? 2 * P : TR;
    for (int e = tid; e < rows * UW; e += NT) {
      const int gi = row0 + e / UW;
      const int gj = j0 - P + e % UW;
      const bool in = gi >= 0 && gi < n0 && gj >= 0 && gj < n1;
      gdm::copy_async(st + e, in ? u + static_cast<size_t>(gi) * n1 + gj : u,
                      in);
    }
    if (k > 0) {
      const int i0 = seg_lo + (k - 1) * TR;
      T* ra = st + TR * UW;
      T* rb = ra + TR * K;
      for (int e = tid; e < TR * K; e += NT) {
        const bool in = i0 + e / K < n0;
        const size_t at = in ? static_cast<size_t>(i0) * K + e : 0;
        gdm::copy_async(ra + e, a0 + at, in);
        gdm::copy_async(rb + e, b0 + at, in);
      }
    }
  };

  for (int k = 0; k < NS - 1; ++k) {
    if (k < n_loads) issue(k);
    gdm::commit_group();
  }
  for (int k = tid; k < K * TX; k += NT) {
    const int t = k / TX;
    const int j = j0 + k % TX;
    const bool in = j < n1;
    ca[k] = in ? a1[static_cast<size_t>(j) * K + t] : T(0);
    cb[k] = in ? b1[static_cast<size_t>(j) * K + t] : T(0);
  }

  const int j = j0 + tx;
  for (int k = 0; k < n_loads; ++k) {
    // loads 0 .. k + NS - 2 are committed; load k has landed once at
    // most NS - 2 groups are pending.  The barrier then also ends every
    // thread's step k - 1, so its slot and V/W rows may be refilled.
    gdm::wait_group<NS - 2>();
    __syncthreads();
    if (k + NS - 1 < n_loads) issue(k + NS - 1);
    gdm::commit_group();

    // column stage on the rows of load k
    const T* st = ring + (k % NS) * G::SLOT;
    const int rows = k == 0 ? 2 * P : TR;
    const int jbase = k == 0 ? 0 : 2 * P + (k - 1) * TR;
    for (int r = ty; r < rows; r += NTY) {
      const T* row = st + r * UW + tx;
      T v = T(0);
      T w = T(0);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const T x = row[t];
        v = gdm::fma_(ca[t * TX + tx], x, v);
        w = gdm::fma_(cb[t * TX + tx], x, w);
      }
      const int sl = (jbase + r) % VR;
      vs[sl * TX + tx] = v;
      ws[sl * TX + tx] = w;
    }
    __syncthreads();
    if (k == 0 || j >= n1) continue;

    // row stage: output rows i0 + r of tile k - 1 read ring rows
    // (k-1) TR + r + t, t = 0 .. 2p
    const int i0 = seg_lo + (k - 1) * TR;
    const T* ra = st + TR * UW;
    const T* rb = ra + TR * K;
    for (int r = ty; r < TR && i0 + r < seg_hi; r += NTY) {
      const int first = ((k - 1) * TR + r) % VR;
      T acc = T(0);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        int sl = first + t;
        if (sl >= VR) sl -= VR;
        acc = gdm::fma_(ra[r * K + t], vs[sl * TX + tx], acc);
        acc = gdm::fma_(rb[r * K + t], ws[sl * TX + tx], acc);
      }
      y[static_cast<size_t>(i0 + r) * n1 + j] = acc;
    }
  }
  gdm::wait_group<0>();
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, cudaStream_t stream) {
  constexpr size_t smem = Geom<T, P>::BYTES;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(laplace2_stream_kernel<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, laplace2_stream_kernel<T, P>, NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave: split each strip's rows into as many segments as still
  // fit the SMs at once (rounding up would start a second, mostly idle
  // wave), never below one tile per segment
  const int strips = (n1 + TX - 1) / TX;
  const int want = sms * (per_sm > 0 ? per_sm : 1);
  int segs = std::max(1, std::min(want / strips, (n0 + TR - 1) / TR));
  const int seg_rows = (n0 + segs - 1) / segs;
  segs = (n0 + seg_rows - 1) / seg_rows;
  const dim3 block(TX, NTY);
  const dim3 grid(strips, segs);
  laplace2_stream_kernel<T, P><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, seg_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_p<T, 1>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 3: return launch_p<T, 3>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 5: return launch_p<T, 5>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 7: return launch_p<T, 7>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 9: return launch_p<T, 9>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 11: return launch_p<T, 11>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 13: return launch_p<T, 13>(u, a0, a1, b0, b1, y, n0, n1, s);
    case 15: return launch_p<T, 15>(u, a0, a1, b0, b1, y, n0, n1, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_laplace2_stream_apply_f32(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, stream);
}

int gdm_laplace2_stream_apply_f64(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, stream);
}

}  // extern "C"
