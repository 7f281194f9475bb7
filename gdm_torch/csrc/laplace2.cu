// K3: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T.
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace2 (the TPU
// kernel behind gdm/ops/fast.py::best_field_laplace, which carries the
// CG operator and every multigrid level of the uncut Poisson solve).
// The default bands are the GD Laplace (A0, A1, B0, B1) = (S0, M1, M0,
// S1); any four banded factors may be given.  Each factor is a
// (N_d, 2p+1) row-major band table with band[a][k] = entry (a, a+k-p),
// zero where a+k-p falls outside [0, N_d), so reading zeros beyond the
// grid edge is exact.  U and y are the contiguous (n0, n1) node array:
// no guard rows and no lane padding (the TPU kernel padded both for its
// aligned DMAs).
//
// Bound on the card: at 1024^2, p = 3, each output costs 8(2p+1) = 56
// flops against 8 bytes of u and y in float32, about 7 flops per byte,
// well below the H100's flop-per-byte balance, so the floor is memory
// (2 * 4 MB per apply, L2-resident when applies repeat).  In practice
// the limit is shared-memory traffic: every tap reads its operand from
// shared memory.
//
// Design: one block owns a TY x TX tile of outputs (32 x 32) with 32 x 8
// threads.  It copies the tile of u plus a p-wide halo on every side
// into shared memory (zeros outside the grid), and the tile's band rows
// beside it.  Column stage: V = U A1^T and W = U B1^T for all TY + 2p
// halo rows; both products read the same shifted values of U.  Row
// stage: y = A0 V + B0 W for the tile's rows.  A warp spans 32
// neighbouring columns, so global reads and writes are coalesced and
// shared-memory reads are conflict-free (row coefficients are
// broadcasts).  The degree p is a template parameter (odd p <= 15), so
// the tap loops unroll.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int TX = 32;   // output columns per block: one warp wide
constexpr int TY = 32;   // output rows per block
constexpr int NTY = 8;   // thread rows: 32 x 8 = 256 threads

template <typename T, int P>
__global__ void __launch_bounds__(TX * NTY)
laplace2_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                const T* __restrict__ a1, const T* __restrict__ b0,
                const T* __restrict__ b1, T* __restrict__ y, int n0, int n1) {
  constexpr int K = 2 * P + 1;
  constexpr int UW = TX + 2 * P;  // width of the u tile
  constexpr int UH = TY + 2 * P;  // height of the u, V and W tiles
  extern __shared__ __align__(16) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);  // UH x UW
  T* vs = us + UH * UW;                // UH x TX
  T* ws = vs + UH * TX;                // UH x TX
  T* ca = ws + UH * TX;                // K x TX: A1 rows of the tile columns
  T* cb = ca + K * TX;                 // K x TX: B1
  T* ra = cb + K * TX;                 // TY x K: A0 rows of the tile rows
  T* rb = ra + TY * K;                 // TY x K: B0

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX;

  for (int k = tid; k < UH * UW; k += TX * NTY) {
    const int gi = i0 - P + k / UW;
    const int gj = j0 - P + k % UW;
    us[k] = (gi >= 0 && gi < n0 && gj >= 0 && gj < n1)
                ? u[static_cast<size_t>(gi) * n1 + gj]
                : T(0);
  }
  for (int k = tid; k < K * TX; k += TX * NTY) {
    const int t = k / TX;
    const int j = j0 + k % TX;
    const bool in = j < n1;
    ca[k] = in ? a1[static_cast<size_t>(j) * K + t] : T(0);
    cb[k] = in ? b1[static_cast<size_t>(j) * K + t] : T(0);
  }
  for (int k = tid; k < TY * K; k += TX * NTY) {
    const bool in = i0 + k / K < n0;
    ra[k] = in ? a0[static_cast<size_t>(i0) * K + k] : T(0);
    rb[k] = in ? b0[static_cast<size_t>(i0) * K + k] : T(0);
  }
  __syncthreads();

  // column stage: V[r][c] = sum_t A1[j][t] U[r][c + t], W likewise
  for (int r = ty; r < UH; r += NTY) {
    const T* row = us + r * UW + tx;
    T v = T(0);
    T w = T(0);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const T x = row[t];
      v = gdm::fma_(ca[t * TX + tx], x, v);
      w = gdm::fma_(cb[t * TX + tx], x, w);
    }
    vs[r * TX + tx] = v;
    ws[r * TX + tx] = w;
  }
  __syncthreads();

  // row stage: y[i][j] = sum_t A0[i][t] V[r + t][c] + B0[i][t] W[r + t][c]
  const int j = j0 + tx;
  if (j >= n1) return;
  for (int r = ty; r < TY && i0 + r < n0; r += NTY) {
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      acc = gdm::fma_(ra[r * K + t], vs[(r + t) * TX + tx], acc);
      acc = gdm::fma_(rb[r * K + t], ws[(r + t) * TX + tx], acc);
    }
    y[static_cast<size_t>(i0 + r) * n1 + j] = acc;
  }
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, cudaStream_t stream) {
  constexpr int K = 2 * P + 1;
  constexpr int UW = TX + 2 * P;
  constexpr int UH = TY + 2 * P;
  const size_t smem =
      sizeof(T) * (UH * UW + 2 * UH * TX + 2 * K * TX + 2 * TY * K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace2_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(TX, NTY);
  const dim3 grid((n1 + TX - 1) / TX, (n0 + TY - 1) / TY);
  laplace2_kernel<T, P><<<grid, block, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1);
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

int gdm_laplace2_apply_f32(const void* u, const void* a0, const void* a1,
                           const void* b0, const void* b1, void* y, int p,
                           int n0, int n1, void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, stream);
}

int gdm_laplace2_apply_f64(const void* u, const void* a0, const void* a1,
                           const void* b0, const void* b1, void* y, int p,
                           int n0, int n1, void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, stream);
}

}  // extern "C"
