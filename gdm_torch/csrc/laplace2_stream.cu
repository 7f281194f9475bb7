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
// 8(2p+1) = 56 flops at p = 3, so memory bounds it: at 4097^2 (134 MB
// per apply, more than the 50 MB L2) 40 us at 3.35 TB/s.  The first
// design (32-column strips, u rows and A0/B0 rows by 4-byte cp.async,
// about 1.6 copies an output, V and W through shared memory, two block
// barriers a tile) ran at a quarter of that rate: a block's thread 0
// spent as long issuing copies as in either stage.
//
// Precision class: band sums in the working precision on the FMA units,
// as K3 and gdm's f32-exact rows="vpu" (not gdm's bf16x3 row products).
//
// Design: a block owns a strip of at most `bw` columns (64, 128 or 256)
// and a segment of rows, with one consumer thread for each two adjacent
// columns and a producer warp, of which one thread issues every copy.
// The producer brings the segment's A0/B0 band rows, then streams its u
// rows (with the p-column halo and 2p halo rows) through a ring of NSL
// slots of 2p + 1 rows in shared memory, each row by one bulk copy (the
// TMA unit) that completes on the slot's `full` mbarrier.  A row of 1025
// float32 nodes starts 4 bytes past a 16-byte boundary, which rules out
// 2D tensor maps, so each copy is the row's span rounded out to 16 bytes
// (never past the array's own rounded ends) and lands where its first
// element sits at the same offset from a 16-byte boundary; the
// consumers index it with that shift and read columns outside the grid
// as zero.  A consumer waits on `full`, loads the 2p + 2 values of a row
// that its two columns need, runs their column stages (V = U A1^T, W =
// U B1^T, A1/B1 of the columns in registers) into register rings of the
// last 2p + 1 rows (a slot's rows are unrolled, so the rings' indices
// are static), then the row stage of the output row 2p behind it (y =
// A0 V + B0 W, the A0 and B0 sums apart, then added, as the plain twin
// does; the band rows, moved once to 16-byte aligned rows, as 16-byte
// broadcast loads up to p = 7), and its warp releases the slot on its
// `empty` mbarrier.  No block barrier after the set-up (the consumers'
// one named barrier orders the band rows' move), V and W never touch
// shared memory, and two columns a thread halve the loads, the band
// reads and the index work an output.  (A programmatic dependent
// launch, as K1 takes, measured slower here: 15 us at 1025^2.)  Every u
// row is read once per block column; the 2p halo rows of a segment are
// read again by its neighbour.
//
// The launch plan comes from Python, gdm_torch/ops/stencil2.py::k3s_plan:
// bw and the strips and segments (ntc, ntr), each axis split evenly,
// four blocks an SM in one wave (float32 at p <= 3 is compiled for four
// blocks of 160 threads an SM).  The degree p is a template parameter
// (odd p <= 15).
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BAR_BYTES = 128;  // the 2 NSL + 1 mbarriers, before the ring

template <typename T, int P>
struct Geom {
  static constexpr int K = 2 * P + 1;  // u rows a slot of the ring
  static constexpr int NSL = P <= 7 ? 4 : 2;  // slots of the ring
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int KP = (K + VEC - 1) / VEC * VEC;  // band row pitch
  // float32 at p <= 3: registers for four blocks of 160 threads an SM
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 && P <= 3 ? 4 : 1;
  // a u row in the ring: bw + 2p elements rounded out to 16 bytes
  __host__ __device__ static constexpr int up(int bw) {
    return (bw + 2 * P + 2 * VEC - 2 + VEC - 1) / VEC * VEC;
  }
  // a band table's seg rows as copied (rounded out to 16 bytes)
  __host__ __device__ static constexpr int raw(int seg) {
    return (seg * K + 2 * VEC - 2 + VEC - 1) / VEC * VEC;
  }
  // the ring, a zero row, the two band tables as copied and at a pitch
  // of KP
  __host__ __device__ static constexpr size_t bytes(int bw, int seg) {
    return BAR_BYTES +
           sizeof(T) * (static_cast<size_t>(NSL * K + 1) * up(bw) +
                        2 * raw(seg) + 2 * seg * KP);
  }
};

template <bool V>
struct Flag {
  static constexpr bool value = V;
};

template <typename T, int P>
__global__ void __launch_bounds__(128 + 32, (Geom<T, P>::MIN_BLOCKS))
laplace2_stream_kernel(const T* __restrict__ u, const T* __restrict__ a0,
                       const T* __restrict__ a1, const T* __restrict__ b0,
                       const T* __restrict__ b1, T* __restrict__ y, int n0,
                       int n1, int ntr, int ntc) {
  using G = Geom<T, P>;
  constexpr int K = G::K;
  constexpr int KP = G::KP;
  constexpr int VEC = G::VEC;
  constexpr int NSL = G::NSL;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + NSL;
  unsigned long long* bands = empty + NSL;
  const int nc = blockDim.x - 32;  // consumer threads, two columns each
  const int bw = 2 * nc;           // the strip's width
  const int nw = nc / 32;          // consumer warps
  const int up = G::up(bw);
  const int seg_max = (n0 + ntr - 1) / ntr;
  T* ring = reinterpret_cast<T*>(smem + BAR_BYTES);  // NSL x K x up
  T* zrow = ring + NSL * K * up;                     // up zeros
  T* raw_a = zrow + up;                              // A0 rows as copied
  T* raw_b = raw_a + G::raw(seg_max);                // B0 rows as copied
  T* band_a = raw_b + G::raw(seg_max);               // seg x KP
  T* band_b = band_a + seg_max * KP;                 // seg x KP
  const int tid = threadIdx.x;

  int s_lo, seg, j0, t2;
  gdm::part(n0, ntr, blockIdx.x / ntc, s_lo, seg);
  gdm::part(n1, ntc, blockIdx.x % ntc, j0, t2);
  const int m_rows = seg + 2 * P;  // u rows the block streams
  const int chunks = (m_rows + K - 1) / K;
  // element e of a table sits (mis + e) mod VEC elements past a 16-byte
  // boundary
  auto mis = [](const T* base) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(base) / sizeof(T)) %
                            VEC);
  };
  auto lo16 = [](const T* base) {
    return reinterpret_cast<uintptr_t>(base) & ~static_cast<uintptr_t>(15);
  };
  auto hi16 = [](const T* base, long long n) {
    return (reinterpret_cast<uintptr_t>(base + n) + 15) &
           ~static_cast<uintptr_t>(15);
  };

  if (tid == 0) {
    for (int s = 0; s < NSL; ++s) {
      gdm::bar_init(full + s, 1);
      gdm::bar_init(empty + s, nw);
    }
    gdm::bar_init(bands, 1);
    gdm::bar_init_fence();
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0 || tid == nc, tid == 0 ? 1 : 9, clock64());

  if (tid >= nc) {
    // ---- the producer: one thread issues every copy ----
    if (tid != nc) return;
    const long long nb = static_cast<long long>(n0) * K;
    gdm::copy_span(raw_a, a0, static_cast<long long>(s_lo) * K,
                   static_cast<long long>(s_lo + seg) * K, lo16(a0),
                   hi16(a0, nb), bands);
    gdm::copy_span(raw_b, b0, static_cast<long long>(s_lo) * K,
                   static_cast<long long>(s_lo + seg) * K, lo16(b0),
                   hi16(b0, nb), bands);
    gdm::bar_arrive(bands);
    const uintptr_t u_lo = lo16(u);
    const uintptr_t u_hi = hi16(u, static_cast<long long>(n0) * n1);
    for (int k = 0; k < chunks; ++k) {
      const int sl = k % NSL;
      if (k >= NSL) {
        const long long c0 = GDM_CLOCK();
        gdm::bar_wait(empty + sl, ((k / NSL) - 1) & 1);
        GDM_STAMP_ADD(true, 10, GDM_CLOCK() - c0);
        (void)c0;
      }
      T* st = ring + sl * K * up;
      const int rows = min(K, m_rows - k * K);
      for (int rr = 0; rr < rows; ++rr) {
        const int gi = s_lo - P + k * K + rr;
        if (gi < 0 || gi >= n0) continue;  // zero rows: no copy
        const long long f = static_cast<long long>(gi) * n1 + j0 - P;
        gdm::copy_span(st + rr * up, u, f, f + t2 + 2 * P, u_lo, u_hi,
                       full + sl);
      }
      gdm::bar_arrive(full + sl);
    }
    GDM_STAMP(true, 11, clock64());
    return;
  }

  // ---- the consumers: two adjacent columns each ----
  const int tx = tid;
  const int lane = tid & 31;
  const int jx = 2 * tx;  // the first column, within the strip
  bool col_in[2];
  T ca[2][K], cb[2][K];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    col_in[c] = jx + c < t2;
    const size_t jc = static_cast<size_t>(j0 + jx + c) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      ca[c][t] = col_in[c] ? a1[jc + t] : T(0);
      cb[c][t] = col_in[c] ? b1[jc + t] : T(0);
    }
  }
  // a zero row for the u rows outside the grid, and the segment's band
  // rows at a pitch of KP, for 16-byte loads
  for (int e = tid; e < up; e += nc) zrow[e] = T(0);
  gdm::bar_wait(bands, 0);
  {
    const int sha = (mis(a0) + s_lo * K) % VEC;
    const int shb = (mis(b0) + s_lo * K) % VEC;
    for (int e = tid; e < seg * K; e += nc) {
      const int i = e / K;
      const int t = e - i * K;
      band_a[i * KP + t] = raw_a[sha + e];
      band_b[i * KP + t] = raw_b[shb + e];
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
  }
  GDM_STAMP(tid == 0, 2, clock64());
  const int n1v = n1 % VEC;
  // u row s_lo - p + m starts `sh` elements into its ring row
  const int sh0 = static_cast<int>(
      ((mis(u) + (static_cast<long long>(s_lo) - P) * n1 + j0 - P) % VEC +
       VEC) %
      VEC);
  const int jg = j0 + jx - P;  // the column of x[0] below
  T* yc = y + static_cast<size_t>(s_lo) * n1 + j0 + jx;

  // chunk k holds u rows m = k K + s, s = 0 .. 2p, whose V and W go to
  // ring entry s; output row m - 2p (of the segment) takes ring entries
  // (s + 1 + t) mod K, t = 0 .. 2p.  EDGE: the columns' taps may leave
  // the grid, and read zeros there.
  auto run = [&](auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    T v[2][K] = {};
    T w[2][K] = {};
    int sh = sh0;
    for (int k = 0; k < chunks; ++k) {
      const int sl = k % NSL;
      const long long c0 = GDM_CLOCK();
      gdm::bar_wait(full + sl, (k / NSL) & 1);
      GDM_STAMP_ADD(tid == 0, 3, GDM_CLOCK() - c0);
      (void)c0;
      const T* slot = ring + sl * K * up;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int m = k * K + s;
        const int gi = s_lo - P + m;
        const bool row_in = m < m_rows && gi >= 0 && gi < n0;
        const T* row = (row_in ? slot + s * up + sh : zrow) + jx;
        sh = (sh + n1v) & (VEC - 1);
        T x[K + 1];
#pragma unroll
        for (int t = 0; t <= K; ++t) {
          x[t] = row[t];
          if constexpr (EDGE) {
            x[t] = jg + t >= 0 && jg + t < n1 ? x[t] : T(0);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          T vv = T(0);
          T ww = T(0);
#pragma unroll
          for (int t = 0; t < K; ++t) {
            vv = gdm::fma_(ca[c][t], x[t + c], vv);
            ww = gdm::fma_(cb[c][t], x[t + c], ww);
          }
          v[c][s] = vv;
          w[c][s] = ww;
        }
        const int i = m - 2 * P;  // the output row, within the segment
        const int ic = min(max(i, 0), seg - 1);
        const T* ra = band_a + ic * KP;
        const T* rb = band_b + ic * KP;
        T acc_a[2] = {T(0), T(0)};
        T acc_b[2] = {T(0), T(0)};
        if constexpr (P <= 7) {
          T ar[KP], br[KP];
          gdm::load_row16<T, KP>(ra, ar);
          gdm::load_row16<T, KP>(rb, br);
#pragma unroll
          for (int t = 0; t < K; ++t) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              acc_a[c] = gdm::fma_(ar[t], v[c][(s + 1 + t) % K], acc_a[c]);
              acc_b[c] = gdm::fma_(br[t], w[c][(s + 1 + t) % K], acc_b[c]);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const T at = ra[t];
            const T bt = rb[t];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              acc_a[c] = gdm::fma_(at, v[c][(s + 1 + t) % K], acc_a[c]);
              acc_b[c] = gdm::fma_(bt, w[c][(s + 1 + t) % K], acc_b[c]);
            }
          }
        }
        if (i >= 0 && i < seg) {
          T* yr = yc + static_cast<size_t>(i) * n1;
          if (col_in[0]) yr[0] = acc_a[0] + acc_b[0];
          if (col_in[1]) yr[1] = acc_a[1] + acc_b[1];
        }
      }
      __syncwarp();
      if (lane == 0) gdm::bar_arrive(empty + sl);
    }
  };
  if (jg >= 0 && jg + K < n1) {
    run(Flag<false>());
  } else {
    run(Flag<true>());
  }
  GDM_STAMP(tid == 0, 4, clock64());
  GDM_STAMP(tid == 0, 5, gdm_gtimer());
}

template <typename T, int P>
int launch_p(const void* u, const void* a0, const void* a1, const void* b0,
             const void* b1, void* y, int n0, int n1, int bw, int ntr,
             int ntc, cudaStream_t stream) {
  if (bw < 64 || bw > 256 || bw % 64 != 0 || ntr < 1 || ntc < 1 ||
      ntr > n0 || ntc > n1 || (n1 + ntc - 1) / ntc > bw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = Geom<T, P>::bytes(bw, (n0 + ntr - 1) / ntr);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace2_stream_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  laplace2_stream_kernel<T, P><<<ntr * ntc, bw / 2 + 32, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(a0),
      static_cast<const T*>(a1), static_cast<const T*>(b0),
      static_cast<const T*>(b1), static_cast<T*>(y), n0, n1, ntr, ntc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* a0, const void* a1, const void* b0,
           const void* b1, void* y, int p, int n0, int n1, int bw, int ntr,
           int ntc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define GDM_K3S_CASE(P)                                                    \
  case P:                                                                  \
    return launch_p<T, P>(u, a0, a1, b0, b1, y, n0, n1, bw, ntr, ntc, s);
    GDM_K3S_CASE(1) GDM_K3S_CASE(3) GDM_K3S_CASE(5) GDM_K3S_CASE(7)
    GDM_K3S_CASE(9) GDM_K3S_CASE(11) GDM_K3S_CASE(13) GDM_K3S_CASE(15)
#undef GDM_K3S_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_laplace2_stream_apply_f32(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, int bw, int ntr, int ntc,
                                  void* stream) {
  return launch<float>(u, a0, a1, b0, b1, y, p, n0, n1, bw, ntr, ntc, stream);
}

int gdm_laplace2_stream_apply_f64(const void* u, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, void* y, int p, int n0,
                                  int n1, int bw, int ntr, int ntc,
                                  void* stream) {
  return launch<double>(u, a0, a1, b0, b1, y, p, n0, n1, bw, ntr, ntc,
                        stream);
}

}  // extern "C"
