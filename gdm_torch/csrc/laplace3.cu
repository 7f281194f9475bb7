// K4: the 3D GD Laplace apply
//
//   y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2
//
// Replaces gdm/ops/pallas_stencil2.py::make_padded_laplace3 (gdm's 3D
// Laplace kernel; gdm's dispatch runs it for every 3D apply with
// N0 + 2p > 512).  The six factors are (N_d, 2p+1) row-major band tables,
// band[a][k] = entry (a, a+k-p), zero outside the grid, so zero halos are
// exact.  U and y are the contiguous (n0, n1, n2) node array; the TPU
// kernel's fused-row layout, 128-lane padding and plane-aligned halos are
// not needed here.
//
// The three stages and their intermediates are those of the TPU kernel
// (pallas_stencil2.py:843-856):
//   stage 1 (axis 2): A = U M2^T, B = U S2^T  (one shifted read feeds both)
//   stage 2 (axis 1): P = M1 A,  T = S1 A + M1 B
//   stage 3 (axis 0): y = S0 P + M0 T
//
// Bound on the card: u read and y written once, 8 bytes a node in
// float32 (161^3: 33.4 MB, 9.97 us at 3.35 TB/s) against about
// 14(2p+1) = 98 flops a node (6.1 us at 67 TFLOP/s): memory bounds it.
// The first design (a u plane tile by 4-byte loads, A, B and a 2p+1-slot
// ring of P and T planes in shared memory, three block barriers a plane,
// S0 and M0 read from device memory in the innermost loop) took 110 us
// at 161^3 on an H100 80GB HBM3 at 700 W, 11 times its bound.
//
// Design: a block owns a segment of up to K4_SEG_STRIPS strips of at
// most 32 columns of axis 2 (one consumer warp a strip, one column a
// lane), one run of at most R rows of axis 1 and a chunk of output planes
// of axis 0, and marches the chunk's planes with their 2p halo planes.  A
// producer warp streams each plane's u tile (the run's rows with a p-row
// halo, the segment's columns with a p-column halo) through a ring of
// K4_SLOTS slots in shared memory by bulk copies (the TMA unit) that
// complete on the slot's `full` mbarrier.  Where the segment is the whole
// width (n2 <= 32 K4_SEG_STRIPS), the tile's rows are one contiguous
// span of the node array and take one copy a plane; else each row takes
// one, lanes sharing the rows.  A copy is its span rounded out to 16
// bytes, landing at its offset from a 16-byte boundary (a row of an odd
// n2 starts unaligned, which rules out tensor maps); the consumers index
// with that shift.  (The first design streamed one 32-column strip of
// four runs, 38 copies of 33 columns a plane: the producer spent a
// block's whole life issuing them and the consumers waited for a third of
// theirs.)  A consumer thread owns one column and the run's R rows: for
// each plane it waits on `full`, computes A and B on its R + 2p rows in
// registers (its column's M2 and S2 taps in registers), releases the
// slot on `empty`, computes P and T on its R rows (the run's M1 and S1
// rows as 16-byte broadcast loads from shared memory), and pushes stage
// 3 forward: plane q's P and T add into a register ring of 2p+1
// output-plane accumulators, each with its own S0 and M0 entry (the
// plane coupling staged once a block, by source plane, in shared memory);
// the accumulator of output plane q - p is then complete, is stored and
// starts over for plane q + p + 1.  The ring index of a plane is static
// inside a switch on the plane's position mod 2p+1.  No intermediate
// leaves the registers, and after the set-up nothing waits on a block
// barrier.  Stages 1-2 recompute the 2p halo rows of a run ((R + 2p) / R)
// and the 2p halo planes of a chunk ((chunk + 2p) / chunk); R is set per
// degree and type from the registers a thread takes (k4_rows), and the
// launch plan trades the chunk against the blocks that fill the card.
//
// The launch plan comes from Python, gdm_torch/ops/stencil3.py::k4_plan:
// the strips of axis 2 (at most 32 columns each) and the grid (segments
// of at most K4_SEG_STRIPS strips, runs of at most R rows of axis 1,
// chunks of output planes of axis 0), every split even, and the block's
// bytes of shared memory; the launcher checks them against the kernel's
// layout and refuses a plan that does not fit it.  The degree p is a
// template parameter (odd p <= 7).
#include <cstddef>
#include <cstdint>
#include <utility>

#include "common.cuh"

namespace {

constexpr int K4_SEG_STRIPS = 6;  // strips (consumer warps) a segment
constexpr int K4_SLOTS = 4;       // planes in the copy ring
constexpr int K4_LANES = 32;      // the widest strip: one column a lane
constexpr int BAR_BYTES = 128;    // the ring's mbarriers, before the ring

// Rows a consumer thread owns at (T, P), from the registers a thread
// takes (ptxas on sm_90a): float32 8 at p = 1, 4 at p = 3 and 5, 2 at
// p = 7; float64 4 at p = 1, else 2 (stencil3.K4_ROWS mirrors it).
template <typename T, int P>
constexpr int k4_rows() {
  return sizeof(T) == 4 ? (P == 1 ? 8 : P <= 5 ? 4 : 2) : (P == 1 ? 4 : 2);
}

template <typename T, int P>
struct Geom {
  static constexpr int K = 2 * P + 1;
  static constexpr int R = k4_rows<T, P>();
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int KP = (K + VEC - 1) / VEC * VEC;  // band row pitch
  // a slot: the whole-width tile's rows as one span, or per row the
  // segment's width w + 2p (a lane may read 31 columns past its strip)
  // rounded out to 16 bytes, at a pitch of `pitch`
  __host__ __device__ static constexpr int pitch(int w) {
    return (w + 2 * P + K4_LANES + 2 * VEC + VEC - 1) / VEC * VEC;
  }
  __host__ __device__ static constexpr int slot(bool whole, int n2, int w) {
    return whole ? ((R + 2 * P) * n2 + 2 * P + K4_LANES + 2 * VEC + VEC - 1) /
                       VEC * VEC
                 : (R + 2 * P) * pitch(w);
  }
  // the ring, the run's [M1 | S1] rows and the chunk's [S0 | M0] entries
  __host__ __device__ static constexpr size_t bytes(bool whole, int n2,
                                                    int w, int chunk) {
    return BAR_BYTES +
           sizeof(T) * (static_cast<size_t>(K4_SLOTS) * slot(whole, n2, w) +
                        2 * R * KP + 2 * static_cast<size_t>(chunk + 2 * P) *
                                         KP);
  }
};

// f(integral_constant<int, s>) for the runtime s in [0, N): the register
// ring's index is static inside each call.
template <typename F, int... S>
__device__ __forceinline__ void static_switch(
    int s, F&& f, std::integer_sequence<int, S...>) {
  ((s == S ? f(std::integral_constant<int, S>()) : void()), ...);
}

// Stage 3 of one plane: its P and T into the ring slots of the 2p+1
// output planes it couples to (slot s + t for tap t, with the plane's S0
// and M0 entries cc[t], cc[KP + t]), then the completed output plane
// (slot s) to yo (rows below rs, when yo is set) and its slot cleared.
template <int S, typename T, int K, int R, int KP>
__device__ __forceinline__ void push(T (&acc)[K][R], const T (&pv)[R],
                                     const T (&tv)[R], const T (&cc)[2 * KP],
                                     T* yo, int rs, int n2) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T& a = acc[(S + t) % K][i];
      a = gdm::fma_(cc[t], pv[i], a);
      a = gdm::fma_(cc[KP + t], tv[i], a);
    }
  }
  if (yo != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < rs) yo[static_cast<size_t>(i) * n2] = acc[S][i];
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) acc[S][i] = T(0);
}

template <typename T, int P>
__global__ void __launch_bounds__(32 * (K4_SEG_STRIPS + 1))
laplace3_kernel(const T* __restrict__ u, const T* __restrict__ s0,
                const T* __restrict__ m0, const T* __restrict__ s1,
                const T* __restrict__ m1, const T* __restrict__ s2,
                const T* __restrict__ m2, T* __restrict__ y, int n0, int n1,
                int n2, int nrun, int nstrip) {
  using G = Geom<T, P>;
  constexpr int K = G::K;
  constexpr int R = G::R;
  constexpr int KP = G::KP;
  constexpr int VEC = G::VEC;
  constexpr int NS = K4_SLOTS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + NS;
  T* ring = reinterpret_cast<T*>(smem + BAR_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int producer = blockDim.x / 32 - 1;   // the last warp

  int k0, ns, r0, rs, q_lo, cq, cs0, ce, sz;
  gdm::part(nstrip, gridDim.x, blockIdx.x, k0, ns);   // the segment
  gdm::part(n1, nrun, blockIdx.y, r0, rs);            // the run
  gdm::part(n0, gridDim.z, blockIdx.z, q_lo, cq);     // the output planes
  gdm::part(n2, nstrip, k0, cs0, sz);                 // its columns
  gdm::part(n2, nstrip, k0 + ns, ce, sz);
  const bool whole = gridDim.x == 1;
  const int w_most = ((nstrip + gridDim.x - 1) / gridDim.x) *
                     ((n2 + nstrip - 1) / nstrip);
  const int pitch = whole ? n2 : G::pitch(w_most);
  const int slot = G::slot(whole, n2, w_most);
  T* c1 = ring + NS * slot;    // the run's R rows of [M1 | S1]
  T* cb = c1 + R * 2 * KP;     // (chunk + 2p) rows of [S0 | M0] entries
  const int m_total = cq + 2 * P;          // planes q = q_lo - p + m
  const int m_a = max(0, P - q_lo);        // the planes inside the grid
  const int m_b = min(m_total, n0 + P - q_lo);
  const long long plane = static_cast<long long>(n1) * n2;
  const int ga = max(r0 - P, 0);           // the tile's rows in the grid
  const int gb = min(r0 + rs + P, n1);

  // rows and columns no copy fills must hold finite values (their band
  // entries are zero): the ring starts as zeros
  for (int e = tid; e < NS * slot; e += blockDim.x) ring[e] = T(0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      gdm::bar_init(full + s, 1);
      gdm::bar_init(empty + s, ns);
    }
    gdm::bar_init_fence();
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0 || tid == 32 * producer, tid == 0 ? 1 : 9, clock64());

  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(u) / sizeof(T)) % VEC);
  if (warp == producer) {
    // ---- the producer warp ----
    const uintptr_t u_lo = reinterpret_cast<uintptr_t>(u) &
                           ~static_cast<uintptr_t>(15);
    const uintptr_t u_hi =
        (reinterpret_cast<uintptr_t>(u + n0 * plane) + 15) &
        ~static_cast<uintptr_t>(15);
    for (int m = m_a; m < m_b; ++m) {
      const int k = m - m_a;
      const int sl = k % NS;
      if (k >= NS) {
        const long long c0 = GDM_CLOCK();
        gdm::bar_wait(empty + sl, ((k / NS) - 1) & 1);
        GDM_STAMP_ADD(lane == 0, 10, GDM_CLOCK() - c0);
        (void)c0;
      }
      T* st = ring + sl * slot;
      const long long q = q_lo - P + m;
      if (whole) {
        // one span: rows ga .. gb - 1 with the p columns on either side;
        // element (r0 - p, -p) stands at st[sh], sh its misalignment
        if (lane == 0) {
          const long long e0 = (q * n1 + r0 - P) * n2 - P;
          const long long ea = (q * n1 + ga) * n2 - P;
          const long long eb = (q * n1 + gb) * n2 + P;
          const int sh = static_cast<int>(((mis + e0) % VEC + VEC) % VEC);
          const int ma = static_cast<int>(((mis + ea) % VEC + VEC) % VEC);
          gdm::copy_span(st + sh + (ea - e0) - ma, u, ea, eb, u_lo, u_hi,
                         full + sl);
        }
      } else {
        for (int rr = lane; rr < rs + 2 * P; rr += 32) {
          const int gi = r0 - P + rr;
          if (gi < 0 || gi >= n1) continue;  // rows outside: no copy
          const long long f = (q * n1 + gi) * n2 + cs0 - P;
          gdm::copy_span(st + rr * pitch, u, f, f + (ce - cs0) + 2 * P,
                         u_lo, u_hi, full + sl);
        }
      }
      __syncwarp();
      if (lane == 0) gdm::bar_arrive(full + sl);
    }
    GDM_STAMP(lane == 0, 11, clock64());
    return;
  }
  if (warp >= ns) return;  // a segment of fewer strips than the widest

  // ---- the consumers: one column of the run each ----
  int j0, t2;
  gdm::part(n2, nstrip, k0 + warp, j0, t2);
  const int j = j0 + lane;
  const bool col_in = lane < t2;
  T cm2[K], cs2[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    cm2[t] = col_in ? m2[static_cast<size_t>(j) * K + t] : T(0);
    cs2[t] = col_in ? s2[static_cast<size_t>(j) * K + t] : T(0);
  }
  // the run's M1 and S1 rows, zero past the run, and the plane coupling
  // by source plane: row m holds, for t = 0 .. 2p, the S0 and M0 entries
  // (i, q) of output plane i = q - p + t, q = q_lo - p + m (zero outside
  // the grid)
  const int nc = 32 * ns;
  for (int e = tid; e < R * 2 * KP; e += nc) {
    const int i = e / (2 * KP);
    const int t = e - i * 2 * KP;
    const int tt = t < KP ? t : t - KP;
    T v = T(0);
    if (i < rs && tt < K) {
      v = (t < KP ? m1 : s1)[static_cast<size_t>(r0 + i) * K + tt];
    }
    c1[e] = v;
  }
  for (int e = tid; e < m_total * 2 * KP; e += nc) {
    const int m = e / (2 * KP);
    const int t = e - m * 2 * KP;
    const int tt = t < KP ? t : t - KP;
    const int i = q_lo - 2 * P + m + tt;
    T v = T(0);
    if (tt < K && i >= 0 && i < n0) {
      v = (t < KP ? s0 : m0)[static_cast<size_t>(i) * K + 2 * P - tt];
    }
    cb[e] = v;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
  GDM_STAMP(tid == 0, 2, clock64());

  // element (q, r0 - p + jj, j0 - p + lane + t) sits at
  // ring[slot index + jj pitch + sh_jj + (j - cs0) + t]: sh_m the
  // misalignment of element (q, r0 - p, cs0 - p) for plane m, sh_jj = sh_m
  // for one span, sh_m + jj n2 (mod VEC) for copies by row
  const long long e0 = (static_cast<long long>(q_lo - P) * n1 + r0 - P) *
                           n2 + cs0 - P;
  int sh_m = static_cast<int>(((mis + e0) % VEC + VEC) % VEC);
  const int dsh = whole ? 0 : n2 % VEC;
  const int plv = static_cast<int>(plane % VEC);
  T* yc = y + static_cast<size_t>(r0) * n2 + j;
  T acc[K][R] = {};
  for (int m = 0; m < m_total; ++m) {
    T pv[R], tv[R];
    if (m >= m_a && m < m_b) {
      const int k = m - m_a;
      const int sl = k % NS;
      const long long c0 = GDM_CLOCK();
      gdm::bar_wait(full + sl, (k / NS) & 1);
      GDM_STAMP_ADD(tid == 0, 3, GDM_CLOCK() - c0);
      (void)c0;
      // stage 1: A and B on the run's R + 2p rows
      const T* rows = ring + sl * slot + (j - cs0);
      T a[R + 2 * P], b[R + 2 * P];
      int sh = sh_m;
#pragma unroll
      for (int jj = 0; jj < R + 2 * P; ++jj) {
        const T* x = rows + jj * pitch + sh;
        T av = T(0);
        T bv = T(0);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const T xv = x[t];
          av = gdm::fma_(cm2[t], xv, av);
          bv = gdm::fma_(cs2[t], xv, bv);
        }
        a[jj] = av;
        b[jj] = bv;
        sh = (sh + dsh) & (VEC - 1);
      }
      __syncwarp();
      if (lane == 0) gdm::bar_arrive(empty + sl);
      // stage 2: P = M1 A, T = S1 A + M1 B on the run's R rows
#pragma unroll
      for (int i = 0; i < R; ++i) {
        T c[2 * KP];
        gdm::load_row16<T, 2 * KP>(c1 + i * 2 * KP, c);
        T pi = T(0);
        T ti = T(0);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          pi = gdm::fma_(c[t], a[i + t], pi);
          ti = gdm::fma_(c[KP + t], a[i + t], ti);
          ti = gdm::fma_(c[t], b[i + t], ti);
        }
        pv[i] = pi;
        tv[i] = ti;
      }
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = tv[i] = T(0);
    }
    // stage 3, pushed forward; output plane q - p is complete
    T cc[2 * KP];
    gdm::load_row16<T, 2 * KP>(cb + m * 2 * KP, cc);
    const int io = m - 2 * P;
    T* yo = (io >= 0 && col_in)
                ? yc + static_cast<size_t>(q_lo + io) * plane
                : nullptr;
    static_switch(
        m % K,
        [&](auto s) {
          push<decltype(s)::value, T, K, R, KP>(acc, pv, tv, cc, yo, rs, n2);
        },
        std::make_integer_sequence<int, K>());
    sh_m = (sh_m + plv) & (VEC - 1);
  }
  GDM_STAMP(tid == 0, 4, clock64());
  GDM_STAMP(tid == 0, 5, gdm_gtimer());
}

template <typename T, int P>
int launch_p(const void* u, const void* s0, const void* m0, const void* s1,
             const void* m1, const void* s2, const void* m2, void* y, int n0,
             int n1, int n2, int strips, int segments, int runs, int chunks,
             int smem, cudaStream_t stream) {
  using G = Geom<T, P>;
  // parts of n, each at most `most` (an even split has no empty part)
  auto fits = [](int n, int parts, int most) {
    return parts >= 1 && parts <= n && (n + parts - 1) / parts <= most &&
           parts <= 65535;
  };
  if (!fits(n2, strips, K4_LANES) || !fits(strips, segments, K4_SEG_STRIPS) ||
      !fits(n1, runs, G::R) || !fits(n0, chunks, n0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ns_most = (strips + segments - 1) / segments;
  const size_t bytes =
      G::bytes(segments == 1, n2, ns_most * ((n2 + strips - 1) / strips),
               (n0 + chunks - 1) / chunks);
  if (static_cast<size_t>(smem) != bytes || bytes > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace3_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(segments, runs, chunks);
  laplace3_kernel<T, P><<<grid, 32 * (ns_most + 1), bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(s0),
      static_cast<const T*>(m0), static_cast<const T*>(s1),
      static_cast<const T*>(m1), static_cast<const T*>(s2),
      static_cast<const T*>(m2), static_cast<T*>(y), n0, n1, n2, runs,
      strips);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* u, const void* s0, const void* m0, const void* s1,
           const void* m1, const void* s2, const void* m2, void* y, int p,
           int n0, int n1, int n2, int strips, int segments, int runs,
           int chunks, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
#define GDM_K4_CASE(P)                                                   \
  case P:                                                                \
    return launch_p<T, P>(u, s0, m0, s1, m1, s2, m2, y, n0, n1, n2,     \
                          strips, segments, runs, chunks, smem, s);
    GDM_K4_CASE(1) GDM_K4_CASE(3) GDM_K4_CASE(5) GDM_K4_CASE(7)
#undef GDM_K4_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int P>
int occupancy_p(int warps, int smem, int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        laplace3_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, laplace3_kernel<T, P>, 32 * (warps + 1), smem));
}

template <typename T>
int occupancy(int p, int warps, int smem, int* out) {
  switch (p) {
    case 1: return occupancy_p<T, 1>(warps, smem, out);
    case 3: return occupancy_p<T, 3>(warps, smem, out);
    case 5: return occupancy_p<T, 5>(warps, smem, out);
    case 7: return occupancy_p<T, 7>(warps, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The plan: strips of axis 2; segments, runs and chunks (the grid);
// bytes of shared memory a block.
int gdm_laplace3_apply_f32(const void* u, const void* s0, const void* m0,
                           const void* s1, const void* m1, const void* s2,
                           const void* m2, void* y, int p, int n0, int n1,
                           int n2, int strips, int segments, int runs,
                           int chunks, int smem, void* stream) {
  return launch<float>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, strips,
                       segments, runs, chunks, smem, stream);
}

int gdm_laplace3_apply_f64(const void* u, const void* s0, const void* m0,
                           const void* s1, const void* m1, const void* s2,
                           const void* m2, void* y, int p, int n0, int n1,
                           int n2, int strips, int segments, int runs,
                           int chunks, int smem, void* stream) {
  return launch<double>(u, s0, m0, s1, m1, s2, m2, y, p, n0, n1, n2, strips,
                        segments, runs, chunks, smem, stream);
}

// Blocks of K4 one SM holds with `warps` consumer warps and `smem` bytes
// of shared memory, as the runtime's occupancy calculator reports them
// for the built kernel (stencil3.k4_plan's default model).
int gdm_laplace3_occupancy(int p, int f64, int warps, int smem, int* out) {
  return f64 ? occupancy<double>(p, warps, smem, out)
             : occupancy<float>(p, warps, smem, out);
}

}  // extern "C"
