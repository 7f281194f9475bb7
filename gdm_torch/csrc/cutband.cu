// K1: the 2D stencil-band apply on the padded layout.
//
// Replaces gdm/ops/pallas_cutband.py::make_padded_stencil2 (the TPU
// kernel behind gdm/cut/fastapply.py::fast_stencil_bundle):
//
//   y[i0, i1] = sum_t plane[t][i0, i1] * u[i0 + dy_t, i1 + dx_t]
//
// over the operator's nonzero taps t (at most (2r+1)^2, 81 at p = 3),
// with y = 0 on every guard cell, so the layout is closed under the
// apply and CG can run inside it.
//
// Bound on the card: memory.  Each cell reads its T coefficients once
// and u/y cost two more words, about (T + 2) * 4 bytes per cell in f32
// against 2T flops, far below the H100's flop-per-byte balance.  At the
// flagship 128^2 size (T = 77 planes of 137 x 140 f32, 5.9 MB) the
// planes sit in the 50 MB L2 and the floor is 1.8 us at HBM rate; at
// 512^2 (521 x 524, 84 MB) they stream from HBM, 25.7 us at 3.35 TB/s.
// In practice a block is bound by the latency of its loads: the first
// design (one thread a cell, all T taps one after another, 32 x 8 cells
// a block) spent 1.1 us of a 3.6 us block at 128^2 copying its u tile
// before its first tap load and 2.3 us on 77 dependent 4-byte taps.
//
// Design: a thread owns a vector of V adjacent cells of one row (V = 4
// in float32, 2 in float64: the pitch is a multiple of 4, so every
// plane row starts on 16 bytes and each tap is one 16-byte load) and
// one of G tap groups (the taps split evenly, G = 1, 2, 4 or 8).  A
// block of 256 threads holds a tile 32 cells wide and 256 V / (32 G)
// rows high, once for each group; a warp is 32 / V vectors by V rows,
// so its plane loads are whole 128-byte lines.  A thread first issues
// the loads of all its group's taps at once (up to MAXT = 12 or 24 of
// them, in registers; a larger group loads the rest MAXT at a time),
// and only then copies the block's u tile (with the r-wide halo, UB
// loads in flight a thread) and the tap offsets into shared memory, so
// the tile's copy and the one barrier hide under the planes' loads.
// The tile's pitch is 1 mod 32 words, so the four rows of a float32
// warp hit 32 distinct banks.  The groups leave their partial sums in
// shared memory and, after a second barrier, each cell's thread adds
// them in group order: the result does not depend on timing.  Cells
// outside the node block (the guard frame and the pitch tail) load no
// planes and store zeros.  The launch is a programmatic dependent one
// (common.cuh, launch_overlapped): a block may start, and issue its
// plane loads, while the kernel before it in the stream finishes, and
// reads u and writes y only once that kernel has ended.
//
// The launch plan comes from Python, gdm_torch/ops/cutband.py::k1_plan:
// G (eight at the flagship's 77 taps: 9-10 a thread, all in flight),
// MAXT, and the tiles along rows and vectors (ntr, ntc), each axis split
// evenly (a tile holds the floor or the ceiling of n / tiles).
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads of a block
constexpr int UB = 8;    // u tile loads a thread keeps in flight

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
};

__device__ __forceinline__ void unpack(const float4& v, float (&x)[4]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double (&x)[2]) {
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float (&x)[4]) {
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ double2 pack(const double (&x)[2]) {
  return make_double2(x[0], x[1]);
}

// the u tile's pitch: 32 cells plus the halo, rounded up to 1 mod 32
__host__ __device__ constexpr int tile_pitch(int r) {
  return (32 + 2 * r + 30) / 32 * 32 + 1;
}

// an even split of n into parts: the start and size of part k
__device__ __forceinline__ void part(int n, int parts, int k, int& lo,
                                     int& size) {
  const int base = n / parts;
  const int rem = n - base * parts;
  lo = k * base + min(k, rem);
  size = base + (k < rem ? 1 : 0);
}

// MAXT: the taps a thread has in flight at once (all of its group's when
// the group has no more)
template <typename T, int MAXT>
__global__ void __launch_bounds__(NT)
cutband_apply_kernel(const T* __restrict__ u, const T* __restrict__ planes,
                     const int* __restrict__ offs, T* __restrict__ y,
                     int n_taps, int rows, int pitch, int n0, int n1, int r,
                     int groups, int ntr, int ntc) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::N;
  constexpr int TQ = 32 / V;  // vectors across a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = NT / groups;  // vector slots of the tile
  const int th = cells / TQ;      // rows of the tile
  const int tw = tile_pitch(r);
  // the groups' partial sums (G > 1), the u tile, the tap offsets
  VT* red = reinterpret_cast<VT*>(smem);
  T* tile = reinterpret_cast<T*>(red + (groups > 1 ? NT : 0));
  int* soff = reinterpret_cast<int*>(tile + (th + 2 * r) * tw);

  const int tid = threadIdx.x;
  const int g = tid / cells;  // whole warps: cells is a multiple of 32
  const int c = tid - g * cells;
  const int qx = c % TQ;
  const int ry = c / TQ;
  int i0, t0, q0, tq;
  part(rows, ntr, blockIdx.x / ntc, i0, t0);
  part(pitch / V, ntc, blockIdx.x % ntc, q0, tq);
  const int row = i0 + ry;
  const int col = (q0 + qx) * V;
  const bool live = ry < t0 && qx < tq && row >= r && row < r + n0 &&
                    col + V > r && col < r + n1;
  int t_lo, t_n;
  part(n_taps, groups, g, t_lo, t_n);
  const size_t plane = static_cast<size_t>(rows) * pitch;
  const T* pc = planes + static_cast<size_t>(row) * pitch + col;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());

  // 1. the group's first MAXT taps' planes in flight at once
  T buf[MAXT][V];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      VT v = VT{};
      if (live && base + i < t_n) {
        v = __ldg(reinterpret_cast<const VT*>(
            pc + static_cast<size_t>(t_lo + base + i) * plane));
      }
      unpack(v, buf[i]);
    }
  };
  // 2. the u tile, rows i0 - r .. i0 + t0 + r (zero outside the layout),
  // UB loads a thread at a time, and the taps' offsets in it.  The planes
  // are set-up data, loaded while the kernel before this one may still
  // run (launch_overlapped); u is read, and y written, only once it has
  // ended.  (Issuing the u tile's loads ahead of the planes measured
  // slower at 128^2 and 512^2.)
  const int uw = tq * V + 2 * r;
  const int un = (t0 + 2 * r) * uw;
  T x[UB];
  auto u_load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int k = k0 + i * NT;
      const int gy = i0 - r + k / uw;
      const int gx = q0 * V - r + k % uw;
      x[i] = k < un && gy >= 0 && gy < rows && gx >= 0 && gx < pitch
                 ? u[static_cast<size_t>(gy) * pitch + gx]
                 : T(0);
    }
  };
  auto u_store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int k = k0 + i * NT;
      if (k < un) tile[(k / uw) * tw + k % uw] = x[i];
    }
  };
  load(0);
  gdm::grid_dep_wait();
  gdm::grid_dep_release();
  u_load(tid);
  GDM_STAMP(tid == 0, 2, clock64());
  u_store(tid);
  for (int k0 = tid + UB * NT; k0 < un; k0 += UB * NT) {
    u_load(k0);
    u_store(k0);
  }
  for (int t = tid; t < n_taps; t += NT) {
    soff[t] = offs[2 * t] * tw + offs[2 * t + 1];
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 3, clock64());

  // 3. the sums; a group of more than MAXT taps loads the rest MAXT at a
  // time
  T acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = T(0);
  const T* center = tile + (ry + r) * tw + qx * V + r;
  for (int base = 0;;) {
#pragma unroll
    for (int i = 0; i < MAXT; ++i) {
      if (base + i < t_n) {
        const T* x = center + soff[t_lo + base + i];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = gdm::fma_(buf[i][e], x[e], acc[e]);
      }
    }
    base += MAXT;
    if (base >= t_n) break;
    load(base);
  }
  GDM_STAMP(tid == 0, 4, clock64());

  // 4. group order: every group leaves its partial sums in shared memory
  // and, after one barrier, slot cs's thread adds them in group order;
  // zeros off the nodes
  int cs = c;
  if (groups > 1) {
    red[g * cells + c] = pack(acc);
    __syncthreads();
    if (tid >= cells) return;
    cs = tid;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = T(0);
    for (int h = 0; h < groups; ++h) {
      T part_sum[V];
      unpack(red[h * cells + cs], part_sum);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += part_sum[e];
    }
  }
  GDM_STAMP(tid == 0, 5, clock64());
  const int sx = cs % TQ;
  const int sy = cs / TQ;
  if (sx >= tq || sy >= t0) return;
  const int orow = i0 + sy;
  const int ocol = (q0 + sx) * V;
  const bool row_in = orow >= r && orow < r + n0;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (!(row_in && ocol + e >= r && ocol + e < r + n1)) acc[e] = T(0);
  }
  *reinterpret_cast<VT*>(y + static_cast<size_t>(orow) * pitch + ocol) =
      pack(acc);
  GDM_STAMP(tid == 0, 6, clock64());
  GDM_STAMP(tid == 0, 7, gdm_gtimer());
}

template <typename T, int MAXT>
int launch(const void* u, const void* planes, const void* offs, void* y,
           int n_taps, int rows, int pitch, int n0, int n1, int r, int groups,
           int ntr, int ntc, void* stream) {
  constexpr int V = Vec<T>::N;
  const int th = NT * V / (32 * groups);
  if (groups < 1 || NT % (groups * 32) != 0 || pitch % 4 != 0 || ntr < 1 ||
      ntc < 1 || ntr > rows || ntc > pitch / V ||
      (rows + ntr - 1) / ntr > th || (pitch / V + ntc - 1) / ntc > 32 / V) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      (groups > 1 ? static_cast<size_t>(NT) * V * sizeof(T) : 0) +
      static_cast<size_t>(th + 2 * r) * tile_pitch(r) * sizeof(T) +
      static_cast<size_t>(n_taps) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cutband_apply_kernel<T, MAXT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(gdm::launch_overlapped(
      cutband_apply_kernel<T, MAXT>, dim3(ntr * ntc), dim3(NT), smem,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(u),
      static_cast<const T*>(planes), static_cast<const int*>(offs),
      static_cast<T*>(y), n_taps, rows, pitch, n0, n1, r, groups, ntr, ntc));
}

template <typename T>
int launch_t(const void* u, const void* planes, const void* offs, void* y,
             int n_taps, int rows, int pitch, int n0, int n1, int r,
             int groups, int ntr, int ntc, int maxt, void* stream) {
  switch (maxt) {
    case 12:
      return launch<T, 12>(u, planes, offs, y, n_taps, rows, pitch, n0, n1,
                           r, groups, ntr, ntc, stream);
    case 24:
      return launch<T, 24>(u, planes, offs, y, n_taps, rows, pitch, n0, n1,
                           r, groups, ntr, ntc, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gdm_cutband_apply_f32(const void* u, const void* planes, const void* offs,
                          void* y, int n_taps, int rows, int pitch, int n0,
                          int n1, int r, int groups, int ntr, int ntc,
                          int maxt, void* stream) {
  return launch_t<float>(u, planes, offs, y, n_taps, rows, pitch, n0, n1, r,
                         groups, ntr, ntc, maxt, stream);
}

int gdm_cutband_apply_f64(const void* u, const void* planes, const void* offs,
                          void* y, int n_taps, int rows, int pitch, int n0,
                          int n1, int r, int groups, int ntr, int ntc,
                          int maxt, void* stream) {
  return launch_t<double>(u, planes, offs, y, n_taps, rows, pitch, n0, n1, r,
                          groups, ntr, ntc, maxt, stream);
}

const char* gdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
