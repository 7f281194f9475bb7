// K2: the whole FSAI-preconditioned CG of a 2D band system in one launch.
//
// Replaces gdm/ops/pallas_resident.py::make_resident_cg, which loads the
// band A and the FSAI factors G, G^T (gdm/cut/fsai.py) into the TPU's
// VMEM once and runs every CG iteration on chip.  Semantics kept from
// that kernel:
//   * stop while it < max_iter && ||r|| > max(abs_tol, rel_tol*||r0||)
//     (deal.II ReductionControl), with early exit;
//   * alpha = 0 when p^T A p <= 0 and beta = 0 when r^T z <= 0;
//   * after the loop, one fresh apply gives the TRUE residual ||b - A x||
//     (the recurrence residual can drift from it on ill-conditioned
//     systems; gdm_torch.cut.fsai.verified_fsai_solver checks it);
//   * stats = [true ||b - A x||, iterations, ||r0||] (f32).
//
// Bound on the card: latency of the grid-wide synchronizations and L2
// bandwidth.  Hopper has no 96 MB on-chip store, so there is no
// counterpart of gdm's VMEM gate (pallas_resident.py:60,114-116): the
// planes stay in device memory, and at the flagship 128^2 size all of
// them (A: 77, G and G^T: 41 each, ~12 MB in f32) plus the six work
// vectors fit in the 50 MB L2, so after the first iteration the applies
// read L2, not HBM.  Each iteration costs four band sweeps' worth of
// L2 traffic (~159 planes) and five grid syncs; at ~19k cells the card
// is mostly idle between syncs.
//
// Design: a cooperative persistent kernel (cudaLaunchCooperativeKernel)
// with at most occupancy x SM-count blocks of 256 threads, each striding
// over the flat padded array.  cooperative_groups::this_grid().sync()
// separates the phases (A p, x/r update, G r, G^T t, p update).  Every
// dot product is summed per thread in double, reduced per block, and
// written to one slot per block; after the next grid sync every block
// sums all slots in the same order, so every block derives the same
// alpha, beta and stop decision and none can leave the loop while
// others wait at a sync.  The kernel allocates nothing: the caller
// passes the work vectors r, z, p, Ap, t and the per-block slots.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 256;

template <typename T>
struct Args {
  const T* b;
  T* x;  // in: x0, out: the solution
  const T* plA;
  const int* offA;
  int nA;
  const T* plG;
  const int* offG;
  int nG;
  const T* plGT;
  const int* offGT;
  int nGT;
  int precond;       // 0: z = r (plain CG)
  T* work;           // 5 * rows * pitch: r, z, p, Ap, t
  double* partials;  // 3 * gridDim.x: p^T A p, r^T r, r^T z
  float* stats;      // 3
  int rows, pitch, n0, n1, r;
  int max_iter;
  double rel_tol, abs_tol;
};

// Band apply at one cell; soff holds the flat offsets dy * pitch + dx.
template <typename T>
__device__ __forceinline__ T band_at(const T* __restrict__ planes,
                                     const int* soff, int n, long long plane,
                                     long long idx, const T* u) {
  T acc = T(0);
  for (int t = 0; t < n; ++t) {
    acc = gdm::fma_(planes[t * plane + idx], u[idx + soff[t]], acc);
  }
  return acc;
}

// Sum over the block; the result is valid in thread 0.
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < BLOCK / 32; ++w) s += red[w];
  }
  return s;
}

// Sum of all blocks' slots, in slot order, broadcast to the block.
// Call after a grid sync that follows the writes.
__device__ double grid_total(const double* slots, double* bcast) {
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < static_cast<int>(gridDim.x); ++i) s += __ldcg(slots + i);
    *bcast = s;
  }
  __syncthreads();
  const double s = *bcast;
  __syncthreads();  // bcast is rewritten by the next call
  return s;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) resident_cg_kernel(Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int soff[];  // flat tap offsets of A, then G, then G^T
  __shared__ double red[BLOCK / 32];
  __shared__ double bcast;

  const int ntap = a.nA + a.nG + a.nGT;
  for (int k = threadIdx.x; k < ntap; k += BLOCK) {
    const int* o = k < a.nA          ? a.offA + 2 * k
                   : k < a.nA + a.nG ? a.offG + 2 * (k - a.nA)
                                     : a.offGT + 2 * (k - a.nA - a.nG);
    soff[k] = o[0] * a.pitch + o[1];
  }
  __syncthreads();
  const int* sA = soff;
  const int* sG = soff + a.nA;
  const int* sGT = sG + a.nG;

  const long long cells = static_cast<long long>(a.rows) * a.pitch;
  T* r = a.work;
  T* z = r + cells;
  T* p = z + cells;
  T* Ap = p + cells;
  T* t = Ap + cells;
  T* zz = a.precond ? z : r;  // the preconditioned residual
  const long long start =
      static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * BLOCK;
  double* slot_pAp = a.partials;
  double* slot_rr = a.partials + gridDim.x;
  double* slot_rz = a.partials + 2 * gridDim.x;
  const bool lead = threadIdx.x == 0;
  auto node = [&](long long idx) {
    return gdm::is_node(static_cast<int>(idx / a.pitch),
                        static_cast<int>(idx % a.pitch), a.n0, a.n1, a.r);
  };

  // r = b - A x0, z = B r, p = z
  for (long long i = start; i < cells; i += stride) {
    r[i] = a.b[i] - (node(i) ? band_at(a.plA, sA, a.nA, cells, i, a.x) : T(0));
  }
  grid.sync();
  if (a.precond) {
    for (long long i = start; i < cells; i += stride) {
      t[i] = node(i) ? band_at(a.plG, sG, a.nG, cells, i, r) : T(0);
    }
    grid.sync();
    for (long long i = start; i < cells; i += stride) {
      z[i] = node(i) ? band_at(a.plGT, sGT, a.nGT, cells, i, t) : T(0);
    }
  }
  double srz = 0.0, srr = 0.0;
  for (long long i = start; i < cells; i += stride) {
    const T ri = r[i], zi = zz[i];
    srz += static_cast<double>(ri) * zi;
    srr += static_cast<double>(ri) * ri;
    p[i] = zi;
  }
  srz = block_sum(srz, red);
  if (lead) slot_rz[blockIdx.x] = srz;
  srr = block_sum(srr, red);
  if (lead) slot_rr[blockIdx.x] = srr;
  grid.sync();
  double rz = grid_total(slot_rz, &bcast);
  const double nr0 = sqrt(grid_total(slot_rr, &bcast));
  const double tol = fmax(a.abs_tol, a.rel_tol * nr0);
  double nr = nr0;
  int it = 0;

  while (it < a.max_iter && nr > tol) {
    // Ap = A p and p^T A p
    double s = 0.0;
    for (long long i = start; i < cells; i += stride) {
      const T v = node(i) ? band_at(a.plA, sA, a.nA, cells, i, p) : T(0);
      Ap[i] = v;
      s += static_cast<double>(p[i]) * v;
    }
    s = block_sum(s, red);
    if (lead) slot_pAp[blockIdx.x] = s;
    grid.sync();
    const double pAp = grid_total(slot_pAp, &bcast);
    const T alpha = static_cast<T>(pAp <= 0.0 ? 0.0 : rz / pAp);
    // x += alpha p, r -= alpha Ap, and r^T r
    s = 0.0;
    for (long long i = start; i < cells; i += stride) {
      a.x[i] += alpha * p[i];
      const T ri = r[i] - alpha * Ap[i];
      r[i] = ri;
      s += static_cast<double>(ri) * ri;
    }
    s = block_sum(s, red);
    if (lead) slot_rr[blockIdx.x] = s;
    grid.sync();
    double rz_new;
    if (a.precond) {
      // z = G^T (G r) and r^T z
      for (long long i = start; i < cells; i += stride) {
        t[i] = node(i) ? band_at(a.plG, sG, a.nG, cells, i, r) : T(0);
      }
      grid.sync();
      s = 0.0;
      for (long long i = start; i < cells; i += stride) {
        const T v = node(i) ? band_at(a.plGT, sGT, a.nGT, cells, i, t) : T(0);
        z[i] = v;
        s += static_cast<double>(r[i]) * v;
      }
      s = block_sum(s, red);
      if (lead) slot_rz[blockIdx.x] = s;
      grid.sync();
      rz_new = grid_total(slot_rz, &bcast);
    } else {
      rz_new = grid_total(slot_rr, &bcast);
    }
    nr = sqrt(grid_total(slot_rr, &bcast));
    const T beta = static_cast<T>(rz <= 0.0 ? 0.0 : rz_new / rz);
    for (long long i = start; i < cells; i += stride) {
      p[i] = zz[i] + beta * p[i];
    }
    rz = rz_new;
    ++it;
    grid.sync();
  }

  // the true residual from one fresh apply
  double s = 0.0;
  for (long long i = start; i < cells; i += stride) {
    const T v =
        a.b[i] - (node(i) ? band_at(a.plA, sA, a.nA, cells, i, a.x) : T(0));
    s += static_cast<double>(v) * v;
  }
  s = block_sum(s, red);
  if (lead) slot_pAp[blockIdx.x] = s;
  grid.sync();
  if (blockIdx.x == 0) {
    const double true_rr = grid_total(slot_pAp, &bcast);
    if (lead) {
      a.stats[0] = static_cast<float>(sqrt(true_rr));
      a.stats[1] = static_cast<float>(it);
      a.stats[2] = static_cast<float>(nr0);
    }
  }
}

template <typename T>
int grid_blocks(int cells, int n_taps, int* nblocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, resident_cg_kernel<T>, BLOCK,
      static_cast<size_t>(n_taps) * sizeof(int));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int need = (cells + BLOCK - 1) / BLOCK;
  *nblocks = need < per_sm * sms ? need : per_sm * sms;
  return 0;
}

template <typename T>
int launch(const void* b, void* x, const void* plA, const void* offA, int nA,
           const void* plG, const void* offG, int nG, const void* plGT,
           const void* offGT, int nGT, int precond, void* work,
           void* partials, int nblocks, void* stats, int rows, int pitch,
           int n0, int n1, int r, int max_iter, double rel_tol,
           double abs_tol, void* stream) {
  Args<T> a;
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  a.plA = static_cast<const T*>(plA);
  a.offA = static_cast<const int*>(offA);
  a.nA = nA;
  a.plG = static_cast<const T*>(plG);
  a.offG = static_cast<const int*>(offG);
  a.nG = nG;
  a.plGT = static_cast<const T*>(plGT);
  a.offGT = static_cast<const int*>(offGT);
  a.nGT = nGT;
  a.precond = precond;
  a.work = static_cast<T*>(work);
  a.partials = static_cast<double*>(partials);
  a.stats = static_cast<float*>(stats);
  a.rows = rows;
  a.pitch = pitch;
  a.n0 = n0;
  a.n1 = n1;
  a.r = r;
  a.max_iter = max_iter;
  a.rel_tol = rel_tol;
  a.abs_tol = abs_tol;
  void* params[] = {&a};
  const size_t smem = static_cast<size_t>(nA + nG + nGT) * sizeof(int);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(resident_cg_kernel<T>), dim3(nblocks),
      dim3(BLOCK), params, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gdm_resident_cg_blocks_f32(int cells, int n_taps, int* nblocks) {
  return grid_blocks<float>(cells, n_taps, nblocks);
}

int gdm_resident_cg_blocks_f64(int cells, int n_taps, int* nblocks) {
  return grid_blocks<double>(cells, n_taps, nblocks);
}

int gdm_resident_cg_f32(const void* b, void* x, const void* plA,
                        const void* offA, int nA, const void* plG,
                        const void* offG, int nG, const void* plGT,
                        const void* offGT, int nGT, int precond, void* work,
                        void* partials, int nblocks, void* stats, int rows,
                        int pitch, int n0, int n1, int r, int max_iter,
                        double rel_tol, double abs_tol, void* stream) {
  return launch<float>(b, x, plA, offA, nA, plG, offG, nG, plGT, offGT, nGT,
                       precond, work, partials, nblocks, stats, rows, pitch,
                       n0, n1, r, max_iter, rel_tol, abs_tol, stream);
}

int gdm_resident_cg_f64(const void* b, void* x, const void* plA,
                        const void* offA, int nA, const void* plG,
                        const void* offG, int nG, const void* plGT,
                        const void* offGT, int nGT, int precond, void* work,
                        void* partials, int nblocks, void* stats, int rows,
                        int pitch, int n0, int n1, int r, int max_iter,
                        double rel_tol, double abs_tol, void* stream) {
  return launch<double>(b, x, plA, offA, nA, plG, offG, nG, plGT, offGT, nGT,
                        precond, work, partials, nblocks, stats, rows, pitch,
                        n0, n1, r, max_iter, rel_tol, abs_tol, stream);
}

}  // extern "C"
