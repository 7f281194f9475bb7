// K2: the whole preconditioned CG of a 2D band system in one launch.
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
//   * stats = [true ||b - A x||, iterations, ||r0||, ran] (f32), ran = 1
//     for a solve, 0 for a launch its gate closed.
//
// The preconditioner's mode, a template parameter (each mode its own
// kernel, so the FSAI mode's code is the one-mode kernel's):
//   * MODE_NONE: plain CG;
//   * MODE_FSAI: z = G^T (G r), two bands (gdm's resident kernel);
//   * MODE_BAND: z = P r, one band P: the streamed route's assembled
//     Schwarz band (gdm/cut/fsai.py's _streamed_solver, gdm's
//     lax.while_loop CG on its TPU route) or a Jacobi preconditioner as
//     a one-tap band.  Stage B writes z and r^T z as it writes r, so an
//     iteration has two grid syncs, not three.
// The gate: with a pointer to the stats of an earlier solve, the launch
// solves only when those stats fail gdm's check, true residual > slack *
// max(abs, rel * ||r0||) (gdm/cut/fsai.py:336-356, whose lax.cond
// reruns a rejected solve); otherwise every block returns at once, x
// keeps x0 and stats reads [0, 0, 0, 0].
//
// Bound on the card: latency.  At the flagship 128^2 size (137 x 140
// cells; A 77 taps, G and G^T 41 each) the bytes of a whole solve take
// under 4 us at 3.35 TB/s, while every iteration waits on grid-wide
// synchronizations, L2 round trips and the serial tap sums of few cells.
// What the design does about each:
//   * one block per SM, 512 threads.  Block b owns the contiguous range
//     [b cells / G, (b + 1) cells / G) of the flat padded array.
//   * planes resident (SHARED = true): at launch each block copies its
//     cells' slice of every A, G and G^T plane into shared memory
//     (cp.async), once per solve, as gdm keeps them in VMEM; no
//     iteration reads a plane from device memory again.  Where they do
//     not fit (the launcher decides from the bytes, gdm_torch/ops/
//     resident.py::resident_plan), SHARED = false reads them through the
//     read-only path and keeps everything below.
//   * vectors staged with their halo: before a band apply a block stages
//     the cells its taps reach, the window of rows dy = -r .. r around
//     its chunk (stride sw = min(pitch, chunk + 2r): one contiguous run
//     [c0 - r pitch - r, c0 + chunk + r pitch + r) when the chunk spans a
//     row, 2r + 1 short runs when it does not), into shared memory, and
//     sums each cell's taps from there.  One thread sums a cell's taps,
//     in tap order with fma: a float32 solve ends at float32's accuracy
//     floor, where another summation order moves the true residual by up
//     to ~10% (PERF.md section 6), and splitting a cell's taps over
//     threads buys nothing while the shared-memory loads (two a tap)
//     bound the sum.
//   * three grid syncs an iteration in MODE_FSAI (two in MODE_NONE and
//     MODE_BAND) instead of five: the buffers of r and p are
//     ping-ponged, and the halo values of p = z + beta p and of
//     r = r - alpha Ap that a phase needs are computed again by every
//     block that reads them:
//       A: p = z + beta p (window), Ap = A p, p^T A p;        sync
//       B: alpha; r -= alpha Ap (window), x += alpha p,
//          t = G r, r^T r (MODE_BAND: z = P r, r^T z);        sync
//       C: z = G^T t, r^T z (MODE_FSAI only);                 sync
//     beta and the stop decision come from the slots at the top of the
//     next iteration.  A value two blocks compute must agree bit for
//     bit, so the updates are pinned to __fma_rn/__fmaf_rn.
//   * deterministic sums: each dot is summed per thread in double,
//     reduced per block in a fixed order into one slot per block; after
//     the grid sync warp 0 of every block reads all slots 32 lanes wide
//     and reduces them with a fixed shuffle tree, so every block derives
//     the same alpha, beta and stop decision and none can leave the loop
//     while others wait at a sync.
// The kernel allocates nothing: the caller passes the work vectors (r
// twice, p twice, Ap, t, z) and the per-block slots.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MODE_NONE = 0, MODE_FSAI = 1, MODE_BAND = 2;
constexpr int NT = 512;                  // threads per block, one block per SM
constexpr int NWARP = NT / 32;
constexpr int SCRATCH = NWARP + 8;       // doubles at the head of shared memory

template <typename T>
struct Args {
  const T* b;
  T* x;  // in: x0, out: the solution
  const T* pl[3];    // planes of A, G, G^T: (n[k], rows, pitch)
  const int* off[3];  // their (dy, dx) offsets
  int n[3];          // taps: n[1] = n[2] = 0 in MODE_NONE, n[2] = 0 in
                     // MODE_BAND (P in slot 1)
  T* work;           // 7 * cells: r (two), p (two), Ap, t, z
  double* partials;  // 3 * gridDim.x: p^T A p, r^T r, r^T z
  float* stats;      // 4
  const float* gate;  // stats of an earlier solve, or null
  double gate_slack, gate_rel, gate_abs;
  long long cells;
  int pitch, n0, n1, r;
  int chunk;         // cells a block stages at once (its range if SHARED)
  int sw;            // the window's row stride
  int max_iter;
  double rel_tol, abs_tol;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T, bool SHARED, int MODE>
__global__ void __launch_bounds__(NT, 1) resident_cg_kernel(Args<T> a) {
  if (a.gate) {
    // every block reads the same stats and takes the same branch
    const double g_tol =
        fmax(a.gate_abs, a.gate_rel * static_cast<double>(a.gate[2]));
    if (!(static_cast<double>(a.gate[0]) > a.gate_slack * g_tol)) {
      if (blockIdx.x == 0 && threadIdx.x < 4) a.stats[threadIdx.x] = 0.0f;
      return;
    }
  }
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scr = reinterpret_cast<double*>(smem_raw);
  const int ntap = a.n[0] + a.n[1] + a.n[2];
  const int win_len = 2 * a.r * a.sw + a.chunk + 2 * a.r;
  T* planes = reinterpret_cast<T*>(scr + SCRATCH);  // ntap x chunk if SHARED
  T* win = planes + (SHARED ? ntap * a.chunk : 0);
  // SHARED: the block's own p, r and x, kept from phase to phase
  T* kp = win + win_len;
  T* kr = kp + (SHARED ? a.chunk : 0);
  T* kx = kr + (SHARED ? a.chunk : 0);
  int* toff = reinterpret_cast<int*>(kx + (SHARED ? a.chunk : 0));
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const long long lo = static_cast<long long>(blockIdx.x) * a.cells / G;
  const long long hi = static_cast<long long>(blockIdx.x + 1) * a.cells / G;
  const int own = a.r * a.sw + a.r;  // window index of the chunk's first cell

  // tap k of the three operators in one list: its window offset
  auto op_tap = [&](int k, int* op) {
    *op = k < a.n[0] ? 0 : k < a.n[0] + a.n[1] ? 1 : 2;
    return k - (*op > 0 ? a.n[0] : 0) - (*op > 1 ? a.n[1] : 0);
  };
  for (int k = tid; k < ntap; k += NT) {
    int op;
    const int t = op_tap(k, &op);
    toff[k] = (a.off[op][2 * t] + a.r) * a.sw + a.off[op][2 * t + 1] + a.r;
  }
  if (SHARED) {
    // one group of copies per operator: the setup's apply of A waits for
    // A's planes alone while G's and G^T's are still on their way
    const int n_own = static_cast<int>(hi - lo);
    for (int op = 0, k0 = 0; op < 3; k0 += a.n[op++]) {
      for (int e = tid; e < a.n[op] * n_own; e += NT) {
        const int t = e / n_own, c = e - t * n_own;
        gdm::copy_async(planes + (k0 + t) * a.chunk + c,
                        a.pl[op] + t * a.cells + lo + c, true);
      }
      gdm::commit_group();
    }
    for (int c = tid; c < n_own; c += NT) kx[c] = a.x[lo + c];
  }
  __syncthreads();

  auto node = [&](long long i) {  // cells < 2^31: 32-bit division
    const int ii = static_cast<int>(i);
    return gdm::is_node(ii / a.pitch, ii % a.pitch, a.n0, a.n1, a.r);
  };
  // the padded cell that window index w of the chunk at c0 stands for
  auto cell = [&](long long c0, int w) {
    const int row = min(w / a.sw, 2 * a.r);
    return c0 - a.r + static_cast<long long>(row - a.r) * a.pitch +
           (w - row * a.sw);
  };
  // The window of the chunk at c0: win[w] = f(g) for the padded cell g it
  // stands for, zero outside the array.
  auto fill = [&](long long c0, auto&& f) {
    __syncthreads();  // the window may still be read
#pragma unroll 4
    for (int w = tid; w < win_len; w += NT) {
      const long long g = cell(c0, w);
      win[w] = g >= 0 && g < a.cells ? f(g) : T(0);
    }
    __syncthreads();
  };
  // Operator `op` at the chunk's cells [c0, c0 + C) from the window:
  // out(c, i, v) with v the band sum at node cells, zero elsewhere.  The
  // taps go in order, eight loads ahead of their fma chain.
  auto band = [&](int op, long long c0, int C, auto&& out) {
    const int k0 = op == 0 ? 0 : op == 1 ? a.n[0] : a.n[0] + a.n[1];
    const int* to = toff + k0;
    const int n = a.n[op];
    for (int c = tid; c < C; c += NT) {
      const long long i = c0 + c;
      const T* wc = win + c;
      const T* pc = SHARED ? planes + k0 * a.chunk + c : a.pl[op] + i;
      const long long ps = SHARED ? a.chunk : a.cells;
      auto plane = [&](int t) {
        return SHARED ? pc[t * ps] : __ldg(pc + t * ps);
      };
      T acc = T(0);
      int t = 0;
      for (; t + 8 <= n; t += 8) {
        int o[8];
        T pv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = to[t + k];
#pragma unroll
        for (int k = 0; k < 8; ++k) pv[k] = plane(t + k);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = fma_rn(pv[k], wc[o[k]], acc);
      }
      for (; t < n; ++t) acc = fma_rn(plane(t), wc[to[t]], acc);
      out(c, i, node(i) ? acc : T(0));
    }
  };
  // The block's sum of v in a fixed order; valid in thread 0.
  auto block_sum = [&](double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    __syncthreads();  // scr may still be read
    if ((tid & 31) == 0) scr[tid >> 5] = v;
    __syncthreads();
    double s = 0.0;
    if (tid == 0)
      for (int w = 0; w < NWARP; ++w) s += scr[w];
    return s;
  };
  // The totals of one or two slot arrays after a grid sync, the same in
  // every block: warp 0 reads the G slots 32 lanes wide in slot order and
  // reduces them with a fixed shuffle tree; lane 0's sums are broadcast.
  auto totals = [&](const double* s0, const double* s1, double* t0,
                    double* t1) {
    if (tid < 32) {
      double v0 = 0.0, v1 = 0.0;
      for (int i = tid; i < G; i += 32) {
        v0 += __ldcg(s0 + i);
        if (s1) v1 += __ldcg(s1 + i);
      }
      for (int o = 16; o > 0; o >>= 1) {
        v0 += __shfl_down_sync(0xffffffffu, v0, o);
        v1 += __shfl_down_sync(0xffffffffu, v1, o);
      }
      if (tid == 0) {
        scr[NWARP] = v0;
        scr[NWARP + 1] = v1;
      }
    }
    __syncthreads();
    *t0 = scr[NWARP];
    if (t1) *t1 = scr[NWARP + 1];
    __syncthreads();
  };

  const long long cells = a.cells;
  T* rb[2] = {a.work, a.work + cells};
  T* pb[2] = {a.work + 2 * cells, a.work + 3 * cells};
  T* Ap = a.work + 4 * cells;
  T* t = a.work + 5 * cells;
  T* z = a.work + 6 * cells;
  double* slot_pAp = a.partials;
  double* slot_rr = a.partials + G;
  double* slot_rz = a.partials + 2 * G;
  const bool lead = tid == 0;
  auto chunk_of = [&](long long c0) {
    return static_cast<int>(min(static_cast<long long>(a.chunk), hi - c0));
  };
  auto vec = [](const T* v) {
    return [v](long long g) { return __ldcg(v + g); };
  };
  // this cell's r: kept in shared memory, or from device memory
  auto own_r = [&](const T* r, int c, long long i) {
    return SHARED ? kr[c] : __ldcg(r + i);
  };

  // r = b - A x0, and z = G^T (G r) or z = P r
  double srr = 0.0, srz = 0.0;
  for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
    if (SHARED) gdm::wait_group<2>();  // A's planes
    fill(c0, vec(a.x));
    band(0, c0, chunk_of(c0), [&](int c, long long i, T v) {
      const T ri = __ldg(a.b + i) - v;
      rb[0][i] = ri;
      if (SHARED) kr[c] = ri;
      srr += static_cast<double>(ri) * ri;
    });
  }
  if (MODE == MODE_FSAI) {
    grid.sync();
    for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
      if (SHARED) gdm::wait_group<1>();  // G's planes
      fill(c0, vec(rb[0]));
      band(1, c0, chunk_of(c0), [&](int, long long i, T v) { t[i] = v; });
    }
    grid.sync();
    for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
      if (SHARED) gdm::wait_group<0>();  // G^T's planes
      fill(c0, vec(t));
      band(2, c0, chunk_of(c0), [&](int c, long long i, T v) {
        z[i] = v;
        srz += static_cast<double>(own_r(rb[0], c, i)) * v;
      });
    }
  } else if (MODE == MODE_BAND) {
    grid.sync();
    for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
      if (SHARED) gdm::wait_group<0>();  // P's planes
      fill(c0, vec(rb[0]));
      band(1, c0, chunk_of(c0), [&](int c, long long i, T v) {
        z[i] = v;
        srz += static_cast<double>(own_r(rb[0], c, i)) * v;
      });
    }
  }
  constexpr bool precond = MODE != MODE_NONE;
  if (precond) {
    srz = block_sum(srz);
    if (lead) slot_rz[blockIdx.x] = srz;
  }
  srr = block_sum(srr);
  if (lead) slot_rr[blockIdx.x] = srr;
  grid.sync();
  double rr0, rz;
  totals(slot_rr, precond ? slot_rz : nullptr, &rr0, &rz);
  if (!precond) rz = rr0;
  const double nr0 = sqrt(rr0);
  const double tol = fmax(a.abs_tol, a.rel_tol * nr0);
  double nr = nr0;
  int it = 0;
  T beta = T(0);

  while (it < a.max_iter && nr > tol) {
    T* pold = pb[(it + 1) & 1];
    T* pnew = pb[it & 1];
    T* rold = rb[it & 1];
    T* rnew = rb[(it + 1) & 1];
    const T* zz = precond ? z : rold;  // the preconditioned residual
    // A: p = z + beta p, Ap = A p, p^T A p
    double s = 0.0;
    for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
      fill(c0, [&](long long g) {
        return it == 0 ? __ldcg(zz + g)
                       : fma_rn(beta, __ldcg(pold + g), __ldcg(zz + g));
      });
      const int C = chunk_of(c0);
      for (int c = tid; c < C; c += NT) {
        pnew[c0 + c] = win[own + c];
        if (SHARED) kp[c] = win[own + c];
      }
      band(0, c0, C, [&](int c, long long i, T v) {
        Ap[i] = v;
        s += static_cast<double>(win[own + c]) * v;
      });
    }
    s = block_sum(s);
    if (lead) slot_pAp[blockIdx.x] = s;
    grid.sync();
    double pAp;
    totals(slot_pAp, nullptr, &pAp, nullptr);
    const T alpha = static_cast<T>(pAp <= 0.0 ? 0.0 : rz / pAp);
    // B: r -= alpha Ap, x += alpha p, r^T r, and t = G r (FSAI) or
    // z = P r, r^T z (one band)
    s = 0.0;
    double s2 = 0.0;
    for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
      fill(c0, [&](long long g) {
        return fma_rn(-alpha, __ldcg(Ap + g), __ldcg(rold + g));
      });
      const int C = chunk_of(c0);
      for (int c = tid; c < C; c += NT) {
        const long long i = c0 + c;
        const T ri = win[own + c];
        rnew[i] = ri;
        if (SHARED) {
          kr[c] = ri;
          kx[c] = fma_rn(alpha, kp[c], kx[c]);
          a.x[i] = kx[c];
        } else {
          a.x[i] = fma_rn(alpha, __ldcg(pnew + i), a.x[i]);
        }
        s += static_cast<double>(ri) * ri;
      }
      if (MODE == MODE_FSAI) {
        band(1, c0, C, [&](int, long long i, T v) { t[i] = v; });
      } else if (MODE == MODE_BAND) {
        band(1, c0, C, [&](int c, long long i, T v) {
          z[i] = v;
          s2 += static_cast<double>(win[own + c]) * v;
        });
      }
    }
    s = block_sum(s);
    if (lead) slot_rr[blockIdx.x] = s;
    if (MODE == MODE_BAND) {
      s2 = block_sum(s2);
      if (lead) slot_rz[blockIdx.x] = s2;
    }
    grid.sync();
    if (MODE == MODE_FSAI) {
      // C: z = G^T t, r^T z
      s = 0.0;
      for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
        fill(c0, vec(t));
        band(2, c0, chunk_of(c0), [&](int c, long long i, T v) {
          z[i] = v;
          s += static_cast<double>(own_r(rnew, c, i)) * v;
        });
      }
      s = block_sum(s);
      if (lead) slot_rz[blockIdx.x] = s;
      grid.sync();
    }
    double rr, rz_new;
    totals(slot_rr, precond ? slot_rz : nullptr, &rr, &rz_new);
    if (!precond) rz_new = rr;
    nr = sqrt(rr);
    beta = static_cast<T>(rz <= 0.0 ? 0.0 : rz_new / rz);
    rz = rz_new;
    ++it;
  }

  // the true residual from one fresh apply
  double s = 0.0;
  for (long long c0 = lo; c0 < hi; c0 += a.chunk) {
    fill(c0, vec(a.x));
    band(0, c0, chunk_of(c0), [&](int, long long i, T v) {
      const T ri = __ldg(a.b + i) - v;
      s += static_cast<double>(ri) * ri;
    });
  }
  s = block_sum(s);
  if (lead) slot_pAp[blockIdx.x] = s;
  grid.sync();
  if (blockIdx.x == 0) {
    double true_rr;
    totals(slot_pAp, nullptr, &true_rr, nullptr);
    if (lead) {
      a.stats[0] = static_cast<float>(sqrt(true_rr));
      a.stats[1] = static_cast<float>(it);
      a.stats[2] = static_cast<float>(nr0);
      a.stats[3] = 1.0f;
    }
  }
}

template <typename T, bool SHARED, int MODE>
int launch(const Args<T>& a, int blocks, int smem, cudaStream_t stream) {
  auto kernel = resident_cg_kernel<T, SHARED, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(blocks), dim3(NT), params,
                                  static_cast<size_t>(smem), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int solve(const void* b, void* x, const void* plA, const void* offA, int nA,
          const void* pl1, const void* off1, int n1p, const void* pl2,
          const void* off2, int n2p, int mode, void* work, void* partials,
          void* stats, int rows, int pitch, int n0, int n1, int r,
          int max_iter, double rel_tol, double abs_tol, const void* gate,
          double gate_slack, double gate_rel, double gate_abs, int shared,
          int blocks, int chunk, int sw, int smem, void* stream) {
  if (blocks < 1 || chunk < 1 || sw < 1 || r < 0 || nA < 1 ||
      mode < MODE_NONE || mode > MODE_BAND ||
      (mode == MODE_FSAI && (n1p < 1 || n2p < 1)) ||
      (mode == MODE_BAND && n1p < 1) ||
      static_cast<long long>(rows) * pitch >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  const void* pl[3] = {plA, pl1, pl2};
  const void* off[3] = {offA, off1, off2};
  const int n[3] = {nA, mode != MODE_NONE ? n1p : 0,
                    mode == MODE_FSAI ? n2p : 0};
  for (int k = 0; k < 3; ++k) {
    a.pl[k] = static_cast<const T*>(pl[k]);
    a.off[k] = static_cast<const int*>(off[k]);
    a.n[k] = n[k];
  }
  a.work = static_cast<T*>(work);
  a.partials = static_cast<double*>(partials);
  a.stats = static_cast<float*>(stats);
  a.gate = static_cast<const float*>(gate);
  a.gate_slack = gate_slack;
  a.gate_rel = gate_rel;
  a.gate_abs = gate_abs;
  a.cells = static_cast<long long>(rows) * pitch;
  a.pitch = pitch;
  a.n0 = n0;
  a.n1 = n1;
  a.r = r;
  a.chunk = chunk;
  a.sw = sw;
  a.max_iter = max_iter;
  a.rel_tol = rel_tol;
  a.abs_tol = abs_tol;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == MODE_NONE)
    return shared ? launch<T, true, MODE_NONE>(a, blocks, smem, s)
                  : launch<T, false, MODE_NONE>(a, blocks, smem, s);
  if (mode == MODE_FSAI)
    return shared ? launch<T, true, MODE_FSAI>(a, blocks, smem, s)
                  : launch<T, false, MODE_FSAI>(a, blocks, smem, s);
  return shared ? launch<T, true, MODE_BAND>(a, blocks, smem, s)
                : launch<T, false, MODE_BAND>(a, blocks, smem, s);
}

}  // namespace

extern "C" {

// The card's SM count and the shared memory one block may opt in to;
// cudaErrorNotSupported where the card has no cooperative launch.
int gdm_resident_cg_limits(int* sms, int* smem_optin) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return coop ? 0 : static_cast<int>(cudaErrorNotSupported);
}

// mode: 0 plain CG, 1 FSAI (G in slot 1, G^T in slot 2), 2 one band P
// (slot 1; slot 2 unused).  gate: null, or the float32 stats of an
// earlier solve and gdm's check on them (slack, rel, abs).  shared: 1
// keeps the planes in shared memory, 0 in device memory; blocks, chunk,
// sw and smem (dynamic shared bytes) as
// gdm_torch/ops/resident.py::resident_plan lays them out.  The argument
// list is gdm_torch/ops/resident.py::ENTRY_ARGTYPES.
#define GDM_RESIDENT_ENTRY(NAME, T)                                        \
  int NAME(const void* b, void* x, const void* plA, const void* offA,      \
           int nA, const void* pl1, const void* off1, int n1p,             \
           const void* pl2, const void* off2, int n2p, int mode,           \
           void* work, void* partials, void* stats, int rows, int pitch,   \
           int n0, int n1, int r, int max_iter, double rel_tol,            \
           double abs_tol, const void* gate, double gate_slack,            \
           double gate_rel, double gate_abs, int shared, int blocks,       \
           int chunk, int sw, int smem, void* stream) {                    \
    return solve<T>(b, x, plA, offA, nA, pl1, off1, n1p, pl2, off2, n2p,   \
                    mode, work, partials, stats, rows, pitch, n0, n1, r,   \
                    max_iter, rel_tol, abs_tol, gate, gate_slack,          \
                    gate_rel, gate_abs, shared, blocks, chunk, sw, smem,   \
                    stream);                                               \
  }

GDM_RESIDENT_ENTRY(gdm_resident_cg_f32, float)
GDM_RESIDENT_ENTRY(gdm_resident_cg_f64, double)

}  // extern "C"
