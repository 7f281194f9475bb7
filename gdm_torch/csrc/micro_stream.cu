// M3, M4, M5: can tile copies hide under compute?  gdm's stream-overlap
// micros on the card.
//
// Replaces benchmarks/stream_overlap_micro.py: make_micro (M3, its
// pallas_call at :159), make_auto_micro (M4, :222) and make_sepbuf_micro
// (M5, :307).  gdm's arrays: u, y (R_ext, W2) float32 with R_ext = Rp +
// 2H, H = 8 guard rows, Rp = N0 rounded up to tile_r, W2 = rnd(N1 + 2p,
// 128); K = 2p + 1 taps; coef (K, W2).  The stencil of a tile (gdm's
// compute_tile): V[q][j] = sum_l coef[l][j] u[q][(j + l - p) mod W2] (a
// lane roll, so the columns wrap), then y[H + i][j] = sum_k coef[k][0]
// V[H - p + k + i][j]: a separable K-tap stencil down the rows.
//
// M3 (make_micro) streams tiles of tile_r rows with their 2H halo rows
// through a ring of nb slots, each tile copied as nsplit row chunks:
//   "both"     copies in, computes, writes y (rows [H, H + Rp))
//   "dma"      copies in, writes y[H + i][j] = u[i][0] (gdm's broadcast of
//              the tile's column 0), no stencil
//   "compute"  computes every tile from one fixed tile, reads no u
//   "dma_in"   copies in, no y
//   "dma_out"  writes y from the fixed tile, reads no u
// gdm's "compute" and "dma_out" read their slot without copying into it,
// and its "compute", "dma_in" and "dma_out" leave y undefined, as they do
// every guard row.  Here the fixed tile is the synthetic strip-0 tile
// F[q][j] = ((31 q + 17 j) mod 64) / 64 - 1/2 (``synth``), written into
// the slot once; the guard rows of y are zeros; "compute" and "dma_in"
// write no y but a sink, one float per (tile, strip): the sum of what the
// tile would have written ("compute": the stencil of F under this strip's
// coefficients; "dma_in": the broadcast column-0 values), which keeps
// their work alive; "dma_out" writes y[H + t tile_r + r][j] = F[r][0].
// M5 (make_sepbuf_micro) is M3's ring at nb = 2 with one shared-memory
// buffer per slot and the slot index a compile-time constant in each half
// of a loop unrolled by two; "dma" writes y[H + t tile_r + r][j] =
// u[t tile_r][0] (gdm's buf[0, :1]); "dma_in" copies in and writes the
// sink u[t tile_r][strip's first column].
// M4 (make_auto_micro) streams disjoint tile_r-row blocks of the (Rp, W2)
// array, no halo rows (gdm's automatic BlockSpec pipeline): "dma" y = u
// 1.0000001f, "both" y = sum_k coef[k][0] V (V of the block's own rows).
//
// Bound on the card: memory.  "both" reads T_ext / tile_r u rows per y
// row and writes one: about 9 bytes a node at tile_r = 96 against 4K
// flops; at 4096^2, 151 MB, 45 us at 3.35 TB/s.  M4 reads u and writes y
// once, 8 bytes a cell: at 4096^2, 139 MB, 41.6 us.  What the micros measure
// is whether the copies of the next tiles overlap this tile's FMAs:
// overlap = (t_compute + t_dma - t_both) / (t_compute + t_dma -
// max(t_compute, t_dma)).
//
// Design: a tile spans all W2 columns in gdm (1.89 MB a slot at 4096^2),
// more than a block's 227 KB, so the card cuts it into column strips of
// sw = 64 or 32 columns (the wrapper takes the widest whose ring fits two
// blocks on an SM) with a p-column halo on each side, wrapped mod W2.  A
// (tile, strip) pair is a unit; one wave of persistent blocks takes units
// b, b + G, b + 2G, ... .  The ring (M3, M5): each slot holds a unit's
// T_ext rows of u with their halo, interior columns by 16-byte cp.async,
// halo and column-0 values by 4-byte cp.async, each row chunk a commit
// group; the block keeps nb - 1 units in flight, waits for the current
// one's nsplit groups (cp.async.wait_group), and computes it: the column
// stage V into shared memory, then the row stage.  Every M3 mode reserves
// the same shared memory (nb slots, V and the scratch), used or not, so
// all five run the same grid of blocks and their times compare.
// M4's blocks are whole rows, so its units are contiguous bytes: runs of
// unit_rows rows (about 16 KB a stage in "dma", 32 KB in "both":
// gdm_torch/benchmarks/stream_overlap_micro.py::AUTO_RING) through a ring
// of `stages` stages, each loaded by one bulk copy (cp.async.bulk, TMA
// without a tensor map) that completes on the stage's mbarrier and stored
// by another (cp.async.bulk ... bulk_group); threads spend no
// instructions on the copies, stages - 1 loads and a store stay in
// flight, and "both" takes the column wrap as an index mod W2 inside the
// stage, with no halo copies.  "dma" is then bound by device memory;
// "both" by the loads of each column's K coefficients, which a unit of
// whole rows reuses over its few rows only (the strips of M3 reuse them
// over a tile's 96), so it takes two rows a unit and 1024 threads.
#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

enum Mode { COMPUTE = 0, DMA = 1, BOTH = 2, DMA_IN = 3, DMA_OUT = 4 };

constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;

__host__ __device__ constexpr int rnd4(int n) { return (n + 3) / 4 * 4; }

// One 16-byte global -> shared copy, asynchronously (both 16-byte
// aligned).
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Wait until at most n of this thread's commit groups are pending.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
#define GDM_WAIT(N) case N: gdm::wait_group<N>(); break;
    GDM_WAIT(0) GDM_WAIT(1) GDM_WAIT(2) GDM_WAIT(3) GDM_WAIT(4)
    GDM_WAIT(5) GDM_WAIT(6) GDM_WAIT(7) GDM_WAIT(8) GDM_WAIT(9)
    GDM_WAIT(10) GDM_WAIT(11) GDM_WAIT(12)
#undef GDM_WAIT
    default: gdm::wait_group<0>(); break;
  }
}

// The geometry every kernel here shares.
struct Geom {
  int h, p, tile_r, t_ext, n_tiles, w2, sw, n_strips;
  int hp;    // left halo pad: the interior starts 16-byte aligned
  int lds;   // slot row pitch: sw + 2 hp
  int slot;  // floats per slot: t_ext rows and t_ext column-0 values
  __host__ __device__ Geom(int h_, int p_, int tile_r_, int n_tiles_,
                           int w2_, int sw_, int rows)
      : h(h_), p(p_), tile_r(tile_r_), t_ext(rows), n_tiles(n_tiles_),
        w2(w2_), sw(sw_), n_strips(w2_ / sw_), hp(rnd4(p_)),
        lds(sw_ + 2 * rnd4(p_)), slot(rows * (sw_ + 2 * rnd4(p_)) +
                                      rnd4(rows)) {}
  __device__ int units() const { return n_tiles * n_strips; }
};

// Issue the copies of unit `unit` (rows [row0, row0 + g.t_ext) of u, the
// strip's columns with the wrapped halo, and the rows' column-0 values)
// into slot `sl`, as `nsplit` commit groups of rows; with `halo` false,
// only the interior columns and column 0.
__device__ void issue_unit(const float* __restrict__ u, float* sl,
                           const Geom& g, int unit, int nsplit, bool halo,
                           int tid) {
  const int t = unit / g.n_strips;
  const int j0 = (unit % g.n_strips) * g.sw;
  const size_t row0 = static_cast<size_t>(t) * g.tile_r;
  const int q4 = g.sw / 4;
  const int edge = halo ? 2 * g.p : 0;
  float* c0 = sl + g.t_ext * g.lds;
  for (int k = 0; k < nsplit; ++k) {
    const int qa = k * g.t_ext / nsplit;
    const int qb = (k + 1) * g.t_ext / nsplit;
    const int per = q4 + edge + 1;
    for (int e = tid; e < (qb - qa) * per; e += NT) {
      const int q = qa + e / per;
      const int x = e % per;
      const float* src = u + (row0 + q) * g.w2;
      float* dst = sl + q * g.lds;
      if (x < q4) {
        copy16_async(dst + g.hp + 4 * x, src + j0 + 4 * x);
      } else if (x < q4 + edge) {
        const int hx = x - q4;                  // 0 .. 2p - 1
        const int c = hx < g.p ? hx - g.p : g.sw + hx - g.p;
        int j = j0 + c;
        j = j < 0 ? j + g.w2 : (j >= g.w2 ? j - g.w2 : j);
        gdm::copy_async(dst + g.hp + c, src + j, true);
      } else {
        gdm::copy_async(c0 + q, src, true);
      }
    }
    gdm::commit_group();
  }
}

// The fixed tile of "compute" and "dma_out": exact in float32.
__device__ __forceinline__ float synth(int q, int j) {
  return static_cast<float>((31 * q + 17 * j) & 63) * (1.0f / 64) - 0.5f;
}

// Fill slot `sl` with F over strip 0's columns and their wrapped halo,
// and its column-0 values.
__device__ void fill_synth(float* sl, const Geom& g, int tid) {
  float* c0 = sl + g.t_ext * g.lds;
  for (int e = tid; e < g.t_ext * g.lds; e += NT) {
    int j = e % g.lds - g.hp;
    j = j < 0 ? j + g.w2 : (j >= g.w2 ? j - g.w2 : j);
    sl[e] = synth(e / g.lds, j);
  }
  for (int q = tid; q < g.t_ext; q += NT) c0[q] = synth(q, 0);
}

// The block's sum of v, returned to every thread (red: NW floats).
__device__ float block_sum(float v, float* red, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[w];
  return s;
}

// The stencil of the unit in slot `sl` with strip `j0`'s coefficients:
// V (rows h - p .. h + tile_r + p of the slot) into vs, then each output
// (r, c), r < tile_r, handed to out(r, c, value).
template <int P, typename Out>
__device__ void stencil_unit(const float* sl, float* vs, const Geom& g,
                             const float* cl, const float* ck, int tid,
                             Out out) {
  constexpr int K = 2 * P + 1;
  const int c = tid % g.sw;
  const int rstep = NT / g.sw;
  for (int q = tid / g.sw; q < g.tile_r + 2 * P; q += rstep) {
    const float* row = sl + (g.h - P + q) * g.lds + g.hp + c - P;
    float v = 0.0f;
#pragma unroll
    for (int l = 0; l < K; ++l) v = fmaf(cl[l], row[l], v);
    vs[q * g.sw + c] = v;
  }
  __syncthreads();
  for (int r = tid / g.sw; r < g.tile_r; r += rstep) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(ck[k], vs[(r + k) * g.sw + c], acc);
    out(r, c, acc);
  }
}

// zeros in the guard rows of the unit's strip (first and last tiles)
__device__ void zero_guards(float* __restrict__ y, const Geom& g, int t,
                            int j0, int tid) {
  for (int side = 0; side < 2; ++side) {
    if (t != (side == 0 ? 0 : g.n_tiles - 1)) continue;
    const size_t base = side == 0 ? 0 : g.h + static_cast<size_t>(g.n_tiles) *
                                                  g.tile_r;
    for (int e = tid; e < g.h * g.sw; e += NT)
      y[(base + e / g.sw) * g.w2 + j0 + e % g.sw] = 0.0f;
  }
}

// M3 (SEP false) and M5 (SEP true: nb = 2, nsplit = 1, slot indices
// compile-time constants).
template <int MODE, int P, bool SEP>
__global__ void __launch_bounds__(NT)
stream_kernel(const float* __restrict__ u, const float* __restrict__ coef,
              float* __restrict__ y, float* __restrict__ sink, Geom g,
              int nb, int nsplit) {
  constexpr int K = 2 * P + 1;
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                       // NW floats (16 reserved)
  float* vs = smem + 16;                   // (tile_r + 2p) x sw
  float* ring = vs + rnd4((g.tile_r + 2 * P) * g.sw);
  const int tid = threadIdx.x;
  const int n_units = g.units();
  const int G = gridDim.x;
  const int c = tid % g.sw;
  const bool ring_in = MODE == DMA || MODE == BOTH || MODE == DMA_IN;
  const bool halo = MODE == BOTH;
  float ck[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ck[k] = coef[static_cast<size_t>(k) * g.w2];

  if (!ring_in) {   // the fixed tile, no copies
    fill_synth(ring, g, tid);
    __syncthreads();
  } else {
    for (int k = 0; k < nb - 1; ++k) {
      const int unit = blockIdx.x + k * G;
      if (unit < n_units)
        issue_unit(u, ring + k * g.slot, g, unit, nsplit, halo, tid);
      else
        for (int s = 0; s < nsplit; ++s) gdm::commit_group();
    }
  }
  // one unit: issue unit + (nb - 1) G into slot `nxt`, wait for this
  // unit's copies in slot `cur`, consume it
  auto body = [&](int unit, float* cur, float* nxt) {
    const int t = unit / g.n_strips;
    const int j0 = (unit % g.n_strips) * g.sw;
    float* sl = ring;
    if (ring_in) {
      const int next = unit + (nb - 1) * G;
      if (next < n_units)
        issue_unit(u, nxt, g, next, nsplit, halo, tid);
      else
        for (int s = 0; s < nsplit; ++s) gdm::commit_group();
      wait_pending((nb - 1) * nsplit);
      __syncthreads();
      sl = cur;
    }
    const float* c0 = sl + g.t_ext * g.lds;
    const size_t yrow = static_cast<size_t>(g.h) + static_cast<size_t>(t) *
                                                       g.tile_r;
    if (MODE != COMPUTE && MODE != DMA_IN) zero_guards(y, g, t, j0, tid);
    if (MODE == BOTH || MODE == COMPUTE) {
      float cl[K];
#pragma unroll
      for (int l = 0; l < K; ++l)
        cl[l] = coef[static_cast<size_t>(l) * g.w2 + j0 + c];
      float sum = 0.0f;
      stencil_unit<P>(sl, vs, g, cl, ck, tid, [&](int r, int cc, float v) {
        if (MODE == BOTH)
          y[(yrow + r) * g.w2 + j0 + cc] = v;
        else
          sum += v;
      });
      if (MODE == COMPUTE) {
        sum = block_sum(sum, red, tid);
        if (tid == 0) sink[unit] = sum;
      }
    } else if (MODE == DMA || MODE == DMA_OUT) {
      for (int e = tid; e < g.tile_r * g.sw; e += NT) {
        const int r = e / g.sw;
        y[(yrow + r) * g.w2 + j0 + e % g.sw] = SEP ? c0[0] : c0[r];
      }
    } else {   // DMA_IN
      if (SEP) {
        if (tid == 0) sink[unit] = sl[g.hp];
      } else {
        float sum = 0.0f;
        for (int e = tid; e < g.tile_r * g.sw; e += NT) sum += c0[e / g.sw];
        sum = block_sum(sum, red, tid);
        if (tid == 0) sink[unit] = sum;
      }
    }
    __syncthreads();   // the slot and vs are free for the next unit
  };
  if (SEP) {
    // two buffers, the slot of each half of the loop fixed
    float* b0 = ring;
    float* b1 = ring + g.slot;
    for (int unit = blockIdx.x; unit < n_units; unit += 2 * G) {
      body(unit, b0, b1);
      if (unit + G < n_units) body(unit + G, b1, b0);
    }
  } else {
    int k = 0;
    for (int unit = blockIdx.x; unit < n_units; unit += G, ++k)
      body(unit, ring + (k % nb) * g.slot,
           ring + ((k + nb - 1) % nb) * g.slot);
  }
  gdm::wait_group<0>();
}

// M4: units of whole rows of the (Rp, W2) array, contiguous bytes, through
// a ring of bulk copies (TMA without a tensor map).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Load `bytes` (a multiple of 16, both addresses 16-byte aligned) into
// shared memory; the copy completes its bytes on `bar`, which this call
// arms with them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until `bar` has completed the phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Store `bytes` of shared memory to device memory as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

constexpr int AUTO_MAX_STAGES = 16;   // mbarriers in the ring's first 128 B
constexpr int AUTO_MAX_THREADS = 1024;

// Block b takes units b, b + G, ...: unit k of its own is rows [(b + k G)
// unit_rows, ...) of u, the last unit shorter where unit_rows does not
// divide Rp.  Thread 0 keeps stages - 1 units in flight: it loads the
// first `stages` at the start, and after it has stored unit k it waits
// until the store of unit k - 1 has read its stage and loads unit
// k - 1 + stages there.  Every thread waits on the stage's mbarrier,
// computes in shared memory ("dma" in place, "both" into the stage's
// second buffer), fences its writes to the async proxy, and after a
// block barrier thread 0 stores the unit with one bulk copy.
template <int MODE, int P>
__global__ void __launch_bounds__(AUTO_MAX_THREADS)
auto_kernel(const float* __restrict__ u, const float* __restrict__ coef,
            float* __restrict__ y, int rp, int w2, int unit_rows,
            int stages) {
  constexpr int K = 2 * P + 1;
  constexpr int BUFS = MODE == BOTH ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + 128);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int G = gridDim.x;
  const int unit = unit_rows * w2;   // floats a unit holds
  const int n_units = (rp + unit_rows - 1) / unit_rows;
  const int mine = (n_units - static_cast<int>(blockIdx.x) + G - 1) / G;
  auto first_row = [&](int k) {
    return (static_cast<int>(blockIdx.x) + k * G) * unit_rows;
  };
  auto rows_of = [&](int k) { return min(unit_rows, rp - first_row(k)); };
  auto stage = [&](int k) { return ring + (k % stages) * BUFS * unit; };
  auto load = [&](int k) {
    bulk_load(stage(k), u + static_cast<size_t>(first_row(k)) * w2,
              static_cast<unsigned>(rows_of(k) * w2 * sizeof(float)),
              full + k % stages);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(stages, mine); ++k) load(k);
  }
  __syncthreads();
  float ck[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ck[k] = __ldg(coef + static_cast<size_t>(k) * w2);
  for (int k = 0; k < mine; ++k) {
    bar_wait(full + k % stages, (k / stages) & 1);
    float* in = stage(k);
    float* out = in + (BUFS - 1) * unit;
    const int nr = rows_of(k);
    if (MODE == DMA) {
      float4* v = reinterpret_cast<float4*>(in);
      for (int e = tid; e < nr * w2 / 4; e += nt) {
        float4 q = v[e];
        q.x = __fmul_rn(q.x, 1.0000001f);
        q.y = __fmul_rn(q.y, 1.0000001f);
        q.z = __fmul_rn(q.z, 1.0000001f);
        q.w = __fmul_rn(q.w, 1.0000001f);
        v[e] = q;
      }
    } else {
      // whole rows: the column wrap is an index mod W2 in shared memory
      for (int j = tid; j < w2; j += nt) {
        float cl[K];
#pragma unroll
        for (int l = 0; l < K; ++l)
          cl[l] = __ldg(coef + static_cast<size_t>(l) * w2 + j);
        for (int q = 0; q < nr; ++q) {
          const float* row = in + q * w2;
          float v = 0.0f;
#pragma unroll
          for (int l = 0; l < K; ++l) {
            int jj = j + l - P;
            jj = jj < 0 ? jj + w2 : (jj >= w2 ? jj - w2 : jj);
            v = fmaf(cl[l], row[jj], v);
          }
          float acc = 0.0f;
#pragma unroll
          for (int kk = 0; kk < K; ++kk) acc = fmaf(ck[kk], v, acc);
          out[q * w2 + j] = acc;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(y + static_cast<size_t>(first_row(k)) * w2, out,
                 static_cast<unsigned>(nr * w2 * sizeof(float)));
      if (k > 0) {
        // the store of unit k - 1 has read its stage: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        if (k - 1 + stages < mine) load(k - 1 + stages);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One wave of persistent blocks of `threads` threads: as many as fit on
// the card at once.
template <typename Kernel>
int wave(Kernel kernel, size_t smem, int n_units, int* blocks,
         int threads = NT) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = n_units < sms * per_sm ? n_units : sms * per_sm;
  return 0;
}

template <int MODE, int P, bool SEP>
int launch_stream(const float* u, const float* coef, float* y, float* sink,
                  const Geom& g, int nb, int nsplit, int* blocks,
                  cudaStream_t s) {
  auto kernel = stream_kernel<MODE, P, SEP>;
  // nb slots in every mode, "compute" and "dma_out" too (they use one)
  const size_t smem = sizeof(float) *
      (16 + rnd4((g.tile_r + 2 * P) * g.sw) + static_cast<size_t>(nb) * g.slot);
  const int e = wave(kernel, smem, g.n_tiles * g.n_strips, blocks);
  if (e != 0) return e;
  kernel<<<*blocks, NT, smem, s>>>(u, coef, y, sink, g, nb, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool SEP>
int stream_p(const float* u, const float* coef, float* y, float* sink,
             const Geom& g, int nb, int nsplit, int* blocks,
             cudaStream_t s) {
  switch (g.p) {
    case 1: return launch_stream<MODE, 1, SEP>(u, coef, y, sink, g, nb, nsplit,
                                               blocks, s);
    case 2: return launch_stream<MODE, 2, SEP>(u, coef, y, sink, g, nb, nsplit,
                                               blocks, s);
    case 3: return launch_stream<MODE, 3, SEP>(u, coef, y, sink, g, nb, nsplit,
                                               blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MODE, int P>
int launch_auto(const float* u, const float* coef, float* y, int rp, int w2,
                int unit_rows, int stages, int threads, int* blocks,
                cudaStream_t s) {
  auto kernel = auto_kernel<MODE, P>;
  const size_t smem = 128 + sizeof(float) * static_cast<size_t>(stages) *
                                (MODE == BOTH ? 2 : 1) * unit_rows * w2;
  const int e = wave(kernel, smem, (rp + unit_rows - 1) / unit_rows, blocks,
                     threads);
  if (e != 0) return e;
  kernel<<<*blocks, threads, smem, s>>>(u, coef, y, rp, w2, unit_rows,
                                        stages);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int p, int tile_r, int n_tiles, int w2, int sw) {
  return p >= 1 && p <= 3 && tile_r >= 1 && n_tiles >= 1 &&
         (sw == 32 || sw == 64) && w2 % 128 == 0;
}

}  // namespace

extern "C" {

// M3 (sep 0) and M5 (sep 1): u, y (n_tiles tile_r + 2h, w2) float32,
// coef (2p + 1, w2), sink (n_tiles, w2 / sw); mode 0 compute, 1 dma,
// 2 both, 3 dma_in, 4 dma_out (M5: dma and dma_in); *blocks gets the
// grid's block count.
int gdm_micro_stream_f32(const void* u, const void* coef, void* y, void* sink,
                         int mode, int sep, int p, int h, int tile_r,
                         int n_tiles, int w2, int sw, int nb, int nsplit,
                         int* blocks, void* stream) {
  if (!valid(p, tile_r, n_tiles, w2, sw) || nb < 2 || nsplit < 1 ||
      (nb - 1) * nsplit > 12 || h < p || (sep && (nb != 2 || nsplit != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g(h, p, tile_r, n_tiles, w2, sw, tile_r + 2 * h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(coef);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(sink);
  if (sep) {
    if (mode == DMA)
      return stream_p<DMA, true>(uf, cf, yf, sf, g, 2, 1, blocks, s);
    if (mode == DMA_IN)
      return stream_p<DMA_IN, true>(uf, cf, yf, sf, g, 2, 1, blocks, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case COMPUTE:
      return stream_p<COMPUTE, false>(uf, cf, yf, sf, g, nb, nsplit, blocks, s);
    case DMA:
      return stream_p<DMA, false>(uf, cf, yf, sf, g, nb, nsplit, blocks, s);
    case BOTH:
      return stream_p<BOTH, false>(uf, cf, yf, sf, g, nb, nsplit, blocks, s);
    case DMA_IN:
      return stream_p<DMA_IN, false>(uf, cf, yf, sf, g, nb, nsplit, blocks, s);
    case DMA_OUT:
      return stream_p<DMA_OUT, false>(uf, cf, yf, sf, g, nb, nsplit, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M4: u, y (rp, w2) float32, coef (2p + 1, w2); mode 1 dma, 2 both; a
// ring of `stages` stages of `unit_rows` rows, blocks of `threads`.
int gdm_micro_auto_f32(const void* u, const void* coef, void* y, int mode,
                       int p, int rp, int w2, int unit_rows, int stages,
                       int threads, int* blocks, void* stream) {
  if (p < 1 || p > 3 || rp < 1 || w2 % 128 || unit_rows < 1 || stages < 2 ||
      stages > AUTO_MAX_STAGES || threads < 32 || threads % 32 ||
      threads > AUTO_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(coef);
  float* yf = static_cast<float*>(y);
  if (mode == DMA)
    return launch_auto<DMA, 1>(uf, cf, yf, rp, w2, unit_rows, stages,
                               threads, blocks, s);
  if (mode != BOTH) return static_cast<int>(cudaErrorInvalidValue);
  switch (p) {
    case 1: return launch_auto<BOTH, 1>(uf, cf, yf, rp, w2, unit_rows, stages,
                                        threads, blocks, s);
    case 2: return launch_auto<BOTH, 2>(uf, cf, yf, rp, w2, unit_rows, stages,
                                        threads, blocks, s);
    case 3: return launch_auto<BOTH, 3>(uf, cf, yf, rp, w2, unit_rows, stages,
                                        threads, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
