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
// M3 (make_micro) streams tiles of tile_r rows through a ring of nb
// slots, each tile copied as nsplit row chunks:
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
// M5 (make_sepbuf_micro) is a two-slot ring (sepbuf_kernel, below) with
// one shared-memory buffer per slot and the slot index a compile-time constant in each half
// of a loop unrolled by two; "dma" writes y[H + t tile_r + r][j] =
// u[t tile_r][0] (gdm's buf[0, :1]); "dma_in" copies in and writes the
// sink u[t tile_r][strip's first column].
// M4 (make_auto_micro) streams disjoint tile_r-row blocks of the (Rp, W2)
// array, no halo rows (gdm's automatic BlockSpec pipeline): "dma" y = u
// 1.0000001f, "both" y = sum_k coef[k][0] V (V of the block's own rows).
//
// Bound on the card: memory.  M3's "both" reads u and writes y once, 8
// bytes a node: at 4096^2, 140 MB, 41.8 us at 3.35 TB/s; M4 the same,
// 41.6 us.  What the micros measure is whether the copies of the next
// tiles overlap this tile's FMAs: overlap = (t_compute + t_dma - t_both)
// / (t_compute + t_dma - max(t_compute, t_dma)).
//
// M3's design (m3_kernel; the launch plan comes from gdm_torch/benchmarks/
// stream_overlap_micro.py::m3_plan).  A tile spans all W2 columns in gdm
// (1.89 MB a slot at 4096^2), more than a block's 227 KB, so the card cuts
// it into column strips of sw = 32, 64 or 128 columns; a (tile, strip)
// pair is a unit.  In the modes that copy, the blocks draw the U units
// from a ticket counter in tile-major order, so a block that starts late
// or streams slowly takes fewer and the blocks end together (fixed runs
// of units left blocks ending 16 us apart); "compute" and "dma_out" take
// the fixed units [b U / G, (b + 1) U / G).  A unit's slot holds the tile_r + 2p u rows its stencil
// reads (rows H - p .. H + p + tile_r of the tile), each the strip's sw
// columns with 4 more on each side (the p-column halo rounded out to 16
// bytes, wrapped mod W2), at a pitch of sw + 8.
// - One producer thread issues, for each unit, nbox boxes of a tensor
//   map over u (cp.async.bulk.tensor, the TMA unit) in nsplit chunks
//   that each complete on an mbarrier of their own, into a ring of nb
//   slots, beside each slot its unit; it refills a slot when the
//   consumer warps have all arrived on its `empty` mbarrier.  The copies
//   cost the consumers no instructions.  Outside u the boxes read zeros,
//   so at the two seam strips the producer warp's other lanes write the
//   wrapped halo columns from device memory once the boxes have landed
//   ("both" only: no other mode reads them).
// - Each consumer thread owns one column of the strip and one of
//   `groups` even runs of the tile's output rows: it waits for the
//   unit's nsplit chunks, marches down its rows (and the 2p before them)
//   with V in a register ring of K rows and its column's K coefficients
//   in registers (K shared loads and K FMAs a row for V, K FMAs an
//   output), stores y from registers, and arrives on `empty`.  No block
//   barrier after the set-up.
// - Every mode runs this grid with this shared memory (nb slots, used or
//   not), so the five times compare.  "dma" copies what "both" copies and
//   writes y from u's column 0, which the consumers read from device
//   memory (every strip reads the same 4 bytes a row, from L2); "dma_in"
//   copies and writes its sink from the same column-0 values; "compute"
//   runs the march on the fixed tile F, written into slot 0 once, and
//   copies nothing; "dma_out" writes y from F[r][0] and copies nothing.
// M5 (sepbuf_kernel) keeps the earlier ring: column strips of 64 or 32
// columns (no halo columns), the T_ext rows of a tile and their column-0
// values by 16- and 4-byte cp.async, one commit group a unit, and blocks
// of 256 threads.
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
#include "tma.cuh"

namespace {

enum Mode { COMPUTE = 0, DMA = 1, BOTH = 2, DMA_IN = 3, DMA_OUT = 4 };

constexpr int NT = 256;   // threads per block

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

// M5's geometry.
struct Geom {
  int h, p, tile_r, t_ext, n_tiles, w2, sw, n_strips;
  int hp;    // left pad: the interior starts 16-byte aligned
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
// strip's columns and the rows' column-0 values) into slot `sl`, as
// `nsplit` commit groups of rows.
__device__ void issue_unit(const float* __restrict__ u, float* sl,
                           const Geom& g, int unit, int nsplit, int tid) {
  const int t = unit / g.n_strips;
  const int j0 = (unit % g.n_strips) * g.sw;
  const size_t row0 = static_cast<size_t>(t) * g.tile_r;
  const int q4 = g.sw / 4;
  float* c0 = sl + g.t_ext * g.lds;
  for (int k = 0; k < nsplit; ++k) {
    const int qa = k * g.t_ext / nsplit;
    const int qb = (k + 1) * g.t_ext / nsplit;
    const int per = q4 + 1;
    for (int e = tid; e < (qb - qa) * per; e += NT) {
      const int q = qa + e / per;
      const int x = e % per;
      const float* src = u + (row0 + q) * g.w2;
      float* dst = sl + q * g.lds;
      if (x < q4) {
        copy16_async(dst + g.hp + 4 * x, src + j0 + 4 * x);
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

// M5: a ring of nb = 2 slots (nsplit = 1), one buffer per slot, the slot
// indices compile-time constants in each half of a loop unrolled by two;
// block b takes units b, b + G, ...; each slot holds a unit's T_ext rows
// (no halo columns) and their column-0 values.  The shared memory also
// holds a reduction scratch and a (tile_r + 2p) x sw scratch that M5
// leaves unused, the layout of the ring it was built with.
template <int MODE, int P>
__global__ void __launch_bounds__(NT)
sepbuf_kernel(const float* __restrict__ u, float* __restrict__ y,
              float* __restrict__ sink, Geom g, int nb, int nsplit) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + 16 + rnd4((g.tile_r + 2 * P) * g.sw);
  const int tid = threadIdx.x;
  const int n_units = g.units();
  const int G = gridDim.x;
  for (int k = 0; k < nb - 1; ++k) {
    const int unit = blockIdx.x + k * G;
    if (unit < n_units)
      issue_unit(u, ring + k * g.slot, g, unit, nsplit, tid);
    else
      for (int s = 0; s < nsplit; ++s) gdm::commit_group();
  }
  // one unit: issue unit + (nb - 1) G into slot `nxt`, wait for this
  // unit's copies in slot `cur`, consume it
  auto body = [&](int unit, float* cur, float* nxt) {
    const int t = unit / g.n_strips;
    const int j0 = (unit % g.n_strips) * g.sw;
    const int next = unit + (nb - 1) * G;
    if (next < n_units)
      issue_unit(u, nxt, g, next, nsplit, tid);
    else
      for (int s = 0; s < nsplit; ++s) gdm::commit_group();
    wait_pending((nb - 1) * nsplit);
    __syncthreads();
    const float* c0 = cur + g.t_ext * g.lds;
    const size_t yrow = static_cast<size_t>(g.h) + static_cast<size_t>(t) *
                                                       g.tile_r;
    if (MODE == DMA) {
      zero_guards(y, g, t, j0, tid);
      for (int e = tid; e < g.tile_r * g.sw; e += NT)
        y[(yrow + e / g.sw) * g.w2 + j0 + e % g.sw] = c0[0];
    } else if (tid == 0) {   // DMA_IN
      sink[unit] = cur[g.hp];
    }
    __syncthreads();   // the slot is free for the next unit
  };
  float* b0 = ring;
  float* b1 = ring + g.slot;
  for (int unit = blockIdx.x; unit < n_units; unit += 2 * G) {
    body(unit, b0, b1);
    if (unit + G < n_units) body(unit + G, b1, b0);
  }
  gdm::wait_group<0>();
}

// ---- M3 ---------------------------------------------------------------------

constexpr int M3_H = 8;            // gdm's guard rows
constexpr int M3_HALO = 4;         // halo columns a side: p <= 3, 16 bytes
constexpr int M3_MAX_THREADS = 512 + 32;   // consumers and the producer
constexpr int M3_MAX_GROUPS = 4;   // row groups of consumers
constexpr int M3_MAX_NB = 8;
constexpr int M3_MAX_NSPLIT = 8;
constexpr int M3_FIXERS = 31;      // the producer warp's other lanes

// The shared memory of an M3 block (m3_plan's smem): the nb x nsplit
// `full`, nb `empty` and nb `halo` mbarriers, a reduction scratch of
// 2 x 16 floats (a float a consumer warp) and the unit of each slot (8
// ints), rounded to 128 bytes, then nb slots of slot_rows rows at a pitch
// of sw + 8, each rounded to 128 bytes.
__host__ __device__ constexpr int m3_bar_bytes(int nb, int nsplit) {
  return (8 * nb * (nsplit + 2) + 128 + 32 + 127) / 128 * 128;
}

__host__ __device__ constexpr int m3_slot_floats(int slot_rows, int sw) {
  return (slot_rows * (sw + 2 * M3_HALO) + 31) / 32 * 32;
}

__host__ __device__ constexpr size_t m3_smem(int nb, int nsplit,
                                             int slot_rows, int sw) {
  return m3_bar_bytes(nb, nsplit) + sizeof(float) * static_cast<size_t>(nb) *
                                        m3_slot_floats(slot_rows, sw);
}

// One column's march down a slot of `rows` rows (base: the slot row 0
// element of its window, p columns left of the column): V of each row
// into a register ring of K, then each output r < rows - 2p, sum_k ck[k]
// V[r + k], handed to out(r, value).
template <int P, typename Out>
__device__ __forceinline__ void m3_march(const float* base, int lds,
                                         int rows, const float (&cl)[2 * P + 1],
                                         const float (&ck)[2 * P + 1],
                                         Out out) {
  constexpr int K = 2 * P + 1;
  // two partial sums a chain (even and odd taps) halve its latency
  auto colv = [&](int q) {
    const float* row = base + q * lds;
    float a[2] = {0.0f, 0.0f};
#pragma unroll
    for (int l = 0; l < K; ++l) a[l & 1] = fmaf(cl[l], row[l], a[l & 1]);
    return a[0] + a[1];
  };
  float v[K];
#pragma unroll
  for (int i = 0; i < 2 * P; ++i) v[i] = colv(i);
  // row q + m sits in v[(q + m) mod K]; q = 2p mod K throughout
  auto row = [&](int q, int m) {
    v[(2 * P + m) % K] = colv(q + m);
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc[k & 1] = fmaf(ck[k], v[(m + k) % K], acc[k & 1]);
    out(q + m - 2 * P, acc[0] + acc[1]);
  };
  int q = 2 * P;
  for (; q + K <= rows; q += K) {
#pragma unroll
    for (int m = 0; m < K; ++m) row(q, m);
  }
  const int rem = rows - q;
#pragma unroll
  for (int m = 0; m < K - 1; ++m)
    if (m < rem) row(q, m);
}

// M3.  In the modes that copy, the producer takes its units from a
// ticket counter shared by the blocks, tile-major (unit = tile n_strips +
// strip), so a block that starts late or streams slowly takes fewer and
// the blocks end together; the tickets of one launch are base .. base + U
// + G - 1 (each producer draws until it passes U), which the wrapper
// keeps count of.  It writes each slot's unit beside the slot, or -1 at
// the end.  "compute" and "dma_out" copy nothing and take the fixed
// units [b U / G, (b + 1) U / G), strip-major.  Thread sw groups of the
// block is the producer:
// a unit is nbox boxes of box_rows rows and sw + 8 columns of the tensor
// map tm_u over u, in nsplit chunks of boxes, each chunk one `full`
// mbarrier.  Outside u the map reads zeros, so the boxes of the two seam
// strips hold zeros where the halo wraps; in "both" the producer warp's
// other lanes (the fixers) write the wrapped halo of those units into
// the slot from device memory once the boxes have landed, and arrive on
// the slot's `halo` mbarrier.  Threads 0 .. sw groups - 1 are the
// consumers: thread c + sw g marches column c down the output rows of row
// group g, the unit's tile_r rows cut into `groups` even runs.
template <int MODE, int P>
__global__ void __launch_bounds__(M3_MAX_THREADS)
m3_kernel(const __grid_constant__ CUtensorMap tm_u,
          const float* __restrict__ u, const float* __restrict__ coef,
          float* __restrict__ y, float* __restrict__ sink, int tile_r,
          int n_tiles, int w2, int sw, int nb, int nsplit, int box_rows,
          int nbox, int groups, unsigned long long* __restrict__ tickets,
          long long base) {
  constexpr int K = 2 * P + 1;
  constexpr bool RING_IN = MODE == DMA || MODE == BOTH || MODE == DMA_IN;
  extern __shared__ __align__(128) unsigned char smem_m3[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_m3);
  unsigned long long* empty = full + nb * nsplit;
  unsigned long long* halo = empty + nb;
  float* red = reinterpret_cast<float*>(halo + nb);   // 2 x 16 floats
  int* slot_unit = reinterpret_cast<int*>(red + 32);   // nb <= 8
  float* ring = reinterpret_cast<float*>(smem_m3 + m3_bar_bytes(nb, nsplit));
  const int rows = tile_r + 2 * P;
  const int lds = sw + 2 * M3_HALO;
  const int slot = m3_slot_floats(nbox * box_rows, sw);
  const int nc = sw * groups;   // consumer threads
  const int cw = nc / 32;       // consumer warps
  const int n_strips = w2 / sw;
  const int units = n_tiles * n_strips;
  const int G = gridDim.x;
  // without copies: the block's units, [b U / G, (b + 1) U / G), strip-major
  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                     units / G);
  const int mine = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                    units / G) - first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < nb * nsplit; ++i) gdm::bar_init(full + i, 1);
    for (int i = 0; i < nb; ++i) {
      // the consumer warps, and in "both" the fixers, free a slot
      gdm::bar_init(empty + i, cw + (MODE == BOTH ? 1 : 0));
      gdm::bar_init(halo + i, M3_FIXERS);
    }
    gdm::bar_init_fence();
  }
  __syncthreads();
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 8, clock64());

  if (tid >= nc) {
    const int pl = tid - nc;   // lane of the producer warp
    if (!RING_IN || (pl > 0 && MODE != BOTH)) return;
    if (pl == 0) {
      // ---- the producer: one thread draws the units and issues every box
      for (int k = 0;; ++k) {
        const int sl = k % nb;
        if (k >= nb) {
          const long long c0 = GDM_CLOCK();
          gdm::bar_wait(empty + sl, ((k / nb) - 1) & 1);
          GDM_STAMP_ADD(true, 4, GDM_CLOCK() - c0);
          (void)c0;
        }
        const long long ticket =
            static_cast<long long>(atomicAdd(tickets, 1ull)) - base;
        if (ticket >= units) {
          slot_unit[sl] = -1;
          for (int c = 0; c < nsplit; ++c)
            gdm::bar_arrive(full + sl * nsplit + c);
          break;
        }
        const int unit = static_cast<int>(ticket);
        slot_unit[sl] = unit;
        const int t = unit / n_strips;
        const int j0 = (unit % n_strips) * sw;
        const int row0 = t * tile_r + M3_H - P;
        float* dst = ring + static_cast<size_t>(sl) * slot;
        for (int c = 0; c < nsplit; ++c) {
          const int b0 = c * nbox / nsplit, b1 = (c + 1) * nbox / nsplit;
          unsigned long long* bar = full + sl * nsplit + c;
          gdm::bar_arrive_expect_tx(
              bar, static_cast<unsigned>(sizeof(float) * (b1 - b0) *
                                         box_rows * lds));
          for (int b = b0; b < b1; ++b)
            gdm::tma_load_2d(dst + b * box_rows * lds, &tm_u, j0 - M3_HALO,
                             row0 + b * box_rows, bar);
        }
      }
      GDM_STAMP(true, 5, clock64());
      return;
    }
    // ---- the fixers ("both"): the wrapped halo of the seam strips ----
    for (int k = 0;; ++k) {
      const int sl = k % nb;
      for (int c = 0; c < nsplit; ++c)
        gdm::bar_wait(full + sl * nsplit + c, (k / nb) & 1);
      const int unit = slot_unit[sl];
      if (unit < 0) break;
      const int t = unit / n_strips, s = unit % n_strips;
      const int sides = (s == 0) + (s == n_strips - 1);
      if (sides > 0) {
        // slot columns 0 .. 3 are u's w2 - 4 .. w2 - 1 (strip 0), slot
        // columns sw + 4 .. sw + 7 are u's 0 .. 3 (the last strip)
        const float* src =
            u + static_cast<size_t>(t * tile_r + M3_H - P) * w2;
        float* dst = ring + static_cast<size_t>(sl) * slot;
        const int n = rows * M3_HALO * sides;
        constexpr int BATCH = 8;
        for (int e0 = pl - 1; e0 < n; e0 += M3_FIXERS * BATCH) {
          float v[BATCH];
          int at[BATCH];
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            const int e = e0 + i * M3_FIXERS;
            const int q = e / (M3_HALO * sides), r = e % (M3_HALO * sides);
            const bool left = s == 0 && r < M3_HALO;
            const int x = r % M3_HALO;
            at[i] = e < n ? q * lds + (left ? x : sw + M3_HALO + x) : -1;
            v[i] = e < n ? __ldg(src + static_cast<size_t>(q) * w2 +
                                 (left ? w2 - M3_HALO + x : x))
                         : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < BATCH; ++i)
            if (at[i] >= 0) dst[at[i]] = v[i];
        }
        // the next box into this slot overwrites these writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      gdm::bar_arrive(halo + sl);
      // the slot (and its unit) may be refilled once the fixers are done
      __syncwarp(0xfffffffeu);
      if (pl == 1) gdm::bar_arrive(empty + sl);
    }
    return;
  }

  // ---- the consumers: column c of the unit's strip, the output rows
  // [o0, o1) of its row group ----
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid % sw, grp = tid / sw;
  const int o0 = grp * tile_r / groups, o1 = (grp + 1) * tile_r / groups;
  float ck[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ck[k] = __ldg(coef + static_cast<size_t>(k) * w2);
  if (MODE == COMPUTE) {
    // F over strip 0's columns and their wrapped halo into slot 0
    for (int e = tid; e < slot; e += nc) {
      int j = e % lds - M3_HALO;
      j = j < 0 ? j + w2 : (j >= w2 ? j - w2 : j);
      ring[e] = synth(M3_H - P + e / lds, j);
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
  }
  const size_t rp = static_cast<size_t>(n_tiles) * tile_r;
  for (int k = 0; RING_IN || k < mine; ++k) {
    const int sl = k % nb;
    int t, st;
    if (RING_IN) {
      const long long c0 = GDM_CLOCK();
      for (int h = 0; h < nsplit; ++h)
        gdm::bar_wait(full + sl * nsplit + h, (k / nb) & 1);
      const int unit = slot_unit[sl];
      if (unit < 0) break;
      t = unit / n_strips;
      st = unit % n_strips;
      if (MODE == BOTH && (st == 0 || st == n_strips - 1))
        gdm::bar_wait(halo + sl, (k / nb) & 1);
      GDM_STAMP_ADD(tid == 0, 2, GDM_CLOCK() - c0);
      GDM_STAMP(tid == 0 && k == 0, 1, GDM_CLOCK());
      GDM_STAMP_ADD(tid == 0, 7, 1);
      (void)c0;
    } else {
      t = (first + k) % n_tiles;
      st = (first + k) / n_tiles;
    }
    const int col = st * sw + c;
    const size_t yrow = M3_H + static_cast<size_t>(t) * tile_r;
    float cl[K];
    if (MODE == BOTH || MODE == COMPUTE) {
#pragma unroll
      for (int l = 0; l < K; ++l)
        cl[l] = __ldg(coef + static_cast<size_t>(l) * w2 + col);
    }
    if ((MODE == DMA || MODE == BOTH || MODE == DMA_OUT) && grp == 0) {
      if (t == 0)
        for (int r = 0; r < M3_H; ++r)
          y[static_cast<size_t>(r) * w2 + col] = 0.0f;
      if (t == n_tiles - 1)
        for (int r = 0; r < M3_H; ++r)
          y[(M3_H + rp + r) * w2 + col] = 0.0f;
    }
    if (MODE == BOTH || MODE == COMPUTE) {
      const float* base = ring + (MODE == COMPUTE ? 0 : sl * slot) +
                          o0 * lds + M3_HALO + c - P;
      float sum = 0.0f;
      m3_march<P>(base, lds, o1 - o0 + 2 * P, cl, ck, [&](int r, float v) {
        if (MODE == BOTH)
          y[(yrow + o0 + r) * w2 + col] = v;
        else
          sum += v;
      });
      if (MODE == COMPUTE) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) red[(k & 1) * 16 + warp] = sum;
        asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
        if (tid == 0) {
          float s = 0.0f;
          for (int w = 0; w < cw; ++w) s += red[(k & 1) * 16 + w];
          sink[t * n_strips + st] = s;
        }
      }
    } else if (MODE == DMA) {
      const float* c0 = u + static_cast<size_t>(t) * tile_r * w2;
#pragma unroll 8
      for (int r = o0; r < o1; ++r)
        y[(yrow + r) * w2 + col] = __ldg(c0 + static_cast<size_t>(r) * w2);
    } else if (MODE == DMA_OUT) {
      for (int r = o0; r < o1; ++r)
        y[(yrow + r) * w2 + col] = synth(r, 0);
    } else if (warp == 0) {   // DMA_IN
      float s = 0.0f;
      for (int r = lane; r < tile_r; r += 32)
        s += __ldg(u + (static_cast<size_t>(t) * tile_r + r) * w2);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0)
        sink[t * n_strips + st] = static_cast<float>(sw) * s;
    }
    if (RING_IN) {
      __syncwarp();
      if (lane == 0) gdm::bar_arrive(empty + sl);
    }
  }
  GDM_STAMP(tid == 0, 3, clock64());
  GDM_STAMP(tid == 0, 6, gdm_gtimer());
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

template <int MODE, int P>
int launch_sepbuf(const float* u, float* y, float* sink, const Geom& g,
                  int* blocks, cudaStream_t s) {
  auto kernel = sepbuf_kernel<MODE, P>;
  // two slots, with the earlier ring's scratch (see sepbuf_kernel)
  const size_t smem = sizeof(float) *
      (16 + rnd4((g.tile_r + 2 * P) * g.sw) + 2 * static_cast<size_t>(g.slot));
  const int e = wave(kernel, smem, g.n_tiles * g.n_strips, blocks);
  if (e != 0) return e;
  kernel<<<*blocks, NT, smem, s>>>(u, y, sink, g, 2, 1);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int sepbuf_p(const float* u, float* y, float* sink, const Geom& g,
             int* blocks, cudaStream_t s) {
  switch (g.p) {
    case 1: return launch_sepbuf<MODE, 1>(u, y, sink, g, blocks, s);
    case 2: return launch_sepbuf<MODE, 2>(u, y, sink, g, blocks, s);
    case 3: return launch_sepbuf<MODE, 3>(u, y, sink, g, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M3's launch parameters beside the tensor map.
struct M3Args {
  const float* u;
  const float* coef;
  float* y;
  float* sink;
  int tile_r, n_tiles, w2, sw, nb, nsplit, box_rows, nbox, groups, blocks,
      smem;
  unsigned long long* tickets;
  long long base;
};

template <int MODE, int P>
int launch_m3(const CUtensorMap& tm, const M3Args& a, cudaStream_t s) {
  auto kernel = m3_kernel<MODE, P>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<a.blocks, a.sw * a.groups + 32, a.smem, s>>>(
      tm, a.u, a.coef, a.y, a.sink, a.tile_r, a.n_tiles, a.w2, a.sw, a.nb,
      a.nsplit, a.box_rows, a.nbox, a.groups, a.tickets, a.base);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int m3_p(int p, const CUtensorMap& tm, const M3Args& a, cudaStream_t s) {
  switch (p) {
    case 1: return launch_m3<MODE, 1>(tm, a, s);
    case 2: return launch_m3<MODE, 2>(tm, a, s);
    case 3: return launch_m3<MODE, 3>(tm, a, s);
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

}  // namespace

extern "C" {

// M3: u, y (n_tiles tile_r + 16, w2) float32, coef (2p + 1, w2), sink
// (n_tiles, w2 / sw); mode 0 compute, 1 dma, 2 both, 3 dma_in, 4 dma_out;
// the plan (m3_plan): strips of sw columns, nb slots of nsplit copies of
// nbox boxes of box_rows rows in all, `groups` consumer row groups,
// `blocks` blocks of `threads` = sw groups + 32 threads, `smem` bytes a
// block; `tickets`, the plan's ticket counter (8 bytes), at `base` for
// this launch in "dma", "both" and "dma_in", which draw U + blocks
// tickets.  The tensor map over u is encoded on every call (host work
// only).
int gdm_micro_stream_f32(const void* u, const void* coef, void* y, void* sink,
                         int mode, int p, int tile_r, int n_tiles, int w2,
                         int sw, int nb, int nsplit, int box_rows, int nbox,
                         int groups, int blocks, int threads, int smem,
                         void* tickets, long long base, void* stream) {
  const int rows = tile_r + 2 * p;
  if (p < 1 || p > 3 || tile_r < 1 || n_tiles < 1 || w2 < 128 || w2 % 128 ||
      (sw != 32 && sw != 64 && sw != 128) || nb < 2 || nb > M3_MAX_NB ||
      nsplit < 1 || nsplit > M3_MAX_NSPLIT || box_rows < 4 ||
      box_rows > 256 || box_rows % 4 || nbox < nsplit ||
      nbox * box_rows < rows || (nbox - 1) * box_rows >= rows ||
      groups < 1 || groups > M3_MAX_GROUPS || groups > tile_r ||
      threads != sw * groups + 32 || threads > M3_MAX_THREADS ||
      blocks < 1 ||
      blocks > n_tiles * (w2 / sw) ||
      static_cast<size_t>(smem) != m3_smem(nb, nsplit, nbox * box_rows, sw) ||
      smem > 232448 || reinterpret_cast<uintptr_t>(u) % 16 ||
      tickets == nullptr || base < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  const int e = gdm::tensor_map_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, u,
                                   n_tiles * tile_r + 2 * M3_H, w2, box_rows,
                                   sw + 2 * M3_HALO,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  const M3Args a{static_cast<const float*>(u), static_cast<const float*>(coef),
                 static_cast<float*>(y), static_cast<float*>(sink), tile_r,
                 n_tiles, w2, sw, nb, nsplit, box_rows, nbox, groups, blocks,
                 smem, static_cast<unsigned long long*>(tickets), base};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define GDM_M3(M) \
    case M: return m3_p<M>(p, tm, a, s);
    GDM_M3(COMPUTE) GDM_M3(DMA) GDM_M3(BOTH) GDM_M3(DMA_IN) GDM_M3(DMA_OUT)
#undef GDM_M3
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M5: u, y (n_tiles tile_r + 2h, w2) float32, sink (n_tiles, w2 / sw);
// mode 1 dma, 3 dma_in; *blocks gets the grid's block count.
int gdm_micro_sepbuf_f32(const void* u, void* y, void* sink, int mode, int p,
                         int h, int tile_r, int n_tiles, int w2, int sw,
                         int* blocks, void* stream) {
  if (p < 1 || p > 3 || tile_r < 1 || n_tiles < 1 || (sw != 32 && sw != 64) ||
      w2 % 128 || h < p)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g(h, p, tile_r, n_tiles, w2, sw, tile_r + 2 * h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(sink);
  if (mode == DMA) return sepbuf_p<DMA>(uf, yf, sf, g, blocks, s);
  if (mode == DMA_IN) return sepbuf_p<DMA_IN>(uf, yf, sf, g, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
