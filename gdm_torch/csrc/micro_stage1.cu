// M1: the 2D Laplace's two stages alone, gdm's stripped micro-kernels.
//
// Replaces benchmarks/mxu_micro.py::make_stage1_micro (its pallas_call,
// mxu_micro.py:188).  gdm ran six modes over the padded (R_ext, W2) node
// array of its mxu3p kernel: R_ext = Rp + 2H rows (H = rnd(p, 8) guard
// rows above and below, Rp = N0 rounded up to tile_r), W2 = rnd(N1 + 2p,
// 128) columns.  Every mode writes output rows [H, H + Rp); the 2H guard
// rows, which gdm never writes, are written as zeros here.
//
// Column modes, K3's column stage alone (laplace2.cu's column loop): a
// TPU lane roll of row i by p - l is a shifted shared-memory read here,
// u[i][(j + l - p) mod W2] (the roll wraps around W2, so does the read):
//   "full"      y = sum_l M[l][j] r_l + S[l][j] r_l   K shifted reads, 2K FMAs
//   "norolls"   the same 2K FMAs on one read value r_p
//   "rollsonly" y = sum_l r_l                        K shifted reads, K adds
// M and S are gdm's (K, W2) coefficient rows (the mass and stiffness band
// of axis 1 at columns p .. p + N1, zero elsewhere), read from shared
// memory as K3 reads its band rows.  (full - norolls) / K is the cost of
// one shifted read a pass, norolls / 2K that of one FMA with its
// coefficient read: the card's answer to whether shared-memory reads or
// FMA issue bound K3's column stage.
//
// Row modes, K3/mxu3's bf16x3 row product alone, over gdm's stand-in
// tables: for tile t of tile_r output rows, with U_t the T_ext = tile_r +
// 2H input rows from row t tile_r, hi = bf16(U_t), lo = bf16(U_t - hi):
//   "rowsonly"   y = Bh [hi; hi] + Bh [lo; lo] + Bl [hi; hi]
//   "dotsonly"   the same with lo = hi (the split elided)
//   "splitsonly" y[r] = hi[r] + lo[r] for r < tile_r (the dots elided)
// Bh, Bl are gdm's (n_tiles tile_r, 2 T_ext) bf16 tables.  The split is
// tc_window.cuh's split_bf16, the split of K3/mxu3.
//
// Bound on the card: the column modes move 8 bytes a node (u read, y
// written) against 4K flops ("full"); memory bounds them (at 1024^2, p =
// 3: 10.6 MB, 3.2 us at 3.35 TB/s); K3 itself takes ~12.5 us, so what they
// measure is the shared-memory and issue cost above that floor.  The row
// modes do 6 tile_r 2T_ext flops a node on the tensor cores (bf16, 989
// TFLOP/s dense): at 1024^2, p = 3, tile_r 256 about 3.9 GFLOP, 3.9 us,
// so they are bound by operations.
//
// Design: column modes, one block of 32 x 8 threads per 32 x 32 outputs;
// it copies its rows and 32 + 2p wrapped columns of u and its K x 32
// coefficients to shared memory, then each thread computes its outputs
// down a column, as K3 does.
//
// Row modes ("rowsonly", "dotsonly"), on Hopper's tensor-core path: the
// three products are one product of depth 3 x 2 T_ext, [Bh | Bh | Bl]
// times [hi; hi; lo; lo; hi; hi] (lo = hi in "dotsonly").  A block owns
// 64 WGS output rows of one tile (WGS MMA warpgroups of 64 rows) and N
// columns (N of 32, 64, 96, 128), chosen by row_plan below so that the
// blocks fill the SMs in as few waves as possible (gdm's 1024^2 p = 3,
// tile_r 256: 128 x 96 outputs, 2 x 12 x 5 = 120 blocks, one wave).  Two
// producer warps each keep one mbarrier ring full with TMA tensor-map
// loads: one loads the tile's u rows (float32, 16 rows x N columns a
// slot, no swizzle: the splitters read rows, a lane a column), the other
// the table tiles (bf16, 64 depth x 64 rows a warpgroup, 128-byte
// swizzled).  Four splitter warps split each u element once, into hi and
// lo panels, k-major and 128-byte swizzled as wgmma reads them, a ring of
// PANEL_SLOTS chunks of 64 u rows; every product of a chunk needs that
// chunk alone, so the ring holds any T_ext.  The depth walks each chunk
// twice for [hi; hi] (copy w of the chunk pairs with table columns w
// T_ext + k), so no u row past T_ext is read and no table column across
// the seam: the panel's columns past T_ext are zero, and the table box's
// columns past 2 T_ext are the tensor map's zero fill.  A Bh tile feeds
// the hi and the lo product, a Bl tile the hi product, each up to four
// wgmma m64nNk16 (bf16, float32 accumulators in registers), the next
// tiles' loads and the next chunk's split in flight meanwhile; the
// accumulators go through shared memory for coalesced float4 stores.
// (The first design, one block of 8 warps per 64 x 64 outputs walking
// the depth in chunks of 64 staged by element, each block splitting its
// u strip again, wmma m16n16k16, took 106 us at gdm's shape on an H100
// 80GB HBM3 at 700 W.)
#include <cuda.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "tc_window.cuh"
#include "tma.cuh"

namespace {

using gdm::tensor_map_2d;
using gdm::tma_load_2d;

using gdm::tc::bf16;

enum Mode { FULL = 0, NOROLLS = 1, ROLLSONLY = 2, ROWSONLY = 3,
            DOTSONLY = 4, SPLITSONLY = 5 };

constexpr int TX = 32;   // columns per block: one warp
constexpr int TY = 32;   // rows per block (column modes)
constexpr int NTY = 8;   // thread rows: 32 x 8 = 256 threads

template <int MODE, int P>
__global__ void __launch_bounds__(TX * NTY)
stage1_cols_kernel(const float* __restrict__ u, const float* __restrict__ cs,
                   const float* __restrict__ cm, float* __restrict__ y,
                   int h, int rp, int r_ext, int w2) {
  constexpr int K = 2 * P + 1;
  constexpr int UW = TX + 2 * P;
  __shared__ float us[TY * UW];
  __shared__ float sm[K * TX];
  __shared__ float ss[K * TX];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX;
  for (int k = tid; k < TY * UW; k += TX * NTY) {
    const int i = i0 + k / UW;
    int j = j0 - P + k % UW;
    j = j < 0 ? j + w2 : (j >= w2 ? j - w2 : j);   // the roll wraps
    us[k] = (i < r_ext && i >= h && i < h + rp)
                ? u[static_cast<size_t>(i) * w2 + j] : 0.0f;
  }
  for (int k = tid; k < K * TX; k += TX * NTY) {
    const size_t at = static_cast<size_t>(k / TX) * w2 + j0 + k % TX;
    sm[k] = cm[at];
    ss[k] = cs[at];
  }
  __syncthreads();
  const int j = j0 + tx;
  for (int r = ty; r < TY; r += NTY) {
    const int i = i0 + r;
    if (i >= r_ext) break;
    const float* row = us + r * UW + tx;
    float acc = 0.0f;
    if (MODE == FULL) {
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const float x = row[l];
        acc = fmaf(sm[l * TX + tx], x, acc);
        acc = fmaf(ss[l * TX + tx], x, acc);
      }
    } else if (MODE == NOROLLS) {
      const float x = row[P];
#pragma unroll
      for (int l = 0; l < K; ++l) {
        acc = fmaf(sm[l * TX + tx], x, acc);
        acc = fmaf(ss[l * TX + tx], x, acc);
      }
    } else {
#pragma unroll
      for (int l = 0; l < K; ++l) acc += row[l];
    }
    y[static_cast<size_t>(i) * w2 + j] =
        (i >= h && i < h + rp) ? acc : 0.0f;
  }
}

// "splitsonly": y[i][j] = hi + lo of u[i - h][j] on rows [h, h + rp)
__global__ void stage1_split_kernel(const float* __restrict__ u,
                                    float* __restrict__ y, int h, int rp,
                                    int r_ext, int w2) {
  const size_t n = static_cast<size_t>(r_ext) * w2;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(e / w2);
    float out = 0.0f;
    if (i >= h && i < h + rp) {
      bf16 hi, lo;
      gdm::tc::split_bf16(u[e - static_cast<size_t>(h) * w2], &hi, &lo);
      out = __bfloat162float(hi) + __bfloat162float(lo);
    }
    y[e] = out;
  }
}

// ---- the row modes on TMA and wgmma ----

constexpr int TMA_STAGES = 3;   // table tiles in the ring
constexpr int PANEL_SLOTS = 4;  // 64-deep panel chunks in the ring
constexpr int SPLITTERS = 128;  // threads that split u into the panels
constexpr int U_STAGES = 6;     // u slots in the ring
constexpr int U_ROWS = 16;      // u rows a slot
constexpr int A_TILE = 64 * 64 * 2;   // one warpgroup's table stage, bytes
constexpr int SMEM_ALIGN = 1024;      // a 128-byte swizzle's repeat

// wgmma m64nNk16, bf16 from shared memory (both k-major), float32
// accumulators in registers: d += a . b.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "n"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "n"(1));
  }
};

// A shared-memory matrix descriptor of a k-major operand in 128-byte
// swizzled rows (8 rows of 128 bytes an atom, atoms 1024 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// Bytes of shared memory of a row block (row_plan's arithmetic): the
// mbarriers, the table ring, the hi (and lo) panel ring of 64-deep
// chunks of N rows of 128 bytes and the u ring (the epilogue's staged
// result reuses them), and the alignment.
__host__ __device__ constexpr size_t rows_smem(int n, int wgs, bool split) {
  const size_t rings =
      static_cast<size_t>(TMA_STAGES) * wgs * A_TILE +
      (split ? 2 : 1) * static_cast<size_t>(PANEL_SLOTS) * n * 128 +
      static_cast<size_t>(U_STAGES) * U_ROWS * n * 4;
  const size_t staged = static_cast<size_t>(wgs) * 64 * (n + 8) * 4;
  return static_cast<size_t>(SMEM_ALIGN) * 2 +
         (rings > staged ? rings : staged);
}

template <bool SPLIT, int N, int WGS>
__global__ void __launch_bounds__(128 * WGS + 64 + SPLITTERS, 1)
stage1_rows_tma_kernel(const __grid_constant__ CUtensorMap tm_h,
                       const __grid_constant__ CUtensorMap tm_l,
                       const __grid_constant__ CUtensorMap tm_u,
                       float* __restrict__ y, int h, int tile_r, int t_ext,
                       int n_tiles, int w2) {
  constexpr int NC = 128 * WGS;   // consumer threads
  constexpr int LDO = N + 8;      // float pitch of the staged result
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~static_cast<uintptr_t>(SMEM_ALIGN - 1));
  unsigned long long* full_a = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty_a = full_a + TMA_STAGES;
  unsigned long long* full_u = empty_a + TMA_STAGES;
  unsigned long long* empty_u = full_u + U_STAGES;
  unsigned long long* ready = empty_u + U_STAGES;   // a panel chunk split
  unsigned long long* spent = ready + PANEL_SLOTS;  // its products done
  const int nch = (t_ext + 63) / 64;   // 64-deep chunks of the panel
  unsigned char* a_ring = smem + SMEM_ALIGN;
  unsigned char* pan_hi = a_ring + TMA_STAGES * WGS * A_TILE;
  unsigned char* pan_lo = SPLIT ? pan_hi + PANEL_SLOTS * N * 128 : pan_hi;
  float* u_ring = reinterpret_cast<float*>(
      pan_hi + (SPLIT ? 2 : 1) * PANEL_SLOTS * N * 128);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * N;
  const int mb0 = blockIdx.y * 64 * WGS;   // the block's first tile row
  const int t = blockIdx.z;
  const int urow0 = t * tile_r;   // the tile's first u row and table row
  const int nst = 4 * nch;        // table tiles: Bh and Bl, 2 copies
  const int nu = (t_ext + U_ROWS - 1) / U_ROWS;
  GDM_STAMP(tid == 0, 0, gdm_gtimer());
  GDM_STAMP(tid == 0, 1, clock64());

  if (tid == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      gdm::bar_init(full_a + s, 1);
      gdm::bar_init(empty_a + s, 4 * WGS);
    }
    for (int s = 0; s < U_STAGES; ++s) {
      gdm::bar_init(full_u + s, 1);
      gdm::bar_init(empty_u + s, SPLITTERS / 32);
    }
    for (int c = 0; c < PANEL_SLOTS; ++c) {
      gdm::bar_init(ready + c, SPLITTERS / 32);
      gdm::bar_init(spent + c, 4 * WGS);
    }
    gdm::bar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // ---- producer: the table tiles, tile i = (chunk, copy, table) ----
    if (lane == 0) {
      for (int i = 0; i < nst; ++i) {
        const int st = i % TMA_STAGES;
        if (i >= TMA_STAGES) {
          gdm::bar_wait(empty_a + st, ((i / TMA_STAGES) - 1) & 1);
        }
        const int col = ((i / 2) & 1) * t_ext + 64 * (i / 4);
        const CUtensorMap* tm = (i & 1) ? &tm_l : &tm_h;
        gdm::bar_arrive_expect_tx(full_a + st, WGS * A_TILE);
        for (int g = 0; g < WGS; ++g) {
          tma_load_2d(a_ring + (st * WGS + g) * A_TILE, tm, col,
                      urow0 + mb0 + 64 * g, full_a + st);
        }
      }
    }
  } else if (warp == 4 * WGS + 1) {
    // ---- producer: the tile's u rows, 16 a slot ----
    if (lane == 0) {
      for (int j = 0; j < nu; ++j) {
        const int st = j % U_STAGES;
        if (j >= U_STAGES) {
          gdm::bar_wait(empty_u + st, ((j / U_STAGES) - 1) & 1);
        }
        gdm::bar_arrive_expect_tx(full_u + st, U_ROWS * N * 4);
        tma_load_2d(u_ring + st * U_ROWS * N, &tm_u, n0, urow0 + U_ROWS * j,
                    full_u + st);
      }
    }
  } else if (warp >= 4 * WGS + 2) {
    // ---- the splitters: u rows [urow0, urow0 + T_ext) split once into
    // the hi and lo panels, element (k, n) at chunk k / 64, atom n / 8,
    // row n % 8, 16-byte group (k % 64) / 8 ^ n % 8 (the 128-byte
    // swizzle); rows past T_ext zero.  Panel chunk c (u slots 4c .. 4c +
    // 3) goes to ring slot c mod PANEL_SLOTS once the products of chunk
    // c - PANEL_SLOTS are done with it, and is announced on its `ready`
    // while the products of chunk c - 1 run.
    const int ts = tid - (128 * WGS + 64);
    for (int j = 0; j < nu; ++j) {
      const int st = j % U_STAGES;
      const int c = j / 4;
      const int ps = c % PANEL_SLOTS;
      if (j % 4 == 0 && c >= PANEL_SLOTS) {
        gdm::bar_wait(spent + ps, ((c / PANEL_SLOTS) - 1) & 1);
      }
      gdm::bar_wait(full_u + st, (j / U_STAGES) & 1);
      const float* us = u_ring + st * U_ROWS * N;
      for (int item = ts; item < 2 * N; item += SPLITTERS) {
        const int n = item % N;
        const int half = item / N;
        const int k0 = U_ROWS * j + 8 * half;
        uint32_t hw[4], lw[4];
#pragma unroll
        for (int r = 0; r < 8; r += 2) {
          bf16 h2[2], l2[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float x = k0 + r + q < t_ext
                                ? us[(8 * half + r + q) * N + n] : 0.0f;
            gdm::tc::split_bf16(x, h2 + q, l2 + q);
          }
          hw[r / 2] = pack_bf16(h2[0], h2[1]);
          lw[r / 2] = pack_bf16(l2[0], l2[1]);
        }
        const size_t at = static_cast<size_t>(ps) * N * 128 +
                          (n / 8) * 1024 + (n % 8) * 128 +
                          ((((k0 % 64) / 8) ^ (n % 8)) * 16);
        *reinterpret_cast<uint4*>(pan_hi + at) =
            make_uint4(hw[0], hw[1], hw[2], hw[3]);
        if (SPLIT) {
          *reinterpret_cast<uint4*>(pan_lo + at) =
              make_uint4(lw[0], lw[1], lw[2], lw[3]);
        }
      }
      // the generic-proxy stores before wgmma's async-proxy reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        gdm::bar_arrive(empty_u + st);
        if (j % 4 == 3 || j == nu - 1) gdm::bar_arrive(ready + ps);
      }
    }
    GDM_STAMP(ts == 0, 8, clock64());
  } else {
    // ---- the MMA warpgroups ----
    // the guard rows: zeros, written by the first and last tiles' first
    // row blocks
    for (int side = 0; side < 2; ++side) {
      if (blockIdx.y != 0 || t != (side == 0 ? 0 : n_tiles - 1)) continue;
      const int base = side == 0 ? 0 : h + n_tiles * tile_r;
      for (int e = tid; e < h * N; e += NC) {
        const int c = n0 + e % N;
        if (c < w2) y[static_cast<size_t>(base + e / N) * w2 + c] = 0.0f;
      }
    }

    // the product: table tile i is chunk i / 4 of the panels, copy
    // (i / 2) % 2 of the panel, Bh (i even: Bh hi and Bh lo) or Bl (Bl hi),
    // up to four k-steps each
    const int wg = warp / 4;
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    wgmma_fence();
    const uint32_t a_base = gdm::smem_addr(a_ring) + wg * A_TILE;
    for (int i = 0; i < nst; ++i) {
      const int st = i % TMA_STAGES;
      const int c = i / 4;
      const long long c0 = GDM_CLOCK();
      const int ps = c % PANEL_SLOTS;
      if (i % 4 == 0) {
        gdm::bar_wait(ready + ps, (c / PANEL_SLOTS) & 1);
        GDM_STAMP(tid == 0 && c == 0, 2, clock64());
      }
      gdm::bar_wait(full_a + st, (i / TMA_STAGES) & 1);
      GDM_STAMP_ADD(tid == 0, 3, GDM_CLOCK() - c0);
      (void)c0;
      const uint32_t b_hi = gdm::smem_addr(pan_hi) + ps * N * 128;
      const uint32_t b_lo = gdm::smem_addr(pan_lo) + ps * N * 128;
      const uint32_t a_st = a_base + st * WGS * A_TILE;
      const int ks = min(4, (t_ext - 64 * c + 15) / 16);
      const bool bh = (i & 1) == 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < ks) {
          Wgmma<N>::mma(acc, sw128_desc(a_st + 32 * kk),
                        sw128_desc(b_hi + 32 * kk));
          if (bh) {
            Wgmma<N>::mma(acc, sw128_desc(a_st + 32 * kk),
                          sw128_desc(b_lo + 32 * kk));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // tile i - 1's products are done: free its slot,
                         // and after a chunk's last tile the chunk's slot
      if (i > 0 && lane == 0) {
        gdm::bar_arrive(empty_a + (i - 1) % TMA_STAGES);
        if (i % 4 == 0) gdm::bar_arrive(spent + ((i - 1) / 4) % PANEL_SLOTS);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < N / 2; ++e) asm volatile("" : "+f"(acc[e])::"memory");

    // the epilogue: the accumulators through shared memory (over the table
    // ring and the panels, once every warpgroup's products are done), then
    // coalesced float4 stores of the tile's rows
    GDM_STAMP(tid == 0, 5, clock64());
    asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
    float* out = reinterpret_cast<float*>(a_ring) + wg * 64 * LDO;
    const int r = 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int e = 0; e < N / 8; ++e) {
      const int c = 8 * e + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + r * LDO + c) =
          make_float2(acc[4 * e], acc[4 * e + 1]);
      *reinterpret_cast<float2*>(out + (r + 8) * LDO + c) =
          make_float2(acc[4 * e + 2], acc[4 * e + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    const int tw = tid % 128;
    for (int e = tw; e < 64 * (N / 4); e += 128) {
      const int row = e / (N / 4);
      const int col = 4 * (e % (N / 4));
      const int tr = mb0 + 64 * wg + row;   // the row within the tile
      if (tr < tile_r && n0 + col < w2) {
        *reinterpret_cast<float4*>(
            y + (static_cast<size_t>(h) + urow0 + tr) * w2 + n0 + col) =
            *reinterpret_cast<const float4*>(out + row * LDO + col);
      }
    }
    GDM_STAMP(tid == 0, 6, clock64());
    GDM_STAMP(tid == 0, 7, gdm_gtimer());
  }
}

template <int MODE>
int launch_cols(const float* u, const float* cs, const float* cm, float* y,
                int p, int h, int rp, int r_ext, int w2, cudaStream_t s) {
  const dim3 block(TX, NTY);
  const dim3 grid(w2 / TX, (r_ext + TY - 1) / TY);
  switch (p) {
#define GDM_M1_P(PP)                                                   \
    case PP:                                                           \
      stage1_cols_kernel<MODE, PP><<<grid, block, 0, s>>>(u, cs, cm, y, \
                                                         h, rp, r_ext, \
                                                         w2);          \
      break;
    GDM_M1_P(1) GDM_M1_P(3) GDM_M1_P(5) GDM_M1_P(7)
    GDM_M1_P(9) GDM_M1_P(11) GDM_M1_P(13) GDM_M1_P(15)
#undef GDM_M1_P
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The row modes' launch: N columns and WGS warpgroups of 64 rows a block.
// row_plan picks the N of 128, 96, 64, 32 whose blocks fill the 132 SMs
// of an H100 best (blocks / (132 x waves), the larger N on a tie), WGS =
// 2 where a tile has more than 64 rows.
struct RowPlan {
  int n, wgs, blocks;
  size_t smem;
};

RowPlan row_plan_for(int n, int wgs, int tile_r, int n_tiles, int w2,
                     bool split) {
  return {n, wgs,
          ((w2 + n - 1) / n) * ((tile_r + 64 * wgs - 1) / (64 * wgs)) *
              n_tiles,
          rows_smem(n, wgs, split)};
}

RowPlan row_plan(int tile_r, int n_tiles, int w2, bool split) {
  const int wgs = tile_r > 64 ? 2 : 1;
  RowPlan best = row_plan_for(32, wgs, tile_r, n_tiles, w2, split);
  double best_fill = -1.0;
  for (int n : {128, 96, 64, 32}) {
    const RowPlan pl = row_plan_for(n, wgs, tile_r, n_tiles, w2, split);
    const int waves = (pl.blocks + 131) / 132;
    const double fill = static_cast<double>(pl.blocks) / (132.0 * waves);
    if (fill > best_fill) {
      best = pl;
      best_fill = fill;
    }
  }
  return best;
}

template <bool SPLIT, int N, int WGS>
int launch_rows_tma_nw(const CUtensorMap& th, const CUtensorMap& tl,
                       const CUtensorMap& tu, float* y, int h, int tile_r,
                       int t_ext, int n_tiles, int w2, size_t smem,
                       cudaStream_t s) {
  const int e = gdm::tc::allow_smem(stage1_rows_tma_kernel<SPLIT, N, WGS>,
                                    smem);
  if (e != 0) return e;
  const dim3 grid((w2 + N - 1) / N, (tile_r + 64 * WGS - 1) / (64 * WGS),
                  n_tiles);
  stage1_rows_tma_kernel<SPLIT, N, WGS>
      <<<grid, 128 * WGS + 64 + SPLITTERS, smem, s>>>(th, tl, tu, y, h,
                                                       tile_r, t_ext,
                                                       n_tiles, w2);
  return static_cast<int>(cudaGetLastError());
}

template <bool SPLIT>
int launch_rows_plan(const float* u, const bf16* th, const bf16* tl,
                     float* y, int h, int tile_r, int n_tiles, int w2,
                     const RowPlan& pl, cudaStream_t s) {
  const int t_ext = tile_r + 2 * h;
  if (pl.smem > static_cast<size_t>(gdm::tc::SMEM_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the maps are encoded on every call (host work only, no device call)
  CUtensorMap mh, ml, mu;
  const int rows = n_tiles * tile_r;
  int e = tensor_map_2d(&mh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, th, rows,
                        2 * t_ext, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0) {
    e = tensor_map_2d(&ml, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, tl, rows,
                      2 * t_ext, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (e == 0) {
    e = tensor_map_2d(&mu, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, u,
                      rows + 2 * h, w2, U_ROWS, pl.n,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (e != 0) return e;
#define GDM_M1_NW(NN, WW)                                                  \
  if (pl.n == NN && pl.wgs == WW)                                          \
    return launch_rows_tma_nw<SPLIT, NN, WW>(mh, ml, mu, y, h, tile_r,    \
                                             t_ext, n_tiles, w2, pl.smem, \
                                             s);
  GDM_M1_NW(32, 1) GDM_M1_NW(64, 1) GDM_M1_NW(96, 1) GDM_M1_NW(128, 1)
  GDM_M1_NW(32, 2) GDM_M1_NW(64, 2) GDM_M1_NW(96, 2) GDM_M1_NW(128, 2)
#undef GDM_M1_NW
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// mode: 0 full, 1 norolls, 2 rollsonly, 3 rowsonly, 4 dotsonly,
// 5 splitsonly.  t0, t1: the (K, W2) rows S, M (column modes) or the
// bf16 tables Bh, Bl (row modes; unused by splitsonly).  u and y are the
// (r_ext, w2) float32 arrays, r_ext = n_tiles tile_r + 2h, w2 a multiple
// of 128; t_ext = tile_r + 2h.
int gdm_micro_stage1_f32(const void* u, const void* t0, const void* t1,
                         void* y, int mode, int p, int h, int tile_r,
                         int n_tiles, int w2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  const int rp = n_tiles * tile_r;
  const int r_ext = rp + 2 * h;
  const int t_ext = tile_r + 2 * h;
  if (w2 % 128 != 0 || tile_r % 8 != 0 || h % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* f0 = static_cast<const float*>(t0);
  const float* f1 = static_cast<const float*>(t1);
  const bf16* b0 = static_cast<const bf16*>(t0);
  const bf16* b1 = static_cast<const bf16*>(t1);
  switch (mode) {
    case FULL:
      return launch_cols<FULL>(uf, f0, f1, yf, p, h, rp, r_ext, w2, s);
    case NOROLLS:
      return launch_cols<NOROLLS>(uf, f0, f1, yf, p, h, rp, r_ext, w2, s);
    case ROLLSONLY:
      return launch_cols<ROLLSONLY>(uf, f0, f1, yf, p, h, rp, r_ext, w2, s);
    case ROWSONLY:
    case DOTSONLY: {
      // tensor maps take 16-byte aligned arrays (the wrapper's are)
      if (((reinterpret_cast<uintptr_t>(u) |
            reinterpret_cast<uintptr_t>(t0) |
            reinterpret_cast<uintptr_t>(t1)) & 15) != 0) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
      const bool split = mode == ROWSONLY;
      const RowPlan pl = row_plan(tile_r, n_tiles, w2, split);
      return split ? launch_rows_plan<true>(uf, b0, b1, yf, h, tile_r,
                                            n_tiles, w2, pl, s)
                   : launch_rows_plan<false>(uf, b0, b1, yf, h, tile_r,
                                             n_tiles, w2, pl, s);
    }
    case SPLITSONLY:
      stage1_split_kernel<<<4 * 132, 256, 0, s>>>(uf, yf, h, rp, r_ext, w2);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The row modes with a given plan (split: "rowsonly", else "dotsonly";
// n columns and wgs warpgroups a block).
int gdm_micro_stage1_rows_f32(const void* u, const void* t0, const void* t1,
                              void* y, int split, int h, int tile_r,
                              int n_tiles, int w2, int n, int wgs,
                              void* stream) {
  if (w2 % 128 != 0 || tile_r % 8 != 0 || h % 8 != 0 ||
      (wgs != 1 && wgs != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowPlan pl = row_plan_for(n, wgs, tile_r, n_tiles, w2, split != 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const bf16* b0 = static_cast<const bf16*>(t0);
  const bf16* b1 = static_cast<const bf16*>(t1);
  float* yf = static_cast<float*>(y);
  return split ? launch_rows_plan<true>(uf, b0, b1, yf, h, tile_r, n_tiles,
                                        w2, pl, s)
               : launch_rows_plan<false>(uf, b0, b1, yf, h, tile_r, n_tiles,
                                         w2, pl, s);
}

// The plan gdm_micro_stage1_f32 launches the row modes with (n < 0), or
// the plan (n, wgs) given: out = {n, wgs, blocks, bytes of shared
// memory}.
int gdm_micro_stage1_rows_plan(int tile_r, int n_tiles, int w2, int split,
                               int n, int wgs, int* out) {
  const RowPlan pl = n < 0 ? row_plan(tile_r, n_tiles, w2, split != 0)
                           : row_plan_for(n, wgs, tile_r, n_tiles, w2,
                                          split != 0);
  out[0] = pl.n;
  out[1] = pl.wgs;
  out[2] = pl.blocks;
  out[3] = static_cast<int>(pl.smem);
  return 0;
}

}  // extern "C"
