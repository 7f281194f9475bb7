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
// tc_window.cuh's split_bf16 and the product its Acc16Bf16x3 (bf16 wmma,
// m16n16k16, float32 accumulation), the split and product of K3/mxu3;
// tc_window.cuh's RowOperands is not used, because its operands are K3's
// band windows over a 32-column strip and these are dense tables of depth
// 2 T_ext.
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
// down a column, as K3 does.  Row modes: one block of 8 warps per 64 x 64
// outputs of one tile; it walks the 2 T_ext depth in chunks of 64, each
// chunk's table rows (bf16 as given) and u rows (split to bf16 hi/lo as
// they are written) staged in shared memory, each warp accumulating two
// 16 x 16 blocks, then stages the result for coalesced stores.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "tc_window.cuh"

namespace {

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

constexpr int BR = 64;           // output rows per block (row modes)
constexpr int BC = 64;           // output columns per block
constexpr int KC = 64;           // depth chunk
constexpr int LDA = KC + 8;      // bf16 pitches: multiples of 8 elements
constexpr int LDB = BC + 8;
constexpr int LDO = BC + 4;      // float pitch of the staged result

constexpr size_t A_BYTES = sizeof(bf16) * BR * LDA;
constexpr size_t B_BYTES = sizeof(bf16) * KC * LDB;
constexpr size_t ROWS_SMEM = 2 * A_BYTES + 2 * B_BYTES;
static_assert(sizeof(float) * BR * LDO <= ROWS_SMEM,
              "the staged result reuses the operands' shared memory");

template <bool SPLIT>
__global__ void __launch_bounds__(256)
stage1_rows_kernel(const float* __restrict__ u, const bf16* __restrict__ th,
                   const bf16* __restrict__ tl, float* __restrict__ y, int h,
                   int tile_r, int t_ext, int n_tiles, int w2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ah = reinterpret_cast<bf16*>(smem);
  bf16* al = reinterpret_cast<bf16*>(smem + A_BYTES);
  bf16* bh = reinterpret_cast<bf16*>(smem + 2 * A_BYTES);
  bf16* bl = SPLIT ? reinterpret_cast<bf16*>(smem + 2 * A_BYTES + B_BYTES)
                   : bh;
  float* out = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int c0 = blockIdx.x * BC;
  const int r0 = blockIdx.y * BR;     // first row of the block in the tile
  const int t = blockIdx.z;
  const int depth = 2 * t_ext;
  const size_t trow0 = static_cast<size_t>(t) * tile_r;   // table/u row

  // the guard rows: zeros, written by the first and last tiles' first row
  // blocks
  for (int side = 0; side < 2; ++side) {
    if (r0 != 0 || t != (side == 0 ? 0 : n_tiles - 1)) continue;
    const int base = side == 0 ? 0 : h + n_tiles * tile_r;
    for (int e = tid; e < h * BC; e += blockDim.x)
      y[static_cast<size_t>(base + e / BC) * w2 + c0 + e % BC] = 0.0f;
  }

  gdm::tc::Acc16Bf16x3 acc[2];
  acc[0].zero();
  acc[1].zero();
  const int wr = (warp / 2) * 16;          // the warp's 16 rows
  const int wc = (warp % 2) * 32;          // and its two 16-column blocks
  for (int k0 = 0; k0 < depth; k0 += KC) {
    const int kc = min(KC, depth - k0);    // a multiple of 16
    __syncthreads();
    for (int e = tid; e < BR * kc; e += blockDim.x) {
      const int r = e / kc;
      const int k = e % kc;
      const bool in = r0 + r < tile_r;
      const size_t at = (trow0 + r0 + r) * depth + k0 + k;
      ah[r * LDA + k] = in ? th[at] : __float2bfloat16(0.0f);
      al[r * LDA + k] = in ? tl[at] : __float2bfloat16(0.0f);
    }
    for (int e = tid; e < kc * BC; e += blockDim.x) {
      const int k = e / BC;
      const int c = e % BC;
      const int kk = k0 + k;
      const float x = u[(trow0 + (kk < t_ext ? kk : kk - t_ext)) * w2 + c0 + c];
      if (SPLIT) {
        gdm::tc::split_bf16(x, bh + k * LDB + c, bl + k * LDB + c);
      } else {
        bh[k * LDB + c] = __float2bfloat16(x);
      }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < 2; ++f)
      acc[f].add(ah + wr * LDA, al + wr * LDA, LDA, bh + wc + 16 * f,
                 bl + wc + 16 * f, LDB, kc);
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 2; ++f) acc[f].store(out + wr * LDO + wc + 16 * f, LDO);
  __syncthreads();
  for (int e = tid; e < BR * BC; e += blockDim.x) {
    const int r = e / BC;
    if (r0 + r < tile_r)
      y[(static_cast<size_t>(h) + trow0 + r0 + r) * w2 + c0 + e % BC] =
          out[r * LDO + e % BC];
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

template <bool SPLIT>
int launch_rows(const float* u, const bf16* th, const bf16* tl, float* y,
                int h, int tile_r, int t_ext, int n_tiles, int w2,
                cudaStream_t s) {
  const int e = gdm::tc::allow_smem(stage1_rows_kernel<SPLIT>, ROWS_SMEM);
  if (e != 0) return e;
  const dim3 grid(w2 / BC, (tile_r + BR - 1) / BR, n_tiles);
  stage1_rows_kernel<SPLIT><<<grid, 256, ROWS_SMEM, s>>>(
      u, th, tl, y, h, tile_r, t_ext, n_tiles, w2);
  return static_cast<int>(cudaGetLastError());
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
      return launch_rows<true>(uf, b0, b1, yf, h, tile_r, t_ext, n_tiles, w2,
                               s);
    case DOTSONLY:
      return launch_rows<false>(uf, b0, b1, yf, h, tile_r, t_ext, n_tiles,
                                w2, s);
    case SPLITSONLY:
      stage1_split_kernel<<<4 * 132, 256, 0, s>>>(uf, yf, h, rp, r_ext, w2);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
