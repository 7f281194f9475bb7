// The Hopper stage that K3f (laplace2_fullmxu.cu), K0 (laplace2_v1.cu),
// K3/mxu and K3/mxu3 (laplace2_mxu.cu), K3/mxu3p (laplace2_mxu3p.cu) and
// K3p (laplace2_hybp.cu) share: window tables built once per Bands2 and
// row units on the device (ops/tc_tables.py), u tiles copied in one unit
// ahead, operands split once, persistent blocks.  K3/mxu, K3/mxu3 and
// K3/mxu3p take units of 64 output columns (the CW of Geom, wgmma's M),
// the others 32; K3p's units are whole tiles of a 32-column strip.
//
// A unit is one row unit (at most TRB = 32 output rows, the rows of a
// tile of tile_r, cut into pieces of 32 where tile_r is larger) times one
// block of TX = 32 output columns.  (Row units of 64 rows, one wgmma M of
// A0w alone, took 2.5 to 3.5 times the shared memory and ran 15-40%
// slower at every shape measured: fewer blocks an SM hide less latency.)
// Units are numbered row unit major (unit = k n_cb + cb) and every block
// of the persistent grid walks an even share of consecutive units, so it
// keeps a row unit's window for all the column blocks it takes in that
// row unit.
//
// Tables (gdm_torch/ops/tc_tables.py builds them once per Bands2 and
// row units, on the device): the row window of row unit k stacks its A0 and
// B0 windows, [A0w; B0w], 64 rows (one wgmma M) by the depth of the
// unit's extended rows; A0w[r][s] = A0(i0 + r, s - r) for 0 <= s - r <=
// 2p and r below the unit's rows, zero elsewhere.  K3f's column slice of
// block cb is C^T, 64 rows by KD: row x (< 32) holds A1(j0 + x, w - x) at
// w, row 32 + x holds B1's, zero past the grid.  In float32 each table is
// stored as hi = tf32(x) (round to nearest, ties away, as cvt.rna.tf32)
// and lo = tf32(x - hi): a window as hi's image then lo's in the 32-byte
// swizzled K-major layout of wgmma.cuh, so its bytes land in shared
// memory as they are; C^T in the order of the wgmma A fragments a thread
// holds.  In float64 unsplit and row-major, padded as the DMMA fragments
// read them.
//
// Only a window's band can be non-zero, and its place is the same in
// every row unit, so the float32 path zeroes its window buffer once a
// block and copies, per row unit, only the 16-byte halves that hold the
// band (copy_band_halves): about (2p + 7) / 4 of a row's M / 4.
//
// u tiles: a row of 1025 float32 nodes starts 4 bytes past a 16-byte
// boundary (no 2D tensor map; laplace2_stream.cu), so each row's span of
// 32 + 2p elements, rounded out to 16 bytes (never past the array's own
// rounded ends), comes in by 16-byte cp.async copies of the whole
// warpgroup, one unit ahead into the other of two landing slots; element
// c of landing row r sits `roff[r]` elements past the row's start.  (One
// bulk copy a row span, issued by the lanes of warp 0 onto a slot's
// mbarrier, measured 2 us slower at 1025^2: the spans are only 160-240
// bytes.)  Splitting reads the landed rows with zeros outside the grid.
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace gdm {
namespace tcs {

constexpr int TX = 32;            // output columns of a unit
constexpr int TRB = 32;           // output rows of a row unit, at most
constexpr int NT = 128;           // threads of a block: one warpgroup
constexpr int SMEM_MAX = 232448;  // shared memory one H100 block may use
constexpr int ALIGN = 1024;       // every buffer starts on such a line

__host__ __device__ constexpr int rnd(int n, int m) {
  return (n + m - 1) / m * m;
}

__host__ __device__ constexpr size_t line(size_t bytes) {
  return (bytes + ALIGN - 1) / ALIGN * ALIGN;
}

// The geometry of degree P, element type T and CW output columns a unit
// (K3/mxu and K3/mxu3p take 64, wgmma's M).
template <typename T, int P, int CW = TX>
struct Geom {
  static constexpr int UW = CW + 2 * P;      // u columns a unit reads
  static constexpr int KD = rnd(UW, 8);      // ... padded to k-steps
  static constexpr int WR = 2 * TRB;         // rows of [A0w; B0w]
  // u rows a unit reads, padded: to k-steps (float32, wgmma's N and K)
  // or to the 16-row blocks of the DMMA fragments (float64)
  static constexpr int M = rnd(TRB + 2 * P, sizeof(T) == 4 ? 8 : 16);
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int LW = rnd(UW + VEC - 1, VEC);  // landing row pitch
  static constexpr int NG = LW / VEC;                // 16-byte groups a row
  static constexpr size_t land_bytes = sizeof(T) * M * LW;
};

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before has
// landed (the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void copies_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The element offset of unit column 0 of u row gi in its landing row: the
// element's index mod 16 / sizeof(T), in 32-bit arithmetic.
template <typename T>
__device__ __forceinline__ int land_offset(const T* u, int gi, int j0, int p,
                                           int n1) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int base = static_cast<int>(
      (reinterpret_cast<uintptr_t>(u) / sizeof(T)) & (VEC - 1));
  return (base + gi * (n1 & (VEC - 1)) + j0 - p) & (VEC - 1);
}

// Issue the 16-byte cp.async copies of a unit's u rows i0 - P .. i0 - P +
// rows (ROWS, M unless named, or a count a unit gives) at column j0 into
// the landing slot `land` (the whole warpgroup): each row's span of UW
// elements rounded out to 16 bytes, never past the array's own rounded
// ends.  Rows outside the grid are not copied; the split reads them as
// zero.
template <typename T, int P, int CW = TX, int ROWS = Geom<T, P, CW>::M>
__device__ void issue_u_rows(T* land, const T* __restrict__ u, int i0, int j0,
                             int n0, int n1, int tid, int rows = ROWS) {
  using G = Geom<T, P, CW>;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(u) &
                       ~static_cast<uintptr_t>(15);
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(u + static_cast<size_t>(n0) * n1) + 15) &
      ~static_cast<uintptr_t>(15);
  for (int e = tid; e < rows * G::NG; e += NT) {
    const int r = e / G::NG;
    const int g = e % G::NG;
    const int gi = i0 - P + r;
    if (gi < 0 || gi >= n0) continue;
    const long long first = static_cast<long long>(gi) * n1 + j0 - P;
    const uintptr_t a16 =
        (reinterpret_cast<uintptr_t>(u) + first * static_cast<long long>(
                                                      sizeof(T))) &
        ~static_cast<uintptr_t>(15);
    const uintptr_t src = a16 + 16 * static_cast<uintptr_t>(g);
    if (src < lo || src >= hi) continue;
    copy16(land + r * G::LW + g * G::VEC, reinterpret_cast<const void*>(src));
  }
}

// The landing offsets of a unit's u rows, once a unit: roff[r] = the
// element offset of unit column 0 of row r (u row i0 - P + r) in its
// landing row, -1 for a row outside the grid (rows below ROWS, or below
// a count a unit gives).
template <typename T, int P, int ROWS = Geom<T, P>::M>
__device__ __forceinline__ void row_offsets(int* roff, const T* u, int i0,
                                            int j0, int n0, int n1, int tid,
                                            int rows = ROWS) {
  for (int r = tid; r < rows; r += NT) {
    const int gi = i0 - P + r;
    roff[r] = gi < 0 || gi >= n0 ? -1 : land_offset(u, gi, j0, P, n1);
  }
}

// The unit columns [lo, hi) that lie in the grid and its u span.
template <int P, int CW = TX>
struct Cols {
  int lo, hi;
  __device__ __forceinline__ Cols(int j0, int n1)
      : lo(P - j0 > 0 ? P - j0 : 0),
        hi(n1 + P - j0 < CW + 2 * P ? n1 + P - j0 : CW + 2 * P) {}
};

// Landed u at unit row r, unit column c (zero outside the grid).
template <typename T, int P, int CW = TX>
__device__ __forceinline__ T landed(const T* land, const int* roff, int r,
                                    int c, const Cols<P, CW>& cols) {
  const int o = roff[r];
  return o >= 0 && c >= cols.lo && c < cols.hi
             ? land[r * Geom<T, P, CW>::LW + o + c]
             : T(0);
}

// Task e of a band copy of a split table image (hi's image of `rows` x
// `depth` floats, then lo's): the float offset of its 16-byte half, or -1.
// Row g holds entries at k - g % period in [0, 2P] only.
template <int P>
__device__ __forceinline__ int band_half(int e, int rows, int depth,
                                         int period) {
  constexpr int NH = (2 * P + 3) / 4 + 1;
  const int part = e / (rows * NH);
  const int g = (e / NH) % rows;
  const int r = g % period;
  const int h = r / 4 + e % NH;
  if (part > 1 || 4 * h > r + 2 * P || 4 * h >= depth) return -1;
  return part * rows * depth + wg::sw32_offset(g, 4 * h, rows) / 4;
}

// Copy a table image's band halves into the same place of shared memory.
template <int P>
__device__ void copy_band_halves(float* dst, const float* __restrict__ src,
                                 int rows, int depth, int period, int tid) {
  constexpr int NH = (2 * P + 3) / 4 + 1;   // its 2p + 1 entries' halves
  for (int e = tid; e < 2 * rows * NH; e += NT) {
    const int at = band_half<P>(e, rows, depth, period);
    if (at >= 0) copy16(dst + at, src + at);
  }
}

// Copy `bytes` (a multiple of 16) of a table image into shared memory.
__device__ __forceinline__ void copy_image(void* dst, const void* src,
                                           size_t bytes, int tid) {
  for (size_t e = tid; e < bytes / 16; e += NT)
    copy16(static_cast<unsigned char*>(dst) + 16 * e,
           static_cast<const unsigned char*>(src) + 16 * e);
}

// 16-byte zeros over `bytes` (a multiple of 16) of shared memory.
__device__ __forceinline__ void zero_smem(void* dst, size_t bytes, int tid) {
  for (size_t e = tid; e < bytes / 16; e += NT)
    reinterpret_cast<float4*>(dst)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// hi = tf32(x), lo = tf32(x - hi) of four values into the hi and lo
// operands at the same (16-byte aligned) element offset.
__device__ __forceinline__ void split4(float* hi, float* lo, int at,
                                       const float (&x)[4]) {
  float h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = tf32_rna(x[i]);
    l[i] = tf32_rna(x[i] - h[i]);
  }
  *reinterpret_cast<float4*>(hi + at) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(lo + at) = make_float4(l[0], l[1], l[2], l[3]);
}

// The three chains of a 3xTF32 product, the small terms first:
// d (+)= a_lo b_hi + a_hi b_lo + a_hi b_hi, for one k-step; `first`
// starts the accumulation (d's old values are ignored).
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], uint32_t a_hi,
                                     uint32_t a_lo, uint32_t b_hi,
                                     uint32_t b_lo, bool first) {
  wg::WgmmaTf32<N>::mma(d, wg::sw32_desc(a_lo), wg::sw32_desc(b_hi),
                        first ? 0 : 1);
  wg::WgmmaTf32<N>::mma(d, wg::sw32_desc(a_hi), wg::sw32_desc(b_lo), 1);
  wg::WgmmaTf32<N>::mma(d, wg::sw32_desc(a_hi), wg::sw32_desc(b_hi), 1);
}

// The same with A's hi and lo in registers (wgmma.cuh's WgmmaTf32RS).
template <int N>
__device__ __forceinline__ void mma3rs(float (&d)[N / 2],
                                       const uint32_t (&a_hi)[4],
                                       const uint32_t (&a_lo)[4],
                                       uint32_t b_hi, uint32_t b_lo,
                                       bool first) {
  wg::WgmmaTf32RS<N>::mma(d, a_lo, wg::sw32_desc(b_hi), first ? 0 : 1);
  wg::WgmmaTf32RS<N>::mma(d, a_hi, wg::sw32_desc(b_lo), 1);
  wg::WgmmaTf32RS<N>::mma(d, a_hi, wg::sw32_desc(b_hi), 1);
}

// A plan's launch checks: row units of TRB rows, a grid of 1 .. units
// blocks, shared memory within a block.
inline bool plan_ok(int trb, int units, int grid, size_t smem) {
  return trb == TRB && units >= 1 && grid >= 1 && grid <= units &&
         smem <= static_cast<size_t>(SMEM_MAX);
}

// Shared memory above 48 KB needs the kernel's opt-in; returns a CUDA
// error code (0 on success).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(SMEM_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Blocks of `kernel` with `smem` bytes one SM holds, by the runtime.
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* out) {
  int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, NT, smem));
}

}  // namespace tcs
}  // namespace gdm

// Clock stamps of a block's phases (thread 0; empty in the kernels' own
// build, see common.cuh): slot `slot` += the clocks since `t`, and `t`
// restarts.  scripts/torch_k3f_k0_breakdown.py reads them: slots 0 and
// 10 the block's start and end (%globaltimer), 1 and 9 (clock64), 2 the
// set-up done, 3 the waits for copies, 4 the u split, 5 the first
// product, 6 its accumulators out, 7 the second product (K0: the column
// stage), 8 the epilogue, 11 the units.  K3/mxu's are
// scripts/torch_k3mxu_breakdown.py's: 12 the next copies issued, 7 the
// band rows and the wait for this unit's copies, 3 the barrier after it,
// 4 the column stage, 5 the product, 6 y staged.
#define GDM_TCS_PHASE(slot, t)                                     \
  do {                                                             \
    GDM_STAMP_ADD(threadIdx.x == 0, slot, GDM_CLOCK() - (t));      \
    (t) = GDM_CLOCK();                                             \
  } while (0)

// The switch from a runtime degree to the template instance (odd p <=
// 7 or 15); the call names the degree P.
#define GDM_TCS_CASE(PP, ...) \
  case PP: {                  \
    constexpr int P = PP;     \
    return __VA_ARGS__;       \
  }
#define GDM_TCS_DISPATCH7(p, ...)                                   \
  switch (p) {                                                      \
    GDM_TCS_CASE(1, __VA_ARGS__) GDM_TCS_CASE(3, __VA_ARGS__)       \
    GDM_TCS_CASE(5, __VA_ARGS__) GDM_TCS_CASE(7, __VA_ARGS__)       \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }
#define GDM_TCS_DISPATCH15(p, ...)                                  \
  switch (p) {                                                      \
    GDM_TCS_CASE(1, __VA_ARGS__) GDM_TCS_CASE(3, __VA_ARGS__)       \
    GDM_TCS_CASE(5, __VA_ARGS__) GDM_TCS_CASE(7, __VA_ARGS__)       \
    GDM_TCS_CASE(9, __VA_ARGS__) GDM_TCS_CASE(11, __VA_ARGS__)      \
    GDM_TCS_CASE(13, __VA_ARGS__) GDM_TCS_CASE(15, __VA_ARGS__)     \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }
