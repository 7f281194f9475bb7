// Shared helpers of the gdm_torch CUDA kernels.
//
// K1 and K2 work on one padded 2D layout (gdm_torch/ops/cutband.py,
// PaddedLayout): a (rows, pitch) row-major array with rows = n0 + 2r,
// data nodes at [r, r + n0) x [r, r + n1) and zeros everywhere else.
// Coefficient planes are tap-major, (n_taps, rows, pitch), with the tap
// offsets (dy, dx) passed beside them as int32 pairs.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Clock stamps of a block's phases: scripts/torch_k1_k3s_breakdown.py
// compiles a copy of a kernel with GDM_STAMP, GDM_STAMP_ADD and
// GDM_CLOCK defined (and gdm_gtimer, the %globaltimer); in the kernels'
// own build the stamps are empty, their arguments are never evaluated,
// and GDM_CLOCK() is 0.
#ifndef GDM_STAMP
#define GDM_STAMP(cond, slot, value)
#define GDM_STAMP_ADD(cond, slot, value)
#define GDM_CLOCK() 0LL
#endif

namespace gdm {

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_(double a, double b, double c) {
  return ::fma(a, b, c);
}

// One element, global -> shared, asynchronously (cp.async, 4 or 8
// bytes): any address of the element's own alignment; zero-filled when
// !valid (src is then not read).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? static_cast<int>(sizeof(T)) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))), "r"(n));
}

// N elements from 16-byte aligned shared memory into registers, 16
// bytes a load (N a multiple of 16 / sizeof(T)): a band row that every
// lane of a warp reads costs N / 4 (float) or N / 2 (double) broadcast
// loads instead of N.
template <typename T, int N>
__device__ __forceinline__ void load_row16(const T* p, T (&out)[N]) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  static_assert(N % V == 0, "load_row16: N must fill whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < N; i += V) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
      out[i + 2] = x.z;
      out[i + 3] = x.w;
    } else {
      const double2 x = *reinterpret_cast<const double2*>(p + i);
      out[i] = x.x;
      out[i + 1] = x.y;
    }
  }
}

// mbarriers in shared memory (a 64-bit word each).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the inits visible before the block's first barrier.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar` by this thread.
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Add `bytes` to the transactions `bar`'s current phase waits for.
__device__ __forceinline__ void bar_expect_tx(unsigned long long* bar,
                                              unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One bulk copy (the TMA unit) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) global -> shared, completing its bytes on
// `bar` (which bar_expect_tx must have been told of).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until `bar` has completed the phase of parity `parity`.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival on `bar` by this thread that also adds `bytes` to the
// transactions its current phase waits for (the TMA producer's arrival).
__device__ __forceinline__ void bar_arrive_expect_tx(unsigned long long* bar,
                                                     unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Part k of an even split of n into `parts`: the first n mod parts parts
// one larger (the split every launch plan of gdm_torch/ops/ simulates).
__device__ __forceinline__ void part(int n, int parts, int k, int& lo,
                                     int& size) {
  const int base = n / parts;
  const int rem = n - base * parts;
  lo = k * base + min(k, rem);
  size = base + (k < rem ? 1 : 0);
}

// Elements [e_lo, e_hi) of `base` (e_lo may be negative) into `dst`, a
// 16-byte aligned row of shared memory that stands for the 16 bytes
// around element e_lo: one bulk copy of the span rounded out to 16
// bytes, clipped to [lo, hi), completing on `bar`.  Element e_lo lands
// at dst[(base's misalignment + e_lo) mod (16 / sizeof(T))].
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* base,
                                          long long e_lo, long long e_hi,
                                          uintptr_t lo, uintptr_t hi,
                                          unsigned long long* bar) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  const uintptr_t a16 = (b + e_lo * static_cast<long long>(sizeof(T))) &
                        ~static_cast<uintptr_t>(15);
  const uintptr_t start = a16 > lo ? a16 : lo;
  uintptr_t end = (b + e_hi * static_cast<long long>(sizeof(T)) + 15) &
                  ~static_cast<uintptr_t>(15);
  end = end < hi ? end : hi;
  if (end > start) {
    const unsigned bytes = static_cast<unsigned>(end - start);
    bar_expect_tx(bar, bytes);
    bulk_copy(dst + (start - a16) / sizeof(T),
              reinterpret_cast<const void*>(start), bytes, bar);
  }
}

// Close this thread's group of copies issued since the last commit.
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (Hopper; K1 takes it): a kernel
// launched with launch_overlapped may start while the kernel before it
// in the stream finishes.  grid_dep_wait() returns once that kernel has
// ended and its writes are visible (at once on a plain launch): a kernel
// reads what earlier kernels write, and writes anything, only after it.
// grid_dep_release() lets the next such launch start its own set-up.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_release() {
  asm volatile("griddepcontrol.launch_dependents;\n" :::);
}

template <typename... Params, typename... Args>
inline cudaError_t launch_overlapped(void (*kernel)(Params...), dim3 grid,
                                     dim3 block, size_t smem,
                                     cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// True iff the padded-layout cell (row, col) holds a grid node.
__device__ __forceinline__ bool is_node(int row, int col, int n0, int n1,
                                        int r) {
  return row >= r && row < r + n0 && col >= r && col < r + n1;
}

}  // namespace gdm
