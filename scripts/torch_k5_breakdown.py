#!/usr/bin/env python3
"""Where K5's time goes, on a CUDA card, at the 64^3 solve's level shapes
and at 161^3 (float32, p = 3, the launch plan ``stencil3.k5_plan`` picks).

Run from the repository root:  python3 scripts/torch_k5_breakdown.py

Builds a copy of gdm_torch/csrc/laplace3_mxu.cu with stamps of each
block's thread 0 (clock64 at the phase boundaries, %globaltimer at the
block's start and end) into the gitignored gdm_torch/_build/, runs it
on the same inputs as the kernel, and prints per shape: the kernel's
device time by events (and the stamped copy's), the span from the first
block's start to the last block's end and the spread of block starts
(globaltimer), and the mean and largest time of each phase over the
blocks (clock64 at the card's maximum SM clock): set-up (band rows, C
slice, the first copies issued), warp 0's wait for its planes' copies
and its stages 1-2 per plane, the barrier before the product, the
product, the stores.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from gdm_torch.benchmarks.timing import device_ms  # noqa: E402
from gdm_torch.grid import Grid  # noqa: E402
from gdm_torch.ops import _build, stencil3  # noqa: E402

NB = 4096   # blocks stamped (block index mod NB)
NS = 16     # stamps a block

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
src = open(os.path.join(ROOT, "gdm_torch/csrc/laplace3_mxu.cu")).read()


def C(k):
    return f"if (tid == 0) stp[{k}] = clock64();"


patches = [
    ("namespace {\n",
     "namespace {\n__device__ long long g_stamp[%d * %d];\n"
     "__device__ __forceinline__ long long gtimer() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n" % (NB, NS), 1),
    ("  const int warp = tid >> 5;\n  int a0, t0, i1_0, t1, i2_0, t2;\n",
     "  const int warp = tid >> 5;\n  long long* stp = g_stamp + "
     "((blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) "
     "%% %d) * %d;\n  if (tid == 0) {\n    for (int i = 2; i < %d; ++i) "
     "stp[i] = 0;\n    stp[0] = gtimer();\n    stp[1] = clock64();\n  }"
     "\n  int a0, t0, i1_0, t1, i2_0, t2;\n" % (NB, NS, NS), 1),
    ("  // C slice: column j (< W) of row i is S0(a0 + i, a0 - p + j), column\n",
     "  " + C(13) + "\n  // C slice: column j (< W) of row i is S0(a0 + i, a0 - p + j), "
     "column\n", 1),
    ("  // stage 2's band rows, at a pitch of KP (16-byte loads)\n",
     "  " + C(14) + "\n  // stage 2's band rows, at a pitch of KP (16-byte loads)\n", 1),
    ("  __syncthreads();  // C slice and stage-2 rows in place\n",
     "  " + C(15) + "\n  __syncthreads();  // C slice and stage-2 rows in place\n  "
     + C(2) + "\n", 1),
    ("    gdm::wait_group<NS - 1>();  // plane j's copies have landed\n"
     "    __syncwarp();\n",
     "    gdm::wait_group<NS - 1>();  // plane j's copies have landed\n"
     "    __syncwarp();\n    if (tid == 0 && k < 3) stp[3 + 2 * k] = "
     "clock64();\n", 1),
    ("    __syncwarp();  // every lane is done with the slot before its "
     "refill\n",
     "    if (tid == 0 && k < 3) stp[4 + 2 * k] = clock64();\n"
     "    __syncwarp();  // every lane is done with the slot before its "
     "refill\n", 1),
    ("  __syncthreads();  // [P ; T] complete; the u slots become the y "
     "stage\n",
     "  __syncthreads();  // [P ; T] complete; the u slots become the y "
     "stage\n  " + C(9) + "\n", 1),
    ("    window_product<T, P, NS>(ct, pt, ys, warp);\n    __syncwarp();\n",
     "    window_product<T, P, NS>(ct, pt, ys, warp);\n    __syncwarp();\n"
     "    " + C(10) + "\n", 1),
    ("        yb[static_cast<size_t>(i) * plane] = yr[i * LDP];\n    }\n  }\n}",
     "        yb[static_cast<size_t>(i) * plane] = yr[i * LDP];\n    }\n"
     "    if (tid == 0) { stp[11] = clock64(); stp[12] = gtimer(); }\n  }\n}",
     1),
    ("}  // extern \"C\"", "int gdm_k5_stamps(void* host) {\n  return "
     "static_cast<int>(cudaMemcpyFromSymbol(host, g_stamp, "
     "sizeof(g_stamp)));\n}\n\n}  // extern \"C\"", 1),
]
for old, new, n in patches:
    assert src.count(old) == n, (old, src.count(old))
    src = src.replace(old, new)
build = _build.BUILD_DIR
os.makedirs(build, exist_ok=True)
cu = os.path.join(build, "laplace3_mxu_dbg.cu")
open(cu, "w").write(src)
so = os.path.join(build, "libk5dbg.so")
subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                os.path.join(ROOT, "gdm_torch/csrc"), "-o", so, cu],
               check=True, capture_output=True)
lib = ctypes.CDLL(so)
P, I = ctypes.c_void_p, ctypes.c_int
lib.gdm_laplace3_mxu_apply_f32.argtypes = [P] * 8 + [I] * 8 + [P]
lib.gdm_laplace3_mxu_apply_f32.restype = I
lib.gdm_k5_stamps.argtypes = [P]

clock = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
     "nounits"], capture_output=True, text=True).stdout.strip()) * 1e6
dev = torch.device("cuda")
phases = [("set-up: the first planes' copies issued", 1, 13),
          ("set-up: C slice", 13, 14),
          ("set-up: band rows, padding, stage-1 bands", 14, 15),
          ("set-up: the first barrier", 15, 2),
          ("warp 0, plane 1: wait for its copies", 2, 3),
          ("warp 0, plane 1: stages 1-2", 3, 4),
          ("warp 0, plane 2: wait", 4, 5),
          ("warp 0, plane 2: stages 1-2", 5, 6),
          ("warp 0, plane 3: wait", 6, 7),
          ("warp 0, plane 3: stages 1-2", 7, 8),
          ("warp 0 to the barrier before the product", None, 9),
          ("product (warp 0)", 9, 10),
          ("stores (warp 0)", 10, 11)]
for n in (64, 32, 16, 160):
    g = Grid(3, (n,) * 3, (0.0,) * 3, (1.0,) * 3)
    bt = stencil3.laplace3_bands(g, dev, torch.float32)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(g.nodes),
                        dtype=torch.float32, device=dev)
    plan = stencil3.k5_plan(g.nodes, 3, torch.float32)
    y = torch.empty_like(u)
    (s0, s1, s2), (m0, m1, m2) = bt.s, bt.m

    def run():
        err = lib.gdm_laplace3_mxu_apply_f32(
            u.data_ptr(), s0.data_ptr(), m0.data_ptr(), s1.data_ptr(),
            m1.data_ptr(), s2.data_ptr(), m2.data_ptr(), y.data_ptr(), 3,
            *g.nodes, *plan.grid, plan.slots,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    yk = stencil3.laplace3_mxu_apply(u, bt)
    assert torch.equal(y, yk), "the stamped copy disagrees with K5"
    st = np.zeros(NB * NS, np.int64)
    lib.gdm_k5_stamps(st.ctypes.data)
    st = st.reshape(NB, NS)[:min(plan.blocks, NB)]
    ms = device_ms(lambda: stencil3.laplace3_mxu_apply(u, bt))
    ms_dbg = device_ms(run)
    t0 = st[:, 0].min()
    print(f"{g.nodes[0]}^3: {plan}; K5 {ms * 1e3:.2f} us by events (the "
          f"stamped copy {ms_dbg * 1e3:.2f}); blocks stamped {len(st)}: "
          f"first start to last end {(st[:, 12].max() - t0) / 1e3:.2f} us, "
          f"block starts spread over {(st[:, 0].max() - t0) / 1e3:.2f} us, "
          f"a block's own span mean {(st[:, 12] - st[:, 0]).mean() / 1e3:.2f}"
          f" us, max {(st[:, 12] - st[:, 0]).max() / 1e3:.2f} us")
    for name, a, b in phases:
        if a is None:
            done = [st[:, 4 + 2 * k] for k in range(3)]
            last = np.where(done[2] > 0, done[2],
                            np.where(done[1] > 0, done[1], done[0]))
            d = st[:, b] - last
        else:
            valid = (st[:, a] > 0) & (st[:, b] > 0)
            if not valid.any():
                continue
            d = (st[:, b] - st[:, a])[valid]
        print(f"  {name:42s} mean {d.mean() / clock * 1e6:7.3f} us, max "
              f"{d.max() / clock * 1e6:7.3f} us")
