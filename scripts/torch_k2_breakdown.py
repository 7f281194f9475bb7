#!/usr/bin/env python3
"""Where K2's time goes, on a CUDA card, at the flagship 128^2 size.

Run from the repository root:

    python3 scripts/torch_k2_breakdown.py [--root DIR] [--times-only]

1. both bodies of K2 against the plain version on nine right-hand sides
   (float32): iterations, true residuals and their difference, x;
2. device times (CUDA events) of the FSAI-preconditioned solve (max_iter
   40, rel 1e-5, as chip_smoke.py's phase 4), at max_iter 0 and 10 and
   unpreconditioned, which split a solve into its fixed cost and its
   iterations;
3. unless ``--times-only``, a copy of gdm_torch/csrc/resident.cu with
   clock64 stamps of block 0's thread 0 at the phase boundaries of
   iteration 2, built with nvcc into the gitignored gdm_torch/_build/
   and run for 10 FSAI iterations in both bodies: cycles and us per
   phase.  Its C entry's argument list and values come from
   ``resident.ENTRY_ARGTYPES`` and ``resident.entry_args``, the
   launcher's own.

``--root DIR`` imports ``gdm_torch`` from the checkout DIR instead of
this one, so that one call can time two trees on one card (the parent
unpacked into the gitignored ``.parent/``; run parent, change, change,
parent); a tree whose launcher has no ``entry_args`` (before K2's
one-band mode) gets parts 1 and 2 only.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ap = argparse.ArgumentParser()
ap.add_argument("--root", default=HERE)
ap.add_argument("--times-only", action="store_true")
opts = ap.parse_args()
ROOT = os.path.abspath(opts.root)
sys.path.insert(0, ROOT)
from gdm_torch.benchmarks.timing import device_ms  # noqa: E402
from gdm_torch.cut.fsai import fsai_factors  # noqa: E402
from gdm_torch.entry import flagship_operators  # noqa: E402
from gdm_torch.ops import _build, cutband, resident  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
print(f"gdm_torch from {ROOT}")
src = open(os.path.join(ROOT, "gdm_torch/csrc/resident.cu")).read()


def S(k, loop=False):
    """A clock64 stamp k by block 0's thread 0 (in iteration 2 if loop)."""
    cond = "it == 2 && " if loop else ""
    return (f"if ({cond}blockIdx.x == 0 && threadIdx.x == 0) "
            f"g_stamp[{k}] = clock64();")


patches = [
    ("namespace {\n", "namespace {\n__device__ long long g_stamp[64];\n", 1),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  " + S(0) + "\n", 1),
    ("  __syncthreads();\n\n  auto node", "  __syncthreads();\n  " + S(1)
     + "\n\n  auto node", 1),
    ("  const double nr0 = sqrt(rr0);", "  " + S(2) + "\n  const double nr0 = "
     "sqrt(rr0);", 1),
    ("    const T* zz = precond ? z : rold;  // the preconditioned residual\n",
     "    const T* zz = precond ? z : rold;\n    " + S(10, True) + "\n", 1),
    ("      const int C = chunk_of(c0);\n      for (int c = tid; c < C; c += NT) {\n"
     "        pnew[c0 + c]",
     "      " + S(11, True) + "\n      const int C = chunk_of(c0);\n"
     "      for (int c = tid; c < C; c += NT) {\n        pnew[c0 + c]", 1),
    ("    s = block_sum(s);\n    if (lead) slot_pAp[blockIdx.x] = s;\n"
     "    grid.sync();\n",
     "    " + S(12, True) + "\n    s = block_sum(s);\n    if (lead) "
     "slot_pAp[blockIdx.x] = s;\n    grid.sync();\n    " + S(13, True) + "\n", 1),
    ("    const T alpha = static_cast<T>(pAp <= 0.0 ? 0.0 : rz / pAp);\n",
     "    const T alpha = static_cast<T>(pAp <= 0.0 ? 0.0 : rz / pAp);\n    "
     + S(14, True) + "\n", 1),
    ("      const int C = chunk_of(c0);\n      for (int c = tid; c < C; c += NT) {\n"
     "        const long long i = c0 + c;\n        const T ri = win[own + c];",
     "      " + S(15, True) + "\n      const int C = chunk_of(c0);\n"
     "      for (int c = tid; c < C; c += NT) {\n"
     "        const long long i = c0 + c;\n        const T ri = win[own + c];", 1),
    ("      if (MODE == MODE_FSAI) {\n        band(1, c0, C,",
     "      " + S(16, True) + "\n      if (MODE == MODE_FSAI) {\n"
     "        band(1, c0, C,", 1),
    ("    s = block_sum(s);\n    if (lead) slot_rr[blockIdx.x] = s;\n"
     "    if (MODE == MODE_BAND) {",
     "    " + S(17, True) + "\n    s = block_sum(s);\n    if (lead) "
     "slot_rr[blockIdx.x] = s;\n    if (MODE == MODE_BAND) {", 1),
    ("      if (lead) slot_rz[blockIdx.x] = s2;\n    }\n    grid.sync();\n",
     "      if (lead) slot_rz[blockIdx.x] = s2;\n    }\n    grid.sync();\n"
     "    " + S(18, True) + "\n", 1),
    ("        fill(c0, vec(t));\n        band(2,",
     "        fill(c0, vec(t));\n        " + S(19, True) + "\n        band(2,", 1),
    ("      s = block_sum(s);\n      if (lead) slot_rz[blockIdx.x] = s;\n"
     "      grid.sync();\n",
     "      " + S(20, True) + "\n      s = block_sum(s);\n      if (lead) "
     "slot_rz[blockIdx.x] = s;\n      grid.sync();\n      " + S(21, True)
     + "\n", 1),
    ("    beta = static_cast<T>(rz <= 0.0 ? 0.0 : rz_new / rz);\n",
     "    beta = static_cast<T>(rz <= 0.0 ? 0.0 : rz_new / rz);\n    "
     + S(22, True) + "\n", 1),
    ("  if (blockIdx.x == 0) {\n    double true_rr;",
     "  " + S(30) + "\n  if (blockIdx.x == 0) {\n    double true_rr;", 1),
    ("      a.stats[3] = 1.0f;\n    }\n  }\n",
     "      a.stats[3] = 1.0f;\n    }\n  }\n  " + S(31) + "\n", 1),
    ("}  // extern \"C\"", "int gdm_stamps(void* host) {\n  return "
     "static_cast<int>(cudaMemcpyFromSymbol(host, g_stamp, "
     "sizeof(g_stamp)));\n}\n\n}  // extern \"C\"", 1),
]
stamped = not opts.times_only and hasattr(resident, "entry_args")
if stamped:
    for old, new, n in patches:
        assert src.count(old) == n, (old, src.count(old))
        src = src.replace(old, new)
    build = _build.BUILD_DIR
    os.makedirs(build, exist_ok=True)
    cu = os.path.join(build, "resident_dbg.cu")
    open(cu, "w").write(src)
    so = os.path.join(build, "libk2dbg.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    os.path.join(ROOT, "gdm_torch/csrc"), "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.gdm_resident_cg_f32.argtypes = resident.ENTRY_ARGTYPES
    lib.gdm_stamps.argtypes = [ctypes.c_void_p]

clock = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,name,power.limit",
     "--format=csv,noheader,nounits"], capture_output=True,
    text=True).stdout.strip().split(",")[1]) * 1e6
dev = torch.device("cuda")
grid, op, mass, stiff = flagship_operators(128)
G, GT = fsai_factors(mass)
layout = cutband.layout_for(grid, max(mass.radius, G.radius))
A, Gp, GTp = (cutband.band_planes(s, layout, dev, torch.float32)
              for s in (mass, G, GT))
N = grid.n_nodes
rng = np.random.default_rng(0)
rng.standard_normal(N)
rng.standard_normal(N)
bs = [rng.standard_normal(N)] + [np.random.default_rng(s).standard_normal(N)
                                 for s in range(1, 9)]
for k, bn in enumerate(bs):
    b = layout.pad(torch.as_tensor(bn, dtype=torch.float32, device=dev))
    x0 = torch.zeros_like(b)
    args = (A, Gp, GTp, 40, 1e-5, 1e-12)
    xp, sp = resident.resident_cg_plain(b, x0, *args)
    sp = resident.read_stats(sp)
    out = []
    for body in resident.BODIES:
        xk, sk = resident.resident_cg(b, x0, *args, body=body)
        sk = resident.read_stats(sk)
        out.append(f"{body} it {sk['iterations']} res {sk['residual']:.4e} "
                   f"({sk['residual'] / sp['residual'] - 1:+.3f}) dx "
                   f"{((xk - xp).norm() / xp.norm()).item():.2e}")
    print(f"b{k}: plain it {sp['iterations']} res {sp['residual']:.4e}; "
          + "; ".join(out), flush=True)

b = layout.pad(torch.as_tensor(bs[0], dtype=torch.float32, device=dev))
x0 = torch.zeros_like(b)
for body in resident.BODIES:
    args = (A, Gp, GTp, 40, 1e-5, 1e-12)
    its = resident.read_stats(resident.resident_cg(b, x0, *args,
                                                   body=body)[1])["iterations"]
    ms = device_ms(lambda: resident.resident_cg(b, x0, *args, body=body))
    print(f"K2 {body} FSAI solve (max_iter 40, rel 1e-5, {its} iterations): "
          f"{ms * 1e3:.2f} us", flush=True)
    for mi in (0, 10):
        args = (A, Gp, GTp, mi, 0.0, 0.0)
        ms = device_ms(lambda: resident.resident_cg(b, x0, *args, body=body))
        print(f"K2 {body} max_iter {mi}: {ms * 1e3:.2f} us", flush=True)
    args = (A, None, None, 10, 0.0, 0.0)
    ms = device_ms(lambda: resident.resident_cg(b, x0, *args, body=body))
    print(f"K2 {body} unpreconditioned 10 iterations: {ms * 1e3:.2f} us",
          flush=True)
ms = device_ms(lambda: x0.clone())
print(f"x0.clone() alone {ms * 1e3:.2f} us")

if not stamped:
    sys.exit(0)
names = {0: "start", 1: "copies of the planes issued",
         2: "setup (3 applies, 3 syncs)", 10: "iterations 0-1",
         11: "A: fill p", 12: "A: band A + own p",
         13: "A: block sum + grid sync", 14: "B: totals (alpha)",
         15: "B: fill r", 16: "B: own cells (r, x)", 17: "B: band G",
         18: "B: block sum + grid sync", 19: "C: fill t",
         20: "C: band G^T", 21: "C: block sum + grid sync",
         22: "totals (beta, stop)", 30: "iterations 3-9 + fresh apply",
         31: "end"}
for body in ("shared", "device"):
    plan = resident.resident_plan(layout, 159, 4, *resident.card_limits(0),
                                  body=body)

    def run():
        x = x0.clone()
        work = torch.empty((7,) + layout.shape, device=dev)
        partials = torch.empty(3 * plan.blocks, dtype=torch.float64,
                               device=dev)
        stats = torch.empty(len(resident.STATS), device=dev)
        err = lib.gdm_resident_cg_f32(*resident.entry_args(
            b, x, A, (Gp, GTp), "fsai", work, partials, stats, 10, 0.0, 0.0,
            None, plan, torch.cuda.current_stream().cuda_stream))
        assert err == 0, err
        return stats
    for _ in range(3):
        stats = run()
    torch.cuda.synchronize()
    st = np.zeros(64, np.int64)
    lib.gdm_stamps(st.ctypes.data)
    ms = device_ms(run)
    print(f"K2 {body} body, 10 iterations: {ms * 1e3:.2f} us by events; "
          f"stats {stats.tolist()}; block 0's clock64 at "
          f"{clock / 1e6:.0f} MHz (max SM clock):")
    prev = st[0]
    for k in sorted(names):
        d = st[k] - prev
        print(f"  {names[k]:34s} {d:8d} cycles {d / clock * 1e6:8.3f} us")
        prev = st[k]
    print(f"  start to end {(st[31] - st[0]) / clock * 1e6:.2f} us; "
          f"iteration 2 {(st[22] - st[10]) / clock * 1e6:.2f} us")
