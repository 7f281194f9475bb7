#!/usr/bin/env python3
"""M4's ring swept on a CUDA card: every unit of 1, 2, 3, 4 or 8 whole
rows, 2, 3, 4 or 6 stages and 256, 512 or 1024 threads that fits a
block's shared memory, in "dma" and "both", at 1024^2 and 4096^2, each
held against the plain twin and timed by CUDA events beside the library
call u * 1.0000001.  gdm_torch/benchmarks/stream_overlap_micro.py's
AUTO_RING keeps the fastest.

Run from the repository root:  python3 scripts/torch_sweep_auto_micro.py
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from gdm_torch.benchmarks import _kernel, stream_overlap_micro as som  # noqa
from gdm_torch.benchmarks.timing import device_ms  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
dev = torch.device("cuda")
print("M4 sweep: n mode unit_rows stages threads blocks us (lib us)")
for n in (1024, 4096):
    for mode in som.AUTO_MODES:
        ap = som.make_auto_micro(mode, n, n, device=dev)[0]
        g = ap.geom
        u = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (g.rp, g.w2)), dtype=torch.float32, device=dev)
        yp = som.auto_micro_plain(u, ap.coef, g, mode)
        lib = device_ms(lambda: u * som.AUTO_SCALE)
        bufs = 2 if mode == "both" else 1
        for ur in (1, 2, 3, 4, 8):
            for st in (2, 3, 4, 6):
                smem = 128 + st * bufs * ur * 4 * g.w2
                if smem > 232448:
                    continue
                for nt in (256, 512, 1024):
                    y = torch.empty_like(u)
                    blocks = ctypes.c_int()

                    def run():
                        _kernel.run("gdm_micro_auto_f32", "M4", dev,
                                    u.data_ptr(), ap.coef.data_ptr(),
                                    y.data_ptr(),
                                    som.AUTO_MODES.index(mode) + 1, g.p,
                                    g.rp, g.w2, ur, st, nt,
                                    ctypes.byref(blocks))
                    run()
                    torch.cuda.synchronize()
                    e = (y - yp).abs().max().item()
                    ok = e == 0 if mode == "dma" else e <= 1e-6 * \
                        som.stream_term_scale(u, ap.coef)
                    ms = device_ms(run)
                    print(f"{n} {mode} {ur} {st} {nt} {blocks.value} "
                          f"{ms * 1e3:.2f} ({lib * 1e3:.2f}) "
                          f"{'ok' if ok else f'WRONG {e:.3e}'}", flush=True)
