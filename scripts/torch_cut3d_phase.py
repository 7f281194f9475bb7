#!/usr/bin/env python3
"""The 3D cut problems on one CUDA card, alone.

    python3 scripts/torch_cut3d_phase.py [--keep-going] [--n N ...]

Builds the kernels and runs chip_smoke.py's 3D phase (``cut3d_phase``)
at 8^3: gdm's tests/test_cut_3d_heat.py configuration (heat-impl, p = 3,
the unit sphere, to t = 0.1) in float64 (run_scan and run() against the
x64 oracle) and float32 (run_scan against the TPU's float32 rows), and
the 3D cut Poisson solve of gdm's tests/test_cut_3d.py in float64, each
with its host set-up by stage, ms a step, and (each run again under the
profiler) device launches a step and the idle share.  Each ``--n N``
then runs the same heat configuration at N^3 cells (16 is the size this
repo reports; ~30 s of host set-up a dtype there), float64 and float32,
the float32 rows held against the float64 card run
(chip_smoke.CUT3D_N_LIMIT).  Exits non-zero on any failed check; with
--keep-going a failed check is printed and the phase goes on, the exit
code 1 at its end.
"""

import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main():
    cs = load_chip_smoke()
    import numpy as np
    import torch

    from gdm_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    args = sys.argv[1:]
    sizes = [int(args[i + 1]) for i, a in enumerate(args) if a == "--n"]
    print(f"card: {cs.card_line()}")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel build {time.perf_counter() - t0:.1f} s")
    failed = []
    if "--keep-going" in args:
        def check(cond, what):
            if not cond:
                failed.append(what)
                print(f"CHECK FAILED: {what}")

        cs.check = check
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cs.cut3d_phase(rng, dev, profiled=True)
    for n in sizes:
        cs.cut3d_phase(rng, dev, n=n, oracle=False, profiled=True)
    if failed:
        raise SystemExit(f"{len(failed)} checks failed: {failed}")


if __name__ == "__main__":
    main()
