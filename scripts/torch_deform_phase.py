#!/usr/bin/env python3
"""Grid deformation on one CUDA card, alone.

    python3 scripts/torch_deform_phase.py [--keep-going] [--n N]

Builds the kernels and runs chip_smoke.py's deformation phase
(``deform_phase``): (a) the deformed uncut Poisson solve at 512^2 (or
N^2) in float32 and float64 with the never-cut multigrid, its host
set-up by stage, the CG phase, K1's launches, the idle share and the L2
error; (b) the deformed 2D wave preset in float32, run_scan and run() in
turns; (c) deformed heat-impl 2D in float32 and float64; (d) deformed
step85 with the cut multigrid; (e) heat_deformed_1d against the TPU's
rows and the x64 oracle; (f) K1 and K2's one-band mode on the deformed
bands against their plain twins; (g) the 3D deformed solve at 16^3;
(h) the wave-ev CLI on the card against a CPU run.  Prints the card and
the three kernels-line rows of the phase.  Exits non-zero on any failed
check; with --keep-going a failed check is printed and the phase goes
on, the exit code 1 at its end.
"""

import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from gdm_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    args = sys.argv[1:]
    if "--n" in args:
        cs.DEFORM_N = int(args[args.index("--n") + 1])
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
    out = cs.deform_phase(np.random.default_rng(0), torch.device("cuda"))
    for name, launches, vals in (
            ("K1 Dirichlet band", out["a_k1"], out["a_row"]),
            ("K1 wave mass", out["b_k1"], out["mass_row"]),
            ("K2 one-band wave mass", out["b_k2"], (*out["k2"], None))):
        err, ms, pms, bnd, lib = vals
        print(f"{name} row: launches {launches}, error {err:.3e}, "
              f"{ms * 1e3:.2f} us, plain {pms * 1e3:.1f} us, bound "
              f"{bnd[0] * 1e3:.2f} us ({bnd[1]}), library "
              + (f"{lib * 1e3:.2f} us" if lib is not None else "none"))
    if failed:
        raise SystemExit(f"{len(failed)} checks failed: {failed}")


if __name__ == "__main__":
    main()
