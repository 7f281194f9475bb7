#!/usr/bin/env python3
"""The cut advection family on one CUDA card, alone.

    python3 scripts/torch_advection_phase.py [--keep-going]

Builds the kernels and runs chip_smoke.py's advection phase
(``advection_phase``): the convergence case in float64 against the x64
oracle, the strong-BC advection_02 case against gdm's pins, the
composite DoD case at full width (200^2, p = 5, two domains) to t = 0.2
in float32 (rows against the TPU's trajectory, routing, K1 and K2
launches, iterations a solve, syncs a chunk, ms a step, idle share) and
in float64 to t = 0.15 (domain 1's err2 at t = 0.10, 0.15), run() against
run_scan in turns, checkpoint and resume, K1 and K2's one-band mode
against their plain twins at the DoD masses (radius 6) and both CLIs.
Exits non-zero on any failed check; with --keep-going a failed check
is printed and the phase goes on, the exit code 1 at its end.
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
    print(f"card: {cs.card_line()}")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel build {time.perf_counter() - t0:.1f} s")
    failed = []
    if "--keep-going" in sys.argv[1:]:
        def check(cond, what):
            if not cond:
                failed.append(what)
                print(f"CHECK FAILED: {what}")

        cs.check = check
    out = cs.advection_phase(np.random.default_rng(0), torch.device("cuda"))
    for name in ("k1", "k2"):
        launches, err, ms, pms, bnd = out[name][:5]
        print(f"{name.upper()} DoD row: launches {launches}, error "
              f"{err:.3e} (K1: max abs, float32; K2: the A-norm gap), "
              f"{ms * 1e3:.2f} us, plain {pms * 1e3:.1f} us, "
              f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
    if failed:
        raise SystemExit(f"{len(failed)} checks failed: {failed}")


if __name__ == "__main__":
    main()
