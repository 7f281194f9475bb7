#!/usr/bin/env python3
"""The deformed uncut Poisson solve at 1024^2 on one CUDA card.

    python3 scripts/torch_deform_poisson.py [--n N]

chip_smoke.py's deformation phase (a) at N^2 cells (default 1024, the
uncut multigrid cell's size; chip_smoke.py runs 512^2): p = 3,
examples/05_deformed_grid.py's warp, the never-cut multigrid
("mg"), through poisson.system_deformed on the card in float64 to rel
1e-12 and in float32 to rel 1e-6.  Prints the card, the host set-up by
stage (assembly, Dirichlet band, load vector, multigrid hierarchy), and
for each dtype the iterations, the CG phase's median of 5, K1's
launches, the device busy time and idle share, and the L2 error against
sin(pi x) sin(pi y) (float64; deform.l2_error on the host).  Checks
float32 within 1e-3 relative of float64 and within one iteration of a
float64 solve to rel 1e-6; exits non-zero on a failed check.
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
    n = int(args[args.index("--n") + 1]) if "--n" in args else 1024
    print(f"card: {cs.card_line()}")
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, _, out = cs.deform_poisson(n, torch.device("cuda"),
                                  rng=np.random.default_rng(0))
    print(f"deformed Poisson {n}^2: {out}; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
