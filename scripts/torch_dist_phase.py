#!/usr/bin/env python3
"""gdm_torch.dist on the CUDA cards of one machine, alone.

    python3 scripts/torch_dist_phase.py [--keep-going] [--steps N]
                                        [--dryrun N]

Builds the kernels and runs chip_smoke.py's distribution phase
(``dist_phase``), the mesh's slots over every card present (shards share
a card where there are fewer cards than slots): (a) the sharded cut
apply of the flagship 128^2 mass over 1, 3 and 4 slots against the
serial K1 apply and the plain twin, in turns against the serial apply,
and K1 on each shard's layout; (b) dist.poisson.solve over 1, 3 and 7
slots; (c) the 2D wave preset over 4 slots in float64, all 111 steps
(``--steps N`` for its first N), against wave_1 and against one slot;
(d) the composite advection run_scan over 4 slots against one; (e) a
profiling.trace of a sharded apply.  Then
``gdm_torch.dist.dryrun.dryrun_multichip(N)`` (default 4) on the card.
Prints the card and the phase's K1 shard rows.  Exits non-zero on any
failed check; with --keep-going a failed check is printed and the phase
goes on, the exit code 1 at its end.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_cut3d_phase import load_chip_smoke  # noqa: E402


def main():
    cs = load_chip_smoke()
    import numpy as np
    import torch

    from gdm_torch.dist.dryrun import dryrun_multichip
    from gdm_torch.entry import flagship_operators
    from gdm_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    args = sys.argv[1:]
    steps = int(args[args.index("--steps") + 1]) if "--steps" in args \
        else None
    n_dry = int(args[args.index("--dryrun") + 1]) if "--dryrun" in args \
        else 4
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
    mass = flagship_operators(cs.N_GRID)[2]
    out = cs.dist_phase(np.random.default_rng(0), torch.device("cuda"),
                        mass, steps=steps)
    for (key, dtype), (err, ms, pms, bnd, lib) in out["k1_rows"].items():
        launches = out["a launches", dtype] if key == "128" else \
            out["c"]["k1_mass"]
        print(f"K1 shard row {key} {dtype}: launches {launches}, "
              f"error {err:.3e}, {ms * 1e3:.2f} us, plain {pms * 1e3:.1f} "
              f"us, bound {bnd[0] * 1e3:.2f} us ({bnd[1]}), library "
              + (f"{lib * 1e3:.2f} us" if lib is not None else "none"))
    t0 = time.perf_counter()
    print(f"dryrun_multichip({n_dry}): {dryrun_multichip(n_dry)} "
          f"({time.perf_counter() - t0:.1f} s)")
    if failed:
        raise SystemExit(f"{len(failed)} checks failed: {failed}")


if __name__ == "__main__":
    main()
