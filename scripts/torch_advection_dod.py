#!/usr/bin/env python3
"""Run the composite "DoD stabilization" advection case on one CUDA card.

The port's counterpart of scripts/run_composite_dod.py: the advection
app's built-in configuration (reference applications/advection/
advection-app.cc:86-154: two domains, p = 5, 200^2 cells, plane interface
at 135 degrees, velocities (3,1)/(1,2), cfl 0.2, end_t 0.6 = 1200 RK4
steps, two mass solves a stage) through
``AdvectionProblem.run_scan(chunk=32, checkpoint_path=OUT.ckpt)``, in
float32 with gdm's script's settings (solves to rel 1e-6, max_iter 400:
the params' rel 1e-14 is out of float32's reach) or, with --float64, at
the params' own tolerances.  A killed run started again with the same
arguments resumes from the checkpoint, which is removed once the
horizon is complete.

    python3 scripts/torch_advection_dod.py [OUT] [--steps N] [--float64]

Writes the per-step error rows of both domains to OUT (default
composite_dod_rows.txt) in the format of tests/data/composite_dod_rows.txt
and prints the card, the set-up and whole-run seconds, ms a step, the
mass solves' routing, K1 and K2 launches, iterations a solve, the idle
share of one chunk (its device busy time under the profiler against its
neighbours' wall time), the rows' scaled deviation from the TPU's float32
trajectory (tests/data/composite_dod_rows.txt; held within 1e-3 in
float32; with --float64, domain 1's err2 at t = 0.10, 0.15, 0.20 within
1e-3 of the TPU's) and the invariants of tests/test_composite_dod_pin.py
(copied, on the window run).  --steps N runs the first N steps of the horizon.
Exits non-zero on any failed check.
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

    args = sys.argv[1:]
    steps = 1200
    if "--steps" in args:
        k = args.index("--steps")
        steps = int(args[k + 1])
        del args[k:k + 2]
    dtype = torch.float64 if "--float64" in args else torch.float32
    paths = [a for a in args if not a.startswith("--")]
    out_path = paths[0] if paths else "composite_dod_rows.txt"

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

    prob, geo_s, setup_s = cs.dod_setup(dtype, steps)
    pp = prob.params
    print(f"DoD {dtype}, {steps} steps (end_t {pp.end_t:.4f}), solves to "
          f"rel {pp.solver_rel_tolerance:g}, max_iter "
          f"{pp.solver_max_iterations}: problem {geo_s:.1f} s, mass solvers "
          f"{setup_s:.1f} s; layout {prob.mass_solvers[0].layout.shape}")
    read_solves = cs.solve_counter(prob)
    hook = cs.chunk_profiler()     # chunk 2 under the profiler
    ckpt = out_path + ".ckpt"
    resumed = os.path.exists(ckpt)
    run_s, counts, log = cs.scan_logged(prob, hook=hook,
                                        chunk=cs.DOD_CHUNK,
                                        checkpoint_path=ckpt)
    if os.path.exists(ckpt):
        os.remove(ckpt)   # horizon complete; the trajectory is in out_path
    ms_step = cs.dod_report(prob, f"{dtype} run_scan(chunk={cs.DOD_CHUNK})"
                            + (" resumed" if resumed else ""), run_s, counts,
                            log, read_solves())
    with open(out_path, "w") as f:
        f.write("# composite DoD run (advection-app.cc config), "
                f"end_t={pp.end_t}, wall_s={run_s:.0f}\n")
        f.write("# slot counter time err2 err1 errinf face2 face1 "
                "faceinf\n")
        for slot in (0, 1):
            for r in prob.rows[slot]:
                f.write(f"{slot} {r[0]} {r[1]:.6f} "
                        + " ".join(f"{x:.8e}" for x in r[2:]) + "\n")
    print(f"wrote {out_path} ({len(prob.rows[0])}+{len(prob.rows[1])} rows)")

    if hook.items is not None and len(log) >= 3:
        n = cs.DOD_CHUNK
        cs.busy_report(hook.items, n, (log[0][4] + log[2][4]) / 2 / n * 1e3,
                       "chunk 2 under the profiler against chunks 1 and 3")
    golden = cs.dod_golden()
    dev = cs.dod_dev(prob.rows, golden)
    n_inv = cs.dod_invariants(prob.rows)
    e1 = np.array([r[2] for r in prob.rows[1]])
    for k, want in cs.DOD_F64_ERR2:
        if k < len(e1):
            gap = abs(e1[k] - want) / want
            print(f"domain 1 err2 at t = {prob.rows[1][k][1]:.2f}: "
                  f"{e1[k]:.8e} (the TPU's {want:.8e}, relative {gap:.2e}"
                  f"{', limit 1e-3' if dtype == torch.float64 else ''})")
            if dtype == torch.float64:
                cs.check(gap <= 1e-3, f"domain 1 err2 at step {k}: {gap:.2e}")
    print(f"rows against the TPU's float32 trajectory: max scaled deviation "
          f"{dev:.3e} over {len(prob.rows[0])} rows a slot (limit "
          f"{cs.DOD_LIMIT:g} in float32); {n_inv} invariants of "
          f"tests/test_composite_dod_pin.py hold; {ms_step:.2f} ms a step, "
          f"whole horizon {run_s:.1f} s; last rows {prob.rows[0][-1]}, "
          f"{prob.rows[1][-1]}")
    if dtype == torch.float32:
        cs.check(dev <= cs.DOD_LIMIT, f"rows deviate {dev:.3e}")


if __name__ == "__main__":
    main()
