#!/usr/bin/env python3
"""CPU rehearsal of the wave family's card routes in float32.

Runs the wave app's presets the way chip_smoke.py's wave-family phase
runs them on the card, but on the CPU: the 2D runs take the card's
routes (K1 and K2, whose wrappers run their plain twins for CPU
tensors) by forcing the route rule ``cut.stencil.kernel_route`` to the
card's answer.  Prints, for each run,
what the card phase holds it to:

- ``heat`` 2D float32: the solvers' routing and iterations, rows against
  the port's own float64 CPU run (gdm's CPU route) in the scaled measure
  max |m - g| / max g over L2, L1, Linf;
- ``wave-composite`` 2D float32, its first 13 rows (end_t = 0.2) against
  the float64 CPU run, both slots;
- ``step85`` 2D float32 with Jacobi CG and with MG: the row and L2;
- the 1D float32 runs (gdm's CPU route, as on the card) against the TPU's
  rows of tests/data/tpu_wave_goldens.json: heat-composite against
  heat_composite_0, wave-composite against wave_composite_0, heat-rk
  against heat_1.

Run from the repository root:  python3 scripts/torch_wave_family_rehearsal.py
(no card needed; about 5 minutes on one CPU core).
"""

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gdm_torch.cut import stencil  # noqa: E402
from gdm_torch.problems import wave  # noqa: E402

F32, F64 = torch.float32, torch.float64
GOLDENS = os.path.join(ROOT, "tests", "data", "tpu_wave_goldens.json")


@contextlib.contextmanager
def card_routes():
    """The card's 2D routes on CPU tensors (the kernels' plain twins)."""
    route = stencil.kernel_route
    stencil.kernel_route = lambda grid, device: grid.dim == 2
    try:
        yield
    finally:
        stencil.kernel_route = route


def scaled_dev(rows, ref):
    m = np.array([r[2:5] for r in rows])
    g = np.array([r[2:5] for r in ref])
    return float((np.abs(m - g) / g.max(axis=0)).max())


def run(name, dim, dtype, **changes):
    p = wave.make_preset(name, dim)
    for k, v in changes.items():
        setattr(p, k, v)
    prob = wave.WaveProblem(p, verbose=False, device="cpu", dtype=dtype)
    t0 = time.perf_counter()
    prob.run()
    return prob, time.perf_counter() - t0


def main():
    out = {}
    ref, _ = run("heat", 2, F64, print_solver_info=True)
    with card_routes():
        prob, s = run("heat", 2, F32, print_solver_info=True)
    routes = {dt: (v.path, v.probe) for dt, v in prob.heat_solvers.items()}
    dev = scaled_dev(prob.rows[0], ref.rows[0])
    print(f"heat 2D float32 (card route, twins) {s:.1f} s: routing "
          f"{routes}; solver rows {prob.solver_rows[0]}; rows against "
          f"float64 CPU: {dev:.3e}")
    out["heat_2d"] = dev

    ref, _ = run("wave-composite", 2, F64, end_t=0.2)
    with card_routes():
        prob, s = run("wave-composite", 2, F32, end_t=0.2)
    dev = max(scaled_dev(prob.rows[k], ref.rows[k]) for k in (0, 1))
    print(f"wave-composite 2D float32 (card route, twins), 13 rows, {s:.1f} "
          f"s: routing {prob._solver_meta}; rows against float64 CPU: "
          f"{dev:.3e}")
    out["wave_composite_2d"] = dev

    for solver in ("CG", "MG"):
        kw = {} if solver == "CG" else dict(solver_name="MG",
                                            solver_rel_tolerance=1e-12)
        with card_routes():
            prob, s = run("step85", 2, F32, **kw)
        print(f"step85 2D float32 {solver}: row {prob.rows[0][0]}, "
              f"{prob.poisson_info}, {s:.1f} s")
        out[f"step85_{solver}"] = prob.rows[0][0][2]

    with open(GOLDENS) as f:
        cases = json.load(f)["cases"]
    for name, case in (("heat-composite", "heat_composite_0"),
                       ("wave-composite", "wave_composite_0"),
                       ("heat-rk", "heat_1")):
        prob, s = run(name, 1, F32)
        golden = cases[case]
        slots = golden["rows"] if golden["n_slots"] == 2 else [golden["rows"]]
        dev = max(scaled_dev(prob.rows[k], slots[k])
                  for k in range(len(slots)))
        print(f"{name} 1D float32, {s:.1f} s: rows against {case}: {dev:.3e} "
              f"(the TPU's own deviation {golden['max_scaled_dev_vs_golden']:.3e})")
        out[case] = dev
    print(json.dumps(out))


if __name__ == "__main__":
    main()
