#!/usr/bin/env python3
"""The cut multigrid's CG sweep on the card: step85 at 64^2 ... 512^2.

For each size, the system of gdm's tests/test_cut_multigrid.py (the
step85 cut stiffness with interface Nitsche, ghost penalty 0.5, Nitsche
15, right-hand side 4 and interface value 1) is solved by CG to rel
1e-8, preconditioned by the port's CutMultigrid (gdm_torch.cut.multigrid)
in float64 on the card, every operator and level band applied by K1.
Prints, per size: the CG iterations against gdm's documented
[6, 8, 26, 12] (BASELINE.md's round-5 sweep, the comment in
tests/test_cut_multigrid.py; live gdm under x64 on a CPU takes 14 at
256^2, as the port does there), the host
setup time (geometry, operators, Galerkin hierarchy, Schwarz blocks),
the levels and their band radii, the time of one V-cycle (CUDA events,
median of 20) and its device launches (profiler), and the solve's time.

Run from the repository root on a machine with a card:
    python3 scripts/torch_cut_mg_sweep.py [--sizes 64 128 256 512]
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# gdm's documented counts (BASELINE.md round 5); live gdm under x64
# takes 14 at 256^2 (the knife edge of the coarse Chebyshev intervals)
GDM_ITERS = {64: 6, 128: 8, 256: 26, 512: 12}


def vcycle_ms(fn, n=20):
    import torch

    fn()
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_launches(fn):
    """Device kernels of one call of fn (profiler), and their busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in items),
            sum(e.self_device_time_total for e in items) / 1e3)


def main():
    import torch

    from gdm_torch import solvers
    from gdm_torch.cut.geometry import INSIDE, CutGeometry
    from gdm_torch.cut.multigrid import cut_poisson_multigrid
    from gdm_torch.cut.operators import CutOperators
    from gdm_torch.cut.stencil import assemble_stencil, routed_apply
    from gdm_torch.grid import Grid
    from gdm_torch.ops import cutband
    from gdm_torch.problems.wave import sphere_signed_distance as ls

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[64, 128, 256, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_cut_mg_sweep.py: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    dev, f64 = torch.device("cuda"), torch.float64
    rows = []
    for n in args.sizes:
        t0 = time.perf_counter()
        grid = Grid(3, (n, n), (-1.21, -1.21), (1.21, 1.21))
        op = CutOperators(CutGeometry.build(grid, ls, 3), INSIDE)
        t_geo = time.perf_counter() - t0
        st = assemble_stencil(op, "stiff", 0.5, 15.0, with_nitsche=True)
        mg = cut_poisson_multigrid(op, 0.5, 15.0, ls, level_set_degree=3,
                                   device=dev, dtype=f64)
        setup = time.perf_counter() - t0
        b = op.compute_rhs(
            torch.zeros(grid.n_nodes, dtype=f64, device=dev), 0.0, False,
            rhs_fn=lambda pts, t: np.full(pts.shape[:-1], 4.0),
            interface_dbc=lambda pts, t: np.full(pts.shape[:-1], 1.0),
            nitsche_gamma=15.0)
        apply = routed_apply(st)
        solvers.cg(apply, b, precond=mg.precondition, max_iter=2,
                   rel_tol=1e-8)            # builds K1 and its tables
        torch.cuda.synchronize()
        cutband.band_apply.launches = 0
        t0 = time.perf_counter()
        x, info = solvers.cg(apply, b, precond=mg.precondition,
                             max_iter=400, rel_tol=1e-8)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        k1 = cutband.band_apply.launches
        rel = ((apply(x) - b).norm() / b.norm()).item()
        r = torch.as_tensor(np.random.default_rng(0).standard_normal(
            grid.n_nodes), dtype=f64, device=dev)
        ms = vcycle_ms(lambda: mg.precondition(r))
        launches, busy = device_launches(lambda: mg.precondition(r))
        levels = [(lv["grid"].nodes[0], lv["band"].radius)
                  for lv in mg.levels]
        row = {"n": n, "iterations": info["iterations"],
               "gdm_iterations": GDM_ITERS.get(n), "relres": rel,
               "setup_s": setup, "geometry_s": t_geo,
               "levels (nodes, radius)": levels, "vcycle_ms": ms,
               "vcycle_device_launches": launches,
               "vcycle_device_busy_ms": busy, "solve_s": solve_s,
               "k1_launches_per_solve": k1}
        rows.append(row)
        print(row, flush=True)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
