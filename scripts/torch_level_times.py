#!/usr/bin/env python3
"""K3 and K5 at the shapes the Poisson solves give them, on one CUDA card.

    python3 scripts/torch_level_times.py [--root DIR] [--sweep]

Times, with CUDA events (``device_ms``), the kernel gdm's dispatch picks
at every multigrid level shape of the 1024^2 (2D, K3) and 64^3 (3D, K5)
MG-CG solves, p = 3, float32, each in turns against another schedule
of its operator (chip_smoke.py's anchors: K3s in 2D; K4 in 3D, whose
band-sum design changed after K5's, so its times there moved while K5's
did not), with its
launches per CG phase and the
kernel's device time and share per CG phase (profiler); then the matvec
sizes: K3 at 1024^2 (p = 3, 5), 2048^2, 4096^2 in turns against K3s and
K3h, and K4 at 161^3, 257^3 and 511 x 65 x 65 (the shape gdm's dispatch
sends K4) in turns against K5, the unchanged 3D anchor.

``--root DIR`` imports ``gdm_torch`` from the checkout DIR instead of
this one (so one call can time two trees on one card, each in its own
process).  ``--sweep`` also times every launch plan of K3 and K5 that
``stencil2.k3_plans``/``stencil3.k5_plans`` list at each shape, through
the private ``_launch_plan`` hooks.
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    import gdm_torch
    from gdm_torch.grid import Grid
    from gdm_torch.ops import _build, stencil2, stencil3
    from gdm_torch.problems import poisson

    # chip_smoke's helpers, run against the gdm_torch imported above
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    print(f"card: {cs.card_line()}")
    print(f"gdm_torch from {os.path.dirname(gdm_torch.__file__)}")
    kl = _build.kernels()
    for line in kl.log.splitlines():
        if ("laplace2_kernel" in line or "laplace3_mxu_kernel" in line
                or "registers" in line or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    dev, f32 = torch.device("cuda"), torch.float32
    if hasattr(stencil3, "k5_occupancy"):
        for dt in (f32, torch.float64):
            print(f"K5 blocks per SM at p = 3, {dt}, 1/2/3 slots: "
                  f"{[stencil3.k5_occupancy(s, dt) for s in (1, 2, 3)]}")

    for dim, n in ((2, 1024), (3, 64)):
        grid = Grid(3, (n,) * dim, (0.0,) * dim, (1.0,) * dim)
        tag = f"{dim}D {n}^{dim}"
        sysf = poisson.system(grid, cs.sin_rhs, "mg", dev, f32)
        _, info = sysf.run(rel_tol=1e-3)
        busy, launches, items = cs.device_breakdown(
            lambda: sysf.run(rel_tol=1e-3), top=None)
        symbol = "laplace2_kernel<" if dim == 2 else "laplace3_mxu_kernel<"
        k_ms = sum(ms for name, ms, _ in items if symbol in name)
        k_n = sum(cnt for name, _, cnt in items if symbol in name)
        print(f"{tag}: {info['iterations']} iterations; device busy "
              f"{busy:.4f} ms per CG phase, {launches:.0f} launches; "
              f"{symbol[:-1]} {k_ms * 1e3:.1f} us x{k_n:.1f} "
              f"({k_ms / busy:.1%})")
        _, _, rows = cs.levels_vs_plain(sysf, dev, f32, tag)
        if args.sweep:
            for r in rows:
                sweep(cs, dim, tuple(r["nodes"]), dev, f32)

    rng = np.random.default_rng(0)
    for n, p in ((1024, 3), (1024, 5), (2048, 3), (4096, 3)):
        g = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(g, dev, f32)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=f32,
                            device=dev)
        print(f"{n}^2 p={p}:")
        for name, fn in (("K3s", stencil2.laplace2_stream_apply),
                         ("K3h", stencil2.laplace2_hybrid_apply)):
            cs.turns(name, lambda: fn(u, bt), "K3",
                     lambda: stencil2.laplace2_apply(u, bt))
        if args.sweep:
            sweep(cs, 2, g.nodes, dev, f32, p)
        del u, bt
    for cells in ((160,) * 3, (256,) * 3, (510, 64, 64)):
        g = Grid(3, cells, (0.0,) * 3, (1.0,) * 3)
        bt = stencil3.laplace3_bands(g, dev, f32)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=f32,
                            device=dev)
        print(f"{'x'.join(map(str, g.nodes))} p=3:")
        cs.turns("K5 (anchor)", lambda: stencil3.laplace3_mxu_apply(u, bt),
                 "K4", lambda: stencil3.laplace3_apply(u, bt))
        if args.sweep:
            sweep(cs, 3, g.nodes, dev, f32)
        del u, bt


def sweep(cs, dim, nodes, dev, dtype, p=3):
    """Every plan the module lists for ``nodes``, timed against the
    plan the wrapper picks, and held against the plain twin."""
    import numpy as np
    import torch

    from gdm_torch.grid import Grid
    from gdm_torch.ops import stencil2, stencil3

    mod = stencil2 if dim == 2 else stencil3
    cells = tuple(k - 1 for k in nodes)
    g = Grid(p, cells, (0.0,) * dim, (1.0,) * dim)
    if dim == 2:
        bt = stencil2.laplace2_bands(g, dev, dtype)
        plans, pick = stencil2.k3_plans(nodes, p, dtype), stencil2.k3_plan(
            nodes, p, dtype)
        plain = stencil2.laplace2_apply_plain
    else:
        bt = stencil3.laplace3_bands(g, dev, dtype)
        plans, pick = stencil3.k5_plans(nodes, p, dtype), stencil3.k5_plan(
            nodes, p, dtype)
        plain = stencil3.laplace3_mxu_apply_plain
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(nodes),
                        dtype=dtype, device=dev)
    yp = plain(u, bt)
    base = cs.device_ms(lambda: mod._launch_plan(u, bt, pick))
    for plan in plans:
        y = mod._launch_plan(u, bt, plan)
        torch.cuda.synchronize()
        rel = ((y - yp).abs().max() / yp.abs().max()).item()
        cs.check(rel <= 1e-5, f"plan {plan}: max error {rel:.3e}")
        ms = cs.device_ms(lambda: mod._launch_plan(u, bt, plan))
        mark = " (picked)" if plan == pick else ""
        print(f"    sweep {nodes}: {plan} {ms * 1e3:.2f} us "
              f"(picked plan {base * 1e3:.2f}){mark}")


if __name__ == "__main__":
    main()
