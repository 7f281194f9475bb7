#!/usr/bin/env python3
"""Where K3f's and K0's time goes, on one CUDA card.

    python3 scripts/torch_k3f_k0_breakdown.py [--root DIR] [--times-only]

K3f (csrc/laplace2_fullmxu.cu) and K0 (csrc/laplace2_v1.cu) run through
their public wrappers at their default tiles at 1024^2 p = 3 and p = 5,
4096^2 p = 3 and 1024^2 p = 3 in float64, each held against K3's plain
twin (1e-5 of max|y| in float32, 1e-12 in float64) and timed in turns
against K3 (csrc/laplace2.cu, an anchor that this tree does not change:
X, K3, K3, X); M1's "rowsonly" (csrc/micro_stage1.cu, whose wgmma helpers
moved to csrc/wgmma.cuh) at gdm's 1024^2, tile_r 256, in turns against
K3/mxu3.  Device times by CUDA events (``device_ms``); a JSON line
``{"times": {...}}`` holds them (µs).

Unless ``--times-only``, it compiles copies of laplace2_fullmxu.cu and
laplace2_v1.cu with clock stamps into the gitignored gdm_torch/_build/
(the helpers are scripts/torch_k4_m1_breakdown.py's), runs each once in
float32 at 1024^2 p = 3 with the wrapper's plan and tables and prints the
span of the persistent blocks and each phase of a block (set-up, waits
for copies, the u split, the products, the accumulators' way out, the
epilogue), summed over its units.

``--root DIR`` takes ``gdm_torch`` and the sources from the checkout DIR
(the parent's tree, unpacked into the gitignored .parent/), so one call
times two trees in turns on one card (parent, change, change, parent),
each in its own process; a tree without stamps is timed only.
"""

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
import torch_k4_m1_breakdown as bd  # noqa: E402

# (name, first stamp, last stamp or None for a sum over the units)
K3F_PHASES = [("set-up: first unit's copies, split, column product issued",
               1, 2),
              ("waits for copies (sum)", 3, None),
              ("u split into hi and lo, beside the row product (sum)", 4,
               None),
              ("column product: its wait after the epilogue (sum)", 5, None),
              ("V and W split and stored (sum)", 6, None),
              ("row product: its wait after the split (sum)", 7, None),
              ("epilogue: y stored, beside the column product (sum)", 8,
               None),
              ("every unit", 2, 9)]
K0_PHASES = [("set-up: first unit's copies, split, row product issued",
              1, 2),
             ("waits for copies (sum)", 3, None),
             ("u split, transposed, beside the row product (sum)", 4, None),
             ("row product: its wait after the split (sum)", 5, None),
             ("ts and tm stored (sum)", 6, None),
             ("column stage and y stores, beside the next row product (sum)",
              7, None),
             ("every unit", 2, 9)]
END = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--times-only", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import subprocess
    import torch

    import gdm_torch
    from gdm_torch.benchmarks import mxu_micro
    from gdm_torch.benchmarks.timing import device_ms, mean_ms
    from gdm_torch.grid import Grid
    from gdm_torch.ops import _build, stencil, stencil2

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    print(f"card: {bd.card_line()}")
    print(f"gdm_torch from {os.path.dirname(gdm_torch.__file__)}")
    # the tree's kernels are built before any timing: device_ms sets its
    # spin from a warm-up, which a build inside it would stretch to minutes
    kl = _build.kernels()
    print(f"kernel build {kl.build_seconds:.1f} s: {kl.path}")
    dev = torch.device("cuda")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]) * 1e6
    rng = np.random.default_rng(0)
    times = {}
    new = hasattr(stencil2, "tc_plan")
    kernels = {"K3f": stencil2.laplace2_fullmxu_apply,
               "K0": stencil.laplace_v1_apply}

    def turns(name_a, fa, name_b, fb):
        a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
        print(f"  in turns: {name_a} {a1 * 1e3:.2f}, {name_b} {b1 * 1e3:.2f},"
              f" {name_b} {b2 * 1e3:.2f}, {name_a} {a2 * 1e3:.2f} us")
        return mean_ms((a1, a2)), mean_ms((b1, b2))

    libs = {}
    if not args.times_only:
        libs = {"K3f": bd.stamped_library(root, "laplace2_fullmxu"),
                "K0": bd.stamped_library(root, "laplace2_v1")}
    for n, p, dt in ((1024, 3, torch.float32), (1024, 5, torch.float32),
                     (4096, 3, torch.float32), (1024, 3, torch.float64)):
        g = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(g, dev, dt)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=dt,
                            device=dev)
        yp = stencil2.laplace2_apply_plain(u, bt)
        tol = 1e-5 if dt == torch.float32 else 1e-12
        case = f"{n + 1}^2 p={p} {str(dt)[6:]}"
        for name, fn in kernels.items():
            y = fn(u, bt)
            torch.cuda.synchronize()
            rel = ((y - yp).abs().max() / yp.abs().max()).item()
            assert rel <= tol, (name, case, rel)
            k_ms, a_ms = turns(name, lambda: fn(u, bt), "K3",
                               lambda: stencil2.laplace2_apply(u, bt))
            times[f"{name} {case}"] = k_ms * 1e3
            times[f"K3 (anchor) beside {name} {case}"] = a_ms * 1e3
            plan = ""
            if new:
                kern = "fullmxu" if name == "K3f" else "v1"
                tile = stencil2.tc_options(kern, bt)["tile_r"]
                pl = stencil2.tc_plan(kern, bt.shape, p, dt, tile)
                plan = (f"; tile {tile}, {len(pl.row_units)} row units, "
                        f"{pl.units} units on {pl.blocks} blocks, "
                        f"{pl.smem} B of shared memory")
            print(f"{name} {case}: {k_ms * 1e3:.2f} us (max error "
                  f"{rel:.2e} of max|y|), K3 {a_ms * 1e3:.2f} us{plan}")
            lib = libs.get(name)
            if lib is not None and new and dt == torch.float32 and (
                    (n, p) == (1024, 3)):
                from gdm_torch.ops import tc_tables

                kern = "fullmxu" if name == "K3f" else "v1"
                tile = stencil2.tc_options(kern, bt)["tile_r"]
                pl = stencil2.tc_plan(kern, bt.shape, p, dt, tile)
                tab = tc_tables.tables(bt, kern, tile)
                yk = torch.empty_like(u)
                P, I = ctypes.c_void_p, ctypes.c_int

                def check():
                    e = ((yk - yp).abs().max() / yp.abs().max()).item()
                    assert e <= tol, ("stamped", name, e)

                tabs = ((tab["win"], tab["ct"], tab["ru"]) if kern == "fullmxu"
                        else (bt.a1, bt.b1, tab["win"], tab["ru"]))
                bd.run_stamped(
                    lib, f"gdm_laplace2_{kern}_apply_f32",
                    [P] * (len(tabs) + 2) + [I] * 6 + [P],
                    [u.data_ptr(), *(t.data_ptr() for t in tabs),
                     yk.data_ptr(), p, *g.nodes, tc_tables.TRB,
                     len(pl.row_units), pl.blocks],
                    check,
                    K3F_PHASES if name == "K3f" else K0_PHASES, END, clock,
                    f"{name} {case} stamped ({pl.blocks} blocks)", k_ms)
                st = np.zeros(bd.NB * bd.NS, np.int64)
                lib.gdm_stamps_read(st.ctypes.data)
                st = st.reshape(bd.NB, bd.NS)[:pl.blocks]
                print(f"  units a block: {st[:, 11].min()}-{st[:, 11].max()}")
        del u, bt, yp

    grid = Grid(3, (1024, 1024), (0.0, 0.0), (1.0, 1.0))
    bt2 = stencil2.laplace2_bands(grid, dev, torch.float32)
    u2 = torch.as_tensor(rng.standard_normal(grid.nodes),
                         dtype=torch.float32, device=dev)
    mxu3 = stencil2.make_padded_laplace2(grid, torch.float32,
                                         rows="mxu3", device=dev)[0]
    apply, shape = mxu_micro.make_stage1_micro(grid, "rowsonly", device=dev)
    u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev)
    yp = mxu_micro.stage1_micro_plain(u, *apply.tables, "rowsonly",
                                      apply.geom)
    y = apply(u)
    torch.cuda.synchronize()
    err = ((y - yp).abs().max() / yp.abs().max()).item()
    assert err <= 1e-5, err
    m1_ms, a_ms = turns("M1", lambda: apply(u), "K3/mxu3", lambda: mxu3(u2))
    times["M1 rowsonly 1024^2 p=3 tile_r 256"] = m1_ms * 1e3
    times["K3/mxu3 (anchor) beside M1"] = a_ms * 1e3
    print(f"M1 rowsonly 1024^2 p=3 tile_r 256: {m1_ms * 1e3:.2f} us (max "
          f"error {err:.2e} of max|y|), K3/mxu3 {a_ms * 1e3:.2f} us")
    del bt2
    print(json.dumps({"times": times, "root": root}))


if __name__ == "__main__":
    main()
