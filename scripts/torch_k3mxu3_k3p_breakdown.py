#!/usr/bin/env python3
"""Where K3/mxu3's and K3p's time goes, on one CUDA card.

    python3 scripts/torch_k3mxu3_k3p_breakdown.py [--root DIR] [--times-only]

K3/mxu3 (K3's bf16x3 row mode, csrc/laplace2_mxu.cu) and K3p (the
pipelined hybrid column stage, csrc/laplace2_hybp.cu) run through their
public wrappers at their default tiles at 1024^2 p = 3 and p = 5, 4096^2
p = 3 and 1024^2 p = 3 in float64 (node arrays one larger), each held
against K3's plain twin (1e-4 of max|y| for K3/mxu3's bf16x3 product, 1e-5
for K3p's 3xTF32, in float32; 1e-12 in float64) and timed in turns
against K3 (csrc/laplace2.cu: X, K3, K3, X); K3p also with vpu_rows = 0
(every column row on the tensor cores) and all on the FMA units.  The
anchors, each in turns against K3 at 1024^2 and 4096^2 p = 3: K3/mxu and
K3/mxu3p (which share the stage headers tc_stage.cuh, tc_rows.cuh and
wgmma.cuh, and K3/mxu K3/mxu3's kernel), K3f and K0 (tc_stage.cuh and
wgmma.cuh), K3c and K3h (tc_strip.cuh, which K3p shares).  Device times
by CUDA events (``device_ms``); a JSON line ``{"times": {...}}`` holds
them (µs).

Unless ``--times-only``, it compiles copies of laplace2_mxu.cu and
laplace2_hybp.cu with clock stamps into the gitignored gdm_torch/_build/
(``GDM_STAMP`` in common.cuh, empty in the kernels' own build; the
helpers are scripts/torch_k4_m1_breakdown.py's), runs each once in
float32 at 1024^2 and 4096^2, p = 3, with the wrapper's plan and tables,
and prints the span of the persistent blocks and each phase of a block,
summed over its units: K3/mxu3's set-up, waits for copies, column stage,
product, staging and stores; K3p's per warpgroup: the FMA warpgroup's
waits for the landed copies, FMA column rows, waits on "full" and row
stage; the tensor warpgroup's waits on "empty", copies issued, waits for
the landed copies, u split, products and V, W stores.

``--root DIR`` takes ``gdm_torch`` and the sources from the checkout DIR
(the parent's tree, unpacked into the gitignored .parent/), so one call
times two trees in turns on one card (parent, change, change, parent),
each in its own process; a tree whose kernels have no stamps or plans of
this design is timed only.  Build the parent's library in a step of its
own first: ``cd .parent && python -c "from gdm_torch.ops import _build;
_build.kernels()"``.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
import torch_k4_m1_breakdown as bd  # noqa: E402

# (name, first stamp, last stamp or None for a sum over the units)
MXU3_PHASES = [("set-up: zeroing, first copies", 1, 2),
               ("next copies issued (sum)", 12, None),
               ("band rows, offsets, waits for copies (sum)", 7, None),
               ("waits for the other warps (sum)", 3, None),
               ("column stage, V^T and W^T split and stored (sum)", 4, None),
               ("bf16x3 row product (sum)", 5, None),
               ("y staged (sum)", 6, None),
               ("stores, the next window issued (sum)", 8, None),
               ("every unit", 2, 9)]
K3P_PHASES = [("set-up: barriers", 1, 2),
              ("fma wg: waits for the landed copies (sum)", 3, None),
              ("fma wg: FMA column rows (sum)", 4, None),
              ("fma wg: waits on full (sum)", 5, None),
              ("fma wg: row stage and stores (sum)", 6, None),
              ("fma wg: every unit", 2, 9),
              ("tensor wg: waits on empty (sum)", 12, None),
              ("tensor wg: next copies issued (sum)", 13, None),
              ("tensor wg: offsets, waits for the landed copies (sum)", 7,
               None),
              ("tensor wg: u split (sum)", 8, None),
              ("tensor wg: products (sum)", 14, None),
              ("tensor wg: V, W stored (sum)", 15, None)]
END = 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--times-only", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import gdm_torch
    from gdm_torch.benchmarks.timing import device_ms, mean_ms
    from gdm_torch.grid import Grid
    from gdm_torch.ops import _build, stencil, stencil2, tc_tables

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
    new = "hybp" in getattr(tc_tables, "KERNELS", ())
    k3 = stencil2.laplace2_apply

    def turns(name_a, fa, name_b, fb):
        a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
        print(f"  in turns: {name_a} {a1 * 1e3:.2f}, {name_b} {b1 * 1e3:.2f},"
              f" {name_b} {b2 * 1e3:.2f}, {name_a} {a2 * 1e3:.2f} us")
        return mean_ms((a1, a2)), mean_ms((b1, b2))

    libs = {}
    if new and not args.times_only:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = {"K3/mxu3": pool.submit(bd.stamped_library, root,
                                           "laplace2_mxu"),
                    "K3p": pool.submit(bd.stamped_library, root,
                                       "laplace2_hybp")}
            libs = {k: j.result() for k, j in jobs.items()}
    hybp = stencil2.laplace2_hybp_apply
    # name: (tables kernel, wrapper, float32 limit, vpu_rows or None)
    kernels = {"K3/mxu3": ("mxu3", stencil2.laplace2_mxu3_apply, 1e-4, None),
               "K3p": ("hybp", hybp, 1e-5, None),
               "K3p vpu_rows=0": (None, hybp, 1e-5, 0),
               "K3p all FMA": (None, hybp, 1e-5, 10**6)}
    anchors = {"K3/mxu (anchor)": (stencil2.laplace2_mxu_apply, 1e-5),
               "K3/mxu3p (anchor)": (stencil2.laplace2_mxu3p_apply, 1e-4),
               "K3f (anchor)": (stencil2.laplace2_fullmxu_apply, 1e-5),
               "K0 (anchor)": (stencil.laplace_v1_apply, 1e-5),
               "K3c (anchor)": (stencil2.laplace2_mxucol_apply, 1e-5),
               "K3h (anchor)": (stencil2.laplace2_hybrid_apply, 1e-5)}
    for n, p, dt in ((1024, 3, torch.float32), (1024, 5, torch.float32),
                     (4096, 3, torch.float32), (1024, 3, torch.float64)):
        g = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(g, dev, dt)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=dt,
                            device=dev)
        yp = stencil2.laplace2_apply_plain(u, bt)
        case = f"{n + 1}^2 p={p} {str(dt)[6:]}"
        runs = {k: v for k, v in kernels.items()
                if v[3] is None or (p == 3 and dt == torch.float32)}
        if dt == torch.float32 and p == 3:
            runs.update({k: (None, f, tol, None)
                         for k, (f, tol) in anchors.items()})
        for name, (kern, fn, tol32, vr) in runs.items():
            tol = tol32 if dt == torch.float32 else 1e-12

            def call(fn=fn, vr=vr):
                return fn(u, bt) if vr is None else fn(u, bt, vpu_rows=vr)

            y = call()
            torch.cuda.synchronize()
            rel = ((y - yp).abs().max() / yp.abs().max()).item()
            assert rel <= tol, (name, case, rel)
            k_ms, a_ms = turns(name, call, "K3", lambda: k3(u, bt))
            times[f"{name} {case}"] = k_ms * 1e3
            times[f"K3 beside {name} {case}"] = a_ms * 1e3
            plan = ""
            if new and kern is not None:
                opts = stencil2.tc_options(kern, bt)
                pl = stencil2.tc_plan(kern, bt.shape, p, dt, opts["tile_r"])
                plan = (f"; {opts}, {len(pl.row_units)} row units x "
                        f"{pl.n_cb} blocks of {pl.cols} columns = {pl.units} "
                        f"units on {pl.blocks} blocks, {pl.smem} B of shared "
                        f"memory")
            print(f"{name} {case}: {k_ms * 1e3:.2f} us (max error "
                  f"{rel:.2e} of max|y|), K3 {a_ms * 1e3:.2f} us{plan}")
            lib = libs.get(name)
            if lib is not None and dt == torch.float32 and p == 3:
                stamped_run(lib, kern, bt, u, yp, tol, p, g, clock, k_ms,
                            f"{name} {case}", np)
        del u, bt, yp
    print(json.dumps({"times": times, "root": root}))


def stamped_run(lib, kern, bt, u, yp, tol, p, g, clock, k_ms, what, np):
    """The stamped copy of ``kern`` on the wrapper's plan and tables."""
    import torch

    from gdm_torch.ops import stencil2, tc_tables

    opts = stencil2.tc_options(kern, bt)
    tile = opts["tile_r"]
    pl = stencil2.tc_plan(kern, bt.shape, p, u.dtype, tile)
    tab = tc_tables.tables(bt, kern, tile)
    yk = torch.empty_like(u)
    P, I = ctypes.c_void_p, ctypes.c_int

    def check():
        e = ((yk - yp).abs().max() / yp.abs().max()).item()
        assert e <= tol, ("stamped", kern, e)

    if kern == "hybp":
        tabs = (bt.a1, bt.b1, tab["ct"], tab["rb"])
        fn, argtypes = "gdm_laplace2_hybp_apply_f32", [P] * 6 + [I] * 8 + [P]
        ints = [p, *g.nodes, tile, opts["vpu_rows"], len(pl.row_units),
                pl.segs, pl.blocks]
        phases = K3P_PHASES
    else:
        tabs = (bt.a1, bt.b1, tab["win"], tab["ru"])
        fn, argtypes = "gdm_laplace2_mxu3_apply_f32", [P] * 6 + [I] * 7 + [P]
        ints = [p, *g.nodes, tc_tables.TRB, pl.cols, len(pl.row_units),
                pl.blocks]
        phases = MXU3_PHASES
    bd.run_stamped(
        lib, fn, argtypes,
        [u.data_ptr(), *(t.data_ptr() for t in tabs), yk.data_ptr(), *ints],
        check, phases, END, clock, f"{what} stamped ({pl.blocks} blocks)",
        k_ms)
    st = np.zeros(bd.NB * bd.NS, np.int64)
    lib.gdm_stamps_read(st.ctypes.data)
    st = st.reshape(bd.NB, bd.NS)[:pl.blocks]
    print(f"  units a block: {st[:, 11].min()}-{st[:, 11].max()}")


if __name__ == "__main__":
    main()
