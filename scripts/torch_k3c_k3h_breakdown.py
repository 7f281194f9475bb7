#!/usr/bin/env python3
"""Where K3c's and K3h's time goes, on one CUDA card.

    python3 scripts/torch_k3c_k3h_breakdown.py [--root DIR] [--times-only]
                                               [--tiles]

K3c (the column stage on the tensor cores, pipelined across the tiles of
a strip, csrc/laplace2_mxucol.cu) and K3h (the column stage split by rows
between the FMA units and the tensor cores, csrc/laplace2_hybrid.cu) run
through their public wrappers at their default tiles at 1024^2 p = 3 and
p = 5, 4096^2 p = 3 and 1024^2 p = 3 in float64 (node arrays one
larger), each held against K3's plain twin (1e-5 of max|y| in float32,
1e-12 in float64) and timed in turns against K3 (csrc/laplace2.cu: X,
K3, K3, X); K3h also with vpu_rows = 0 (every column row on the tensor
cores) and all on the FMA units.  The anchors, each in turns against K3
at 1024^2 and 4096^2 p = 3: K3s, K3f, K0, K3/mxu, K3/mxu3, K3/mxu3p and
K3p (K3p shares tc_strip.cuh with K3c and K3h, the others the stage
headers tc_stage.cuh, tc_rows.cuh, tc_window.cuh and wgmma.cuh).  Device
times by CUDA events (``device_ms``); a JSON line ``{"times": {...}}``
holds them (µs).  ``--tiles`` also times K3c and K3h at tiles of 32, 48,
58 (58 + 2p = 64 extended rows at p = 3: one product chain a tile), 64
and 122 (two whole chains) rows, in turns against K3.

Unless ``--times-only``, it compiles copies of laplace2_mxucol.cu and
laplace2_hybrid.cu with clock stamps into the gitignored gdm_torch/_build/
(``GDM_STAMP`` in common.cuh, empty in the kernels' own build; the
helpers are scripts/torch_k4_m1_breakdown.py's), runs each once in
float32 at 1024^2 and 4096^2, p = 3, with the wrapper's plan and tables,
and prints the span of the persistent blocks and each phase of a block,
summed over its units, per warpgroup: K3c's FMA warpgroup's waits on
"full" and row stage, its tensor warpgroup's waits on "empty", waits for
the landed copies, copies issued, A loads and splits, products and V, W
stores; K3h's FMA warpgroup's waits for the copies, FMA column rows,
waits at the column barrier and row stage, its tensor warpgroup's waits,
copies, A loads, products, stores and its share of the row stage.

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
K3C_PHASES = [("set-up: barriers", 1, 2),
              ("fma wg: waits on full (sum)", 5, None),
              ("fma wg: row stage and stores (sum)", 6, None),
              ("fma wg: every unit", 2, 9),
              ("tensor wg: waits on empty (sum)", 12, None),
              ("tensor wg: offsets, waits for the landed copies (sum)", 7,
               None),
              ("tensor wg: next copies issued (sum)", 13, None),
              ("tensor wg: A loads and splits (sum)", 8, None),
              ("tensor wg: products (sum)", 15, None),
              ("tensor wg: V, W stored (sum)", 14, None)]
K3H_PHASES = [("set-up: barriers", 1, 2),
              ("fma wg: offsets, waits for the landed copies (sum)", 3,
               None),
              ("fma wg: FMA column rows (sum)", 4, None),
              ("fma wg: waits at the column barrier (sum)", 5, None),
              ("fma wg: row stage, stores, end barrier (sum)", 6, None),
              ("every unit", 2, 9),
              ("tensor wg: offsets, waits for the landed copies (sum)", 7,
               None),
              ("tensor wg: next copies issued (sum)", 13, None),
              ("tensor wg: A loads and splits (sum)", 8, None),
              ("tensor wg: products (sum)", 15, None),
              ("tensor wg: V, W stored (sum)", 14, None),
              ("tensor wg: column barrier, row stage, end barrier (sum)", 12,
               None)]
END = 10
TILES = (32, 48, 58, 64, 122)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--tiles", action="store_true")
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
    new = "mxucol" in getattr(tc_tables, "KERNELS", ())
    k3 = stencil2.laplace2_apply

    def turns(name_a, fa, name_b, fb):
        a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
        print(f"  in turns: {name_a} {a1 * 1e3:.2f}, {name_b} {b1 * 1e3:.2f},"
              f" {name_b} {b2 * 1e3:.2f}, {name_a} {a2 * 1e3:.2f} us")
        return mean_ms((a1, a2)), mean_ms((b1, b2))

    libs = {}
    if new and not args.times_only:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = {"K3c": pool.submit(bd.stamped_library, root,
                                       "laplace2_mxucol"),
                    "K3h": pool.submit(bd.stamped_library, root,
                                       "laplace2_hybrid")}
            libs = {k: j.result() for k, j in jobs.items()}
    hybrid = stencil2.laplace2_hybrid_apply
    # name: (tables kernel, wrapper, keywords)
    kernels = {"K3c": ("mxucol", stencil2.laplace2_mxucol_apply, {}),
               "K3h": ("hybrid", hybrid, {}),
               "K3h vpu_rows=0": ("hybrid", hybrid, {"vpu_rows": 0}),
               "K3h all FMA": ("hybrid", hybrid, {"vpu_rows": 10**6})}
    anchors = {"K3s (anchor)": stencil2.laplace2_stream_apply,
               "K3f (anchor)": stencil2.laplace2_fullmxu_apply,
               "K0 (anchor)": stencil.laplace_v1_apply,
               "K3/mxu (anchor)": stencil2.laplace2_mxu_apply,
               "K3/mxu3 (anchor)": stencil2.laplace2_mxu3_apply,
               "K3/mxu3p (anchor)": stencil2.laplace2_mxu3p_apply,
               "K3p (anchor)": stencil2.laplace2_hybp_apply}
    tol32 = {"K3/mxu3 (anchor)": 1e-4, "K3/mxu3p (anchor)": 1e-4}
    for n, p, dt in ((1024, 3, torch.float32), (1024, 5, torch.float32),
                     (4096, 3, torch.float32), (1024, 3, torch.float64)):
        g = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(g, dev, dt)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=dt,
                            device=dev)
        yp = stencil2.laplace2_apply_plain(u, bt)
        case = f"{n + 1}^2 p={p} {str(dt)[6:]}"
        main_case = p == 3 and dt == torch.float32
        runs = {k: (kern, fn, kw) for k, (kern, fn, kw) in kernels.items()
                if not kw or main_case}
        if main_case:
            runs.update({k: (None, f, {}) for k, f in anchors.items()})
        if args.tiles and main_case:
            runs.update({f"{k} tile {t}": (None, fn, {"tile_r": t})
                         for k, fn in (("K3c", kernels["K3c"][1]),
                                       ("K3h", hybrid)) for t in TILES})
        for name, (kern, fn, kw) in runs.items():
            tol = tol32.get(name, 1e-5) if dt == torch.float32 else 1e-12

            def call(fn=fn, kw=kw):
                return fn(u, bt, **kw)

            try:
                y = call()
            except ValueError as e:   # a tile that does not fit a block
                print(f"{name} {case}: refused ({e})")
                continue
            torch.cuda.synchronize()
            rel = ((y - yp).abs().max() / yp.abs().max()).item()
            assert rel <= tol, (name, case, rel)
            k_ms, a_ms = turns(name, call, "K3", lambda: k3(u, bt))
            times[f"{name} {case}"] = k_ms * 1e3
            times[f"K3 beside {name} {case}"] = a_ms * 1e3
            plan = ""
            if new and kern is not None:
                opts = stencil2.tc_options(kern, bt, **kw)
                pl = stencil2.tc_plan(kern, bt.shape, p, dt, opts["tile_r"])
                plan = (f"; {opts}, {len(pl.row_units)} tiles x {pl.n_cb} "
                        f"strips in runs of {pl.segs} a strip on "
                        f"{pl.blocks} blocks, {pl.smem} B of shared memory")
            print(f"{name} {case}: {k_ms * 1e3:.2f} us (max error "
                  f"{rel:.2e} of max|y|), K3 {a_ms * 1e3:.2f} us{plan}")
            lib = libs.get(name.split()[0])
            if lib is not None and main_case and kern is not None and (
                    not kw or n == 1024):
                stamped_run(lib, kern, kw, bt, u, yp, tol, p, g, clock, k_ms,
                            f"{name} {case}", np)
        del u, bt, yp
    print(json.dumps({"times": times, "root": root}))


def stamped_run(lib, kern, kw, bt, u, yp, tol, p, g, clock, k_ms, what, np):
    """The stamped copy of ``kern`` on the wrapper's plan and tables."""
    import torch

    from gdm_torch.ops import stencil2, tc_tables

    opts = stencil2.tc_options(kern, bt, **kw)
    tile = opts["tile_r"]
    pl = stencil2.tc_plan(kern, bt.shape, p, u.dtype, tile)
    tab = tc_tables.tables(bt, kern, tile)
    yk = torch.empty_like(u)
    P, I = ctypes.c_void_p, ctypes.c_int

    def check():
        e = ((yk - yp).abs().max() / yp.abs().max()).item()
        assert e <= tol, ("stamped", kern, e)

    tail = [len(pl.row_units), pl.segs, pl.blocks]
    if kern == "hybrid":
        tabs = (bt.a1, bt.b1, tab["ct"], tab["rb"])
        fn, argtypes = "gdm_laplace2_hybrid_apply_f32", [P] * 6 + [I] * 8 + [P]
        ints = [p, *g.nodes, tile, opts["vpu_rows"], *tail]
        phases = K3H_PHASES
    else:
        tabs = (tab["ct"], tab["rb"])
        fn, argtypes = "gdm_laplace2_mxucol_apply_f32", [P] * 4 + [I] * 7 + [P]
        ints = [p, *g.nodes, tile, *tail]
        phases = K3C_PHASES
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
