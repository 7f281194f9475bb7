#!/usr/bin/env python3
"""Where K3/mxu's and K3/mxu3p's time goes, on one CUDA card.

    python3 scripts/torch_k3mxu_breakdown.py [--root DIR] [--times-only]

K3/mxu (csrc/laplace2_mxu.cu) and K3/mxu3p (csrc/laplace2_mxu3p.cu), K3's
tensor-core row modes, run through their public wrappers at their default
tiles at 1024^2 p = 3 and p = 5, 4096^2 p = 3 and 1024^2 p = 3 in float64
(node arrays one larger), each held against K3's plain twin (1e-5 of
max|y| for K3/mxu, 1e-4 for K3/mxu3p's bf16x3 product, in float32; 1e-12
in float64) and timed in turns against K3 (csrc/laplace2.cu: X, K3, K3,
X); K3/mxu3 (K3/mxu's kernel with a bf16x3 product, csrc/laplace2_mxu.cu)
in turns against K3 as an anchor; K3f and K0 (csrc/laplace2_fullmxu.cu, csrc/laplace2_v1.cu,
which share the stage headers tc_stage.cuh and wgmma.cuh) at 1024^2 and
4096^2 p = 3 in turns against K3.  The split cut apply
(cut.fastapply.make_fast_cut_apply, K3/mxu3p its separable part) on the
flagship disc at 128^2 and 512^2: its separable part alone, and the whole
apply in turns against K1's flat apply of the same band, by events and
per call with the launch.  Device times by CUDA events (``device_ms``);
a JSON line ``{"times": {...}}`` holds them (µs).

Unless ``--times-only``, it compiles copies of laplace2_mxu.cu and
laplace2_mxu3p.cu with clock stamps into the gitignored gdm_torch/_build/
(``GDM_STAMP`` in common.cuh, empty in the kernels' own build; the
helpers are scripts/torch_k4_m1_breakdown.py's), runs each once in
float32 at 1024^2 and 4096^2, p = 3, with the wrapper's plan and tables
and prints the span of the persistent blocks and each phase of a block,
summed over its units (2-3 a block at 1025^2, 31-32 at 4097^2): K3/mxu's
set-up, waits for copies, column stage, product, staging and stores;
K3/mxu3p's per warpgroup: warpgroup 0's waits for copies and on "empty",
its column stage; warpgroup 1's window loads, waits on "full", products
and epilogue.

``--root DIR`` takes ``gdm_torch`` and the sources from the checkout DIR
(the parent's tree, unpacked into the gitignored .parent/), so one call
times two trees in turns on one card (parent, change, change, parent),
each in its own process; a tree without stamps or window tables for these
kernels is timed only.  Build the parent's library in a step of its own
first: ``cd .parent && python -c "from gdm_torch.ops import _build;
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
MXU_PHASES = [("set-up: zeroing, first copies", 1, 2),
              ("next copies issued (sum)", 12, None),
              ("band rows, offsets, waits for copies (sum)", 7, None),
              ("waits for the other warps (sum)", 3, None),
              ("column stage, V^T and W^T split and stored (sum)", 4, None),
              ("row product (sum)", 5, None),
              ("y staged (sum)", 6, None),
              ("stores, the next window issued (sum)", 8, None),
              ("every unit", 2, 9)]
MXU3P_PHASES = [("set-up: zeroing, barriers", 1, 2),
                ("wg0: waits for copies (sum)", 3, None),
                ("wg0: band rows, waits on empty (sum)", 4, None),
                ("wg0: column stage, bf16 split and stores (sum)", 5, None),
                ("wg0: every unit", 2, 9),
                ("wg1: window loads (sum)", 12, None),
                ("wg1: waits on full (sum)", 6, None),
                ("wg1: bf16x3 product (sum)", 7, None),
                ("wg1: staging and stores (sum)", 8, None),
                ("wg1: every unit", 2, 13)]
END = 10

# K3/mxu3p's float64 entry launches K3/mxu's kernel, which its stamped
# copy, built alone, does not hold: the stamped run is float32 only
MXU3P_F64_STUB = """
extern "C" int gdm_laplace2_mxu_apply_f64(const void*, const void*,
    const void*, const void*, const void*, void*, int, int, int, int, int,
    int, int, void*) { return 1; }
extern "C" int gdm_laplace2_mxu_occupancy(int, int, int, int*) { return 1; }
"""


def stamped(root, name, extra=""):
    """bd.stamped_library of ``name``.cu, with ``extra`` appended."""
    if not extra:
        return bd.stamped_library(root, name)
    src = os.path.join(root, "gdm_torch/csrc", name + ".cu")
    if "GDM_STAMP" not in open(src).read():
        return None
    from gdm_torch.ops import _build

    tag = f"{name}_stamped_x"
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"{tag}.cu")
    with open(cu, "w") as fh:
        fh.write(bd.PRELUDE + open(src).read() + bd.READER + extra)
    so = os.path.join(_build.BUILD_DIR, f"lib{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-I", os.path.join(root, "gdm_torch/csrc"), "-o",
                           so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Used" in line or "spill" in line or "C75" in line:
            print(f"  ptxas ({tag}): {line.strip()[:160]}")
    lib = ctypes.CDLL(so)
    lib.gdm_stamps_read.argtypes = [ctypes.c_void_p]
    return lib


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
    from gdm_torch.benchmarks.timing import call_ms, device_ms, mean_ms
    from gdm_torch.cut import fastapply
    from gdm_torch.entry import flagship_operators
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
    new = "mxu" in getattr(tc_tables, "COLS", {})
    k3 = stencil2.laplace2_apply

    def turns(name_a, fa, name_b, fb):
        a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
        print(f"  in turns: {name_a} {a1 * 1e3:.2f}, {name_b} {b1 * 1e3:.2f},"
              f" {name_b} {b2 * 1e3:.2f}, {name_a} {a2 * 1e3:.2f} us")
        return mean_ms((a1, a2)), mean_ms((b1, b2))

    libs = {}
    if new and not args.times_only:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = {"K3/mxu": pool.submit(stamped, root, "laplace2_mxu"),
                    "K3/mxu3p": pool.submit(stamped, root, "laplace2_mxu3p",
                                            MXU3P_F64_STUB)}
            libs = {k: j.result() for k, j in jobs.items()}
    kernels = {"K3/mxu": ("mxu", stencil2.laplace2_mxu_apply, 1e-5),
               "K3/mxu3p": ("mxu3p", stencil2.laplace2_mxu3p_apply, 1e-4),
               "K3/mxu3 (anchor)": (None, stencil2.laplace2_mxu3_apply,
                                    1e-4)}
    stage_kernels = {"K3f": stencil2.laplace2_fullmxu_apply,
                     "K0": stencil.laplace_v1_apply}
    for n, p, dt in ((1024, 3, torch.float32), (1024, 5, torch.float32),
                     (4096, 3, torch.float32), (1024, 3, torch.float64)):
        g = Grid(p, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(g, dev, dt)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=dt,
                            device=dev)
        yp = stencil2.laplace2_apply_plain(u, bt)
        case = f"{n + 1}^2 p={p} {str(dt)[6:]}"
        runs = dict(kernels)
        if dt == torch.float32 and p == 3:
            runs.update({k: (None, f, 1e-5) for k, f in stage_kernels.items()})
        for name, (kern, fn, tol32) in runs.items():
            tol = tol32 if dt == torch.float32 else 1e-12
            y = fn(u, bt)
            torch.cuda.synchronize()
            rel = ((y - yp).abs().max() / yp.abs().max()).item()
            assert rel <= tol, (name, case, rel)
            k_ms, a_ms = turns(name, lambda: fn(u, bt), "K3",
                               lambda: k3(u, bt))
            times[f"{name} {case}"] = k_ms * 1e3
            times[f"K3 (anchor) beside {name} {case}"] = a_ms * 1e3
            plan = ""
            if new and kern is not None:
                tile = stencil2.tc_options(kern, bt)["tile_r"]
                pl = stencil2.tc_plan(kern, bt.shape, p, dt, tile)
                plan = (f"; tile {tile}, {len(pl.row_units)} row units x "
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

    # the split cut apply on the flagship disc: its separable part on
    # K3/mxu3p, the whole apply against K1's flat apply of the same band
    for n in (128, 512):
        grid, op, mass, stiff = flagship_operators(n)
        for kind, st in (("mass", mass), ("stiff", stiff)):
            split = fastapply.make_fast_cut_apply(
                st, op, fastapply.kron_pairs(grid, kind),
                inactive_identity=kind == "mass", device=dev)
            k1 = fastapply.fast_stencil_apply(st, device=dev)
            u = torch.as_tensor(rng.standard_normal(grid.n_nodes),
                                dtype=torch.float32, device=dev)
            y, yk1 = split(u), k1(u)
            torch.cuda.synchronize()
            rel = ((y - yk1).abs().max() / yk1.abs().max()).item()
            assert rel <= 1e-4, ("split", n, kind, rel)
            u2 = u.reshape(grid.nodes)
            sep = split.separable
            s_ms = device_ms(lambda: sep(u2))
            k_ms, x_ms = turns("K1", lambda: k1(u), "split", lambda: split(u))
            ck1, cs = call_ms(lambda: k1(u)), call_ms(lambda: split(u))
            key = f"split {kind} {n}^2"
            times[f"{key} separable part"] = s_ms * 1e3
            times[f"{key} apply"] = x_ms * 1e3
            times[f"K1 beside {key}"] = k_ms * 1e3
            times[f"{key} per call"] = cs * 1e3
            times[f"K1 per call beside {key}"] = ck1 * 1e3
            print(f"{key}: separable part (K3/mxu3p) {s_ms * 1e3:.2f} us; "
                  f"the apply {x_ms * 1e3:.2f} us against K1 "
                  f"{k_ms * 1e3:.2f} ({x_ms / k_ms:.2f}x); per call "
                  f"{cs * 1e3:.2f} us against K1 {ck1 * 1e3:.2f}")
    print(json.dumps({"times": times, "root": root}))


def stamped_run(lib, kern, bt, u, yp, tol, p, g, clock, k_ms, what, np):
    """The stamped copy of ``kern`` on the wrapper's plan and tables."""
    import torch

    from gdm_torch.ops import stencil2, tc_tables

    tile = stencil2.tc_options(kern, bt)["tile_r"]
    pl = stencil2.tc_plan(kern, bt.shape, p, u.dtype, tile)
    tab = tc_tables.tables(bt, kern, tile)
    yk = torch.empty_like(u)
    P, I = ctypes.c_void_p, ctypes.c_int

    def check():
        e = ((yk - yp).abs().max() / yp.abs().max()).item()
        assert e <= tol, ("stamped", kern, e)

    tabs = (bt.a1, bt.b1, tab["win"], tab["ru"])
    bd.run_stamped(
        lib, f"gdm_laplace2_{kern}_apply_f32", [P] * 6 + [I] * 7 + [P],
        [u.data_ptr(), *(t.data_ptr() for t in tabs), yk.data_ptr(), p,
         *g.nodes, tc_tables.TRB, pl.cols, len(pl.row_units), pl.blocks],
        check, MXU_PHASES if kern == "mxu" else MXU3P_PHASES, END, clock,
        f"{what} stamped ({pl.blocks} blocks)", k_ms)
    st = np.zeros(bd.NB * bd.NS, np.int64)
    lib.gdm_stamps_read(st.ctypes.data)
    st = st.reshape(bd.NB, bd.NS)[:pl.blocks]
    print(f"  units a block: {st[:, 11].min()}-{st[:, 11].max()}")


if __name__ == "__main__":
    main()
