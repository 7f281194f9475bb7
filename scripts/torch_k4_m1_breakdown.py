#!/usr/bin/env python3
"""Where K4's and M1's row-mode time goes, on one CUDA card.

    python3 scripts/torch_k4_m1_breakdown.py [--root DIR] [--times-only]
                                             [--sweep] [--rows R ...]

K4 (the 3D band-sum Laplace, csrc/laplace3.cu) runs at 161^3, 257^3 and
511 x 65 x 65 nodes (p = 3, float32; the last is the shape gdm's dispatch
sends K4, 510 x 64 x 64 cells), at 161^3 also for p = 5 and in float64,
each in turns against K5 (csrc/laplace3_mxu.cu, the same operator,
unchanged in this tree's redesign of K4: K4, K5, K5, K4); M1's row modes
("rowsonly", "dotsonly", csrc/micro_stage1.cu) at gdm's 1024^2, p = 3,
tile_r 256, in turns against K3/mxu3 at 1024^2 p = 3 (the bf16x3 row
product inside K3: M1, K3/mxu3, K3/mxu3, M1).  Device times by
CUDA events (``device_ms``); a JSON line ``{"times": {...}}`` holds them
(µs).

Unless ``--times-only``, it compiles copies of laplace3.cu and
micro_stage1.cu with clock stamps into the gitignored gdm_torch/_build/
(``GDM_STAMP`` in common.cuh is empty in the kernels' own build), runs
each copy once on the same inputs and prints the span from the first
block's start to the last block's end (%globaltimer), the spread of the
block starts, and each phase's median and largest time over the blocks
(clock64 at the card's maximum SM clock).  ``--rows R`` (repeatable)
also builds and stamps a K4 copy whose threads own R rows each (its
k4_rows patched), the design choice the plan does not sweep, launched
with the default plan's chunk.  The host cost of M1's row modes is
printed too: its C entry's host time a call beside the same entry's in
"splitsonly" (a launch and no tensor maps): the difference is the three
tensor-map encodes it makes on every call.

``--sweep`` also times every launch plan that ``stencil3.k4_plans`` and
``mxu_micro.stage1_row_plans`` list at each shape, through the private
``_launch_plan`` and ``_launch_row_plan`` hooks.  ``--root DIR`` takes
``gdm_torch`` and the sources from the checkout DIR (the parent's tree,
unpacked into the gitignored .parent/), so one call times two trees in
turns on one card (parent, change, change, parent), each in its own
process; sources without stamps (the kernels before this redesign) are
timed only.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = 16384   # blocks stamped (linear block index mod NB)
NS = 16      # stamps a block

PRELUDE = """
__device__ long long g_stamp[%d * %d];
__device__ __forceinline__ long long gdm_gtimer() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define GDM_BLOCK_STAMPS \\
  (g_stamp + ((blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * \\
                blockIdx.z)) %% %d) * %d)
#define GDM_STAMP(cond, slot, value) \\
  do { if (cond) GDM_BLOCK_STAMPS[slot] = (value); } while (0)
#define GDM_STAMP_ADD(cond, slot, value) \\
  do { if (cond) GDM_BLOCK_STAMPS[slot] += (value); } while (0)
#define GDM_CLOCK() clock64()
__device__ __forceinline__ unsigned gdm_smid() {
  unsigned r;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(r));
  return r;
}
""" % (NB, NS, NB, NS)

READER = """
extern "C" int gdm_stamps_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamp,
                                               sizeof(g_stamp)));
}
extern "C" int gdm_stamps_clear() {
  static long long zero[%d * %d];
  return static_cast<int>(cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero)));
}
""" % (NB, NS)

# (name, first stamp, last stamp or None for a sum), the block's end stamp
K4_PHASES = [("consumer: M2/S2 taps, band rows, plane coupling", 1, 2),
             ("consumer: waits for full slots (sum)", 3, None),
             ("consumer: every plane, waits included", 2, 4),
             ("producer: waits for free slots (sum)", 10, None),
             ("producer: every copy issued", 9, 11)]
K4_END = 5
M1_PHASES = [("the panels' first chunk ready (u loads, split)", 1, 2),
             ("waits for panel chunks and table stages (sum)", 3, None),
             ("the products, waits included", 2, 5),
             ("epilogue: staged, stored", 5, 6),
             ("splitters: every u row split", 1, 8)]
M1_END = 7


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


# laplace3.cu's k4_rows, patched for --rows
K4_ROWS_LINE = ("  return sizeof(T) == 4 ? (P == 1 ? 8 : P <= 5 ? 4 : 2) : "
                "(P == 1 ? 4 : 2);")


def stamped_library(root, name, rows=None):
    """Build ``name``.cu of the tree ``root`` with clock stamps (and, for
    K4, ``rows`` rows a thread) into a shared library of its own; None
    for a source without stamps."""
    from gdm_torch.ops import _build

    src = open(os.path.join(root, "gdm_torch/csrc", name + ".cu")).read()
    if "GDM_STAMP" not in src:
        return None
    if rows is not None:
        assert src.count(K4_ROWS_LINE) == 1, "k4_rows changed"
        src = src.replace(K4_ROWS_LINE, f"  return {rows};")
    tag = f"{name}_stamped" + ("" if rows is None else f"_rows{rows}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"{tag}.cu")
    with open(cu, "w") as fh:
        fh.write(PRELUDE + src + READER)
    so = os.path.join(_build.BUILD_DIR, f"lib{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                           os.path.join(root, "gdm_torch/csrc"), "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and i + 3 < len(lines):
            used = [x.strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            print(f"  ptxas ({tag}): {line.split('for')[0][-70:]} "
                  f"{' | '.join(used)}")
        if "Performance" in line:
            print(f"  ptxas ({tag}): {line.strip()[:200]}")
    injected = sum("C7519" in x for x in lines)
    if injected:
        print(f"  ptxas ({tag}): {injected} notes C7519 (warpgroup.arrive "
              f"injected around wgmma)")
    lib = ctypes.CDLL(so)
    lib.gdm_stamps_read.argtypes = [ctypes.c_void_p]
    return lib


def m1_host_us(u, tables, mode, g, rounds=7):
    """Host µs a call of M1's C entry takes in ``mode`` and in
    "splitsonly" (one launch, no tensor maps), each the median of
    ``rounds`` rounds of 200 calls queued before one sync (host clocks
    of a shared machine vary).  The difference is what the row modes
    add on the host: the three tensor maps encoded on every call
    (micro_stage1.cu's launch_rows_plan) and the row plan."""
    import statistics

    import torch

    from gdm_torch.benchmarks import mxu_micro
    from gdm_torch.ops import _build

    lib = _build.kernels().lib
    y = torch.empty_like(u)
    stream = torch.cuda.current_stream().cuda_stream

    def entry_us(m):
        args = (u.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(),
                y.data_ptr(), mxu_micro.MODES.index(m), g.p, g.h, g.tile_r,
                g.n_tiles, g.w2, stream)
        assert lib.gdm_micro_stage1_f32(*args) == 0
        us = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                lib.gdm_micro_stage1_f32(*args)
            us.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
        return statistics.median(us)

    return entry_us(mode), entry_us("splitsonly")


def report(lib, phases, end, clock, what, ms, ms_stamped):
    import numpy as np

    st = np.zeros(NB * NS, np.int64)
    lib.gdm_stamps_read(st.ctypes.data)
    st = st.reshape(NB, NS)
    st = st[st[:, 0] > 0]
    t0 = st[:, 0].min()
    print(f"{what}: {ms * 1e3:.2f} us by events (the stamped copy "
          f"{ms_stamped * 1e3:.2f}); {len(st)} blocks stamped: first start "
          f"to last end {(st[:, end].max() - t0) / 1e3:.2f} us, starts "
          f"spread over {(st[:, 0].max() - t0) / 1e3:.2f} us, a block's "
          f"span median {np.median(st[:, end] - st[:, 0]) / 1e3:.2f} us, "
          f"max {(st[:, end] - st[:, 0]).max() / 1e3:.2f} us")
    for name, a, b in phases:
        d = st[:, a] if b is None else st[:, b] - st[:, a]
        print(f"  {name:52s} median {np.median(d) / clock * 1e6:8.3f} us, "
              f"max {d.max() / clock * 1e6:8.3f} us")


def run_stamped(lib, fn_name, argtypes, args, check, phases, end, clock,
                what, ms):
    """Run the stamped copy's C entry once on ``args`` (or on what the
    callable ``args`` returns at each call), check its output
    (``check()``), time it and print its stamps."""
    import torch

    from gdm_torch.benchmarks.timing import device_ms

    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*(args() if callable(args) else args), stream)
        assert err == 0, (fn_name, err)

    run()
    torch.cuda.synchronize()
    check()
    ms_st = device_ms(run)
    lib.gdm_stamps_clear()
    run()
    torch.cuda.synchronize()
    report(lib, phases, end, clock, what, ms, ms_st)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rows", action="append", type=int, default=[])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import gdm_torch
    from gdm_torch.benchmarks import mxu_micro
    from gdm_torch.benchmarks.timing import device_ms, mean_ms
    from gdm_torch.grid import Grid
    from gdm_torch.ops import stencil2, stencil3

    from gdm_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    print(f"card: {card_line()}")
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
    P, I = ctypes.c_void_p, ctypes.c_int
    rng = np.random.default_rng(0)
    times = {}

    def turns(name_a, fa, name_b, fb):
        a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
        print(f"  in turns: {name_a} {a1 * 1e3:.2f}, {name_b} {b1 * 1e3:.2f},"
              f" {name_b} {b2 * 1e3:.2f}, {name_a} {a2 * 1e3:.2f} us")
        return mean_ms((a1, a2)), mean_ms((b1, b2))

    k4_libs = {}
    if not args.times_only:
        k4_libs[None] = stamped_library(root, "laplace3")
        for r in args.rows:
            k4_libs[r] = stamped_library(root, "laplace3", r)
    new_k4 = hasattr(stencil3, "k4_plan")
    for cells, p, dt in (((160,) * 3, 3, torch.float32),
                         ((256,) * 3, 3, torch.float32),
                         ((510, 64, 64), 3, torch.float32),
                         ((160,) * 3, 5, torch.float32),
                         ((160,) * 3, 3, torch.float64)):
        g = Grid(p, cells, (0.0,) * 3, (1.0,) * 3)
        bt = stencil3.laplace3_bands(g, dev, dt)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=dt,
                            device=dev)
        what = (f"K4 {'x'.join(map(str, g.nodes))} p={p} "
                f"{str(dt)[6:]}")
        k4_ms, k5_ms = turns("K4", lambda: stencil3.laplace3_apply(u, bt),
                             "K5", lambda: stencil3.laplace3_mxu_apply(u, bt))
        times[what] = k4_ms * 1e3
        times[what.replace("K4", "K5 (anchor)")] = k5_ms * 1e3
        yp = stencil3.laplace3_apply_plain(u, bt)
        if new_k4:
            plan = stencil3.k4_plan(g.nodes, p, dt)
            print(f"{what}: {k4_ms * 1e3:.2f} us, K5 {k5_ms * 1e3:.2f} us; "
                  f"plan {plan}, {plan.blocks} blocks, stages 1-2 on "
                  f"{plan.recompute:.3f} planes an output plane")
        else:
            print(f"{what}: {k4_ms * 1e3:.2f} us, K5 {k5_ms * 1e3:.2f} us")
        if args.sweep and new_k4:
            for pl in stencil3.k4_plans(g.nodes, p, dt):
                y = stencil3._launch_plan(u, bt, pl)
                torch.cuda.synchronize()
                rel = ((y - yp).abs().max() / yp.abs().max()).item()
                assert rel <= (1e-5 if dt == torch.float32 else 1e-12), pl
                ms = device_ms(lambda: stencil3._launch_plan(u, bt, pl))
                mark = " (picked)" if pl == plan else ""
                print(f"  sweep {what}: {pl} {ms * 1e3:.2f} us{mark}")
        for rows, lib in k4_libs.items():
            if lib is None or not new_k4:
                continue
            y = torch.empty_like(u)
            plan = stencil3.k4_plan(g.nodes, p, dt)
            if rows is not None:   # the default chunk at `rows` rows
                key = (p, dt == torch.float64)
                saved, stencil3.K4_ROWS[key] = stencil3.K4_ROWS[key], rows
                plan = stencil3._k4_plan(g.nodes, p, u.element_size(),
                                         plan.chunk)
                stencil3.K4_ROWS[key] = saved
            sfx = "f64" if dt == torch.float64 else "f32"
            tables = [t.data_ptr() for t in (bt.s[0], bt.m[0], bt.s[1],
                                             bt.m[1], bt.s[2], bt.m[2])]
            tol = 1e-5 if dt == torch.float32 else 1e-12

            def check():
                rel = ((y - yp).abs().max() / yp.abs().max()).item()
                assert rel <= tol, ("stamped K4", rows, rel)

            run_stamped(lib, f"gdm_laplace3_apply_{sfx}",
                        [P] * 8 + [I] * 9 + [P],
                        [u.data_ptr(), *tables, y.data_ptr(), p, *g.nodes,
                         plan.strips, *plan.grid, plan.smem], check,
                        K4_PHASES, K4_END, clock,
                        f"{what} stamped"
                        + ("" if rows is None else f", {rows} rows a thread"),
                        k4_ms)
        del u, bt, yp

    m1_lib = None if args.times_only else stamped_library(root,
                                                          "micro_stage1")
    grid = Grid(3, (1024, 1024), (0.0, 0.0), (1.0, 1.0))
    bt2 = stencil2.laplace2_bands(grid, dev, torch.float32)
    u2 = torch.as_tensor(rng.standard_normal(grid.nodes),
                         dtype=torch.float32, device=dev)
    mxu3 = stencil2.make_padded_laplace2(grid, torch.float32,
                                         rows="mxu3", device=dev)[0]
    for mode in ("rowsonly", "dotsonly"):
        apply, shape = mxu_micro.make_stage1_micro(grid, mode, device=dev)
        g = apply.geom
        u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)
        yp = mxu_micro.stage1_micro_plain(u, *apply.tables, mode, g)
        y = apply(u)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item() / yp.abs().max().item()
        assert err <= 1e-5, (mode, err)
        what = f"M1 {mode} 1024^2 p=3 tile_r {g.tile_r}"
        m1_ms, a_ms = turns("M1", lambda: apply(u), "K3/mxu3",
                            lambda: mxu3(u2))
        times[what] = m1_ms * 1e3
        times[what.replace("M1", "K3/mxu3 (anchor) beside M1")] = a_ms * 1e3
        flops = 3 * 2 * g.rp * 2 * g.t_ext * g.w2
        plan = (mxu_micro.stage1_row_plan(g, mode)
                if hasattr(mxu_micro, "stage1_row_plan") else None)
        print(f"{what}: {m1_ms * 1e3:.2f} us ({flops / m1_ms / 1e9:.0f} "
              f"TFLOP/s; max error {err:.2e} of max|y|), K3/mxu3 "
              f"{a_ms * 1e3:.2f} us; plan {plan}")
        if plan is not None:
            entry_us, split_us = m1_host_us(u, apply.tables, mode, g)
            times[f"{what} host: the C entry a call"] = entry_us
            times[f"{what} host: the C entry a call, splitsonly"] = split_us
            print(f"{what}: host, the C entry {entry_us:.2f} us a call "
                  f"(three tensor maps encoded, a launch), {split_us:.2f} "
                  f"us in \"splitsonly\" (a launch, no maps): "
                  f"{entry_us - split_us:.2f} us for the maps and plan")
        if args.sweep and plan is not None:
            for pl in mxu_micro.stage1_row_plans(g, mode):
                yk = mxu_micro._launch_row_plan(u, *apply.tables, mode, g, pl)
                torch.cuda.synchronize()
                e = (yk - yp).abs().max().item() / yp.abs().max().item()
                assert e <= 1e-5, (pl, e)
                ms = device_ms(lambda: mxu_micro._launch_row_plan(
                    u, *apply.tables, mode, g, pl))
                mark = " (picked)" if pl == plan else ""
                print(f"  sweep {what}: {pl} {ms * 1e3:.2f} us{mark}")
        if m1_lib is not None:
            yk = torch.empty_like(u)

            def check():
                e = (yk - yp).abs().max().item() / yp.abs().max().item()
                assert e <= 1e-5, ("stamped M1", e)

            run_stamped(m1_lib, "gdm_micro_stage1_f32", [P] * 4 + [I] * 6
                        + [P], [u.data_ptr(), apply.tables[0].data_ptr(),
                                apply.tables[1].data_ptr(), yk.data_ptr(),
                                mxu_micro.MODES.index(mode), g.p, g.h,
                                g.tile_r, g.n_tiles, g.w2], check,
                        M1_PHASES, M1_END, clock, f"{what} stamped", m1_ms)
        del u, y, yp
    print(json.dumps({"times": times, "root": root}))


if __name__ == "__main__":
    main()
