#!/usr/bin/env python3
"""Where K1's and K3s's time goes, on one CUDA card.

    python3 scripts/torch_k1_k3s_breakdown.py [--root DIR] [--times-only]
                                              [--sweep]

K1 (the band apply, csrc/cutband.cu) runs on the flagship cut disc at
128^2 and 512^2 (float32, the mass and the stiffness band, 77 taps);
K3s (the streamed 2D Laplace, csrc/laplace2_stream.cu) at 1025^2,
2049^2 and 4097^2 nodes (p = 3, float32).  For each the script prints
the kernel's device time by CUDA events (``device_ms``) and a JSON line
``{"times": {...}}`` with them (µs), and, unless ``--times-only``, where
a block's time goes: it compiles a copy of the source with clock stamps
into the gitignored gdm_torch/_build/ (``GDM_STAMP`` in common.cuh is
empty in the kernels' own build), runs the copy once on the same inputs
and prints the span from the first block's start to the last block's end
(%globaltimer), the spread of the block starts, and each phase's median
and largest time over the blocks (clock64 at the card's maximum SM
clock).

``--sweep`` also times every launch plan that ``cutband.k1_plans`` and
``stencil2.k3s_plans`` list at each shape (the redesigned kernels only),
through the private ``_launch_plan`` hooks.  ``--root DIR`` takes
``gdm_torch`` and the sources from the checkout DIR, so one call can time
two trees in turns on one card (parent, change, change, parent), each in
its own process.  A source without ``GDM_STAMP``
(the kernels before their Hopper redesign) is stamped by the patches
below.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = 8192   # blocks stamped (block index mod NB)
NS = 16     # stamps a block

PRELUDE = """
__device__ long long g_stamp[%d * %d];
__device__ __forceinline__ long long gdm_gtimer() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define GDM_BLOCK_STAMPS \\
  (g_stamp + ((blockIdx.x + gridDim.x * blockIdx.y) %% %d) * %d)
#define GDM_STAMP(cond, slot, value) \\
  do { if (cond) GDM_BLOCK_STAMPS[slot] = (value); } while (0)
#define GDM_STAMP_ADD(cond, slot, value) \\
  do { if (cond) GDM_BLOCK_STAMPS[slot] += (value); } while (0)
#define GDM_CLOCK() clock64()
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

# the kernels before the redesign: stamps of each block's thread 0
OLD_K1 = [
    ("  const int col0 = blockIdx.x * TILE_X - r;\n",
     "  const int col0 = blockIdx.x * TILE_X - r;\n"
     "  GDM_STAMP(tid == 0, 0, gdm_gtimer());\n"
     "  GDM_STAMP(tid == 0, 1, clock64());\n"),
    ("  __syncthreads();\n",
     "  __syncthreads();\n  GDM_STAMP(tid == 0, 2, clock64());\n"),
    ("  y[idx] = acc;\n",
     "  GDM_STAMP(tid == 0, 3, clock64());\n  y[idx] = acc;\n"
     "  GDM_STAMP(tid == 0, 4, clock64());\n"
     "  GDM_STAMP(tid == 0, 5, gdm_gtimer());\n"),
]
OLD_K1_PHASES = [("u tile and tap offsets to shared memory, barrier", 1, 2),
                 ("the taps (one thread, all 77)", 2, 3),
                 ("the store", 3, 4)]
OLD_K1_END = 5

OLD_K3S = [
    ("  const int n_loads = n_tiles + 1;\n",
     "  const int n_loads = n_tiles + 1;\n"
     "  GDM_STAMP(tid == 0, 0, gdm_gtimer());\n"
     "  GDM_STAMP(tid == 0, 1, clock64());\n"),
    ("  const int j = j0 + tx;\n  for (int k = 0; k < n_loads; ++k) {\n",
     "  const int j = j0 + tx;\n  GDM_STAMP(tid == 0, 2, clock64());\n"
     "  long long gdm_prev = clock64();\n"
     "  for (int k = 0; k < n_loads; ++k) {\n"
     "    const long long gdm_c0 = clock64();\n"
     "    GDM_STAMP_ADD(tid == 0, 7, gdm_c0 - gdm_prev);\n"),
    ("    __syncthreads();\n    if (k + NS - 1 < n_loads) issue(k + NS - 1);\n"
     "    gdm::commit_group();\n",
     "    __syncthreads();\n    const long long gdm_c1 = clock64();\n"
     "    GDM_STAMP_ADD(tid == 0, 3, gdm_c1 - gdm_c0);\n"
     "    if (k + NS - 1 < n_loads) issue(k + NS - 1);\n"
     "    gdm::commit_group();\n    const long long gdm_c2 = clock64();\n"
     "    GDM_STAMP_ADD(tid == 0, 4, gdm_c2 - gdm_c1);\n"),
    ("    __syncthreads();\n    if (k == 0 || j >= n1) continue;\n",
     "    const long long gdm_c3 = clock64();\n"
     "    GDM_STAMP_ADD(tid == 0, 5, gdm_c3 - gdm_c2);\n"
     "    __syncthreads();\n    gdm_prev = clock64();\n"
     "    GDM_STAMP_ADD(tid == 0, 6, gdm_prev - gdm_c3);\n"
     "    if (k == 0 || j >= n1) continue;\n"),
    ("  gdm::wait_group<0>();\n}",
     "  GDM_STAMP_ADD(tid == 0, 7, clock64() - gdm_prev);\n"
     "  GDM_STAMP(tid == 0, 8, clock64());\n"
     "  GDM_STAMP(tid == 0, 9, gdm_gtimer());\n"
     "  GDM_STAMP(tid == 0, 10, n_loads);\n"
     "  gdm::wait_group<0>();\n}"),
]
OLD_K3S_PHASES = [("prologue: first two loads issued, A1/B1 columns", 1, 2),
                  ("wait for the tile's copies + barrier (sum)", 3, None),
                  ("issue the next tile's copies (sum)", 4, None),
                  ("column stage (sum)", 5, None),
                  ("barrier after the column stage (sum)", 6, None),
                  ("row stage and stores (sum)", 7, None)]
OLD_K3S_END = 9

# the redesigned kernels carry their own GDM_STAMP calls
NEW_K1_PHASES = [("plane loads and the first u loads issued", 1, 2),
                 ("u tile stored, tap offsets, barrier", 2, 3),
                 ("the group's taps (thread 0)", 3, 4),
                 ("partial sums, barrier, the groups' sum", 4, 5),
                 ("the store", 5, 6)]
NEW_K1_END = 7
NEW_K3S_PHASES = [("consumer: A1/B1 to registers, band rows moved", 1, 2),
                  ("consumer: waits for full slots (sum)", 3, None),
                  ("consumer: every row, waits included", 2, 4),
                  ("producer: waits for free slots (sum)", 10, None),
                  ("producer: every copy issued", 9, 11)]
NEW_K3S_END = 5


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def stamped_library(root, name, patches):
    """Build ``name``.cu of the tree ``root`` with clock stamps into a
    shared library of its own; returns (ctypes library, stamped by
    patches)."""
    from gdm_torch.ops import _build

    src = open(os.path.join(root, "gdm_torch/csrc", name + ".cu")).read()
    old = "GDM_STAMP" not in src
    if old:
        for a, b in patches:
            assert src.count(a) == 1, (name, a, src.count(a))
            src = src.replace(a, b)
    src = PRELUDE + src + READER
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, f"{name}_stamped.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    so = os.path.join(_build.BUILD_DIR, f"lib{name}_stamped.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_build._nvcc(), *flags, "-shared", "-I",
                           os.path.join(root, "gdm_torch/csrc"), "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.gdm_stamps_read.argtypes = [ctypes.c_void_p]
    return lib, old


def report(lib, blocks, phases, end, clock, what, ms, ms_stamped):
    import numpy as np

    st = np.zeros(NB * NS, np.int64)
    lib.gdm_stamps_read(st.ctypes.data)
    st = st.reshape(NB, NS)[:min(blocks, NB)]
    t0 = st[:, 0].min()
    print(f"{what}: {ms * 1e3:.2f} us by events (the stamped copy "
          f"{ms_stamped * 1e3:.2f}); {blocks} blocks, {len(st)} stamped: "
          f"first start to last end {(st[:, end].max() - t0) / 1e3:.2f} us, "
          f"starts spread over {(st[:, 0].max() - t0) / 1e3:.2f} us, a "
          f"block's span median {np.median(st[:, end] - st[:, 0]) / 1e3:.2f}"
          f" us, max {(st[:, end] - st[:, 0]).max() / 1e3:.2f} us")
    for name, a, b in phases:
        d = st[:, a] if b is None else st[:, b] - st[:, a]
        print(f"  {name:52s} median {np.median(d) / clock * 1e6:8.3f} us, "
              f"max {d.max() / clock * 1e6:8.3f} us")


def sweep(plans, pick, launch, y_plain, what):
    """Every plan of ``plans`` through ``launch``, held against the
    plain twin's ``y_plain`` (1e-5 of max|y|) and timed by events."""
    import torch

    from gdm_torch.benchmarks.timing import device_ms

    for plan in plans:
        y = launch(plan)
        torch.cuda.synchronize()
        rel = ((y - y_plain).abs().max() / y_plain.abs().max()).item()
        assert rel <= 1e-5, (plan, rel)
        ms = device_ms(lambda: launch(plan))
        mark = " (picked)" if plan == pick else ""
        print(f"  sweep {what}: {plan} {ms * 1e3:.2f} us{mark}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import gdm_torch
    from gdm_torch.benchmarks.timing import device_ms
    from gdm_torch.entry import flagship_operators
    from gdm_torch.grid import Grid
    from gdm_torch.ops import cutband, stencil2

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    print(f"card: {card_line()}")
    print(f"gdm_torch from {os.path.dirname(gdm_torch.__file__)}")
    dev, f32 = torch.device("cuda"), torch.float32
    stream = torch.cuda.current_stream().cuda_stream
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]) * 1e6
    times = {}
    k1 = k3s = None
    if not args.times_only:
        k1 = stamped_library(root, "cutband", OLD_K1)
        k3s = stamped_library(root, "laplace2_stream", OLD_K3S)
    P, I = ctypes.c_void_p, ctypes.c_int
    rng = np.random.default_rng(0)

    for n in (128, 512):
        t0 = time.perf_counter()
        grid, _, mass, stiff = flagship_operators(n)
        print(f"host setup at {n}^2: {time.perf_counter() - t0:.1f} s")
        layout = cutband.layout_for(grid, max(mass.radius, stiff.radius))
        for name, st in (("mass", mass), ("stiffness", stiff)):
            bp = cutband.band_planes(st, layout, dev, f32)
            u = layout.pad(torch.as_tensor(
                rng.standard_normal(grid.n_nodes), dtype=f32, device=dev))
            what = f"K1 {n}^2 {name} ({len(bp.taps)} taps, layout " \
                   f"{layout.rows} x {layout.pitch})"
            ms = device_ms(lambda: cutband.band_apply(u, bp))
            times[f"K1 {n}^2 {name}"] = ms * 1e3
            if args.sweep:
                lay = layout
                sweep(cutband.k1_plans(lay.rows, lay.pitch, len(bp.taps),
                                       f32, lay.r),
                      cutband.k1_plan(lay.rows, lay.pitch, len(bp.taps),
                                      f32, lay.r),
                      lambda pl: cutband._launch_plan(u, bp, pl),
                      cutband.band_apply_plain(u, bp), what)
            if k1 is None:
                print(f"{what}: {ms * 1e3:.2f} us by events")
                continue
            lib, old = k1
            fn = lib.gdm_cutband_apply_f32
            y = torch.empty_like(u)
            base = [u.data_ptr(), bp.planes.data_ptr(),
                    bp.offsets.data_ptr(), y.data_ptr(), len(bp.taps),
                    layout.rows, layout.pitch, layout.n0, layout.n1,
                    layout.r]
            if old:
                extra, blocks = [], (-(-layout.pitch // 32) *
                                     -(-layout.rows // 8))
                phases, end = OLD_K1_PHASES, OLD_K1_END
            else:
                plan = cutband.k1_plan(layout.rows, layout.pitch,
                                       len(bp.taps), f32, layout.r)
                extra, blocks = list(plan.args), plan.blocks
                phases, end = NEW_K1_PHASES, NEW_K1_END
            fn.argtypes = [P, P, P, P] + [I] * (6 + len(extra)) + [P]

            def run():
                err = fn(*base, *extra, stream)
                assert err == 0, err

            run()
            torch.cuda.synchronize()
            assert torch.equal(y, cutband.band_apply(u, bp)), \
                "the stamped copy disagrees with K1"
            ms_st = device_ms(run)
            lib.gdm_stamps_clear()
            run()
            torch.cuda.synchronize()
            report(lib, blocks, phases, end, clock, what, ms, ms_st)

    for n in (1024, 2048, 4096):
        g = Grid(3, (n, n), (0.0, 0.0), (1.0, 1.0))
        bt = stencil2.laplace2_bands(g, dev, f32)
        u = torch.as_tensor(rng.standard_normal(g.nodes), dtype=f32,
                            device=dev)
        what = f"K3s {n + 1}^2 p=3"
        ms = device_ms(lambda: stencil2.laplace2_stream_apply(u, bt))
        times[what] = ms * 1e3
        if args.sweep:
            sweep(stencil2.k3s_plans(g.nodes, 3, f32),
                  stencil2.k3s_plan(g.nodes, 3, f32),
                  lambda pl: stencil2._launch_plan(u, bt, pl),
                  stencil2.laplace2_stream_apply_plain(u, bt), what)
        if k3s is None:
            print(f"{what}: {ms * 1e3:.2f} us by events")
            continue
        lib, old = k3s
        fn = lib.gdm_laplace2_stream_apply_f32
        y = torch.empty_like(u)
        base = [u.data_ptr(), bt.a0.data_ptr(), bt.a1.data_ptr(),
                bt.b0.data_ptr(), bt.b1.data_ptr(), y.data_ptr(), 3, *g.nodes]
        if old:
            extra = []
            phases, end = OLD_K3S_PHASES, OLD_K3S_END
        else:
            plan = stencil2.k3s_plan(g.nodes, 3, f32)
            extra = list(plan.args)
            phases, end = NEW_K3S_PHASES, NEW_K3S_END
        fn.argtypes = [P] * 6 + [I] * (3 + len(extra)) + [P]

        def run():
            err = fn(*base, *extra, stream)
            assert err == 0, err

        run()
        torch.cuda.synchronize()
        assert torch.equal(y, stencil2.laplace2_stream_apply(u, bt)), \
            "the stamped copy disagrees with K3s"
        ms_st = device_ms(run)
        lib.gdm_stamps_clear()
        run()
        torch.cuda.synchronize()
        st = np.zeros(NB * NS, np.int64)
        lib.gdm_stamps_read(st.ctypes.data)
        blocks = int((st.reshape(NB, NS)[:, 0] > 0).sum())
        report(lib, blocks, phases, end, clock, what, ms, ms_st)
        del u, y, bt
    print(json.dumps({"times": times, "root": root}))


if __name__ == "__main__":
    main()
