#!/usr/bin/env python3
"""Where M2's and M3's time goes, on one CUDA card.

    python3 scripts/torch_m2_m3_breakdown.py [--root DIR] [--times-only]
                                             [--sweep]

M2 (gdm's relayout micro, csrc/micro_relayout.cu) runs at gdm's (512, 128)
with 4096 steps in float32 and bf16, padded and unpadded, each in turns
against ``x.t().contiguous()`` (the library transpose, an anchor that no
tree changes: M2, anchor, anchor, M2); M3 (gdm's stream-overlap micro,
csrc/micro_stream.cu) runs every mode at 1024^2 and 4096^2 (tile_r 96,
nb 2, nsplit 1; gdm's overlap fraction from "compute", "dma" and
"both"), "both" at 4096^2 also with nb 3 and nsplit 2, each of "both" and
"dma" in turns against M4's "dma" (the same bytes through an unchanged
kernel), and M5's "dma" at 4096^2 in turns against M4's.  Device times by
CUDA events (``device_ms``); a JSON line ``{"times": {...}}`` holds them
(µs).

Unless ``--times-only``, it compiles copies of micro_relayout.cu and
micro_stream.cu with clock stamps into the gitignored gdm_torch/_build/
(``GDM_STAMP`` in common.cuh is empty in the kernels' own build; the
helpers are scripts/torch_k4_m1_breakdown.py's), runs each once on the
same inputs as its plan and prints: for M2 the span of the blocks, the
blocks each SM ran (%smid) and the shared-memory bytes a clock an SM
that a block's warp 0 moved in its steps; for M3 "both" the span and its
phases (consumers' waits for full slots, the producer's for free ones).

``--sweep`` also times every plan of ``mxu_micro.relayout_plans`` and
``stream_overlap_micro.m3_plans`` through the private
``_launch_relayout_plan`` and ``_launch_m3_plan`` hooks.  ``--root DIR``
takes ``gdm_torch`` and the sources from the checkout DIR (the parent's
tree, unpacked into the gitignored .parent/), so one call times two trees
in turns on one card (parent, change, change, parent), each in its own
process; plans and stamps of the kernels before their redesign are
skipped.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
import torch_k4_m1_breakdown as bd  # noqa: E402

M3_PHASES = [("consumer: waits for full slots (sum)", 2, None),
             ("consumer: first unit's copies landed", 8, 1),
             ("consumer: every unit, waits included", 8, 3),
             ("producer: waits for free slots (sum)", 4, None),
             ("producer: every copy issued", 8, 5)]
M3_END = 6


def m2_stamps(lib, plan, steps, itemsize, clock, what, ms):
    """M2's stamps: the blocks' span, blocks an SM, and warp 0's steps and
    clocks a block (stamp slots 0 start, 1 SM, 2 steps, 3 clocks in the
    steps, 4 end)."""
    import numpy as np

    st = np.zeros(bd.NB * bd.NS, np.int64)
    lib.gdm_stamps_read(st.ctypes.data)
    st = st.reshape(bd.NB, bd.NS)[:plan.blocks]
    t0 = st[:, 0].min()
    per_sm = np.bincount(st[:, 1])
    per_sm = per_sm[per_sm > 0]
    step_bytes = 2 * plan.edge * 128   # one read and one write a step
    rate = plan.warps * st[:, 2] * step_bytes / np.maximum(st[:, 3], 1)
    print(f"{what}: {ms * 1e3:.2f} us by events; {plan.blocks} blocks: "
          f"first start to last end {(st[:, 4].max() - t0) / 1e3:.2f} us, "
          f"starts spread over {(st[:, 0].max() - t0) / 1e3:.2f} us, a "
          f"block's span median {np.median(st[:, 4] - st[:, 0]) / 1e3:.2f} "
          f"us, max {(st[:, 4] - st[:, 0]).max() / 1e3:.2f} us")
    print(f"  {len(per_sm)} SMs ran blocks, {per_sm.min()}-{per_sm.max()} "
          f"an SM; warp 0 of a block: {st[:, 2].min()}-{st[:, 2].max()} "
          f"steps, {np.median(st[:, 3] / np.maximum(st[:, 2], 1)):.1f} "
          f"clocks a step (median), so {np.median(rate):.1f} B a clock an "
          f"SM if every warp of the block ran alike ({itemsize}-byte "
          f"elements; the SM's limit is 128), "
          f"{np.median(rate) * clock * len(per_sm) / 1e12:.2f} TB/s at "
          f"{clock / 1e9:.3f} GHz")


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
    from gdm_torch.benchmarks import mxu_micro, stream_overlap_micro as som
    from gdm_torch.benchmarks.timing import device_ms, mean_ms
    from gdm_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    print(f"card: {bd.card_line()}")
    print(f"gdm_torch from {os.path.dirname(gdm_torch.__file__)}")
    # the tree's kernels are built before any timing: device_ms sets its
    # spin from a warm-up, which a build inside it would stretch to minutes
    kl = _build.kernels()
    print(f"kernel build {kl.build_seconds:.1f} s: {kl.path}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]) * 1e6
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rng = np.random.default_rng(0)
    times = {}
    new_m2 = hasattr(mxu_micro, "relayout_plan")
    new_m3 = hasattr(som, "m3_plan")

    def turns(name_a, fa, name_b, fb):
        a1, b1, b2, a2 = (device_ms(f) for f in (fa, fb, fb, fa))
        print(f"  in turns: {name_a} {a1 * 1e3:.2f}, {name_b} {b1 * 1e3:.2f},"
              f" {name_b} {b2 * 1e3:.2f}, {name_a} {a2 * 1e3:.2f} us")
        return mean_ms((a1, a2)), mean_ms((b1, b2))

    # ---- M2 --------------------------------------------------------------
    steps = 4096
    m2_lib = None
    if not args.times_only and new_m2:
        m2_lib = bd.stamped_library(root, "micro_relayout")
    for dt in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(rng.random((512, 128)), dtype=torch.float32,
                            device=dev).to(dt)
        name = f"M2 (512, 128) {str(dt)[6:]} {steps} steps"
        for pad in (True, False):
            y = mxu_micro.relayout_apply(x, steps, pad)
            torch.cuda.synchronize()
            assert y.equal(x.t()), (name, pad)
            what = f"{name} pad={pad}"
            m2_ms, lib_ms = turns(
                "M2", lambda: mxu_micro.relayout_apply(x, steps, pad),
                "x.t().contiguous()", lambda: x.t().contiguous())
            times[what] = m2_ms * 1e3
            times[f"{what}: x.t().contiguous() (anchor)"] = lib_ms * 1e3
            plan = (mxu_micro.relayout_plan(512, 128, steps, dt, sms)
                    if new_m2 else None)
            moved = 2 * steps * x.numel() * x.element_size()
            print(f"{what}: {m2_ms * 1e3:.2f} us, "
                  f"{moved / (m2_ms * 1e-3) / 1e12:.2f} TB/s of shared "
                  f"memory; plan {plan}")
            if args.sweep and new_m2:
                for pl in mxu_micro.relayout_plans(512, 128, steps, dt, sms):
                    yk = mxu_micro._launch_relayout_plan(x, steps, pad, pl)
                    torch.cuda.synchronize()
                    assert yk.equal(x.t()), pl
                    ms = device_ms(lambda: mxu_micro._launch_relayout_plan(
                        x, steps, pad, pl))
                    mark = " (picked)" if pl == plan else ""
                    print(f"  sweep {what}: {pl} {ms * 1e3:.2f} us{mark}")
            if m2_lib is not None:
                yk = torch.empty_like(y)
                fn = f"gdm_micro_relayout_{mxu_micro.RELAYOUT_DTYPES[dt]}"
                scale = float(mxu_micro.relayout_scale(steps, dt).float())
                f = getattr(m2_lib, fn)
                f.argtypes = [P, P, I, I, I, F, I, I, I, I, I, P]
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    assert f(x.data_ptr(), yk.data_ptr(), 512, 128, steps,
                             scale, plan.edge, plan.warps, plan.blocks,
                             plan.smem, int(pad), stream) == 0

                run()
                torch.cuda.synchronize()
                assert yk.equal(x.t()), "stamped M2"
                m2_lib.gdm_stamps_clear()
                run()
                torch.cuda.synchronize()
                m2_stamps(m2_lib, plan, steps, x.element_size(), clock,
                          f"{what} stamped", m2_ms)
        del x, y

    # ---- M3 (and M4, M5 beside it) ---------------------------------------
    m3_lib = None
    if not args.times_only and new_m3:
        m3_lib = bd.stamped_library(root, "micro_stream")
    for n in (1024, 4096):
        aps = {m: som.make_micro(m, n, n, device=dev)[0] for m in som.MODES}
        g = aps["both"].geom
        u = torch.as_tensor(rng.standard_normal((g.r_ext, g.w2)),
                            dtype=torch.float32, device=dev)
        scale = som.stream_term_scale(u, aps["both"].coef)
        for mode, apply in aps.items():
            y = apply(u)
            yp = som.stream_micro_plain(u, apply.coef, g, mode)
            torch.cuda.synchronize()
            limit = {"dma": 0.0, "dma_out": 0.0, "both": 1e-6 * scale}.get(
                mode)
            if limit is not None:
                assert (y - yp).abs().max().item() <= limit, (n, mode)
        m4 = som.make_auto_micro("dma", n, n, device=dev)[0]
        u4 = u[:g.rp].contiguous()
        plan = getattr(aps["both"], "plan", None)
        name = f"M3 {n}^2 tile_r 96 nb 2 nsplit 1"
        print(f"{name}: strips of {g.sw}, plan {plan}")
        t = {}
        for mode in som.MODES:
            if mode in ("both", "dma"):
                t[mode], a = turns(f"M3 {mode}", lambda m=mode: aps[m](u),
                                   "M4 dma", lambda: m4(u4))
                times[f"{name} {mode}: M4 dma (anchor)"] = a * 1e3
            else:
                t[mode] = device_ms(lambda m=mode: aps[m](u))
            times[f"{name} {mode}"] = t[mode] * 1e3
        ov = som.overlap_fraction(t["compute"], t["dma"], t["both"])
        times[f"{name} overlap fraction"] = ov
        print(f"{name}: " + ", ".join(f"{m} {v * 1e3:.2f} us"
                                      for m, v in t.items())
              + f"; overlap fraction {ov:.3f}; both at "
              f"{8 * u.numel() / (t['both'] * 1e-3) / 1e9:.0f} GB/s of u "
              f"and y")
        if n == 4096:
            for nb, nsplit in ((3, 1), (2, 2), (3, 2)):
                alt = som.make_micro("both", n, n, nb=nb, nsplit=nsplit,
                                     device=dev)[0]
                assert alt(u).equal(aps["both"](u)), (nb, nsplit)
                what = f"M3 {n}^2 both nb {nb} nsplit {nsplit}"
                ms, a = turns(what, lambda: alt(u), "M4 dma",
                              lambda: m4(u4))
                times[what] = ms * 1e3
                print(f"{what}: {ms * 1e3:.2f} us, plan "
                      f"{getattr(alt, 'plan', None)}")
            m5 = som.make_sepbuf_micro("dma", n, n, device=dev)[0]
            t5, a = turns("M5 dma", lambda: m5(u), "M4 dma", lambda: m4(u4))
            times[f"M5 {n}^2 dma"] = t5 * 1e3
            times[f"M5 {n}^2 dma: M4 dma (anchor)"] = a * 1e3
        if args.sweep and new_m3:
            for mode in ("both", "dma"):
                for pl in som.m3_plans(n, n, 96, 7, 2, 1, sms):
                    gp = som._geometry(n, n, 96, 7, sw=pl.sw)
                    coef = aps[mode].coef
                    yk = som._launch_m3_plan(u, coef, gp, mode, pl)
                    torch.cuda.synchronize()
                    assert yk.equal(aps[mode](u)) or mode == "both", pl
                    ms = device_ms(lambda: som._launch_m3_plan(
                        u, coef, gp, mode, pl))
                    mark = " (picked)" if pl == plan else ""
                    print(f"  sweep {name} {mode}: {pl} cost "
                          f"{som.m3_plan_cost(pl, sms):.3f} "
                          f"{ms * 1e3:.2f} us{mark}")
        if m3_lib is not None and n == 4096:
            yk = torch.empty_like(u)
            yb = aps["both"](u)
            # the stamped copy draws its own tickets, from a counter of
            # its own
            tickets = torch.zeros(1, dtype=torch.int64, device=dev)
            drawn = [0]

            def base():
                b = drawn[0] * (plan.units + plan.blocks)
                drawn[0] += 1
                return b

            def check():
                assert (yk - yb).abs().max().item() <= 1e-6 * scale

            bd.run_stamped(
                m3_lib, "gdm_micro_stream_f32",
                [P] * 4 + [I] * 14 + [P, ctypes.c_longlong, P],
                lambda: [u.data_ptr(), aps["both"].coef.data_ptr(),
                         yk.data_ptr(), yk.data_ptr(),
                         som.MODES.index("both"), g.p, g.tile_r, g.n_tiles,
                         g.w2, plan.sw, plan.nb, plan.nsplit, plan.box_rows,
                         plan.nbox, plan.groups, plan.blocks, plan.threads,
                         plan.smem, tickets.data_ptr(), base()],
                check, M3_PHASES, M3_END, clock, f"{name} both stamped",
                t["both"])
        del aps, u, u4
    print(json.dumps({"times": times, "root": root}))


if __name__ == "__main__":
    main()
