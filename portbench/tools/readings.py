"""The readings that the limits of ``correct`` are set from.

    python3 portbench/tools/readings.py --workload <cell> --seeds N \
        --control-seeds M [--first-seed S] [--out FILE]

For one cell, in one process on the card: the program's gaps from the
float64 reference on N seeds (one segment each, through the cell's own
`Driver` at its own size), and the control's on M seeds: the reference
computed in TF32 (``reference.arith.TF32``) put in the program's place.
The lower reading of each number is the largest the program gives, the
upper the smallest the control gives; ``limits/<cell>.json`` is set
between them.  Each seed's segment runs twice, timed, to set the spread that
different seeds cause in the step time beside that of one seed.  The
benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 7)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import data as data_mod
    from portbench import harness

    cell = harness.load_cell(args.workload)
    fam, cfg, traffic = cell.family, cell.cfg, cell.traffic
    device = "cuda" if torch.cuda.is_available() else "cpu"

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    datas = [data_mod.draw(cfg, s) for s in seeds]
    t0 = time.perf_counter()
    outs, times = [], []
    if datas:
        drv = fam.Driver(cfg, datas[0], traffic, device)
        for i, d in enumerate(datas):
            drv.set_data(d)
            if i == 0 or traffic["start_step"]:
                drv.first_call()  # the solvers; a later start's checkpoint
            pair = []
            for _ in range(2):    # the seed's segment twice, timed
                sync()
                s0 = time.perf_counter()
                out = drv.segment()
                sync()
                pair.append((time.perf_counter() - s0) / out["steps"] * 1e3)
            times.append(pair)
            outs.append(fam.host(out))
        drv.close()
        del drv
    if device == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = fam.Reference(cfg, traffic, device)
    program = [ref.compare(ref.run(d), o) for d, o in zip(datas, outs)]
    t2 = time.perf_counter()
    ctl = fam.Reference(cfg, traffic, device, arith="tf32")
    cseeds = [args.first_seed + 104729 * (i + 1)
              for i in range(args.control_seeds)]
    control = []
    for s in cseeds:
        d = data_mod.draw(cfg, s)
        control.append(ref.compare(ref.run(d), ctl.run(d)))
    t3 = time.perf_counter()
    keys = sorted((program or control)[0])
    report = {"cell": cell.name, "device": torch.cuda.get_device_name(0)
              if device == "cuda" else "cpu", "seeds": seeds,
              "program": program, "control": control,
              "segment_ms_a_step": times,
              "control_seeds": cseeds,
              "lower": {k: max(p[k] for p in program) for k in keys}
              if program else {},
              "upper": {k: min(c[k] for c in control) for k in keys}
              if control else {},
              "seconds": {"program": t1 - t0, "reference": t2 - t1,
                          "control": t3 - t2}}
    print("ms a step, each seed's segment twice:",
          [[round(a, 3), round(b, 3)] for a, b in times])
    for k in keys:
        print(f"{k}: program {[f'{p[k]:.3e}' for p in program]}; control "
              f"{[f'{c[k]:.3e}' for c in control]}")
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
