#!/usr/bin/env python3
"""Device records that a CUDA profile loses as its process ages, and
what ``gdm_torch.profiling.renew_cupti`` does about it.

    python3 scripts/torch_profiler_aging.py [--age SECONDS]

Every 5 s for ``--age`` seconds (default 120), one short device profile
(torch.profiler, CUDA activity only, kineto's defaults) of 15 kernels
(three rounds of four in-place scalings and one concatenation); prints
how many of the 15 the exported Chrome trace holds, and kineto's
"Out-of-range" count where the trace's metadata reports it.  Then, in
turns, a profile right after ``renew_cupti()`` (with its cost in ms)
and two plain profiles right after that.  Exits non-zero if a renewed
profile lost a record.  Needs a card; prints the card's name and power
limit.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdm_torch.profiling import renew_cupti

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    args = sys.argv[1:]
    age = float(args[args.index("--age") + 1]) if "--age" in args else 120
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    a = torch.randn(4, 41, 140, device="cuda")

    def work():
        for _ in range(3):
            for s in range(4):
                a[s].mul_(1.0001)
            torch.cat([a[s, 4:37] for s in range(4)])
        torch.cuda.synchronize()

    def profiled(tmp):
        """(device records of the 15, kineto's out-of-range count)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            work()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            d = json.load(f)
        n = sum(1 for e in d["traceEvents"] if e.get("cat") == "kernel")
        oor = re.findall(r"Out-of-range = (\d+)",
                         " ".join(d.get("INFO", [])))
        return n, (int(oor[0]) if oor else None)

    work()
    t0 = time.perf_counter()
    lost = 0
    with tempfile.TemporaryDirectory() as tmp:
        while time.perf_counter() - t0 < age:
            n, oor = profiled(tmp)
            print(f"t = {time.perf_counter() - t0:6.1f} s: plain profile "
                  f"{n} of 15 kernels (out-of-range {oor})", flush=True)
            time.sleep(5)
        for _ in range(4):
            t1 = time.perf_counter()
            renew_cupti()
            cost = (time.perf_counter() - t1) * 1e3
            n, oor = profiled(tmp)
            after = [profiled(tmp) for _ in range(2)]
            lost += 15 - n
            print(f"t = {time.perf_counter() - t0:6.1f} s: renewed "
                  f"({cost:.1f} ms) {n} of 15 (out-of-range {oor}); plain "
                  f"right after {after}", flush=True)
    if lost:
        raise SystemExit(f"renewed profiles lost {lost} kernels")


if __name__ == "__main__":
    main()
