"""The program's spans and counters beside a cell's traced run.

    python3 portbench/tools/spans.py --workload <cell> --seed <n> \
        [--cost K] [--out FILE]

Runs the cell's traced run as ``run.py --trace 1`` does
(``harness.run_cell``), with ``gdm_torch.profiling`` recording from
before the cell's ``Driver``, and reads the spans the program recorded
and its counters, split three ways: set-up (before the traced stretch),
the profiled stretch and the unprofiled one.  It prints the run's
result line and, beside it, the readings of the per-layer metrics that
read the program (``READERS``: spans from the unprofiled stretch, since
the profiler inflates host time at each launch; K2's cost an iteration
from the profiled stretch on both sides), the device's idle gaps named
by the innermost span open over each (``"<span> | after <kernel>"``),
the set-up by span, the spans of a ``run_scan`` call, and the profiled
stretch's one-band iterations by the program's tally beside those the
harness's ``trace.kept_solves`` kept.

``before_set_up_s`` gives the seconds from the process's start to
``import torch``, to the port's and the harness's imports and to the
device's context, which no program span can see.

With ``--cost K``: after set-up, 2K segments timed with recording off
and on in turns (off, on, on, off, ...), each ended by a synchronize:
the cost of recording to the end-to-end metric.

The benchmark's runs do not run this; the readers are what a traced
run would report once the harness records the program's spans.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.metrics._kernels import K2_BAND, device_s  # noqa: E402

ITER = 1     # resident.STATS = (residual, iterations, r0, ran)


# -- reading the spans --------------------------------------------------

def _dur(s):
    return (s.end - s.start) * 1e-9


def _ancestors(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
        yield spans[i]


def _children(spans, lo, hi):
    kids = {}
    for j in range(lo, hi):
        kids.setdefault(spans[j].parent, []).append(j)
    return kids


def _iterations(counters):
    return (counters.get("k2.band_iterations", 0)
            + counters.get("k2.fsai_iterations", 0))


# the readers, one a metric: read(t, p) with t the harness's readings
# (``trace.stretch``) and p the program's (``program_readings``); None
# where there is nothing to read

def solve_iterations_per_step(t, p):
    """K2's iterations (one-band and FSAI) a step, unprofiled stretch."""
    n = _iterations(p.counters["unprofiled"])
    return n / t.steps if n and t.steps else None


def k2_us_per_iteration(t, p):
    """K2's one-band device time over its iterations, both from the
    profiled stretch."""
    n = p.counters["profiled"].get("k2.band_iterations", 0)
    dev = device_s(t, lambda name: bool(K2_BAND.search(name)))
    return dev * 1e6 / n if n and dev else None


def host_enqueue_ms_per_step(t, p):
    """The host's time issuing the chunks' steps (``scan.enqueue``, less
    any ``setup.*`` span inside it) a step, unprofiled stretch."""
    lo, hi = p.unprofiled
    sp = p.spans
    kids = _children(sp, lo, hi)
    total = 0.0
    for i in range(lo, hi):
        if sp[i].name == "scan.enqueue":
            total += _dur(sp[i]) - sum(
                _dur(sp[j]) for j in kids.get(i, ())
                if sp[j].name.startswith("setup."))
    return total * 1e3 / t.steps if total and t.steps else None


def read_wait_ms_per_step(t, p):
    """The host blocked on the chunks' one read (``scan.read``) a step,
    unprofiled stretch."""
    lo, hi = p.unprofiled
    total = sum(_dur(s) for s in p.spans[lo:hi] if s.name == "scan.read")
    return total * 1e3 / t.steps if total and t.steps else None


def scan_prepare_ms_per_call(t, p):
    """``scan.prepare`` and the ``setup.*`` spans opened inside a call's
    chunks (the lazy device form), a ``run_scan`` call, unprofiled
    stretch."""
    lo, hi = p.unprofiled
    sp = p.spans
    calls = sum(1 for s in sp[lo:hi] if s.name == "scan.call")
    total = 0.0
    for i in range(lo, hi):
        s = sp[i]
        if s.name == "scan.prepare":
            total += _dur(s)
        elif s.name.startswith("setup."):
            up = [a.name for a in _ancestors(sp, i)]
            if "scan.chunk" in up and not any(
                    a.startswith("setup.") for a in up):
                total += _dur(s)
    return total * 1e3 / calls if calls else None


def setup_mass_solvers_s(t, p):
    """The mass solvers' builds (``setup.mass_solver``, outermost) before
    the traced stretch, less the kernels' build or load inside them (a
    checkout's first run builds the CUDA library at the first probe)."""
    sp = p.spans
    total = 0.0
    for i in range(p.setup):
        up = [a.name for a in _ancestors(sp, i)]
        if "setup.mass_solver" in up:
            if sp[i].name == "setup.kernels":
                total -= _dur(sp[i])
        elif sp[i].name == "setup.mass_solver":
            total += _dur(sp[i])
    return total or None


# the readers by the names a benchmark PR would give their metrics
READERS = {
    "solve_iterations_per_step": solve_iterations_per_step,
    "k2_us_per_iteration": k2_us_per_iteration,
    "host_enqueue_ms_per_step": host_enqueue_ms_per_step,
    "read_wait_ms_per_step": read_wait_ms_per_step,
    "scan_prepare_ms_per_call": scan_prepare_ms_per_call,
    "setup_mass_solvers_s": setup_mass_solvers_s,
}


def named_gaps(t, p, top=10):
    """The ``top`` longest gaps between the profiled stretch's device
    records, each named ``"<span> | after <kernel>"`` by the innermost
    program span open over the whole gap (``"no span"`` where none)."""
    from gdm_torch import profiling

    lo, hi = p.profiled
    sp = p.spans
    depth = {}
    for i in range(lo, hi):
        depth[i] = sum(1 for _ in _ancestors(sp, i))
    iv = [(profiling.to_trace_us(sp[i].start, p.base_ns),
           profiling.to_trace_us(sp[i].end, p.base_ns), depth[i], sp[i].name)
          for i in range(lo, hi) if sp[i].end is not None]
    gaps, end, last = [], None, None
    for name, ts, dur, _ in t.records:
        if end is not None and ts > end:
            over = [s for s in iv if s[0] <= end and s[1] >= ts]
            inner = max(over, key=lambda s: s[2])[3] if over else "no span"
            gaps.append((f"{inner} | after {last[:80]}", (ts - end) * 1e-6))
        if end is None or ts + dur > end:
            end, last = ts + dur, name
    gaps.sort(key=lambda g: -g[1])
    return [list(g) for g in gaps[:top]]


def by_name(spans):
    """Seconds and count of each span name."""
    out = {}
    for s in spans:
        if s.end is not None:
            tot, n = out.get(s.name, (0.0, 0))
            out[s.name] = (tot + _dur(s), n + 1)
    return {k: {"s": v[0], "count": v[1]} for k, v in sorted(out.items())}


def program_readings(marks):
    """The program's readings from the marks the wrapped stretch took."""
    spans = marks["spans"]
    c0, c1, c2 = marks["counters"]
    return types.SimpleNamespace(
        spans=spans, setup=marks["first"], base_ns=marks["base_ns"],
        profiled=(marks["first"], marks["mid"]),
        unprofiled=(marks["mid"], len(spans)),
        counters={"setup": c0,
                  "profiled": {k: c1.get(k, 0) - c0.get(k, 0) for k in c1},
                  "unprofiled": {k: c2.get(k, 0) - c1.get(k, 0)
                                 for k in c2}})


# -- the runs -----------------------------------------------------------

def traced(cell, seed, device):
    """run_cell's traced run with the program recording; returns the
    run's result, its compared numbers and the report."""
    from gdm_torch import profiling
    from portbench import harness
    from portbench import trace as trace_mod

    marks = {}
    orig_stretch, orig_records = trace_mod.stretch, trace_mod.device_records

    def device_records(path):
        with open(path) as f:
            marks["base_ns"] = json.load(f).get("baseTimeNanoseconds", 0)
        return orig_records(path)

    def stretch(drv, n, keep_solvers):
        marks["first"] = len(profiling.spans())
        marks["counters"] = [profiling.counters()]
        calls = []

        def keep(solvers):
            keep_solvers(solvers)
            calls.append(1)
            if len(calls) == n:       # the profiled stretch's last segment
                marks["mid"] = len(profiling.spans())
                marks["counters"].append(profiling.counters())

        t, outs = orig_stretch(drv, n, keep)
        marks["counters"].append(profiling.counters())
        marks["spans"] = profiling.spans()
        marks["t"] = t
        return t, outs

    trace_mod.stretch, trace_mod.device_records = stretch, device_records
    profiling.enable()
    try:
        result, compared = harness.run_cell(cell, seed, 0.0, True, device,
                                            T_START)
    finally:
        profiling.disable()
        trace_mod.stretch, trace_mod.device_records = (orig_stretch,
                                                       orig_records)
    t, p = marks["t"], program_readings(marks)
    sp = p.spans
    kept = sum((first if path == "streamed" else second)[ITER]
               for _, path, (first, second) in t.solves)
    stretch_start = sp[p.setup].start if p.setup < len(sp) else None
    tops = [s for s in sp[:p.setup] if s.parent is None]
    report = {
        "metrics": {k: f(t, p) for k, f in READERS.items()},
        "named_idle_gaps": named_gaps(t, p),
        "band_iterations_profiled": {
            "program": p.counters["profiled"].get("k2.band_iterations", 0),
            "kept_solves": int(kept)},
        "counters": p.counters,
        "steps": t.steps,
        "setup": {
            "by_name": by_name(sp[:p.setup]),
            "top_level": [[s.name, dict(s.attrs),
                           (s.start * 1e-9 - T_START), _dur(s)]
                          for s in tops],
            "top_level_s": sum(_dur(s) for s in tops),
            "harness_spans": t.spans},
        "unprofiled": {
            "by_name": by_name(sp[p.unprofiled[0]:]),
            "calls": sum(1 for s in sp[p.unprofiled[0]:]
                         if s.name == "scan.call"),
            "wall_s": t.wall_s},
        "stretch_start_s": (None if stretch_start is None
                            else stretch_start * 1e-9 - T_START),
    }
    return result, compared, report


def cost(cell, seed, device, k):
    """2k segments after set-up, recording off and on in turns: the
    end-to-end metric of each."""
    import torch

    from gdm_torch import profiling
    from portbench import data as data_mod

    fam = cell.family
    drv = fam.Driver(cell.cfg, data_mod.draw(cell.cfg, seed), cell.traffic,
                     device)
    _, was_segment = drv.first_call()
    if not was_segment:
        drv.segment()
    runs = {"off": [], "on": []}
    order = []
    for i in range(k):
        order += ["off", "on"] if i % 2 == 0 else ["on", "off"]
    for mode in order:
        (profiling.enable if mode == "on" else profiling.disable)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = drv.segment()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[mode].append({"step_ms": wall / out["steps"] * 1e3,
                           "run_s": wall})
    profiling.disable()
    drv.close()
    med = {m: {k2: statistics.median(r[k2] for r in rs)
               for k2 in ("step_ms", "run_s")} for m, rs in runs.items()}
    return {"order": order, "runs": runs, "median": med,
            "on_over_off": {k2: med["on"][k2] / med["off"][k2] - 1.0
                            for k2 in ("step_ms", "run_s")},
            "spans_recorded": len(profiling.spans())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    marks = {"import_torch": time.perf_counter() - T_START}
    cell = harness.load_cell(args.workload)
    import gdm_torch.problems.advection  # noqa: F401  (the families' own)
    import gdm_torch.problems.wave  # noqa: F401

    marks["import_port"] = time.perf_counter() - T_START
    device = "cuda" if torch.cuda.is_available() else "cpu"
    torch.zeros(1, device=device)
    marks["device_context"] = time.perf_counter() - T_START
    report = {"cell": cell.name, "seed": args.seed,
              "device": torch.cuda.get_device_name(0)
              if device == "cuda" else "cpu",
              "before_set_up_s": marks}
    if args.cost:
        report["cost"] = cost(cell, args.seed, device, args.cost)
    else:
        result, compared, report["program"] = traced(cell, args.seed,
                                                     device)
        report["result"] = result
        report["compared"] = {k: list(v) for k, v in compared.items()}
    print(json.dumps(report, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
