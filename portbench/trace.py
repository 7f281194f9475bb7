"""The traced run's readings: a profiled stretch of whole segments and
the same number of segments again unprofiled.

The profiler records device activity only (kernels, copies, sets), in
a fresh process before any other profile, and its Chrome trace is read
for each device record's name, start and length.  The profiler costs
host time at every launch, so wall times come from the unprofiled
stretch, which runs under ``torch.cuda.set_sync_debug_mode("warn")`` to
count the host's waits on the card.  During the profiled stretch the
verified solver's device form is wrapped to keep the stats each solve
returns (its iterations), which the chunk loop drops.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
import types
import warnings

import torch

KERNEL = "kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def kept_solves(store):
    """Wrap ``VerifiedSolver.solve_device`` so that each call's solver and
    (2, 4) stats tensor are appended to ``store`` (no read inside)."""
    from gdm_torch.cut.fsai import VerifiedSolver

    orig = VerifiedSolver.solve_device

    def solve_device(self, b, x0=None):
        x, stats = orig(self, b, x0)
        store.append((self, stats))
        return x, stats

    VerifiedSolver.solve_device = solve_device
    try:
        yield
    finally:
        VerifiedSolver.solve_device = orig


def device_records(path):
    """(name, start us, length us, category) of a Chrome trace's device
    records, in start order."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
            e.get("cat")) for e in events
           if e.get("cat") in DEVICE_CATS and "ts" in e]
    out.sort(key=lambda r: r[1])
    return out


def busy_us(records):
    """The length of the union of the records' intervals."""
    total, end = 0.0, None
    for _, ts, dur, _ in records:
        if end is None or ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def idle_gaps(records, top=10):
    """The ``top`` longest gaps between device records, each named by
    the record before it."""
    gaps, end, last = [], None, None
    for name, ts, dur, _ in records:
        if end is not None and ts > end:
            gaps.append((f"after {last[:80]}", (ts - end) * 1e-6))
        if end is None or ts + dur > end:
            end, last = ts + dur, name
    gaps.sort(key=lambda g: -g[1])
    return [list(g) for g in gaps[:top]]


def stretch(drv, n, keep_solvers):
    """Run n segments profiled, then n unprofiled; returns the readings
    and the segments' outputs."""
    from torch.profiler import ProfilerActivity, profile

    solves, outs = [], []
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        t0 = time.perf_counter()
        with kept_solves(solves), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                outs.append(drv.segment())
                keep_solvers(drv.solvers())
            torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        records = device_records(path)
    steps = sum(o["steps"] for o in outs)
    stats = torch.stack([s for _, s in solves]).tolist() if solves else []
    solves = [(drv.region_of(v), v.path, st)
              for (v, _), st in zip(solves, stats)]

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                outs.append(drv.segment())
                keep_solvers(drv.solvers())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    kernels = [r for r in records if r[3] == KERNEL]
    return types.SimpleNamespace(
        records=records, kernels=kernels, steps=steps,
        busy_s=busy_us(records) * 1e-6, profiled_wall_s=prof_wall,
        wall_s=wall, syncs=syncs, solves=solves), outs


def breakdown(t):
    """The device's ten largest operations by time and its ten longest
    idle gaps, in seconds."""
    by_name = {}
    for name, _, dur, _ in t.records:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in ops],
            "idle_gaps": idle_gaps(t.records)}
