"""Lightweight tracing/profiling hooks.

Port of gdm/profiling.py.  The reference logs only CG iteration counts
(SURVEY §5); production runs need per-phase wall-clock and device
traces.  ``phase_timer`` wraps host phases (wall-clock seconds, summed
per name; ``report`` and ``reset`` read and clear the sums); ``trace``
wraps a block in a ``torch.profiler`` profile and writes it into
``log_dir`` as a Chrome trace (chrome://tracing, Perfetto).  With a
card present the profile records device activity only (kernels and
copies, as ``benchmarks.timing.profiled_ms``): the host ops of a loop
of thousands of launches would cost seconds a trace.  Without one it
records the host's ops.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import time
import types
from collections import defaultdict

_totals = defaultdict(float)
_counts = defaultdict(int)
_traces = itertools.count()


@contextlib.contextmanager
def phase_timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _totals[name] += dt
        _counts[name] += 1


def report() -> dict:
    return {
        k: {"total_s": _totals[k], "count": _counts[k],
            "mean_s": _totals[k] / max(1, _counts[k])}
        for k in sorted(_totals)
    }


def reset():
    _totals.clear()
    _counts.clear()


def renew_cupti():
    """Tear CUPTI down and bring it up again with empty device profiles,
    so that the next profile starts on a freshly initialised CUPTI.
    Kineto keeps CUPTI initialised from one profile to the next; the
    longer it stays up, the more of each profile's device records it
    stamps outside the profile's capture window (about one a profile for
    every 15 s of its life on an H100 host), and kineto drops those (its
    "Out-of-range" count): a short profile late in a long process then
    holds no kernel at all.  The first empty profile brings CUPTI up if
    no profile has yet, the second tears it down at its end, and the
    third takes the re-initialisation, whose profile may record
    nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def empty():
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()

    empty()
    old = os.environ.get("TEARDOWN_CUPTI")
    os.environ["TEARDOWN_CUPTI"] = "1"
    try:
        empty()
    finally:
        if old is None:
            del os.environ["TEARDOWN_CUPTI"]
        else:
            os.environ["TEARDOWN_CUPTI"] = old
    empty()


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace via torch.profiler: yields a namespace whose
    ``path`` is the Chrome trace file written into ``log_dir`` (created
    if missing) when the block ends, and whose ``profile`` is the
    profiler (its ``key_averages()``).  On the card the profile starts
    on a fresh CUPTI (``renew_cupti``), and a trace that holds kernel
    launches and no kernel on the device raises RuntimeError."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    path = os.path.join(log_dir, "trace_%s_%d_%d.json" % (
        time.strftime("%Y%m%d_%H%M%S"), os.getpid(), next(_traces)))
    out = types.SimpleNamespace(path=path, profile=None)
    if on_card:
        renew_cupti()
    with profile(activities=[activity]) as prof:
        out.profile = prof
        try:
            yield out
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if on_card:
        with open(path) as f:
            launched, ran = _device_gap(json.load(f).get("traceEvents", []))
        if launched and not ran:
            raise RuntimeError(
                f"trace {path}: {launched} kernel launches and no kernel "
                f"on the device in the profile")


def _device_gap(events) -> tuple:
    """(kernel launch calls, kernels run on the device) among a Chrome
    trace's events: the host's launch calls (``cuda_runtime`` or
    ``cuda_driver``, named ``*Launch*Kernel*``) and the device's
    ``kernel`` records."""
    launched = sum(1 for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and re.search("Launch.*Kernel", e.get("name", "")))
    ran = sum(1 for e in events if e.get("cat") == "kernel")
    return launched, ran
