"""Lightweight tracing/profiling hooks.

Port of gdm/profiling.py.  The reference logs only CG iteration counts
(SURVEY §5); production runs need per-phase wall-clock and device
traces.

``span(name, **attrs)`` marks a host phase of the program: while
recording is on (``enable``/``disable``, or a ``recording()`` block;
off by default) each span keeps its name, start and end
(``time.perf_counter_ns``), its parent (the span open on the thread
when it began) and its scalar attributes, in a bounded in-memory store
read by ``spans()``; while it is off a span site checks one flag and
reads no clock.  ``phase_timer`` wraps a phase always: its wall-clock
seconds are summed per name, and ``report`` gives the sums of the
phases and of the spans recorded (one store).  ``count(name, n)``
bumps a process-wide host counter, read by ``counters()``.  ``reset``
clears the sums, the spans and the counters.

``to_trace_us`` puts a span's times on the clock of the torch
profiler's Chrome trace (``ts`` in µs past the file's
``baseTimeNanoseconds``, ``time.time_ns``'s clock).  ``trace`` wraps a
block in a ``torch.profiler`` profile and writes it into ``log_dir``
as a Chrome trace (chrome://tracing, Perfetto), with the spans of the
block as complete events on a host track named ``gdm_torch``.  With a
card present the profile records device activity only (kernels and
copies, as ``benchmarks.timing.profiled_ms``): the host ops of a loop
of thousands of launches would cost seconds a trace.  Without one it
records the host's ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import threading
import time
import types
from collections import defaultdict

_totals = defaultdict(float)
_counts = defaultdict(int)
_counters = defaultdict(int)
_traces = itertools.count()

MAX_SPANS = 1 << 18     # the store's bound: later spans are summed, not kept
TRACK = "gdm_torch"     # the host track of the spans in ``trace``'s file
_TRACK_TID = 0x67646D   # its thread id there, apart from the profiler's

_on = False
_spans = []
_stack = threading.local()
_offset_ns = None       # time.time_ns() - time.perf_counter_ns()


@dataclasses.dataclass
class Span:
    """One recorded span: ``parent`` the index in ``spans()`` of the span
    open on the thread when it began (None at the top), ``end`` None
    while it is open."""

    name: str
    start: int
    end: int = None
    parent: int = None
    attrs: dict = dataclasses.field(default_factory=dict)

    def set(self, **attrs):
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)


class _Recorder:
    __slots__ = ("span",)

    def __init__(self, name, attrs):
        self.span = Span(name, 0, attrs=attrs)

    def __enter__(self):
        # the thread's open spans, as indices into _spans (None: not kept)
        stack = _stack.__dict__.setdefault("open", [])
        self.span.parent = stack[-1] if stack else None
        index = None
        if len(_spans) < MAX_SPANS:
            index = len(_spans)
            _spans.append(self.span)
        stack.append(index)
        self.span.start = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc):
        sp = self.span
        sp.end = time.perf_counter_ns()
        _stack.open.pop()
        _totals[sp.name] += (sp.end - sp.start) * 1e-9
        _counts[sp.name] += 1
        return False


class _Off:
    """The span of a site while recording is off: no clock, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records the block as a ``Span`` while
    recording is on (its value: the span, whose ``set`` adds
    attributes), and does nothing otherwise."""
    if not _on:
        return _OFF
    return _Recorder(name, attrs)


def enable():
    """Start recording spans; takes the offset of ``to_trace_us``."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def recording():
    """Record spans inside the block, as they were recorded (or not)
    before it afterwards; yields the index of the block's first span."""
    was = _on
    enable()
    try:
        yield len(_spans)
    finally:
        if not was:
            disable()


def spans() -> list:
    """The recorded spans, in the order they began."""
    return list(_spans)


def count(name: str, n: int = 1):
    """Add ``n`` to the host counter ``name``."""
    _counters[name] += n


def counters() -> dict:
    return dict(_counters)


def to_trace_us(ns: int, base_ns: int) -> float:
    """A ``time.perf_counter_ns`` reading as a Chrome trace ``ts``: µs
    past ``base_ns``, the trace's ``baseTimeNanoseconds``."""
    global _offset_ns
    if _offset_ns is None:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    return (ns + _offset_ns - base_ns) * 1e-3


@contextlib.contextmanager
def phase_timer(name: str):
    if _on:     # a recorded span sums itself
        with span(name):
            yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _totals[name] += time.perf_counter() - t0
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
    _counters.clear()
    _spans.clear()


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
    profiler (its ``key_averages()``).  The block records spans, and
    the file holds them as complete events on the host track ``TRACK``,
    on the profile's clock.  On the card the profile starts on a fresh
    CUPTI (``renew_cupti``), and a trace that holds kernel launches and
    no kernel on the device raises RuntimeError."""
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
    with recording() as first, profile(activities=[activity]) as prof:
        out.profile = prof
        try:
            yield out
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    if on_card:
        launched, ran = _device_gap(events)
        if launched and not ran:
            raise RuntimeError(
                f"trace {path}: {launched} kernel launches and no kernel "
                f"on the device in the profile")
    # older traces carry absolute µs and no base
    events.extend(_span_events(_spans[first:],
                               doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)


def _span_events(recorded, base_ns) -> list:
    """The closed spans of ``recorded`` as Chrome trace complete events
    on the host track ``TRACK``."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid,
               "tid": _TRACK_TID, "args": {"name": TRACK}}]
    for sp in recorded:
        if sp.end is not None:
            events.append({"ph": "X", "cat": TRACK, "name": sp.name,
                           "pid": pid, "tid": _TRACK_TID,
                           "ts": to_trace_us(sp.start, base_ns),
                           "dur": (sp.end - sp.start) * 1e-3,
                           "args": dict(sp.attrs)})
    return events


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
