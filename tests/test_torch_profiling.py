"""The port's profiling hooks (gdm_torch.profiling) against gdm's
gdm/profiling.py, on the CPU.

- ``phase_timer`` sums each name's wall-clock seconds and counts its
  calls, ``report`` gives (total_s, count, mean_s) by name, sorted, in
  gdm's format, and ``reset`` clears them; a phase that raises is still
  timed;
- ``trace(log_dir)`` creates ``log_dir`` and writes one Chrome trace a
  block there (the host's ops without a card), named apart for two
  blocks in one second, and the trace holds the block's ops;
- ``_device_gap`` counts a trace's kernel launch calls and device
  kernels (on the card ``trace`` raises when it recorded launches and
  no kernel);
- ``span``: names, parents, attributes and nesting while recording; off
  (the default) no record, no sum and no clock read; a bounded store;
  one store with ``phase_timer``; times that ``to_trace_us`` puts on the
  profiler's clock (a span around ``a @ a`` holds the aten::mm record);
  ``trace`` writes the block's spans on the ``gdm_torch`` track;
  ``count``/``counters``.
"""

import json
import os
import tempfile
import time

import pytest
import torch

from gdm import profiling as gprofiling

from gdm_torch import profiling


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    gprofiling.reset()
    yield
    profiling.reset()
    gprofiling.reset()


def test_phase_timer_counts_and_totals():
    for mod in (profiling, gprofiling):
        for _ in range(3):
            with mod.phase_timer("b"):
                time.sleep(0.01)
        with mod.phase_timer("a"):
            pass
    rep, grep = profiling.report(), gprofiling.report()
    assert list(rep) == list(grep) == ["a", "b"]
    for k in rep:
        assert set(rep[k]) == set(grep[k]) == {"total_s", "count", "mean_s"}
        assert rep[k]["count"] == grep[k]["count"]
    assert rep["b"]["count"] == 3 and rep["a"]["count"] == 1
    assert rep["b"]["total_s"] >= 0.03
    assert rep["b"]["mean_s"] == pytest.approx(rep["b"]["total_s"] / 3)


def test_phase_timer_times_a_raising_phase():
    with pytest.raises(RuntimeError):
        with profiling.phase_timer("boom"):
            raise RuntimeError("x")
    assert profiling.report()["boom"]["count"] == 1


def test_reset_clears():
    with profiling.phase_timer("x"):
        pass
    assert profiling.report()
    profiling.reset()
    assert profiling.report() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "traces" / "run")
    paths = []
    for _ in range(2):
        with profiling.trace(log_dir) as tr:
            a = torch.ones(64, 64, dtype=torch.float64)
            torch.mm(a, a)
        paths.append(tr.path)
    assert paths[0] != paths[1]
    assert sorted(os.listdir(log_dir)) == sorted(os.path.basename(p)
                                                 for p in paths)
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    names = {e.key for e in tr.profile.key_averages()}
    assert "aten::mm" in names


def test_device_gap_counts_launches_and_kernels():
    events = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "cuda_runtime", "name": "cudaLaunchCooperativeKernel"},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx"},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync"},
        {"cat": "kernel", "name": "cutband_apply_kernel<float, 12>"},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD"},
        {"ph": "i", "name": "Record Window End"},
    ]
    assert profiling._device_gap(events) == (3, 1)
    assert profiling._device_gap(events[:4]) == (3, 0)
    assert profiling._device_gap([]) == (0, 0)


# -- spans and counters -------------------------------------------------

def test_spans_nest_with_parents_and_attributes():
    with profiling.recording() as first:
        assert first == 0 and profiling.enabled()
        with profiling.span("outer", region="inside") as outer:
            with profiling.span("inner", steps=3):
                pass
            with profiling.span("inner"):
                pass
            outer.set(chunk=2)
        with profiling.span("second"):
            pass
    assert not profiling.enabled()
    sp = profiling.spans()
    assert [s.name for s in sp] == ["outer", "inner", "inner", "second"]
    assert [s.parent for s in sp] == [None, 0, 0, None]
    assert sp[0].attrs == {"region": "inside", "chunk": 2}
    assert sp[1].attrs == {"steps": 3} and sp[2].attrs == {}
    for s in sp:
        assert s.end >= s.start
    assert sp[0].start <= sp[1].start and sp[2].end <= sp[0].end
    assert sp[1].end <= sp[2].start <= sp[3].start
    rep = profiling.report()
    assert rep["inner"]["count"] == 2 and rep["outer"]["count"] == 1
    assert rep["outer"]["total_s"] == pytest.approx(
        (sp[0].end - sp[0].start) * 1e-9)


def test_recording_off_records_nothing_and_reads_no_clock(monkeypatch):
    """Off (the default), a span site is one flag check: no clock read,
    no record, no sum; counters count either way."""
    assert not profiling.enabled()

    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(time, "perf_counter", no_clock)
    monkeypatch.setattr(time, "time_ns", no_clock)
    with profiling.span("scan.chunk", steps=4) as sp:
        sp.set(chunk=4)
        with profiling.span("scan.enqueue"):
            pass
    profiling.count("solves", 3)
    profiling.count("solves")
    assert profiling.spans() == [] and profiling.report() == {}
    assert profiling.counters() == {"solves": 4}


def test_recording_block_keeps_an_enabled_state():
    profiling.enable()
    try:
        with profiling.recording():
            pass
        assert profiling.enabled()
    finally:
        profiling.disable()
    assert not profiling.enabled()


def test_store_is_bounded(monkeypatch):
    """Past ``MAX_SPANS`` spans are summed and not kept; a kept span's
    parent is a kept span or None."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    with profiling.span("d"):
                        pass
    assert [s.name for s in profiling.spans()] == ["a", "b"]
    assert profiling.report()["d"]["count"] == 1


def test_phase_timer_and_spans_share_one_store():
    """While recording, a phase is a span too; report() sums the phases
    and the spans alike (off, the phase sums as gdm's does)."""
    with profiling.phase_timer("p"):
        pass
    with profiling.recording():
        with profiling.phase_timer("p"):
            with profiling.span("s"):
                pass
    sp = profiling.spans()
    assert [(s.name, s.parent) for s in sp] == [("p", None), ("s", 0)]
    rep = profiling.report()
    assert rep["p"]["count"] == 2 and rep["s"]["count"] == 1
    assert list(rep) == ["p", "s"]


def test_span_clock_is_the_profilers():
    """A span around ``a @ a`` under a CPU profile contains the profile's
    aten::mm record once its times are put on the trace's clock."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(128, 128, dtype=torch.float64)
    with profiling.recording(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            a @ a
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    (mm,) = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm"]
    (sp,) = profiling.spans()
    lo = profiling.to_trace_us(sp.start, base)
    hi = profiling.to_trace_us(sp.end, base)
    assert lo <= mm["ts"] and mm["ts"] + mm["dur"] <= hi


def test_trace_writes_the_spans(tmp_path):
    """``trace`` records the block's spans and writes them into its
    Chrome trace as complete events on the ``gdm_torch`` track, each
    around the ops it covers."""
    a = torch.ones(64, 64, dtype=torch.float64)
    with profiling.trace(str(tmp_path)) as tr:
        with profiling.span("scan.chunk", steps=2):
            torch.mm(a, a)
    assert not profiling.enabled()
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    (track,) = [e for e in events if e.get("ph") == "M"
                and e.get("args", {}).get("name") == profiling.TRACK]
    (chunk,) = [e for e in events if e.get("cat") == profiling.TRACK
                and e.get("ph") == "X"]
    assert chunk["name"] == "scan.chunk" and chunk["args"] == {"steps": 2}
    assert (chunk["pid"], chunk["tid"]) == (track["pid"], track["tid"])
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert chunk["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= chunk["ts"] + chunk["dur"]
