"""The readers of ``portbench/tools/spans.py`` on synthetic readings, on
the CPU: the program's spans (``gdm_torch.profiling.Span``) and counter
deltas beside the harness's readings of a traced stretch.

- iterations a step from the unprofiled stretch's counters; K2's cost an
  iteration from the profiled stretch's one-band device time and
  one-band counter; nothing to read gives None;
- ``scan.enqueue`` less its ``setup.*`` children, ``scan.read``,
  ``scan.prepare`` with the ``setup.*`` spans opened inside a call's
  chunks, each over the unprofiled stretch's steps or calls;
- the mass solvers' outermost builds before the traced stretch, less the
  kernels' build inside them;
- the idle gaps named by the innermost span open over the whole gap.
"""

import types

import pytest

from gdm_torch import profiling
from gdm_torch.profiling import Span
from portbench.tools import spans as tool

MS = 1_000_000    # ns


def _span(name, start_ms, end_ms, parent=None, **attrs):
    return Span(name, int(start_ms * MS), int(end_ms * MS), parent, attrs)


def _readings():
    """Set-up (spans 0-4): geometry, a first call whose prepare builds
    the mass solver, the kernels' build inside it; the profiled stretch
    (5-6); the unprofiled one (7-17): two calls, each a prepare and a
    chunk, the second chunk building the device form inside its
    enqueue."""
    sp = [
        _span("setup.geometry", 0, 100),                         # 0
        _span("scan.call", 100, 400, steps=4),                   # 1
        _span("scan.prepare", 100, 350, 1),                      # 2
        _span("setup.mass_solver", 110, 340, 2, region="inside"),  # 3
        _span("setup.kernels", 120, 200, 3),                     # 4
        _span("scan.call", 1000, 1100, steps=4),                 # 5
        _span("scan.prepare", 1000, 1040, 5),                    # 6
        _span("scan.call", 2000, 2100),                          # 7
        _span("scan.prepare", 2000, 2020, 7),                    # 8
        _span("scan.chunk", 2020, 2100, 7, steps=2),             # 9
        _span("scan.enqueue", 2020, 2050, 9),                    # 10
        _span("scan.read", 2050, 2100, 9),                       # 11
        _span("scan.call", 3000, 3200),                          # 12
        _span("scan.prepare", 3000, 3030, 12),                   # 13
        _span("scan.chunk", 3030, 3200, 12, steps=2),            # 14
        _span("scan.enqueue", 3030, 3150, 14),                   # 15
        _span("setup.device_form", 3040, 3100, 15),              # 16
        _span("scan.read", 3150, 3200, 14),                      # 17
    ]
    counters = {"setup": {"k2.band_iterations": 50},
                "profiled": {"k2.band_iterations": 400,
                             "k2.fsai_iterations": 0, "solves": 8},
                "unprofiled": {"k2.band_iterations": 360,
                               "k2.fsai_iterations": 40, "solves": 8}}
    p = types.SimpleNamespace(spans=sp, setup=5, profiled=(5, 7),
                              unprofiled=(7, len(sp)), counters=counters,
                              base_ns=0)
    k2 = "void resident_cg_kernel<float, 6, 2>(Params)"
    kernels = [(k2, 0.0, 3000.0, "kernel"),
               ("void resident_cg_kernel<float, 6, 1>(Params)", 3000.0,
                500.0, "kernel"),
               ("elementwise", 4000.0, 10.0, "kernel")]
    t = types.SimpleNamespace(steps=4, kernels=kernels, records=kernels)
    return t, p


def test_counter_readers():
    t, p = _readings()
    assert tool.solve_iterations_per_step(t, p) == 100.0
    # 3000 us of one-band K2 over the 400 one-band iterations
    assert tool.k2_us_per_iteration(t, p) == pytest.approx(7.5)
    p.counters["profiled"] = {}
    p.counters["unprofiled"] = {}
    assert tool.k2_us_per_iteration(t, p) is None
    assert tool.solve_iterations_per_step(t, p) is None


def test_chunk_loop_readers():
    t, p = _readings()
    # enqueue 30 + (120 - 60 of the device form) ms over 4 steps
    assert tool.host_enqueue_ms_per_step(t, p) == pytest.approx(90 / 4)
    assert tool.read_wait_ms_per_step(t, p) == pytest.approx(100 / 4)
    # prepares 20 + 30 ms and the device form's 60, over 2 calls
    assert tool.scan_prepare_ms_per_call(t, p) == pytest.approx(55)
    p.unprofiled = (len(p.spans), len(p.spans))
    for f in (tool.host_enqueue_ms_per_step, tool.read_wait_ms_per_step,
              tool.scan_prepare_ms_per_call):
        assert f(t, p) is None


def test_setup_mass_solvers():
    """The build's 230 ms less the 80 ms of the kernels' build in it."""
    t, p = _readings()
    assert tool.setup_mass_solvers_s(t, p) == pytest.approx(0.15)
    p.setup = 1
    assert tool.setup_mass_solvers_s(t, p) is None


def test_gaps_named_by_the_innermost_open_span():
    """Device records at 0-10 and 15-20 ms, then 45 ms: the first gap
    lies inside a call's prepare, the second crosses the call's end."""
    sp = [_span("scan.call", 0, 30),
          _span("scan.prepare", 5, 18, 0),
          _span("setup.mass_solver", 6, 9, 1)]
    p = types.SimpleNamespace(spans=sp, profiled=(0, 3), base_ns=0)
    offset = profiling.to_trace_us(0, 0)      # perf_counter 0 on the trace
    recs = [("a", offset + 0.0, 10_000.0, "kernel"),
            ("b", offset + 15_000.0, 5_000.0, "kernel"),
            ("c", offset + 45_000.0, 1_000.0, "kernel")]
    t = types.SimpleNamespace(records=recs)
    gaps = tool.named_gaps(t, p)
    assert [g[0] for g in gaps] == ["no span | after b",
                                    "scan.prepare | after a"]
    assert [g[1] for g in gaps] == pytest.approx([0.025, 0.005])


def test_program_readings_split_the_counters():
    marks = {"spans": [_span("a", 0, 1)] * 4, "first": 1, "mid": 3,
             "base_ns": 7,
             "counters": [{"solves": 2}, {"solves": 6, "fallbacks": 1},
                          {"solves": 9, "fallbacks": 1}]}
    p = tool.program_readings(marks)
    assert (p.setup, p.profiled, p.unprofiled) == (1, (1, 3), (3, 4))
    assert p.counters["profiled"] == {"solves": 4, "fallbacks": 1}
    assert p.counters["unprofiled"] == {"solves": 3, "fallbacks": 0}
