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
  no kernel).
"""

import json
import os
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
