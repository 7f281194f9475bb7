"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped: ``harness.run_cell`` drives
the rest of a run on the CPU at a small size of each configuration
(float32, as the cells), once sound and once with each fault that such
a cell can have planted in the port under it:

* a step that returns its state unchanged;
* half of the batch left out: one of the two regions' mass solves gives
  nothing (the composite problem; the wave problem has one region);
* an answer altered where it is produced: the state a chunk hands on
  scaled by 1 + 1e-3.

No cell runs across chips, so no exchange can be left out.
"""

import pytest

from portbench import harness

SMALL = {"dod.early": (dict(n_subdivisions_1D=12, fe_degree=3),
                       dict(segment_steps=4, chunk=2)),
         "dod.late": (dict(n_subdivisions_1D=12, fe_degree=3),
                      dict(start_step=4, start_chunk=2, segment_steps=4,
                           chunk=2)),
         "wave2d.sim": (dict(n_subdivisions_1D=16, end_t=0.25),
                        dict(chunk=5))}


def run(name):
    cell = harness.load_cell(name)
    cfg, traffic = SMALL[name]
    cell.cfg.update(cfg)
    cell.traffic.update(traffic)
    result, compared = harness.run_cell(cell, 2**31 + 11, 0.2, False, "cpu")
    return result, compared


def _unchanged(monkeypatch):
    import gdm_torch.timestepping as ts

    monkeypatch.setattr(ts, "rk_step", lambda f, t, dt, y, *a, **k: y)


def _one_region_left_out(monkeypatch):
    import torch

    from gdm_torch.problems.advection import AdvectionProblem

    build = AdvectionProblem._mass_solver

    def mass_solver(self, op):
        solve = build(self, op)
        return (lambda b: torch.zeros_like(b)) if op is self.op_out \
            else solve

    monkeypatch.setattr(AdvectionProblem, "_mass_solver", mass_solver)


def _altered(monkeypatch):
    from gdm_torch.problems import scan

    chunk = scan.scan_chunk

    def scan_chunk(*a, **k):
        y, rows = chunk(*a, **k)
        scale = lambda u: u * (1 + 1e-3)  # noqa: E731
        return (tuple(map(scale, y)) if isinstance(y, tuple)
                else scale(y)), rows

    monkeypatch.setattr(scan, "scan_chunk", scan_chunk)
    from gdm_torch.problems.advection import AdvectionProblem
    from gdm_torch.problems.wave import WaveProblem

    monkeypatch.setattr(AdvectionProblem, "_scan_chunk",
                        staticmethod(scan_chunk))
    monkeypatch.setattr(WaveProblem, "_scan_chunk", staticmethod(scan_chunk))


FAULTS = {"unchanged": _unchanged, "one_region_left_out": _one_region_left_out,
          "altered": _altered}
CASES = [(n, f) for n in SMALL for f in FAULTS
         if not (f == "one_region_left_out" and n == "wave2d.sim")]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    result, compared = run(name)
    assert result["correct"] and result["failed"] == 0, compared


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_run_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, compared = run(name)
    assert not result["correct"] and result["failed"] >= 1, compared
