"""The port's ``AdvectionProblem(mesh=...)`` against the port's serial
runs and gdm's sharded runs under x64, on the CPU in float64, at the
cases of gdm's tests/test_distributed_cut.py:

- the cut advection convergence case (p = 3, 12 cells, 4 steps) with
  its mass solves over 8 slots, through ``run()``;
- the composite case cut to 12 cells a side at p = 3 (3 steps) over 4
  slots, through ``run_scan``.

Each run's six-column rows (L2, L1, Linf and their surface norms) lie
within rtol 1e-10 of the port's serial run and of gdm's sharded run,
counters and times equal; the mesh route builds no verified solver (the
Schwarz-Jacobi CG over the sharded apply).
"""

import numpy as np
import pytest
import torch

from gdm.dist.mesh import device_mesh as g_device_mesh
from gdm.problems import advection as gadv

from gdm_torch.dist.mesh import device_mesh
from gdm_torch.problems import advection as adv

F64 = torch.float64


def _convergence(mod):
    p = mod.convergence_case(3, 12, 0.4, 0.0, 5.0)
    p.end_t = 4 * (1.0 / 12) * 0.4 / 2.0  # 4 steps
    return p


def _composite(mod):
    p = mod.composite_app_case()
    p.n_subdivisions_1D = 12
    p.fe_degree = 3
    p.end_t = 3 * (2.0 / 12) * 0.2 / 4.0  # 3 steps
    return p


# name: (params, slots, entry point)
CASES = {"convergence-run": (_convergence, 8, "run"),
         "composite-run_scan": (_composite, 4, "run_scan")}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    make, ndev, entry = CASES[request.param]
    serial = adv.AdvectionProblem(make(adv), device="cpu", dtype=F64)
    sharded = adv.AdvectionProblem(make(adv), device="cpu", dtype=F64,
                                   mesh=device_mesh(ndev, device="cpu"))
    gsharded = gadv.AdvectionProblem(make(gadv), mesh=g_device_mesh(ndev))
    for prob in (serial, sharded, gsharded):
        getattr(prob, entry)()
    return {"serial": serial, "sharded": sharded, "gdm": gsharded,
            "ndev": ndev}


def _slots(prob):
    return [s for s in (0, 1) if prob.rows[s]]


def _rows_close(rows1, rows0):
    assert len(rows1) == len(rows0) > 2
    for r0, r1 in zip(rows0, rows1):
        assert r0[0] == r1[0]
        assert r1[1] == pytest.approx(r0[1], abs=1e-12)
        np.testing.assert_allclose(r1[2:], r0[2:], rtol=1e-10, atol=1e-16)


@pytest.mark.parametrize("ref", ["serial", "gdm"])
def test_advection_mesh_rows(runs, ref):
    sharded, other = runs["sharded"], runs[ref]
    assert _slots(sharded) == _slots(other)
    for s in _slots(sharded):
        assert len(sharded.rows[s][0]) == 8
        _rows_close(sharded.rows[s], other.rows[s])


def test_advection_mesh_route(runs):
    sharded = runs["sharded"]
    assert sharded._solver_meta == []
    assert sharded.mesh.size == runs["ndev"]
    assert all(callable(s) for s in sharded.mass_solvers)
