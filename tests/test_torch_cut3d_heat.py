"""The port's 3D cut implicit heat against gdm under x64, on the CPU in
float64: the configuration of gdm's tests/test_cut_3d_heat.py (p = 3,
8^3 cells, the unit sphere, heat-impl to t = 0.1 with the manufactured
solution u = x^2 y^2 z^2 e^{-t}), gdm's only 3D cut time loop and the
oracle's case ``heat_impl_3d``.

- ``run()``'s rows against live gdm's ``run()`` within 1e-10 in the
  scaled measure (max |port - gdm| / max |gdm| per column of L2, L1 and
  Linf), counters and times equal, the t = 0 row exact;
- the same rows against gdm's ``PINNED`` rows at gdm's rel 1e-6;
- against ``tests/data/cpu_oracle_rows.json["heat_impl_3d"]`` (written
  by gdm's ``run_scan``, whose implicit solves start warm): within the
  gap of live gdm's own ``run()`` to that row plus 1e-10;
- the route: gdm's CPU branch, a host streamed FSAI-CG over the
  matrix-free M + dt S ("resident-unavailable"), one solver a step
  size.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.problems import wave as gwave

from gdm_torch.problems import wave

ORACLE = os.path.join(os.path.dirname(__file__), "data",
                      "cpu_oracle_rows.json")
PINNED = [
    (1, 0.09075, 5.264570369398583e-06, 9.5357088993718e-06,
     5.587360439521603e-06),
    (2, 0.1, 4.434726063186262e-06, 8.074405449410244e-06,
     4.2577020407609275e-06),
]


def heat3d_params(mod):
    """gdm's tests/test_cut_3d_heat.py::_params, for gdm's module or the
    port's (data functions on numpy, jax or torch points)."""
    p = mod.WaveParams(dim=3)
    p.simulation_type = "heat-impl"
    p.fe_degree = 3
    p.n_subdivisions_1D = 8
    p.ghost_parameter_M = 0.75
    p.ghost_parameter_A = 1.5
    p.nitsche_parameter = 15.0
    p.level_set_function = mod.sphere_signed_distance
    p.cfl = 0.3
    p.cfl_pow = 1.0
    p.end_t = 0.1

    def exp(t):
        return float(np.exp(-t)) if isinstance(t, float) else jnp.exp(-t)

    def g(pts, t):
        return (pts[..., 0] ** 2 * pts[..., 1] ** 2 * pts[..., 2] ** 2
                * exp(t))

    def f(pts, t):
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        return (-(x * y * z) ** 2
                - 2 * (y * y * z * z + x * x * z * z + x * x * y * y)
                ) * exp(t)

    p.function_interface_dbc = g
    p.function_rhs = f
    p.exact_solution = g
    return p


def scaled(rows, ref):
    a = np.array([r[2:5] for r in rows], np.float64)
    b = np.array([r[2:5] for r in ref], np.float64)
    return float((np.abs(a - b) / np.abs(b).max(axis=0)).max())


@pytest.fixture(scope="module")
def runs():
    port = wave.WaveProblem(heat3d_params(wave), verbose=False,
                            device="cpu", dtype=torch.float64)
    port.run()
    gdm = gwave.WaveProblem(heat3d_params(gwave), verbose=False)
    gdm.run()
    return port, gdm


def test_heat3d_rows_match_gdm(runs):
    port, gdm = runs
    rows, grows = port.rows[0], gdm.rows[0]
    assert len(rows) == len(grows) == 3
    assert rows[0][2] < 1e-15
    for r, g in zip(rows, grows):
        assert r[0] == g[0] and r[1] == pytest.approx(g[1], abs=1e-12)
    assert scaled(rows, grows) <= 1e-10


def test_heat3d_rows_match_pinned(runs):
    rows = runs[0].rows[0]
    for got, want in zip(rows[1:], PINNED):
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], abs=1e-12)
        for k in (2, 3, 4):
            assert got[k] == pytest.approx(want[k], rel=1e-6)


def test_heat3d_rows_against_oracle(runs):
    port, gdm = runs
    with open(ORACLE) as f:
        oracle = json.load(f)["heat_impl_3d"]["rows"]
    gap = scaled(gdm.rows[0], oracle)
    assert gap <= 5e-8
    assert scaled(port.rows[0], oracle) <= gap + 1e-10


def test_heat3d_route(runs):
    port = runs[0]
    assert len(port.heat_solvers) == 2       # the step and the short last
    for solve in port.heat_solvers.values():
        assert solve.path == "streamed"
        assert solve.probe["reason"] == "resident-unavailable"
