"""The self-verifying mass solver (gdm_torch/cut/fsai.py
verified_fsai_solver) against gdm's, in float32 on CPU at 24^2.

Both run the same algorithm: a setup probe of the one-launch FSAI-CG on
np.random.default_rng(0) data, routing to the streamed Schwarz-CG when
its true residual misses 10 x the tolerance, and a per-solve true
residual check with a streamed rerun.  gdm runs its Pallas kernel in
interpret mode; the port runs its kernels' plain versions.  Routing must
agree; answers agree to f32-CG accuracy (1e-4 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gdm.cut.fsai import verified_fsai_solver as g_verified
from gdm.cut.geometry import INSIDE, CutGeometry
from gdm.cut.operators import CutOperators
from gdm.cut.stencil import assemble_stencil
from gdm.grid import Grid

from gdm_torch.cut.fsai import verified_fsai_solver
from gdm_torch.interop import stencil_from


@pytest.fixture(scope="module")
def mass24():
    grid = Grid(3, (24, 24), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 1.0, 3)
    op = CutOperators(geo, INSIDE)
    st = assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))
    return st, stencil_from(st), op.w_cut


def _rhs(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _port_solve(vs, b, dtype=torch.float32):
    x, info = vs.solve_padded_with_info(
        vs.layout.pad(torch.as_tensor(b, dtype=dtype)))
    return vs.layout.unpad(x).double().numpy(), info


def _residual(st, x, b):
    """||M x - b|| / ||b|| in float64.  A float32 CG that stopped at
    rel 1e-6 on its recurrence lands near 1e-4 on this cut mass (gdm's
    own detection test allows the same f32 slack)."""
    return (np.linalg.norm(st.apply(torch.as_tensor(x)).numpy() - b)
            / np.linalg.norm(b))


def test_healthy_system_keeps_resident_path(mass24):
    gst, tst, win = mass24
    kw = dict(windows=win, max_iter=60, rel_tol=1e-5)
    vg = g_verified(gst, interpret=True, **kw)
    vt = verified_fsai_solver(tst, device="cpu", dtype=torch.float32, **kw)
    assert vt.path == vg.path == "resident-verified"
    assert vt.probe["ok"] is True and vg.probe["ok"] is True
    assert abs(vt.probe["iterations"] - vg.probe["iterations"]) <= 1
    b = _rhs(0, tst.grid.n_nodes)
    xt, info = _port_solve(vt, b)
    xg, ginfo = vg.solve_with_info(jnp.asarray(b))
    assert info["fallback"] is False and not bool(ginfo["fallback"])
    assert vt.fallback_count == 0
    assert 0 < info["iterations"] <= 60
    assert info["residual"] <= 10.0 * 1e-5 * np.linalg.norm(b)
    xg = np.asarray(xg, np.float64)
    assert np.linalg.norm(xt - xg) <= 1e-4 * np.linalg.norm(xg)


def test_probe_routes_crippled_resident_to_streamed(mass24):
    gst, tst, win = mass24
    kw = dict(windows=win, max_iter=200, rel_tol=1e-6, resident_max_iter=1)
    vg = g_verified(gst, interpret=True, **kw)
    vt = verified_fsai_solver(tst, device="cpu", dtype=torch.float32, **kw)
    assert vt.path == vg.path == "streamed"
    assert vt.probe["ok"] is False and vt.probe["reason"] == "probe"
    assert vt.probe["iterations"] == 1
    b = _rhs(2, tst.grid.n_nodes)
    xt, info = _port_solve(vt, b)
    assert info["fallback"] is False and vt.fallback_count == 0
    assert _residual(tst, xt, b) <= 1e-4


def test_per_solve_check_falls_back(mass24):
    gst, tst, win = mass24
    kw = dict(windows=win, max_iter=200, rel_tol=1e-6, probe=False,
              resident_max_iter=2)
    vg = g_verified(gst, interpret=True, **kw)
    vt = verified_fsai_solver(tst, device="cpu", dtype=torch.float32, **kw)
    assert vt.path == vg.path == "resident-verified"
    assert vt.probe == {"ok": True, "reason": "probe-disabled"}
    b = _rhs(1, tst.grid.n_nodes)
    _, ginfo = vg.solve_with_info(jnp.asarray(b))
    xt, info = _port_solve(vt, b)
    assert info["fallback"] is True and bool(ginfo["fallback"])
    assert vt.fallback_count == 1
    assert info["iterations"] == 2 and info["fallback_iterations"] > 0
    assert _residual(tst, xt, b) <= 1e-4
    # the streamed answer is the answer: a second solve falls back again
    _port_solve(vt, b)
    assert vt.fallback_count == 2


def test_float64_resident_path(mass24):
    _, tst, win = mass24
    vt = verified_fsai_solver(tst, windows=win, max_iter=40, rel_tol=1e-5,
                              device="cpu", dtype=torch.float64)
    assert vt.path == "resident-verified"
    b = _rhs(3, tst.grid.n_nodes).astype(np.float64)
    xt, info = _port_solve(vt, b, torch.float64)
    assert info["fallback"] is False
    assert _residual(tst, xt, b) <= 1e-5
