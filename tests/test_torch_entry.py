"""The slice as a whole: gdm_torch.entry, one RK4 step of the flagship
cut-wave solver, against a gdm x64 step composed here from the same
pieces (assemble_stencil, solvers.cg with the FSAI preconditioner,
StencilOperator.apply, timestepping.rk_step) on the same u0, dt and
forcing.

gdm's own ``__graft_entry__.entry`` is not the oracle: its CPU branch
solves the mass with a Jacobi CG capped at 30 iterations that does not
converge on this cut mass, while its device branch (the one ported)
uses the verified FSAI-CG.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.special
import torch

import jax.numpy as jnp
from gdm import solvers, timestepping
from gdm.cut.fsai import fsai_preconditioner
from gdm.cut.geometry import INSIDE, CutGeometry
from gdm.cut.operators import CutOperators
from gdm.cut.stencil import assemble_stencil
from gdm.grid import Grid

import gdm_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WN = 3.0 * np.pi


def _gdm_step(n, u0, v0, t, dt, rel_tol):
    """One RK4 step of the flagship problem in gdm (x64); returns
    (u, v, CG iteration counts of the four mass solves)."""
    p = 3
    grid = Grid(p, (n, n), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 1.0, p)
    op = CutOperators(geo, INSIDE)
    ga, gn = 0.5 * np.sqrt(3.0), 5.0 * p
    M = assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))
    S = assemble_stencil(op, "stiff", ga, gn, with_nitsche=True, gp_power=1,
                         inactive_identity=False)
    F = op.compute_rhs(
        jnp.zeros(grid.n_nodes), 0.0, False,
        interface_dbc=lambda pts, t: jnp.asarray(scipy.special.j0(
            WN * np.linalg.norm(np.asarray(pts), axis=-1))),
        gamma_A=ga, nitsche_gamma=gn)
    pre = fsai_preconditioner(M)
    its = []

    def f(t, y):
        u, v = y
        x, info = solvers.cg(M.apply, F * jnp.cos(WN * t) - S.apply(u),
                             precond=pre, abs_tol=1e-12, rel_tol=rel_tol,
                             max_iter=40 if rel_tol >= 1e-5 else 1000)
        its.append(int(info["iterations"]))
        return (v, x)

    u, v = timestepping.rk_step(f, t, dt, (jnp.asarray(u0), jnp.asarray(v0)))
    return np.asarray(u), np.asarray(v), its


@pytest.fixture(scope="module")
def step24():
    step, (t, dt, u0, v0) = gdm_torch.entry(24, device="cpu",
                                            dtype=torch.float64)
    vs = step.mass_solver
    its = []
    solve = vs.solve_padded_with_info

    def recording(b):
        x, info = solve(b)
        its.append(info["iterations"])
        return x, info

    vs.solve_padded_with_info = recording  # solve_padded routes here
    u, v = step(t, dt, u0, v0)
    return {"step": step, "t": t, "dt": dt, "u0": u0.numpy(),
            "v0": v0.numpy(), "u": u.numpy(), "v": v.numpy(), "its": its}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_matches_gdm_step(step24):
    s = step24
    u, v, its = _gdm_step(24, s["u0"], s["v0"], s["t"], s["dt"], 1e-5)
    assert _rel(s["u"], u) <= 1e-10
    assert _rel(s["v"], v) <= 1e-10
    assert s["its"] == its == [7, 7, 8, 8]


def test_close_to_converged_step(step24):
    s = step24
    u, v, _ = _gdm_step(24, s["u0"], s["v0"], s["t"], s["dt"], 1e-13)
    assert _rel(s["u"], u) <= 1e-4
    assert _rel(s["v"], v) <= 1e-4


def test_routing_and_state(step24):
    step = step24["step"]
    assert step.mass_solver.path == "resident-verified"
    assert step.mass_solver.probe["ok"] is True
    assert step.mass_solver.fallback_count == 0
    assert step24["u"].shape == step24["v"].shape == (25 * 25,)
    assert np.isfinite(step24["u"]).all() and np.isfinite(step24["v"]).all()
    assert step.layout.shape == (33, 36)


def test_float32_step_close_to_float64(step24):
    s = step24
    step, (t, dt, u0, v0) = gdm_torch.entry(24, device="cpu",
                                            dtype=torch.float32)
    assert np.array_equal(u0.numpy(), s["u0"].astype(np.float32))
    u, v = step(t, dt, u0, v0)
    assert u.dtype == torch.float32
    assert _rel(u.double().numpy(), s["u"]) <= 1e-4
    assert _rel(v.double().numpy(), s["v"]) <= 1e-4


def test_port_imports_without_jax():
    code = ("import importlib, pkgutil, sys, gdm_torch; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "gdm_torch.__path__, 'gdm_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "need = {'gdm_torch.problems.advection', "
            "'gdm_torch.cut.advection', 'gdm_torch.checkpoint', "
            "'gdm_torch.apps.advection_app', "
            "'gdm_torch.apps.advection_convergence', "
            "'gdm_torch.problems.wave', 'gdm_torch.entry', "
            "'gdm_torch.deform', 'gdm_torch.tools.eigen', "
            "'gdm_torch.tools.wave_ev', 'gdm_torch.dist.mesh', "
            "'gdm_torch.dist.halo', 'gdm_torch.dist.cut', "
            "'gdm_torch.dist.poisson', 'gdm_torch.dist.dryrun', "
            "'gdm_torch.profiling'}; "
            "assert need <= set(mods), need - set(mods); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'gdm.')) or m == 'gdm']; "
            "assert not bad, bad; print(len(mods))")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
