"""gdm_torch.solvers and gdm_torch.timestepping against gdm (x64).

CG keeps deal.II's ReductionControl rule, so on the same SPD system in
float64 the iteration counts are equal and x agrees to 1e-10; RK steps
and the DiscreteTime sequence agree to roundoff.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gdm import solvers as gsolvers, timestepping as gts

from gdm_torch import solvers, timestepping


def _spd(n=60, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n), rng.standard_normal(n)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_gdm(precond):
    A, b = _spd()
    d = np.diag(A).copy()
    xt, it = solvers.cg(
        lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b),
        precond=solvers.jacobi_preconditioner(torch.as_tensor(d))
        if precond else None, max_iter=200, rel_tol=1e-10)
    xg, ig = gsolvers.cg(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
        precond=gsolvers.jacobi_preconditioner(jnp.asarray(d))
        if precond else None, max_iter=200, rel_tol=1e-10)
    assert it["iterations"] == int(ig["iterations"]) > 0
    xg = np.asarray(xg)
    assert np.linalg.norm(xt.numpy() - xg) <= 1e-10 * np.linalg.norm(xg)
    assert it["residual"] == pytest.approx(float(ig["residual"]), rel=1e-6)


def test_cg_stops_at_max_iter_and_abs_tol():
    A, b = _spd(seed=1)
    apply = lambda v: torch.as_tensor(A) @ v  # noqa: E731
    _, info = solvers.cg(apply, torch.as_tensor(b), max_iter=3)
    assert info["iterations"] == 3
    _, info = solvers.cg(apply, torch.as_tensor(b), abs_tol=1e30)
    assert info["iterations"] == 0


def test_jacobi_zero_diagonal_is_identity():
    pre = solvers.jacobi_preconditioner(torch.tensor([2.0, 0.0, 4.0]))
    assert pre(torch.ones(3)).tolist() == [0.5, 1.0, 0.25]


@pytest.mark.parametrize("name", sorted(timestepping.TABLEAUX))
def test_rk_step_matches_gdm(name):
    def f_t(t, y):
        u, v = y
        return (v, -4.0 * u + np.sin(t))

    def f_g(t, y):
        u, v = y
        return (v, -4.0 * u + jnp.sin(t))

    rng = np.random.default_rng(2)
    u0, v0 = rng.standard_normal(5), rng.standard_normal(5)
    ut, vt = timestepping.rk_step(
        f_t, 0.3, 0.05, (torch.as_tensor(u0), torch.as_tensor(v0)),
        timestepping.TABLEAUX[name])
    ug, vg = gts.rk_step(f_g, 0.3, 0.05, (jnp.asarray(u0), jnp.asarray(v0)),
                         gts.TABLEAUX[name])
    np.testing.assert_allclose(ut.numpy(), np.asarray(ug), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vg), rtol=1e-14,
                               atol=1e-15)


def test_discrete_time_and_loop_match_gdm():
    seen_t, seen_g = [], []
    yt = timestepping.time_loop(
        lambda t, y: (-y[0],), (torch.ones(2, dtype=torch.float64),),
        0.0, 1.0, 0.3, callback=lambda t, y: seen_t.append(t))
    yg = gts.time_loop(lambda t, y: (-y[0],), (jnp.ones(2),), 0.0, 1.0, 0.3,
                       callback=lambda t, y: seen_g.append(t))
    assert seen_t == seen_g and seen_t[-1] == 1.0
    np.testing.assert_allclose(yt[0].numpy(), np.asarray(yg[0]), rtol=1e-14)
