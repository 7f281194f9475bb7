"""The uncut modules of the PyTorch port against gdm under x64.

Tensor-product operators (apply_banded, SeparableOperator), the
evaluate/integrate pair, the load vector and L2 error, constraints, the
multigrid transfers and the Poisson multigrid preconditioner, all in
float64 on the CPU with the same numpy inputs given to both packages.
Tolerances: applies and integrals within 1e-12 relative (float sums in
another order), constraints exactly equal (masking and plane copies
only), transfers within 1e-14 (the same slice multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdm.constraints as gcons
import gdm.functional as gfunc
import gdm.multigrid as gmg
import gdm.operators as gops
import gdm.ops.tensor as gtensor
from gdm.grid import Grid as GGrid

from gdm_torch import constraints, functional, multigrid, operators
from gdm_torch.grid import Grid
from gdm_torch.interop import separable_from
from gdm_torch.ops import tensor

F64 = torch.float64
GRIDS = {
    "1d": (3, (9,), (0.0,), (1.0,)),
    "2d": (3, (8, 11), (0.0, -1.0), (1.0, 2.0)),
    "3d": (3, (5, 6, 7), (0.0, 0.0, 0.0), (1.0, 2.0, 1.5)),
    "2d_p5": (5, (10, 12), (0.0, 0.0), (1.0, 1.0)),
}


def _grids(key, n_components=1):
    args = GRIDS[key]
    return Grid(*args, n_components), GGrid(*args, n_components)


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _field(grid, seed):
    return np.random.default_rng(seed).standard_normal(grid.field_shape)


@pytest.mark.parametrize("shape,axis", [((13,), 0), ((9, 12), 0),
                                        ((9, 12), 1), ((6, 7, 8), 2),
                                        ((6, 7, 8), 1)])
@pytest.mark.parametrize("p", [1, 3, 5])
def test_apply_banded(shape, axis, p):
    rng = np.random.default_rng(p)
    u = rng.standard_normal(shape)
    band = rng.standard_normal((shape[axis], 2 * p + 1))
    got = tensor.apply_banded(torch.as_tensor(u), torch.as_tensor(band),
                              axis)
    want = gtensor.apply_banded(jnp.asarray(u), jnp.asarray(band), axis)
    assert _rel(got, want) <= 1e-12


def _builders():
    return {
        "mass": (lambda g: operators.mass(g, device="cpu"), gops.mass, 1),
        "laplace": (lambda g: operators.laplace(g, device="cpu"),
                    gops.laplace, 1),
        "advection": (lambda g: operators.advection(
                          g, (0.7, -1.3, 0.4)[:g.dim], device="cpu"),
                      lambda g: gops.advection(g, (0.7, -1.3, 0.4)[:g.dim]),
                      1),
        "elasticity": (lambda g: operators.elasticity(g, device="cpu"),
                       gops.elasticity, None),
    }


@pytest.mark.parametrize("key", list(GRIDS))
@pytest.mark.parametrize("name", ["mass", "laplace", "advection",
                                  "elasticity"])
def test_separable_operator(name, key):
    build, gbuild, nc = _builders()[name]
    nc = nc or len(GRIDS[key][1])
    grid, ggrid = _grids(key, nc)
    op, gop = build(grid), gbuild(ggrid)
    u = _field(grid, 7)
    want = np.asarray(gop.apply(jnp.asarray(u)))
    assert _rel(op.apply(torch.as_tensor(u)), want) <= 1e-12
    # the same bands taken over from gdm's operator
    assert _rel(separable_from(gop, grid).apply(torch.as_tensor(u)),
                want) <= 1e-12
    assert _rel(op.diagonal(), gop.diagonal()) <= 1e-12


def test_separable_dense_and_batch():
    grid, ggrid = _grids("2d")
    op, gop = operators.laplace(grid, device="cpu"), gops.laplace(ggrid)
    assert _rel(op.dense(), gop.dense()) <= 1e-12
    U = np.random.default_rng(3).standard_normal((4,) + grid.field_shape)
    got = op.apply(torch.as_tensor(U))
    for i in range(4):
        assert _rel(got[i], np.asarray(gop.apply(jnp.asarray(U[i])))) <= 1e-12


def test_lumped_mass_inverse_diagonal():
    grid, ggrid = _grids("2d")
    assert _rel(operators.lumped_mass_inverse_diagonal(grid, device="cpu"),
                np.asarray(gops.lumped_mass_inverse_diagonal(ggrid))) <= 1e-12


@pytest.mark.parametrize("key", ["1d", "2d", "3d", "2d_p5"])
@pytest.mark.parametrize("derivs", ["values", "first"])
def test_evaluate_and_integrate(key, derivs):
    grid, ggrid = _grids(key)
    dv = (0,) * grid.dim if derivs == "values" else (1,) + (0,) * (
        grid.dim - 1)
    u = _field(grid, 11)
    got = tensor.evaluate_at_quad(torch.as_tensor(u), grid, dv)
    want = np.asarray(gtensor.evaluate_at_quad(jnp.asarray(u), ggrid, dv))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-12
    f = np.random.default_rng(12).standard_normal(want.shape)
    got = tensor.integrate_to_nodes(torch.as_tensor(f), grid, dv)
    want = np.asarray(gtensor.integrate_to_nodes(jnp.asarray(f), ggrid, dv))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-12


def _fn(m, c, t=None):
    v = np.cos(1.3 * m[0]) + 0.5 * c
    for x in m[1:]:
        v = v * np.sin(2.0 * x + 0.3)
    return v if t is None else v * (1 + t)


@pytest.mark.parametrize("key", ["1d", "2d", "3d"])
def test_load_vector_and_l2_error(key):
    grid, ggrid = _grids(key)
    got = functional.load_vector(grid, _fn, device="cpu")
    want = np.asarray(gfunc.load_vector(ggrid, _fn))
    assert _rel(got, want) <= 1e-12
    got_t = functional.load_vector(grid, _fn, t=0.5, device="cpu",
                                   dtype=torch.float32)
    assert got_t.dtype == torch.float32
    assert _rel(got_t, np.asarray(gfunc.load_vector(ggrid, _fn, t=0.5))) <= 1e-6
    u = _field(grid, 5)
    assert _rel(tensor.l2_error_squared_per_cell(torch.as_tensor(u), grid,
                                                 _fn),
                np.asarray(gtensor.l2_error_squared_per_cell(
                    jnp.asarray(u), ggrid, _fn))) <= 1e-12
    assert tensor.l2_error(torch.as_tensor(u), grid, _fn) == pytest.approx(
        gtensor.l2_error(jnp.asarray(u), ggrid, _fn), rel=1e-12)


@pytest.mark.parametrize("kind", ["zero_boundary", "periodic", "periodic1",
                                  "none"])
@pytest.mark.parametrize("key", ["2d", "3d"])
def test_constraints_exact(kind, key):
    grid, ggrid = _grids(key)
    if kind == "periodic1":
        c = constraints.Constraints.periodic(grid, axes=(1,), device="cpu")
        gc = gcons.Constraints.periodic(ggrid, axes=(1,))
    else:
        c = getattr(constraints.Constraints, kind)(grid, device="cpu")
        gc = getattr(gcons.Constraints, kind)(ggrid)
    assert np.array_equal(c.full_mask, gc.full_mask)
    u = _field(grid, 2)
    ut = torch.as_tensor(u)
    for name in ("distribute", "compress", "finalize_solution"):
        got = getattr(c, name)(ut)
        want = np.asarray(getattr(gc, name)(jnp.asarray(u)))
        assert np.array_equal(got.numpy(), want), name
    assert np.array_equal(ut.numpy(), u)  # arguments stay untouched
    A, gA = operators.laplace(grid, device="cpu"), gops.laplace(ggrid)
    got = c.constrain_operator(A.apply)(ut)
    want = np.asarray(gc.constrain_operator(gA.apply)(jnp.asarray(u)))
    assert _rel(got, want) <= 1e-12
    vals = _field(grid, 4)
    got = c.constrain_rhs(ut, A.apply, vals)
    want = np.asarray(gc.constrain_rhs(jnp.asarray(u), gA.apply,
                                       jnp.asarray(vals)))
    assert _rel(got, want) <= 1e-12
    assert np.array_equal(c.finalize_solution(ut, vals).numpy(),
                          np.asarray(gc.finalize_solution(jnp.asarray(u),
                                                          jnp.asarray(vals))))


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("axis", [0, 1])
def test_gd_transfers(p, axis):
    coarse = (8, 10)
    fine_cells = tuple(2 * c for c in coarse)
    gc, ggc = Grid(p, coarse, (0.0, 0.0), (1.0, 1.0)), GGrid(
        p, coarse, (0.0, 0.0), (1.0, 1.0))
    tab, off = multigrid._gd_mid_table(gc, axis)
    gtab, goff = gmg._gd_mid_table(ggc, axis)
    assert np.array_equal(tab, gtab) and np.array_equal(off, goff)
    rng = np.random.default_rng(p)
    uc = rng.standard_normal(gc.field_shape)
    n_fine = fine_cells[axis] + 1
    got = multigrid.gd_prolong_axis(torch.as_tensor(uc), axis, tab, off,
                                    n_fine)
    want = np.asarray(gmg.gd_prolong_axis(jnp.asarray(uc), axis, gtab, goff,
                                          n_fine))
    assert got.is_contiguous() and _rel(got, want) <= 1e-14
    shape = list(gc.field_shape)
    shape[axis] = n_fine
    yf = rng.standard_normal(shape)
    got = multigrid.gd_restrict_axis(torch.as_tensor(yf), axis, tab, off)
    want = np.asarray(gmg.gd_restrict_axis(jnp.asarray(yf), axis, gtab,
                                           goff))
    assert got.is_contiguous() and _rel(got, want) <= 1e-14
    with pytest.raises(ValueError, match="n_fine_nodes"):
        multigrid.gd_prolong_axis(torch.as_tensor(uc), axis, tab, off,
                                  n_fine + 1)


@pytest.fixture(scope="module", params=[(32, 32), (16, 16, 16)],
                ids=["32x32", "16x16x16"])
def mg_pair(request):
    cells = request.param
    lo, hi = (0.0,) * len(cells), (1.0,) * len(cells)
    ggrid = GGrid(3, cells, lo, hi)
    gmgr = gmg.PoissonMultigrid(ggrid)
    r = np.random.default_rng(9).standard_normal(ggrid.field_shape)
    r[ggrid.boundary_mask()] = 0.0
    want = np.asarray(gmgr.precondition(jnp.asarray(r)))
    return Grid(3, cells, lo, hi), gmgr, r, want


def test_multigrid_hierarchy_and_coarse_inverse(mg_pair):
    grid, gmgr, _, _ = mg_pair
    mg = multigrid.PoissonMultigrid(grid, "cpu")
    assert [lvl.grid.cells for lvl in mg.levels] == [
        lvl["grid"].cells for lvl in gmgr.levels]
    assert _rel(mg.coarse_inv, np.asarray(gmgr.coarse_inv)) <= 1e-12


def test_multigrid_precondition(mg_pair):
    grid, _, r, want = mg_pair
    mg = multigrid.PoissonMultigrid(grid, "cpu")
    rt = torch.as_tensor(r)
    got = mg.precondition(rt)
    assert _rel(got, want) <= 1e-12
    assert np.array_equal(rt.numpy(), r)  # the residual stays untouched


def test_multigrid_rejects_uncoarsenable():
    with pytest.raises(ValueError, match="cannot be coarsened"):
        multigrid.PoissonMultigrid(Grid(3, (9, 9), (0.0, 0.0), (1.0, 1.0)),
                                  "cpu")
