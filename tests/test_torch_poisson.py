"""The uncut Poisson slice as a whole: gdm_torch.problems.poisson.solve
against gdm.problems.poisson.solve under x64, on the CPU.

The problem is -Laplace(u) = f on the unit square/cube with zero
Dirichlet data and the manufactured solution prod_d sin(pi x_d), solved
to rel_tol 1e-10 with Jacobi- and multigrid-preconditioned CG.  The CG
iteration counts must be equal (47/7 at 32^2, 85/7 at 64^2, 30/8 at
16^3 for jacobi/mg) and the solutions within 1e-10 relative.
"""

import numpy as np
import pytest
import torch

from gdm.grid import Grid as GGrid
from gdm.problems import poisson as gpoisson

from gdm_torch.grid import Grid
from gdm_torch.multigrid import PoissonMultigrid
from gdm_torch.ops.tensor import l2_error
from gdm_torch.problems import poisson

EXPECTED_ITERATIONS = {
    ((32, 32), "jacobi"): 47, ((32, 32), "mg"): 7,
    ((64, 64), "jacobi"): 85, ((64, 64), "mg"): 7,
    ((16, 16, 16), "jacobi"): 30, ((16, 16, 16), "mg"): 8,
}


def rhs(m, c):
    v = len(m) * np.pi**2
    for x in m:
        v = v * np.sin(np.pi * x)
    return v


def exact(m, c):
    v = 1.0
    for x in m:
        v = v * np.sin(np.pi * x)
    return v


def _grid(cls, cells, p=3):
    return cls(p, cells, (0.0,) * len(cells), (1.0,) * len(cells))


@pytest.fixture(scope="module")
def gdm_solutions():
    """gdm's solves, once per module (2.5-6 s each on a CPU core)."""
    out = {}
    for cells, pre in EXPECTED_ITERATIONS:
        x, info = gpoisson.solve(_grid(GGrid, cells), rhs, rel_tol=1e-10,
                                 precondition=pre)
        out[cells, pre] = (np.asarray(x), int(info["iterations"]))
    return out


@pytest.mark.parametrize("cells,pre", list(EXPECTED_ITERATIONS))
def test_solve_matches_gdm(gdm_solutions, cells, pre):
    gx, giters = gdm_solutions[cells, pre]
    assert giters == EXPECTED_ITERATIONS[cells, pre]
    grid = _grid(Grid, cells)
    x, info = poisson.solve(grid, rhs, rel_tol=1e-10, precondition=pre,
                            device="cpu")
    assert info["iterations"] == giters
    assert x.shape == grid.field_shape and x.dtype == torch.float64
    assert np.linalg.norm(x.numpy() - gx) <= 1e-10 * np.linalg.norm(gx)


def test_convergence_rate_p3():
    errs = []
    for n in (8, 16, 32):
        grid = _grid(Grid, (n, n))
        x, info = poisson.solve(grid, rhs, device="cpu")  # jacobi, 1e-12
        assert info["iterations"] < 10000
        errs.append(l2_error(x, grid, exact))
    rates = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
    assert np.all(rates > 3.5), rates


def test_prebuilt_and_unpreconditioned():
    grid = _grid(Grid, (16, 16))
    mg = PoissonMultigrid(grid, "cpu")
    x_mg, i_mg = poisson.solve(grid, rhs, rel_tol=1e-10,
                               precondition=mg.precondition, device="cpu")
    x_ref, i_ref = poisson.solve(grid, rhs, rel_tol=1e-10, precondition="mg",
                                 device="cpu")
    assert i_mg == i_ref and torch.equal(x_mg, x_ref)
    x_none, i_none = poisson.solve(grid, rhs, rel_tol=1e-10,
                                   precondition="none", device="cpu")
    assert i_none["iterations"] > i_mg["iterations"]
    assert ((x_none - x_ref).norm() / x_ref.norm()).item() <= 1e-8
    with pytest.raises(ValueError, match="unknown precondition"):
        poisson.solve(grid, rhs, precondition="ilu", device="cpu")


def test_float32_on_cpu_within_one_iteration():
    grid = _grid(Grid, (32, 32))
    x64, i64 = poisson.solve(grid, rhs, rel_tol=1e-4, precondition="mg",
                             device="cpu")
    x32, i32 = poisson.solve(grid, rhs, rel_tol=1e-4, precondition="mg",
                             device="cpu", dtype=torch.float32)
    assert x32.dtype == torch.float32
    assert abs(i32["iterations"] - i64["iterations"]) <= 1
    assert ((x32.double() - x64).norm() / x64.norm()).item() <= 1e-4


def _bump(pts):
    x, y = pts[:, 0], pts[:, 1]
    s = 0.06 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)
    return np.stack([x + s, y + 0.7 * s], -1)


def test_solve_deformed_matches_gdm():
    """The deformed solve (gdm_torch.deform's condensed band, Jacobi CG)
    at 8^2: gdm's iterations and solution within 1e-10."""
    u, info = poisson.solve_deformed(_grid(Grid, (8, 8)), _bump, rhs,
                                     device="cpu")
    ug, ginfo = gpoisson.solve_deformed(_grid(GGrid, (8, 8)), _bump, rhs)
    ug = np.asarray(ug)
    assert info["iterations"] == int(ginfo["iterations"])
    assert u.shape == ug.shape == (9, 9, 1)
    assert np.abs(u.numpy() - ug).max() <= 1e-10 * np.abs(ug).max()
