"""The port's cut multigrid (gdm_torch.cut.multigrid) and the step85
Poisson run against live gdm under x64, in float64 on the CPU.

- Every host piece equals gdm's: the CSR of a band, the prolongation P,
  the Galerkin coarse band (radius 5 at 20^2 cells, 117 nonzero taps)
  and each level's cut windows; each level's lambda_max estimate within
  1e-10; one V-cycle within 1e-12.
- MG-CG iteration counts (rel 1e-8, gdm's tests/test_cut_multigrid.py
  systems) equal gdm's at 40^2 for step85 and the implicit heat system,
  and equal the constants chip_smoke.py holds the card to; 80^2 and
  160^2 are in tests/test_torch_cut_multigrid_counts.py (gdm's solves
  there take 40 s and over a minute).
- A mistyped ``estimator`` raises ValueError (gdm takes it as "power").
- ``make_preset("step85", 2)`` with Jacobi CG and with ``"MG"`` (rel
  1e-12): iteration counts equal gdm's, L2 within 1e-3 of the
  reference's 8.5201e-9, the solution within 1e-10 of gdm's.  Its row is
  held within 1e-6 in the scaled measure, not 1e-10: the error norms
  (~1e-8) are differences of an O(1) solution from the exact one, so
  rounding at 1e-16 of the solution moves them by ~1e-8 relative.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdm.solvers as g_solvers
from gdm.cut import multigrid as gmg
from gdm.cut.geometry import INSIDE as G_INSIDE, CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import (StencilOperator as GStencilOperator,
                             assemble_stencil as g_assemble)
from gdm.grid import Grid as GGrid
from gdm.problems import wave as gwave

from gdm_torch import solvers
from gdm_torch.cut import multigrid as tmg
from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import StencilOperator, assemble_stencil
from gdm_torch.grid import Grid
from gdm_torch.problems import wave

F64 = torch.float64
GN, GA, GM, GA_HEAT = 15.0, 0.5, 0.75, 1.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ls(m):
    return np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - 1.0


@functools.lru_cache(maxsize=None)
def _systems(n):
    """(port ops, gdm ops) of the disc at n^2 cells."""
    args = (3, (n, n), (-1.21, -1.21), (1.21, 1.21))
    top = CutOperators(CutGeometry.build(Grid(*args), _ls, 3), INSIDE)
    gop = GCutOperators(GCutGeometry.build(GGrid(*args), _ls, 3), G_INSIDE)
    return top, gop


def _step85_rhs(gop):
    return gop.compute_rhs(
        jnp.zeros(gop.grid.n_nodes), 0.0, False,
        rhs_fn=lambda pts, t: jnp.full(pts.shape[:-1], 4.0),
        interface_dbc=lambda pts, t: jnp.full(pts.shape[:-1], 1.0),
        nitsche_gamma=GN)


@functools.lru_cache(maxsize=None)
def _mg40():
    top, gop = _systems(40)
    return (tmg.cut_poisson_multigrid(top, GA, GN, _ls, level_set_degree=3,
                                      device="cpu"),
            gmg.cut_poisson_multigrid(gop, GA, GN, _ls, level_set_degree=3))


def test_band_to_sparse_and_back():
    top, gop = _systems(40)
    st = assemble_stencil(top, "stiff", GA, GN, with_nitsche=True)
    gst = g_assemble(gop, "stiff", GA, GN, with_nitsche=True)
    a, ga = tmg._band_to_sparse(st), gmg._band_to_sparse(gst)
    assert (a != ga).nnz == 0 and a.nnz == ga.nnz
    back = tmg._sparse_to_band(a, top.grid)
    assert back.radius == 4
    np.testing.assert_array_equal(back.band_host, st.band_host)


def test_prolongation_and_windows():
    top, gop = _systems(40)
    fine, coarse = top.grid, Grid(3, (20, 20), (-1.21, -1.21), (1.21, 1.21))
    gfine, gcoarse = gop.grid, GGrid(3, (20, 20), (-1.21, -1.21),
                                     (1.21, 1.21))
    P, gP = (tmg._prolong_sparse(fine, coarse),
             gmg._prolong_sparse(gfine, gcoarse))
    assert P.shape == gP.shape == (41 * 41, 21 * 21)
    assert abs(P - gP).max() == 0.0
    for t, g in ((fine, gfine), (coarse, gcoarse)):
        np.testing.assert_array_equal(tmg._cut_windows(t, _ls, 3),
                                      gmg._cut_windows(g, _ls, 3))


def test_galerkin_hierarchy_and_estimates():
    """The Galerkin coarse band of the 40^2 step85 system: radius 5 and
    117 nonzero taps, equal to gdm's; each level's windows, block
    inverses and lambda_max as gdm's."""
    mg, g = _mg40()
    assert len(mg.levels) == len(g.levels) == 2
    coarse = mg.levels[1]["band"]
    assert coarse.radius == 5 and coarse.grid.nodes == (21, 21)
    taps = np.any(coarse.band_host.reshape(21 * 21, -1) != 0.0, axis=0)
    assert int(taps.sum()) == 117
    g_coarse = gmg._sparse_to_band(
        gmg._prolong_sparse(g.levels[0]["grid"], g.levels[1]["grid"]).T
        @ gmg._band_to_sparse(g_assemble(_systems(40)[1], "stiff", GA, GN,
                                         with_nitsche=True))
        @ gmg._prolong_sparse(g.levels[0]["grid"], g.levels[1]["grid"]),
        g.levels[1]["grid"])
    np.testing.assert_allclose(coarse.band_host, g_coarse.band_host,
                               rtol=0, atol=1e-14 * np.abs(
                                   g_coarse.band_host).max())
    for a, b in zip(mg.levels, g.levels):
        assert abs(a["lmax"] - b["lmax"]) <= 1e-10 * b["lmax"]
        assert abs(a["omega"] - b["omega"]) <= 1e-10 * b["omega"]
        np.testing.assert_array_equal(a["win"].numpy(), np.asarray(b["win"]))
        np.testing.assert_allclose(a["inv"].numpy(), np.asarray(b["inv"]),
                                   rtol=1e-10, atol=0)
        np.testing.assert_array_equal(a["jac"].numpy(), np.asarray(b["jac"]))
    ci, gci = mg.coarse_inv.numpy(), np.asarray(g.coarse_inv)
    assert np.abs(ci - gci).max() <= 1e-10 * np.abs(gci).max()


def test_vcycle_matches_gdm():
    mg, g = _mg40()
    r = np.random.default_rng(31).standard_normal(41 * 41)
    z = mg.precondition(torch.as_tensor(r))
    gz = np.asarray(g.precondition(jnp.asarray(r)))
    assert z.dtype == F64 and z.shape == (41 * 41,)
    assert np.abs(z.numpy() - gz).max() <= 1e-12 * np.abs(gz).max()


@pytest.mark.parametrize("estimator", ["powr", "Lanczos", None])
def test_mistyped_estimator_raises(estimator):
    top, _ = _systems(40)
    with pytest.raises(ValueError, match="estimator"):
        tmg.cut_poisson_multigrid(top, GA, GN, _ls, level_set_degree=3,
                                  estimator=estimator, device="cpu")


def test_lanczos_estimator_matches_gdm():
    top, gop = _systems(40)
    st = assemble_stencil(top, "stiff", GA, GN, with_nitsche=True)
    gst = g_assemble(gop, "stiff", GA, GN, with_nitsche=True)
    a = tmg.CutMultigrid(st, _ls, 3, estimator="lanczos", device="cpu")
    b = gmg.CutMultigrid(gst, _ls, 3, estimator="lanczos")
    for la, lb in zip(a.levels, b.levels):
        assert abs(la["lmax"] - lb["lmax"]) <= 1e-10 * lb["lmax"]


@functools.lru_cache(maxsize=None)
def _counts(n):
    """{system: (port iterations, gdm iterations)} of the MG-CG solves of
    gdm's tests/test_cut_multigrid.py at n^2 (rel 1e-8)."""
    top, gop = _systems(n)
    out = {}
    st = assemble_stencil(top, "stiff", GA, GN, with_nitsche=True)
    gst = g_assemble(gop, "stiff", GA, GN, with_nitsche=True)
    b = _step85_rhs(gop)
    mg = tmg.cut_poisson_multigrid(top, GA, GN, _ls, level_set_degree=3,
                                   device="cpu")
    g = gmg.cut_poisson_multigrid(gop, GA, GN, _ls, level_set_degree=3)
    out["step85"] = (st, gst, b, mg, g)
    dt = 0.3 * 2.42 / n
    m, s = (assemble_stencil(top, "mass", GM), assemble_stencil(
        top, "stiff", GA_HEAT, GN, with_nitsche=True,
        inactive_identity=False))
    gm_, gs_ = (g_assemble(gop, "mass", GM), g_assemble(
        gop, "stiff", GA_HEAT, GN, with_nitsche=True,
        inactive_identity=False))
    rng = np.random.default_rng(0)
    bh = jnp.asarray(rng.standard_normal(gop.grid.n_nodes) * ~gop.inactive)
    out["heat"] = (
        StencilOperator(top.grid, m.band_host + dt * s.band_host, m.radius),
        GStencilOperator(gop.grid, gm_.band_host + dt * gs_.band_host,
                         gm_.radius), bh,
        tmg.cut_heat_impl_multigrid(top, dt, GM, GA_HEAT, GN, _ls,
                                    level_set_degree=3, device="cpu"),
        gmg.cut_heat_impl_multigrid(gop, dt, GM, GA_HEAT, GN, _ls,
                                    level_set_degree=3))
    counts = {}
    for name, (st, gst, b, mg, g) in out.items():
        x, info = solvers.cg(st.apply, torch.as_tensor(np.asarray(b)),
                             precond=mg.precondition, max_iter=400,
                             rel_tol=1e-8)
        gx, ginfo = jax.jit(lambda b, gst=gst, g=g: g_solvers.cg(
            gst.apply, b, precond=g.precondition, max_iter=400,
            rel_tol=1e-8))(b)
        r = st.apply(x) - torch.as_tensor(np.asarray(b))
        assert (r.norm() / np.linalg.norm(np.asarray(b))).item() < 1e-7
        counts[name] = (info["iterations"], int(ginfo["iterations"]))
    return counts


def _chip_smoke_counts():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CUT_MG_ITERS


def check_counts(n):
    """The port's MG-CG counts at n^2 equal gdm's, and gdm's equal
    chip_smoke.py's constants."""
    counts = _counts(n)
    for name, (port, ref) in counts.items():
        assert port == ref, (name, port, ref)
    assert _chip_smoke_counts()[n] == (counts["step85"][1],
                                       counts["heat"][1])


def test_mg_cg_counts_match_gdm():
    check_counts(40)


# ---- step85 through the app -------------------------------------------------

def _recording_cg(monkeypatch):
    """gdm's solvers.cg, its iteration count recorded from inside gdm's
    jitted solve (gdm's run() returns only the rows)."""
    seen = []
    real = g_solvers.cg

    def cg(*a, **kw):
        x, info = real(*a, **kw)
        jax.debug.callback(lambda i: seen.append(int(i)), info["iterations"])
        return x, info

    monkeypatch.setattr(g_solvers, "cg", cg)
    return seen


@pytest.mark.parametrize("solver,iters", [("CG", 208), ("MG", 9)])
def test_step85_matches_gdm_and_the_reference(monkeypatch, solver, iters):
    pt, pg = wave.make_preset("step85", 2), gwave.make_preset("step85", 2)
    if solver == "MG":
        for p in (pt, pg):
            p.solver_name = "MG"
            p.solver_rel_tolerance = 1e-12
    port = wave.WaveProblem(pt, verbose=False, device="cpu", dtype=F64)
    rows = port.run()[0]
    seen = _recording_cg(monkeypatch)
    ref = gwave.WaveProblem(pg, verbose=False)
    grows = ref.run()[0]
    assert port.poisson_info["iterations"] == seen[-1] == iters
    assert len(rows) == len(grows) == 1 and rows[0][:2] == (0, 0.0)
    np.testing.assert_allclose(rows[0][2], 8.5201e-9, rtol=1e-3)
    u, gu = port.final_solution.numpy(), np.asarray(ref.final_solution)
    # the two CGs stop at the same iteration with their recurrences
    # rounded differently: the solutions differ by 2.7e-11 of max|gu|
    # (CG) and 2.7e-11 (MG); held at 1e-10, about four times that gap
    assert np.abs(u - gu).max() <= 1e-10 * np.abs(gu).max()
    dev = (np.abs(np.asarray(rows)[:, 2:] - np.asarray(grows)[:, 2:])
           / np.abs(np.asarray(grows)[:, 2:]))
    assert dev.max() <= 1e-6
    if solver == "MG":
        assert [lv["grid"].nodes for lv in port.multigrid.levels] == [
            (41, 41), (21, 21)]
