"""The port's cut operators on the device side, and its 1D cut host
setup, against gdm under x64 on the CPU.

``CutOperators.cell_matvec``, ``mass_apply``, ``error_norms`` and
``cut.stencil.best_solver_apply`` (the wave application's operator
applies) are held to 1e-12 relative on seeded numpy inputs, in 1D and
2D.  The 1D host setup (cut classification, point "surfaces" of the
Saye quadrature, boundary-face points, ghost-penalty faces, every table
of ``CutOperators`` and ``assemble_stencil``) is copied from gdm and held
to 1e-13 (bit for bit where the code is verbatim).  The host tables move
to the device once per (device, dtype): a second ``compute_rhs`` call
moves none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from gdm.cut.geometry import (INSIDE as G_INSIDE, OUTSIDE as G_OUTSIDE,
                              CutGeometry as GCutGeometry)
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import (assemble_stencil as g_assemble,
                             best_solver_apply as g_best_solver_apply)
from gdm.grid import Grid as GGrid

from gdm_torch.cut import operators as cut_operators
from gdm_torch.cut.geometry import INSIDE, OUTSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil, best_solver_apply
from gdm_torch.grid import Grid

F64 = torch.float64
GM, GA, GN = 0.25 * np.sqrt(3.0), 0.5 * np.sqrt(3.0), 15.0
TOL = 1e-12

# every host table of CutOperators that the device-side methods and the
# band assembly read
TABLES = ("full_ids", "w_full", "cat_full", "A_mass", "A_stiff", "ref_q",
          "w_q", "V_full_cat", "full_phys_q", "cut_ids", "w_cut", "vol_pts",
          "vol_w", "V_cut", "G_cut", "cut_phys_q", "surf_pts", "surf_w",
          "surf_n", "V_surf", "G_surf", "surf_phys_q", "nvol", "nsurf",
          "gp_J", "gp_w", "gp_win", "gp_mat", "inactive", "b_V", "b_G", "b_w",
          "b_phys", "b_normal", "b_normal_q", "b_win")


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _sphere(radius):
    return lambda m: np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - radius


def _build(dim, n, radius, location=INSIDE):
    args = (3, (n,) * dim, (-1.21,) * dim, (1.21,) * dim)
    t, g = Grid(*args), GGrid(*args)
    tgeo = CutGeometry.build(t, _sphere(radius), 3)
    ggeo = GCutGeometry.build(g, _sphere(radius), 3)
    gloc = G_INSIDE if location == INSIDE else G_OUTSIDE
    return {"t": t, "g": g, "tgeo": tgeo, "ggeo": ggeo,
            "top": CutOperators(tgeo, location),
            "gop": GCutOperators(ggeo, gloc)}


# 1D: the wave preset's interval (radius 1), its outside region (two
# pieces, each with a boundary-face point), and an interval past the
# domain (radius 1.3: no cut cell, both boundary points inside)
CASES_1D = {"r1.0": (1.0, INSIDE), "r1.3": (1.3, INSIDE),
            "r1.0-outside": (1.0, OUTSIDE)}


@pytest.fixture(scope="module", params=list(CASES_1D))
def ops1d(request):
    radius, loc = CASES_1D[request.param]
    return dict(_build(1, 40, radius, loc), radius=radius)


@pytest.fixture(scope="module", params=[1, 2])
def ops(request):
    """The wave preset's cut operators, 1D at 40 cells and 2D at 24^2."""
    return _build(request.param, 40 if request.param == 1 else 24, 1.0)


def test_1d_cut_classification(ops1d):
    tgeo, ggeo = ops1d["tgeo"], ops1d["ggeo"]
    assert np.array_equal(tgeo.locations, ggeo.locations)
    assert np.array_equal(tgeo.cut_cells, ggeo.cut_cells)
    assert len(tgeo.cut_cells) == (0 if ops1d["radius"] > 1.21 else 2)
    for loc, gloc in ((INSIDE, G_INSIDE), (OUTSIDE, G_OUTSIDE)):
        assert tgeo.ghost_penalty_faces(loc) == ggeo.ghost_penalty_faces(gloc)
    for a, b in zip(tgeo.cut_quads, ggeo.cut_quads):
        for name in ("inside_pts", "inside_w", "outside_pts", "outside_w",
                     "surface_pts", "surface_w", "surface_normals"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.shape == y.shape, name
            if x.size:
                assert np.abs(x - y).max() <= 1e-14, name
    # a 1D "surface" is one point with weight 1 and a unit normal
    for q in tgeo.cut_quads:
        assert q.surface_pts.shape == (1, 1)
        assert np.array_equal(q.surface_w, [1.0])
        assert abs(abs(q.surface_normals[0, 0]) - 1.0) <= 1e-14


def test_1d_host_tables(ops1d):
    top, gop = ops1d["top"], ops1d["gop"]
    assert top.h_min == gop.h_min and top.nq == gop.nq
    for name in TABLES:
        a, b = np.asarray(getattr(top, name)), np.asarray(getattr(gop, name))
        assert a.shape == b.shape, name
        if a.size:
            assert _rel(a, b) <= 1e-13, name
    assert len(top.bdry) == len(gop.bdry)
    # a boundary point where the domain's end lies on this location's side
    ends_here = (ops1d["radius"] > 1.21) == (top.location == INSIDE)
    assert len(top.b_win) == (2 if ends_here else 0)


@pytest.mark.parametrize("kind", ["mass", "stiff"])
def test_1d_assemble_stencil(ops1d, kind):
    top, gop = ops1d["top"], ops1d["gop"]
    if kind == "mass":
        args, kw = (GM,), {}
    else:
        args = (GA, GN)
        kw = dict(with_nitsche=True, gp_power=1, with_bdry_nitsche=True,
                  inactive_identity=False)
    ts, gs = assemble_stencil(top, kind, *args, **kw), g_assemble(
        gop, kind, *args, **kw)
    assert ts.radius == gs.radius == 4
    assert ts.band_host.shape == gs.band_host.shape == (41, 9)
    assert _rel(ts.band_host, gs.band_host) <= 1e-13
    u = np.random.default_rng(5).standard_normal(41)
    assert _rel(ts.apply(torch.as_tensor(u)),
                np.asarray(gs.apply(jnp.asarray(u)))) <= TOL


def _u(op, seed):
    return np.random.default_rng(seed).standard_normal(op.grid.n_nodes)


def test_cell_matvec(ops):
    top, gop = ops["top"], ops["gop"]
    u = _u(top, 11)
    for wname, mname in (("w_full", "A_stiff"), ("w_full", "A_mass")):
        mats = getattr(top, mname)[top.cat_full]
        yt = top.cell_matvec(torch.as_tensor(u),
                             torch.as_tensor(getattr(top, wname),
                                             dtype=torch.int64),
                             torch.as_tensor(mats))
        yg = gop.cell_matvec(jnp.asarray(u), jnp.asarray(getattr(gop, wname)),
                             jnp.asarray(getattr(gop, mname)[gop.cat_full]))
        assert yt.shape == (len(top.full_ids), 4 ** ops["t"].dim)
        assert _rel(yt, np.asarray(yg)) <= TOL


@pytest.mark.parametrize("gp_power", [3, 1])
def test_mass_apply(ops, gp_power):
    top, gop = ops["top"], ops["gop"]
    u = _u(top, 12)
    yt = top.mass_apply(torch.as_tensor(u), GM, gp_power)
    yg = gop.mass_apply(jnp.asarray(u), GM, gp_power)
    assert yt.dtype == F64 and yt.shape == u.shape
    assert _rel(yt, np.asarray(yg)) <= TOL
    # the matrix-free mass is the assembled band's apply
    if gp_power == 3:
        assert _rel(yt, assemble_stencil(top, "mass", GM).apply(
            torch.as_tensor(u))) <= TOL


def _wave_exact(dim):
    wn = 1.5 * np.pi if dim == 1 else 3.0 * np.pi
    radial = np.cos if dim == 1 else scipy.special.j0

    def g(pts, t):
        r = np.linalg.norm(np.asarray(pts), axis=-1)
        return radial(wn * r) * np.cos(wn * t)

    return g


@pytest.mark.parametrize("t", [0.0, 0.37])
def test_error_norms(ops, t):
    """(L2, L1, Linf) of an interpolant with seeded noise, as Python
    floats; Linf over the real quadrature points only."""
    top, gop = ops["top"], ops["gop"]
    g = _wave_exact(ops["t"].dim)
    pts = np.stack(ops["t"].node_coords_mesh(), axis=-1)
    u = g(pts, t).reshape(-1) + 1e-3 * _u(top, 13)
    et = top.error_norms(torch.as_tensor(u), g, t)
    eg = gop.error_norms(jnp.asarray(u), lambda p, s: jnp.asarray(g(p, s)), t)
    assert all(isinstance(x, float) for x in et)
    for a, b in zip(et, eg):
        assert abs(a - float(b)) <= TOL * abs(float(b))
    assert top.w_q_cell is None


@pytest.mark.parametrize("kind", ["mass", "stiff"])
@pytest.mark.parametrize("max_band_entries", [3e7, 0])
def test_best_solver_apply(ops, kind, max_band_entries):
    """On a CPU tensor: the band apply under the band limit, and past it
    the matrix-free mass or stiffness (``stiffness_matrix_apply``), as
    gdm's off-TPU routes."""
    top, gop = ops["top"], ops["gop"]
    args = (GM,) if kind == "mass" else (GA, GN, True)
    at = best_solver_apply(top, kind, *args, max_band_entries=max_band_entries)
    ag = g_best_solver_apply(gop, kind, *args,
                             max_band_entries=max_band_entries)
    u = _u(top, 14)
    assert _rel(at(torch.as_tensor(u)), np.asarray(ag(jnp.asarray(u)))) <= TOL


def test_compute_rhs_moves_each_table_once(ops, monkeypatch):
    """The first compute_rhs call moves its tables to the device; a
    second call at another t moves none and gives gdm's answer; another
    dtype gets its own copies."""
    top, gop = ops["top"], ops["gop"]
    moved = []
    real = cut_operators._to_device

    def spy(a, device, dtype):
        moved.append(dtype)
        return real(a, device, dtype)

    monkeypatch.setattr(cut_operators, "_to_device", spy)
    top._tables.clear()
    g = _wave_exact(ops["t"].dim)
    u = _u(top, 15)
    kw = dict(rhs_fn=g, interface_dbc=g, domain_dbc=g, gamma_A=GA,
              nitsche_gamma=GN)
    top.compute_rhs(torch.as_tensor(u), 0.1, True, **kw)
    first = len(moved)
    assert first > 0 and len(top._tables) == first
    yt = top.compute_rhs(torch.as_tensor(u), 0.2, True, **kw)
    assert len(moved) == first
    kwg = {k: ((lambda p, s, f=v: jnp.asarray(f(p, s))) if callable(v)
               else v) for k, v in kw.items()}
    yg = gop.compute_rhs(jnp.asarray(u), 0.2, True, **kwg)
    assert _rel(yt, np.asarray(yg)) <= TOL
    # float32: one more copy of each floating table, the indices shared
    y32 = top.compute_rhs(torch.as_tensor(u, dtype=torch.float32), 0.2,
                          True, **kw)
    n_float = sum(1 for d in moved[:first] if d == F64)
    assert len(moved) == first + n_float
    assert all(d == torch.float32 for d in moved[first:])
    names = {k[0] for k in top._tables}
    for name in names:
        dtypes = {k[2] for k in top._tables if k[0] == name}
        assert dtypes in ({torch.int64}, {torch.bool},
                          {F64, torch.float32}), name
    assert _rel(y32.double(), yt) <= 1e-5
    # the mass apply reads the same cache
    top.mass_apply(torch.as_tensor(u), GM)
    top.mass_apply(torch.as_tensor(u), GM)
    assert len(moved) == first + n_float + len(
        [k for k in top._tables if k[0] in ("A_mass_full", "inactive")])
