"""Host setup of the PyTorch port (gdm_torch) against gdm under x64.

The port copies gdm's numpy host modules (basis, quadrature, 1D bands,
level set, Saye cut quadrature, band assembly, FSAI factors, Schwarz
band), so the same inputs must give the same tables: bit for bit where
the code is verbatim, to 1e-13 relative where float sums may reorder.
The one torch operation of the setup, CutOperators.compute_rhs, is held
to 1e-12.
"""

import numpy as np
import pytest
import torch

import gdm.basis as gbasis
import gdm.ops1d as gops1d
import gdm.quadrature as gquad
from gdm.cut.fsai import (fsai_factors as g_fsai_factors,
                          fsai_preconditioner as g_fsai_preconditioner)
from gdm.cut.geometry import INSIDE as G_INSIDE, CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import (assemble_stencil as g_assemble,
                             schwarz_band as g_schwarz_band)
from gdm.grid import Grid as GGrid

from gdm_torch import basis, ops1d, quadrature
from gdm_torch.cut.fsai import fsai_factors, fsai_preconditioner
from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
from gdm_torch.grid import Grid

GM, GA, GN = 0.25 * np.sqrt(3.0), 0.5 * np.sqrt(3.0), 15.0


def _disc(m):
    return np.sqrt(sum(x**2 for x in m)) - 1.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("p", [1, 3, 5])
def test_basis_bitwise(p):
    x = np.linspace(0.0, 1.0, 11)
    for deriv in range(3):
        assert np.array_equal(basis.shape_table(p, x, deriv),
                              gbasis.shape_table(p, x, deriv))
    for c in range(p):
        assert np.array_equal(basis.category_coefficients(p, c),
                              gbasis.category_coefficients(p, c))
        assert np.array_equal(basis.shape_at(p, c, x, 1),
                              gbasis.shape_at(p, c, x, 1))


@pytest.mark.parametrize("p", [1, 3, 5])
def test_quadrature_bitwise(p):
    for a, b in zip(quadrature.gauss(p + 1), gquad.gauss(p + 1)):
        assert np.array_equal(a, b)
    nodes = quadrature.gauss_lobatto_points(p + 1)
    assert np.array_equal(nodes, gquad.gauss_lobatto_points(p + 1))
    pts = np.linspace(0.0, 1.0, 7)
    for deriv in range(2):
        assert np.array_equal(
            quadrature.lagrange_eval_matrix(tuple(nodes), pts, deriv),
            gquad.lagrange_eval_matrix(tuple(nodes), pts, deriv))


@pytest.mark.parametrize("p", [1, 3, 5])
def test_bands_1d_bitwise(p):
    for fn in ("mass_1d", "stiffness_1d", "advection_1d"):
        a = getattr(ops1d, fn)(p, 12, 0.25).band
        b = getattr(gops1d, fn)(p, 12, 0.25).band
        assert np.array_equal(a, b), fn


@pytest.fixture(scope="module", params=[24, 40])
def disc(request):
    n = request.param
    g = GGrid(3, (n, n), (-1.21, -1.21), (1.21, 1.21))
    t = Grid(3, (n, n), (-1.21, -1.21), (1.21, 1.21))
    ggeo = GCutGeometry.build(g, _disc, 3)
    tgeo = CutGeometry.build(t, _disc, 3)
    gop = GCutOperators(ggeo, G_INSIDE)
    top = CutOperators(tgeo, INSIDE)
    return {
        "n": n, "ggeo": ggeo, "tgeo": tgeo, "gop": gop, "top": top,
        "gmass": g_assemble(gop, "mass", GM),
        "tmass": assemble_stencil(top, "mass", GM),
        "gstiff": g_assemble(gop, "stiff", GA, GN, with_nitsche=True,
                             gp_power=1, inactive_identity=False),
        "tstiff": assemble_stencil(top, "stiff", GA, GN, with_nitsche=True,
                                   gp_power=1, inactive_identity=False),
    }


def test_cell_classes(disc):
    assert np.array_equal(disc["tgeo"].locations, disc["ggeo"].locations)
    assert np.array_equal(disc["tgeo"].cut_cells, disc["ggeo"].cut_cells)
    assert (disc["tgeo"].ghost_penalty_faces(INSIDE)
            == disc["ggeo"].ghost_penalty_faces(G_INSIDE))


def test_cut_quadrature(disc):
    tq, gq = disc["tgeo"].cut_quads, disc["ggeo"].cut_quads
    assert len(tq) == len(gq) > 0
    for a, b in zip(tq, gq):
        for name in ("inside_pts", "inside_w", "outside_pts", "outside_w",
                     "surface_pts", "surface_w", "surface_normals"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.shape == y.shape, name
            if x.size:
                assert np.abs(x - y).max() <= 1e-14, name


@pytest.mark.parametrize("kind", ["mass", "stiff"])
def test_assembled_bands(disc, kind):
    assert disc["t" + kind].radius == disc["g" + kind].radius
    assert _rel(disc["t" + kind].band_host,
                disc["g" + kind].band_host) <= 1e-13


def test_mass_diagonal(disc):
    assert _rel(disc["top"].mass_diagonal(GM),
                disc["gop"].mass_diagonal(GM)) <= 1e-13


def test_fsai_factors(disc):
    tG, tGT = fsai_factors(disc["tmass"])
    gG, gGT = g_fsai_factors(disc["gmass"])
    assert tG.radius == gG.radius and tGT.radius == gGT.radius
    assert _rel(tG.band_host, gG.band_host) <= 1e-13
    assert _rel(tGT.band_host, gGT.band_host) <= 1e-13


def test_fsai_preconditioner(disc):
    import jax.numpy as jnp

    r = np.random.default_rng(7).standard_normal(disc["tgeo"].grid.n_nodes)
    zt = fsai_preconditioner(disc["tmass"])(torch.as_tensor(r))
    zg = g_fsai_preconditioner(disc["gmass"])(jnp.asarray(r))
    assert _rel(zt.numpy(), np.asarray(zg)) <= 1e-12


def test_schwarz_band(disc):
    # gdm under x64 adds no f32 ridge; the port's float64 does the same
    tB = schwarz_band(disc["tmass"], disc["top"].w_cut, dtype=torch.float64)
    gB = g_schwarz_band(disc["gmass"], disc["gop"].w_cut)
    assert _rel(tB.band_host, gB.band_host) <= 1e-13


def test_schwarz_band_f32_ridge(disc):
    """In float32 every window block gets the relative 1e-7 ridge before
    inversion, so the band differs from the exact inverse."""
    b64 = schwarz_band(disc["tmass"], disc["top"].w_cut, torch.float64)
    b32 = schwarz_band(disc["tmass"], disc["top"].w_cut, torch.float32)
    assert not np.array_equal(b64.band_host, b32.band_host)
    assert np.isfinite(b32.band_host).all()


def test_compute_rhs_interface(disc):
    """Branch (II), the interface Nitsche forcing, as the flagship path
    calls it at setup."""
    import scipy.special
    import jax.numpy as jnp

    def g(pts, t):
        return scipy.special.j0(3 * np.pi * np.linalg.norm(
            np.asarray(pts), axis=-1)) * np.cos(t)

    N = disc["tgeo"].grid.n_nodes
    yt = disc["top"].compute_rhs(torch.zeros(N, dtype=torch.float64), 0.3,
                                 False, interface_dbc=g, gamma_A=GA,
                                 nitsche_gamma=GN)
    yg = disc["gop"].compute_rhs(
        jnp.zeros(N), 0.3, False,
        interface_dbc=lambda p, t: jnp.asarray(g(p, t)), gamma_A=GA,
        nitsche_gamma=GN)
    assert _rel(yt.numpy(), np.asarray(yg)) <= 1e-12


def test_compute_rhs_implicit_branches(disc):
    """Branches (I), (II) with impl, the f term and (V); (IV) has no
    faces on this disc (see the next test)."""
    import jax.numpy as jnp

    N = disc["tgeo"].grid.n_nodes
    u = np.random.default_rng(3).standard_normal(N)

    def f(pts, t):
        x = np.asarray(pts)
        return np.sin(x[..., 0]) * np.cos(x[..., 1]) + t

    kw = dict(rhs_fn=f, interface_dbc=f, domain_dbc=f, gamma_A=GA,
              nitsche_gamma=GN)
    yt = disc["top"].compute_rhs(torch.as_tensor(u), 0.1, True, **kw)
    kwg = {k: ((lambda p, t: jnp.asarray(f(p, t))) if callable(v) else v)
           for k, v in kw.items()}
    yg = disc["gop"].compute_rhs(jnp.asarray(u), 0.1, True, **kwg)
    assert _rel(yt.numpy(), np.asarray(yg)) <= 1e-12


def _warp(pts):
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[..., 0], pts[..., 1]
    return np.stack(
        [x + 0.05 * np.sin(np.pi * x / 1.21) * np.cos(0.5 * np.pi * y / 1.21),
         y - 0.04 * np.sin(np.pi * y / 1.21) * np.cos(0.5 * np.pi * x / 1.21)],
        axis=-1)


def test_deformed_operators_match_gdm(disc):
    """CutOperators(mapping_fn=...) re-metrics the tables as gdm does:
    the deformed band and right-hand side within 1e-12 of gdm's."""
    import jax.numpy as jnp

    top = CutOperators(disc["tgeo"], INSIDE, mapping_fn=_warp)
    gop = GCutOperators(disc["ggeo"], G_INSIDE, mapping_fn=_warp)
    assert np.array_equal(top.cat_full, gop.cat_full)
    assert _rel(top.A_mass, gop.A_mass) <= 1e-12
    a = assemble_stencil(top, "mass", GM).band_host
    assert _rel(a, g_assemble(gop, "mass", GM).band_host) <= 1e-12
    assert _rel(a, disc["tmass"].band_host) > 1e-4   # the map is in there
    u = np.random.default_rng(4).standard_normal(top.grid.n_nodes)

    def f(pts, t):
        x = np.asarray(pts)
        return np.cos(x[..., 0]) * x[..., 1] + t

    yt = top.compute_rhs(torch.as_tensor(u), 0.1, True, rhs_fn=f,
                         interface_dbc=f, gamma_A=GA, nitsche_gamma=GN)
    yg = gop.compute_rhs(jnp.asarray(u), 0.1, True,
                         rhs_fn=lambda p, t: jnp.asarray(f(p, t)),
                         interface_dbc=lambda p, t: jnp.asarray(f(p, t)),
                         gamma_A=GA, nitsche_gamma=GN)
    assert _rel(yt.numpy(), np.asarray(yg)) <= 1e-12


def test_compute_rhs_domain_boundary():
    """Branch (IV): a disc of radius 1.3 cuts the domain boundary."""
    import jax.numpy as jnp

    def ls(m):
        return np.sqrt(sum(x**2 for x in m)) - 1.3

    g = GGrid(3, (16, 16), (-1.21, -1.21), (1.21, 1.21))
    t = Grid(3, (16, 16), (-1.21, -1.21), (1.21, 1.21))
    gop = GCutOperators(GCutGeometry.build(g, ls, 3), G_INSIDE)
    top = CutOperators(CutGeometry.build(t, ls, 3), INSIDE)
    assert len(top.b_win) == len(gop.b_win) > 0

    def f(pts, t):
        return np.cos(np.asarray(pts)[..., 0]) + t

    u = np.random.default_rng(8).standard_normal(t.n_nodes)
    yt = top.compute_rhs(torch.as_tensor(u), 0.2, True, domain_dbc=f,
                         gamma_A=GA, nitsche_gamma=GN)
    yg = gop.compute_rhs(jnp.asarray(u), 0.2, True,
                         domain_dbc=lambda p, t: jnp.asarray(f(p, t)),
                         gamma_A=GA, nitsche_gamma=GN)
    assert _rel(yt.numpy(), np.asarray(yg)) <= 1e-12
