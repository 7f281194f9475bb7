"""The port's 3D cut problems against gdm under x64, on the CPU in
float64, at the cases of gdm's tests/test_cut_3d.py and
tests/test_cut_3d_bdry.py (3D cut cells are beyond the reference, which
runs cut problems in 1D and 2D only).

- The unit sphere in [-1.21, 1.21]^3 at 8^3 cells, p = 3: the cut
  classification and every cut cell's quadrature (volume, outside,
  surface points, weights, normals) within 1e-12 of gdm's; gdm's checks
  of them (volume 4/3 pi within 2e-5, area 4 pi within 5e-4, normals
  radially outward); every ``CutOperators`` table within 1e-12 relative
  of gdm's; the 3D cut Poisson solve (Nitsche interface data, Jacobi CG
  over the matrix-free stiffness to rel 1e-11) on gdm's right-hand
  side (the port's within 1e-12 of it): gdm's iteration count, the
  solution within 1e-6 of max |gdm's| (``SOLVE_REL``), L2 < 2e-5 and
  within 1e-6 of gdm's L2.
- ``_face_quad_3d`` on the domain boundary: the plane x + y + z = 1.5
  cutting the unit cube, each face's area against the exact one and
  the tables against gdm's (1e-12); a moment integral against the dense
  midpoint sum (2e-3, gdm's) and gdm's own value (1e-12); the sphere's
  outside region, whose six full faces give 6 * 2.42^2, and its inside
  region, with none; the 3D cut Poisson solve with interface and
  domain-boundary Nitsche terms on the assembled band (within 1e-12 of
  gdm's), on gdm's right-hand side: gdm's iteration count, L2 < 5e-8,
  Linf < 5e-6, the solution within 1e-6 of gdm's.
- The card's route in 3D: ``cut.stencil.kernel_route`` is false for a
  CUDA device, so no 3D apply reaches the padded band layout
  (``ops.cutband.layout_for``, which raises for 3D and says so).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm import solvers as gsolvers
from gdm.cut.geometry import INSIDE as G_INSIDE, OUTSIDE as G_OUTSIDE
from gdm.cut.geometry import CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import assemble_stencil as g_assemble_stencil
from gdm.grid import Grid as GGrid

from gdm_torch import solvers
from gdm_torch.cut import stencil
from gdm_torch.cut.geometry import INSIDE, OUTSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil
from gdm_torch.grid import Grid
from gdm_torch.ops import cutband

F64 = torch.float64
TABLES = ("A_mass", "A_stiff", "cat_full", "V_full_cat", "full_phys_q",
          "vol_w", "V_cut", "G_cut", "cut_phys_q", "surf_w", "surf_n",
          "V_surf", "G_surf", "surf_phys_q", "gp_J", "gp_w", "gp_mat",
          "gp_win", "b_V", "b_G", "b_w", "b_phys", "b_normal_q", "b_win",
          "inactive", "w_full", "w_cut")
# two CG solves of these ill-conditioned cut systems to rel 1e-11 or
# 1e-12, from right-hand sides one ulp apart, give solutions ~5e-8 apart
# (gdm's against gdm's); the solutions are held to 1e-6 of max |gdm's|
SOLVE_REL = 1e-6
QUAD = ("inside_pts", "inside_w", "outside_pts", "outside_w", "surface_pts",
        "surface_w", "surface_normals")


def LS(m):
    return np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - 1.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    if a.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _both(n, lower, upper, ls, ls_degree):
    args = (3, (n,) * 3, (lower,) * 3, (upper,) * 3)
    return (CutGeometry.build(Grid(*args), ls, ls_degree),
            GCutGeometry.build(GGrid(*args), ls, ls_degree))


@pytest.fixture(scope="module")
def sphere8():
    geo, ggeo = _both(8, -1.21, 1.21, LS, 3)
    return {"geo": geo, "ggeo": ggeo, "op": CutOperators(geo, INSIDE),
            "gop": GCutOperators(ggeo, G_INSIDE)}


def test_sphere_geometry_matches_gdm(sphere8):
    geo, ggeo = sphere8["geo"], sphere8["ggeo"]
    assert np.array_equal(geo.locations, ggeo.locations)
    assert np.array_equal(geo.cut_cells, ggeo.cut_cells)
    assert len(geo.cut_cells) == 224
    for q, gq in zip(geo.cut_quads, ggeo.cut_quads):
        for name in QUAD:
            assert _rel(getattr(q, name), getattr(gq, name)) <= 1e-12, name


def test_sphere_volume_area(sphere8):
    geo = sphere8["geo"]
    grid = geo.grid
    hx, hy, hz = grid.h
    vol = float((geo.locations == INSIDE).sum()) * hx * hy * hz
    area = 0.0
    for q in geo.cut_quads:
        vol += q.inside_w.sum() * hx * hy * hz
        area += q.surface_w.sum()
        np.testing.assert_allclose(
            q.inside_w.sum() + q.outside_w.sum(), 1.0, rtol=1e-9)
    np.testing.assert_allclose(vol, 4 / 3 * np.pi, rtol=2e-5)
    np.testing.assert_allclose(area, 4 * np.pi, rtol=5e-4)
    for cid, q in zip(geo.cut_cells, geo.cut_quads):
        ijk = (cid % 8, (cid // 8) % 8, cid // 64)
        for pt, nrm in zip(q.surface_pts, q.surface_normals):
            x = np.array([grid.lower[d] + (i + p) * grid.h[d]
                          for d, (i, p) in enumerate(zip(ijk, pt))])
            assert np.dot(x / np.linalg.norm(x), nrm) > 0.99


def test_sphere_tables_match_gdm(sphere8):
    op, gop = sphere8["op"], sphere8["gop"]
    assert len(op.gp_win) > 0
    for name in TABLES:
        a, b = getattr(op, name), getattr(gop, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert _rel(a, b) <= 1e-12, name


def _const(value):
    def fn(pts, t):
        if isinstance(pts, torch.Tensor):
            return pts.new_full(pts.shape[:-1], value)
        return jnp.full(np.shape(pts)[:-1], value)
    return fn


def _sphere_exact(pts, t):
    return 1.0 - (2.0 / 3) * ((pts**2).sum(-1) - 1.0)


def test_cut_poisson_3d_matches_gdm(sphere8):
    op, gop = sphere8["op"], sphere8["gop"]
    N = op.grid.n_nodes
    gn = 15.0
    kw = dict(rhs_fn=_const(4.0), interface_dbc=_const(1.0),
              nitsche_gamma=gn)
    b = op.compute_rhs(torch.zeros(N, dtype=F64), 0.0, False, **kw)
    gb = gop.compute_rhs(jnp.zeros(N), 0.0, False, **kw)
    assert _rel(b.numpy(), gb) <= 1e-12
    diag = op.stiffness_diagonal(0.5, gn)
    assert _rel(diag, gop.stiffness_diagonal(0.5, gn)) <= 1e-12
    # both CGs on gdm's right-hand side: ~180 iterations of Jacobi CG on
    # this system turn a one-ulp change of b into a change of the count
    # (gdm's own count moves from 178 to 179 between its jitted and its
    # unjitted operator)
    x, info = solvers.cg(
        lambda v: op.stiffness_matrix_apply(v, 0.5, gn),
        torch.as_tensor(np.array(gb)),
        precond=solvers.jacobi_preconditioner(torch.as_tensor(diag)),
        max_iter=20000, rel_tol=1e-11)
    gx, ginfo = gsolvers.cg(
        jax.jit(lambda v: gop.stiffness_matrix_apply(v, 0.5, gn)), gb,
        precond=gsolvers.jacobi_preconditioner(jnp.asarray(diag)),
        max_iter=20000, rel_tol=1e-11)
    assert info["iterations"] == int(ginfo["iterations"])
    assert _rel(x.numpy(), gx) <= SOLVE_REL
    l2 = op.error_norms(x, _sphere_exact, 0.0)[0]
    gl2 = float(gop.error_norms(gx, _sphere_exact, 0.0)[0])
    assert l2 < 2e-5, l2
    assert abs(l2 - gl2) <= SOLVE_REL * gl2


def _plane(n=4, c=1.5):
    return _both(n, 0.0, 1.0, lambda m: m[0] + m[1] + m[2] - c, 1)


def test_plane_face_areas():
    geo, ggeo = _plane()
    op, gop = CutOperators(geo, INSIDE), GCutOperators(ggeo, G_INSIDE)
    assert len(op.b_win)
    for name in ("b_w", "b_normal", "b_phys", "b_V", "b_G", "b_win"):
        assert _rel(getattr(op, name), getattr(gop, name)) <= 1e-12, name
    w, nrm = np.asarray(op.b_w), np.asarray(op.b_normal)
    for d in range(3):
        np.testing.assert_allclose(w[nrm[:, d] == -1.0].sum(), 1.0 - 0.125,
                                   rtol=1e-12)
        np.testing.assert_allclose(w[nrm[:, d] == 1.0].sum(), 0.125,
                                   rtol=1e-12)
    np.testing.assert_allclose(w.sum(), 3.0, rtol=1e-12)


def test_plane_face_moment_vs_dense():
    geo, ggeo = _plane(n=3, c=1.4)
    op, gop = CutOperators(geo, INSIDE), GCutOperators(ggeo, G_INSIDE)

    def f(x):
        return x[..., 0] ** 2 * x[..., 1] + np.cos(x[..., 2])

    got = float(np.sum(np.asarray(op.b_w) * f(np.asarray(op.b_phys))))
    want = float(np.sum(np.asarray(gop.b_w) * f(np.asarray(gop.b_phys))))
    assert abs(got - want) <= 1e-12 * abs(want)
    n = 1500
    m = (np.arange(n) + 0.5) / n
    A, B = np.meshgrid(m, m, indexing="ij")
    ref = 0.0
    for d in range(3):
        t1, t2 = [e for e in range(3) if e != d]
        for fc in (0.0, 1.0):
            pts = np.zeros((n * n, 3))
            pts[:, d] = fc
            pts[:, t1] = A.reshape(-1)
            pts[:, t2] = B.reshape(-1)
            ref += f(pts[pts.sum(axis=1) < 1.4]).sum() / n**2
    np.testing.assert_allclose(got, ref, rtol=2e-3)


def test_sphere_outside_full_faces():
    geo, ggeo = _both(4, -1.21, 1.21, LS, 3)
    op_out = CutOperators(geo, OUTSIDE)
    np.testing.assert_allclose(np.asarray(op_out.b_w).sum(), 6 * 2.42**2,
                               rtol=1e-12)
    assert _rel(op_out.b_w, GCutOperators(ggeo, G_OUTSIDE).b_w) <= 1e-12
    assert len(CutOperators(geo, INSIDE).b_win) == 0


def _plane_exact(pts, t):
    return 1.0 - (pts**2).sum(-1) / 3.0


def test_cut_poisson_3d_domain_dbc_matches_gdm():
    geo, ggeo = _plane(n=6, c=1.5)
    op, gop = CutOperators(geo, INSIDE), GCutOperators(ggeo, G_INSIDE)
    grid = op.grid
    gn = 15.0
    S = assemble_stencil(op, "stiff", 0.5, gn, with_nitsche=True,
                         with_bdry_nitsche=True)
    gS = g_assemble_stencil(gop, "stiff", 0.5, gn, with_nitsche=True,
                            with_bdry_nitsche=True)
    assert _rel(S.band_host, np.asarray(gS.band)) <= 1e-12
    kw = dict(rhs_fn=_const(2.0), interface_dbc=_plane_exact,
              domain_dbc=_plane_exact, nitsche_gamma=gn)
    b = op.compute_rhs(torch.zeros(grid.n_nodes, dtype=F64), 0.0, False,
                       **kw)
    gb = gop.compute_rhs(jnp.zeros(grid.n_nodes), 0.0, False, **kw)
    assert _rel(b.numpy(), gb) <= 1e-12
    K = 2 * (grid.degree + 1) + 1
    diag = S.band_host.reshape(grid.n_nodes, -1)[:, (K**3 - 1) // 2]
    x, info = solvers.cg(
        S.apply, torch.as_tensor(np.array(gb)), precond=(
            solvers.jacobi_preconditioner(torch.as_tensor(diag))),
        max_iter=4000, rel_tol=1e-12)
    gx, ginfo = gsolvers.cg(
        gS.apply, gb, precond=gsolvers.jacobi_preconditioner(
            jnp.asarray(diag)), max_iter=4000, rel_tol=1e-12)
    assert info["iterations"] == int(ginfo["iterations"])
    assert _rel(x.numpy(), gx) <= SOLVE_REL
    l2, l1, linf = op.error_norms(x, _plane_exact, 0.0)
    assert l2 < 5e-8, l2
    assert linf < 5e-6, linf


def test_3d_route_never_reaches_the_padded_layout(sphere8):
    """The card's route is ``kernel_route``'s answer, asked here on the
    CPU: false for a CUDA device in 3D (true in 2D), so a 3D CUDA apply
    takes the plain tap loop, and ``layout_for`` refuses 3D."""
    grid3 = sphere8["op"].grid
    grid2 = Grid(3, (8, 8), (-1.21,) * 2, (1.21,) * 2)
    assert not stencil.kernel_route(grid3, torch.device("cuda"))
    assert stencil.kernel_route(grid2, torch.device("cuda"))
    assert not stencil.kernel_route(grid2, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="plain tap loop"):
        cutband.layout_for(grid3, 4)
