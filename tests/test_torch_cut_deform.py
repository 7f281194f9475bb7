"""Cut geometry composed with grid deformation in the port
(``CutOperators(mapping_fn=...)`` and the deformed wave application)
against gdm under x64, on the CPU in float64.

The cut is generated in undeformed coordinates and the deformation
re-metrics every quadrature table, as in gdm/cut/operators.py.  Held
here:

- every deformed table (full cells, cut volume, interface, ghost
  penalty, domain boundary; INSIDE and OUTSIDE; q1 and exact; 1D, 2D
  and 3D) within 1e-12 relative of gdm's;
- ``mass_apply``, ``stiffness_matrix_apply``, ``compute_rhs`` and
  ``error_norms`` on those tables within 1e-12 of gdm's;
- the identity map against the undeformed operators in 2D and 3D (8^3);
- the deformed ``heat`` (implicit) and ``wave`` (explicit RK) presets at
  16^2 and step85 with the cut multigrid at 32^2 against live gdm
  within 1e-10 scaled (max |port - gdm| / max |gdm| per column), the
  composite identity run, and ``heat_deformed_1d`` through run_scan
  and run() against live gdm (1e-10) and the committed x64 oracle
  (tests/data/cpu_oracle_rows.json; 1e-9, since live gdm is 6.4e-10
  from it).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.cut.geometry import INSIDE as G_INSIDE, OUTSIDE as G_OUTSIDE
from gdm.cut.geometry import CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.grid import Grid as GGrid
from gdm.problems import wave as gwave

from gdm_torch.cut.geometry import INSIDE, OUTSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.grid import Grid
from gdm_torch.problems import wave

F64 = torch.float64
ORACLE = os.path.join(os.path.dirname(__file__), "data",
                      "cpu_oracle_rows.json")
TABLES = ("A_mass", "A_stiff", "cat_full", "V_full_cat", "full_phys_q",
          "w_q_cell", "vol_w", "V_cut", "G_cut", "cut_phys_q", "surf_w",
          "surf_n", "V_surf", "G_surf", "surf_phys_q", "gp_J", "gp_w",
          "gp_mat", "gp_win", "b_V", "b_G", "b_w", "b_phys", "b_normal_q",
          "b_win", "inactive", "w_full", "w_cut")


def warp(pts):
    """gdm's tests/test_cut_deform.py map (max displacement ~0.05)."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[..., 0], pts[..., 1]
    return np.stack(
        [x + 0.05 * np.sin(np.pi * x / 1.21) * np.cos(0.5 * np.pi * y / 1.21),
         y - 0.04 * np.sin(np.pi * y / 1.21) * np.cos(0.5 * np.pi * x / 1.21)],
        axis=-1)


def warp1(pts):
    pts = np.asarray(pts, dtype=np.float64)
    return pts + 0.04 * np.sin(np.pi * pts / 1.21)


def warp3(pts):
    pts = np.asarray(pts, dtype=np.float64)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    s = 0.04 * np.sin(np.pi * x / 1.21) * np.cos(0.5 * np.pi * y / 1.21)
    return np.stack([x + s, y - 0.5 * s, z + 0.02 * np.sin(np.pi * z / 1.21)],
                    axis=-1)


MAPS = {1: warp1, 2: warp, 3: warp3}


def _ls(radius):
    return lambda m: np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - radius


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    if a.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _ops(dim, n, radius, location, mapping, geometry="q1"):
    args = (3, (n,) * dim, (-1.21,) * dim, (1.21,) * dim)
    tgeo = CutGeometry.build(Grid(*args), _ls(radius), 3)
    ggeo = GCutGeometry.build(GGrid(*args), _ls(radius), 3)
    gloc = G_INSIDE if location == INSIDE else G_OUTSIDE
    return (CutOperators(tgeo, location, mapping_fn=mapping,
                         geometry=geometry),
            GCutOperators(ggeo, gloc, mapping_fn=mapping, geometry=geometry))


CASES = {
    # a disc that cuts the domain boundary gives boundary-face tables
    "2d-inside-q1": (2, 16, 1.3, INSIDE, "q1"),
    "2d-outside-q1": (2, 16, 1.0, OUTSIDE, "q1"),
    "2d-inside-exact": (2, 12, 1.3, INSIDE, "exact"),
    "2d-outside-exact": (2, 12, 0.9, OUTSIDE, "exact"),
    "1d-inside-q1": (1, 20, 1.0, INSIDE, "q1"),
    "1d-outside-exact": (1, 20, 1.0, OUTSIDE, "exact"),
    "3d-inside-q1": (3, 6, 0.9, INSIDE, "q1"),
}


@pytest.fixture(scope="module", params=list(CASES))
def deformed(request):
    dim, n, radius, location, geometry = CASES[request.param]
    top, gop = _ops(dim, n, radius, location, MAPS[dim], geometry)
    return {"dim": dim, "top": top, "gop": gop, "case": request.param}


def test_deformed_tables_match_gdm(deformed):
    top, gop = deformed["top"], deformed["gop"]
    assert top.w_q_cell is not None and len(top.full_ids)
    assert np.array_equal(top.cat_full, np.arange(len(top.full_ids)))
    if deformed["case"].startswith("2d-inside"):
        assert len(top.b_win) > 0 and len(top.gp_win) > 0
    for name in TABLES:
        a, b = getattr(top, name), getattr(gop, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert _rel(a, b) <= 1e-12, name


def test_deformed_applies_match_gdm(deformed):
    top, gop = deformed["top"], deformed["gop"]
    N = top.grid.n_nodes
    u = np.random.default_rng(5).standard_normal(N)
    ut, ug = torch.as_tensor(u), jnp.asarray(u)
    assert _rel(top.mass_apply(ut, 0.75).numpy(),
                np.asarray(gop.mass_apply(ug, 0.75))) <= 1e-12
    for nit in (True, False):
        assert _rel(
            top.stiffness_matrix_apply(ut, 1.5, 15.0, nit).numpy(),
            np.asarray(gop.stiffness_matrix_apply(ug, 1.5, 15.0, nit))
        ) <= 1e-12

    def f(pts, t):
        x = np.asarray(pts)
        return np.sin(x[..., 0]) * np.cos(x[..., -1]) + t

    kw = dict(rhs_fn=f, interface_dbc=f, domain_dbc=f, gamma_A=1.5,
              nitsche_gamma=15.0)
    kwg = {k: ((lambda p, t: jnp.asarray(f(p, t))) if callable(v) else v)
           for k, v in kw.items()}
    for impl in (True, False):
        yt = top.compute_rhs(ut, 0.1, impl, **kw)
        yg = gop.compute_rhs(ug, 0.1, impl, **kwg)
        assert _rel(yt.numpy(), np.asarray(yg)) <= 1e-12
    et = top.error_norms(ut, f, 0.2)
    eg = [float(x) for x in gop.error_norms(
        ug, lambda p, t: jnp.asarray(f(p, t)), 0.2)]
    assert all(isinstance(x, float) for x in et)
    assert _rel(et, eg) <= 1e-12
    # the full cells' per-cell matrices go to the device once per dtype,
    # with no gathered copy of the host table
    assert top._host_table("A_stiff_full") is top.A_stiff
    key = ("A_stiff_full", ut.device, F64)
    first = top._tables[key]
    top.compute_rhs(ut, 0.3, False, **kw)
    assert top._tables[key] is first


@pytest.mark.parametrize("dim,n", [(2, 20), (3, 8)])
def test_identity_map_is_the_undeformed_operator(dim, n):
    """gdm's tests/test_cut_deform.py identity checks, on the port: the
    identity Q1 chart takes the re-metric path with det = 1, A = I and
    gives the undeformed operators to roundoff."""
    args = (3, (n,) * dim, (-1.21,) * dim, (1.21,) * dim)
    geo = CutGeometry.build(Grid(*args), _ls(1.0), 3)
    op0 = CutOperators(geo, INSIDE)
    op1 = CutOperators(geo, INSIDE, mapping_fn=lambda p: p, geometry="q1")
    v = torch.as_tensor(np.random.default_rng(dim).standard_normal(
        geo.grid.n_nodes))
    m0, m1 = op0.mass_apply(v, 0.75), op1.mass_apply(v, 0.75)
    assert (m1 - m0).abs().max() <= 1e-12 * m0.abs().max()
    s0 = op0.stiffness_matrix_apply(v, 1.5, 15.0)
    s1 = op1.stiffness_matrix_apply(v, 1.5, 15.0)
    assert (s1 - s0).abs().max() <= 1e-11 * s0.abs().max()


def _scaled_dev(port_rows, gdm_rows):
    m = np.asarray(port_rows, np.float64)
    g = np.asarray(gdm_rows, np.float64)
    assert m.shape == g.shape
    assert np.array_equal(m[:, 0], g[:, 0])
    assert np.abs(m[:, 1] - g[:, 1]).max() <= 1e-12
    return (np.abs(m[:, 2:] - g[:, 2:]).max(axis=0)
            / np.abs(g[:, 2:]).max(axis=0))


def _params(mod, name, dim, n, end_t, mapping=warp, **changes):
    p = mod.make_preset(name, dim)
    p.n_subdivisions_1D = n
    if end_t is not None:
        p.end_t = end_t
    p.mapping_q_cache_function = mapping
    for k, v in changes.items():
        setattr(p, k, v)
    if name == "step85":
        # under a deformation the interface is no longer |x| = 1: the
        # manufactured solution itself is the Dirichlet data (gdm's test)
        p.function_interface_dbc = p.exact_solution
    return p


@pytest.mark.parametrize("name,n,end_t,changes", [
    ("heat", 16, 0.1, {}),
    ("wave", 16, 0.1, {}),
    ("step85", 32, None, dict(solver_name="MG", solver_rel_tolerance=1e-10)),
], ids=["heat-impl-16", "wave-rk-16", "step85-mg-32"])
def test_deformed_rows_match_gdm(name, n, end_t, changes):
    port = wave.WaveProblem(_params(wave, name, 2, n, end_t, **changes),
                            verbose=False, device="cpu", dtype=F64)
    rows = port.run()[0]
    grows = gwave.WaveProblem(_params(gwave, name, 2, n, end_t, **changes),
                              verbose=False).run()[0]
    assert len(rows) == len(grows) >= 1
    assert (_scaled_dev(rows, grows) <= 1e-10).all()
    if name == "step85":
        assert rows[-1][2] < 5e-3
        assert port.poisson_info["iterations"] <= 15


def test_interpolate_exact_at_the_deformed_nodes():
    from gdm_torch import deform

    p = _params(wave, "heat", 2, 8, None)
    port = wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64)
    gp = _params(gwave, "heat", 2, 8, None)
    u = port.interpolate_exact(0.05)
    ug = np.asarray(gwave.WaveProblem(gp, verbose=False)
                    .interpolate_exact(0.05))
    assert u.dtype == F64 and _rel(u.numpy(), ug) <= 1e-14
    verts = deform.deformed_node_positions(port.grid, warp)
    assert _rel(u.numpy(), np.asarray(p.exact_solution(verts, 0.05))
                .reshape(-1)) <= 1e-14


def test_composite_identity_run():
    """gdm's composite identity check on the port: both location slots of
    heat-composite 1D under the identity map equal the undeformed rows,
    and gdm's identity rows."""
    def run(mod, mapping, **kw):
        p = mod.make_preset("heat-composite", 1)
        p.n_subdivisions_1D = 24
        p.end_t = 0.02
        p.mapping_q_cache_function = mapping
        return mod.WaveProblem(p, verbose=False, **kw).run()

    kw = dict(device="cpu", dtype=F64)
    plain = run(wave, None, **kw)
    ident = run(wave, lambda p: p, **kw)
    gident = run(gwave, lambda p: p)
    for slot in (0, 1):
        assert len(plain[slot]) >= 2
        np.testing.assert_allclose(np.asarray(ident[slot])[:, 2:],
                                   np.asarray(plain[slot])[:, 2:],
                                   rtol=1e-9)
        assert (_scaled_dev(ident[slot], gident[slot]) <= 1e-10).all()


def test_heat_deformed_1d_run_scan_matches_the_oracle():
    """scripts/make_cpu_oracles.py's heat_deformed_1d (heat preset, 1D,
    40 cells, a sine vertex map, to t = 0.02) through run_scan and run()
    against live gdm's run_scan and run() within 1e-10, and against the
    committed x64 rows within 1e-9: live gdm itself is 6.4e-10 (Linf
    column) from those rows on this CPU, the CG solves' rounding."""
    def params(mod):
        p = mod.make_preset("heat", 1)
        p.n_subdivisions_1D = 40
        p.end_t = p.start_t + 0.02
        p.mapping_q_cache_function = lambda pts: (
            np.asarray(pts, float)
            + 0.04 * np.sin(np.pi * np.asarray(pts, float) / 1.21))
        return p

    with open(ORACLE) as f:
        oracle = json.load(f)["heat_deformed_1d"]["rows"]
    for method in ("run_scan", "run"):
        port = wave.WaveProblem(params(wave), verbose=False, device="cpu",
                                dtype=F64)
        rows = (port.run_scan(chunk=2) if method == "run_scan"
                else port.run())[0]
        gprob = gwave.WaveProblem(params(gwave), verbose=False)
        getattr(gprob, method)()
        assert len(rows) == len(oracle) == 3
        assert (_scaled_dev(rows, gprob.rows[0]) <= 1e-10).all(), method
        assert (_scaled_dev(rows, oracle) <= 1e-9).all(), method
