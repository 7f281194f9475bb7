"""Grid deformation in the port (gdm_torch.deform, the deformed Poisson
solve, DataOut under a mapping, the wave-ev tools) against gdm under
x64, on the CPU in float64.

Every public function of gdm.deform and ``metric_at_cell_points`` is
held within 1e-12 relative of gdm's in 1D, 2D and 3D, for the q1 and
exact geometries and for vectorized and per-point maps (and gdm's
branching per-point clamp map).  ``solve_deformed`` takes gdm's four
preconditioner forms with gdm's iteration counts and a solution within
1e-10 of max|gdm|; DataOut's deformed patch points and file bytes equal
gdm's; ``build_ev_operators`` in each of its branches and
``wave_ev.main`` equal gdm's (matrices within 1e-12, printed spectra).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdm import deform as gdeform
from gdm.constraints import Constraints as GConstraints
from gdm.grid import Grid as GGrid
from gdm.io.vtu import DataOut as GDataOut
from gdm.problems import poisson as gpoisson
from gdm.tools import eigen as geigen
from gdm.tools import wave_ev as gwave_ev

from gdm_torch import deform
from gdm_torch.constraints import Constraints
from gdm_torch.grid import Grid
from gdm_torch.io.vtu import DataOut
from gdm_torch.problems import poisson
from gdm_torch.tools import eigen, wave_ev

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def bump(pts):
    x, y = pts[:, 0], pts[:, 1]
    s = 0.06 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y)
    return np.stack([x + s, y + 0.7 * s], -1)


def warp3(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    s = 0.05 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y) * np.sin(
        2 * np.pi * z)
    return np.stack([x + s, y - 0.6 * s, z + 0.3 * s], -1)


def squeeze1(pts):
    return np.stack([pts[:, 0] + 0.04 * np.sin(np.pi * pts[:, 0])], -1)


MAPS = {1: squeeze1, 2: bump, 3: warp3}
CELLS = {1: (7,), 2: (6, 5), 3: (3, 4, 3)}
EXACT = lambda m, c: np.sin(np.pi * m[0]) * np.sin(np.pi * m[1])  # noqa
RHS = lambda m, c: 2 * np.pi**2 * np.sin(np.pi * m[0]) * np.sin(  # noqa
    np.pi * m[1])


def _f(m, c):
    return np.cos(1.3 * m[0]) + sum(0.5 * x for x in m[1:])


def _map(dim, form):
    fn = MAPS[dim]
    if form == "vectorized":
        return fn
    # (dim,) -> (dim,): a per-point map fed an (N, dim) chunk returns
    # the wrong shape or raises, so the single-point probe sends it down
    # the scalar path
    return lambda p: fn(np.asarray(p, np.float64).reshape(1, -1))[0]


def _grids(dim):
    cells = CELLS[dim]
    upper = (1.0, 1.1, 0.9)[:dim]
    return (Grid(3, cells, (0.0,) * dim, upper),
            GGrid(3, cells, (0.0,) * dim, upper))


@pytest.mark.parametrize("form", ["vectorized", "per-point"])
@pytest.mark.parametrize("geometry", ["q1", "exact"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_deform_functions_match_gdm(dim, geometry, form):
    t, g = _grids(dim)
    fn = _map(dim, form)
    kw = dict(geometry=geometry)
    assert np.array_equal(deform.deformed_node_positions(t, fn),
                          gdeform.deformed_node_positions(g, fn))
    for name in ("mass_band", "laplace_band"):
        a = getattr(deform, name)(t, fn, **kw)
        b = getattr(gdeform, name)(g, fn, **kw)
        assert a.radius == b.radius
        assert _rel(a.band_host, b.band_host) <= 1e-12, name
    assert _rel(deform.load_vector(t, fn, _f, **kw),
                gdeform.load_vector(g, fn, _f, **kw)) <= 1e-12
    u = np.random.default_rng(dim).standard_normal(t.n_nodes)
    e_t = deform.l2_error(t, fn, torch.as_tensor(u), _f, **kw)
    e_g = gdeform.l2_error(g, fn, u, _f, **kw)
    assert isinstance(e_t, float) and abs(e_t - e_g) <= 1e-12 * e_g
    assert np.array_equal(deform.interpolate(t, fn, _f),
                          gdeform.interpolate(g, fn, _f))
    ids = np.arange(t.n_cells)[::2]
    ref = np.random.default_rng(7).uniform(size=(5, dim))
    assert _rel(deform.map_reference_points(t, fn, ids, ref, geometry),
                gdeform.map_reference_points(g, fn, ids, ref,
                                             geometry)) <= 1e-12
    pts = np.random.default_rng(8).uniform(size=(len(ids), 4, dim))
    verts = (deform.deformed_node_positions(t, fn) if geometry == "q1"
             else None)
    for a, b in zip(
            deform.metric_at_cell_points(t, fn, geometry, verts, ids, pts),
            gdeform.metric_at_cell_points(g, fn, geometry, verts, ids, pts)):
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_dirichlet_band_matches_gdm(dim):
    t, g = _grids(dim)
    mask = np.asarray(Constraints.zero_boundary(t, device="cpu")
                      .full_mask).reshape(-1)
    assert np.array_equal(
        mask, np.asarray(GConstraints.zero_boundary(g).full_mask).reshape(-1))
    a = deform.dirichlet_band(deform.laplace_band(t, MAPS[dim]), mask)
    b = gdeform.dirichlet_band(gdeform.laplace_band(g, MAPS[dim]), mask)
    assert _rel(a.band_host, b.band_host) <= 1e-12
    u = np.random.default_rng(0).standard_normal(t.n_nodes)
    y = a.apply(torch.as_tensor(u)).numpy()
    assert _rel(y, np.asarray(b.apply(jnp.asarray(u)))) <= 1e-12


def test_branching_per_point_map():
    """gdm's clamp map (a per-point map with data-dependent branches)
    takes the scalar path and gives the operator of its vectorized
    form, and gdm's operator."""
    t, g = Grid(3, (8, 8), (0.0, 0.0), (1.0, 1.0)), GGrid(
        3, (8, 8), (0.0, 0.0), (1.0, 1.0))

    def clamp_pp(p):  # (dim,) -> (dim,); raises on an (N, dim) chunk
        x, y = float(p[0]), float(p[1])
        if x > 0.75:
            x = 0.75 + 0.5 * (x - 0.75)
        return np.array([x, y])

    def clamp_vec(pts):
        x, y = pts[:, 0].copy(), pts[:, 1]
        sel = x > 0.75
        x[sel] = 0.75 + 0.5 * (x[sel] - 0.75)
        return np.stack([x, y], -1)

    b1 = deform.mass_band(t, clamp_pp).band_host
    b2 = deform.mass_band(t, clamp_vec).band_host
    np.testing.assert_allclose(b1, b2, atol=1e-15)
    assert _rel(b1, gdeform.mass_band(g, clamp_pp).band_host) <= 1e-12


def test_orientation_reversing_map_raises():
    t = Grid(3, (4, 4), (0.0, 0.0), (1.0, 1.0))
    with pytest.raises(AssertionError, match="orientation"):
        deform.mass_band(t, lambda p: p[:, ::-1])


def _dirichlet(t, g, fn):
    mask = np.asarray(GConstraints.zero_boundary(g).full_mask).reshape(-1)
    return (deform.dirichlet_band(deform.laplace_band(t, fn), mask),
            gdeform.dirichlet_band(gdeform.laplace_band(g, fn), mask))


def test_multigrid_preconditioner_matches_gdm():
    """One V-cycle of the never-cut multigrid on the condensed deformed
    band, and its levels, against gdm's."""
    t, g = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0)), GGrid(
        3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    a, b = _dirichlet(t, g, bump)
    pre_t = deform.multigrid_preconditioner(a, device="cpu", dtype=F64)
    pre_g = gdeform.multigrid_preconditioner(b)
    assert len(pre_t.__self__.levels) == len(pre_g.__self__.levels) == 2
    r = np.random.default_rng(4).standard_normal(t.n_nodes)
    assert _rel(pre_t(torch.as_tensor(r)).numpy(),
                np.asarray(pre_g(jnp.asarray(r)))) <= 1e-12


def test_multigrid_preconditioner_needs_even_cells():
    t = Grid(3, (9, 10), (0.0, 0.0), (1.0, 1.0))
    st = deform.laplace_band(t, bump)
    with pytest.raises(ValueError, match="even"):
        deform.multigrid_preconditioner(st, device="cpu")


def _gdm_solve(n, precondition, geometry="q1", fn=bump, rhs=RHS, dim=2):
    g = GGrid(3, (n,) * dim, (0.0,) * dim, (1.0,) * dim)
    if precondition == "callable":
        _, b = _dirichlet(Grid(3, (n,) * dim, (0.0,) * dim, (1.0,) * dim),
                          g, fn)
        precondition = gdeform.multigrid_preconditioner(b)
    u, info = gpoisson.solve_deformed(g, fn, rhs, geometry=geometry,
                                      precondition=precondition)
    return np.asarray(u), int(info["iterations"])


@pytest.mark.parametrize("precondition,geometry", [
    ("jacobi", "q1"), ("mg", "q1"), ("none", "q1"), ("callable", "q1"),
    ("jacobi", "exact")])
def test_solve_deformed_matches_gdm(precondition, geometry):
    n = 16
    t = Grid(3, (n, n), (0.0, 0.0), (1.0, 1.0))
    pre = precondition
    if precondition == "callable":
        a, _ = _dirichlet(t, GGrid(3, (n, n), (0.0, 0.0), (1.0, 1.0)), bump)
        pre = deform.multigrid_preconditioner(a, device="cpu", dtype=F64)
    u, info = poisson.solve_deformed(t, bump, RHS, geometry=geometry,
                                     precondition=pre, device="cpu")
    ug, it_g = _gdm_solve(n, precondition, geometry)
    assert u.shape == t.nodes + (1,) and u.dtype == F64
    assert isinstance(info["iterations"], int)
    assert info["iterations"] == it_g
    assert np.abs(u.numpy() - ug).max() <= 1e-10 * np.abs(ug).max()
    e_t = deform.l2_error(t, bump, u, EXACT, geometry=geometry)
    assert e_t == pytest.approx(
        {"q1": 5.4758e-04, "exact": 9.1348e-05}[geometry], rel=1e-3)


def test_solve_deformed_3d_matches_gdm():
    """The 3D deformed solve (the plain tap loop, 343 taps) at 8^3 with
    gdm's Jacobi CG: gdm's iterations and solution, gdm's pinned error."""
    rhs3 = lambda m, c: 3 * np.pi**2 * np.sin(np.pi * m[0]) * np.sin(  # noqa
        np.pi * m[1]) * np.sin(np.pi * m[2])
    exact3 = lambda m, c: np.sin(np.pi * m[0]) * np.sin(  # noqa
        np.pi * m[1]) * np.sin(np.pi * m[2])
    t = Grid(3, (8, 8, 8), (0.0,) * 3, (1.0,) * 3)
    u, info = poisson.solve_deformed(t, warp3, rhs3, device="cpu")
    ug, it_g = _gdm_solve(8, "jacobi", fn=warp3, rhs=rhs3, dim=3)
    assert info["iterations"] == it_g
    assert np.abs(u.numpy() - ug).max() <= 1e-10 * np.abs(ug).max()
    assert deform.l2_error(t, warp3, u, exact3) == pytest.approx(
        9.0930e-04, rel=1e-3)


def test_system_deformed_float32_and_split():
    """The split form: setup stages timed, the condensed band kept, and
    float32 within one iteration and 1e-4 of float64 (rel 1e-6)."""
    t = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    s64 = poisson.system_deformed(t, bump, RHS, precondition="mg",
                                  device="cpu")
    assert set(s64.setup_s) == {"assembly", "dirichlet", "load",
                                "preconditioner"}
    assert s64.band.radius == 3 and s64.b.shape == (t.n_nodes,)
    x64, i64 = s64.run(rel_tol=1e-6)
    x32, i32 = poisson.system_deformed(
        t, bump, RHS, precondition="mg", device="cpu",
        dtype=torch.float32).run(rel_tol=1e-6)
    assert x32.dtype == torch.float32
    assert abs(i32["iterations"] - i64["iterations"]) <= 1
    assert ((x32.double() - x64).norm() / x64.norm()).item() <= 1e-4


def test_solve_deformed_refuses_unknown_preconditioner():
    with pytest.raises(ValueError, match="ilu"):
        poisson.solve_deformed(Grid(3, (8, 8), (0.0, 0.0), (1.0, 1.0)),
                               bump, RHS, precondition="ilu", device="cpu")


def test_solve_deformed_defaults_to_the_card():
    import inspect

    sig = inspect.signature(poisson.solve_deformed).parameters
    assert sig["device"].default == "cuda"
    assert list(sig)[:8] == ["grid", "mapping_fn", "rhs_fn", "geometry",
                             "rel_tol", "abs_tol", "max_iter",
                             "precondition"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        poisson.solve_deformed(Grid(3, (8, 8), (0.0, 0.0), (1.0, 1.0)),
                               bump, RHS)


@pytest.mark.parametrize("geometry", ["q1", "exact"])
def test_vtu_deformed_points_match_gdm(tmp_path, geometry):
    t, g = Grid(3, (6, 6), (0.0, 0.0), (1.0, 1.0)), GGrid(
        3, (6, 6), (0.0, 0.0), (1.0, 1.0))
    u = gdeform.interpolate(g, bump, _f)
    outs = []
    for cls, grid in ((DataOut, t), (GDataOut, g)):
        d = cls(grid, output_degree=2, mapping_fn=bump, geometry=geometry)
        d.add_data_vector(u, "u")
        outs.append(d)
    pt, pg = outs[0]._patches()[0], outs[1]._patches()[0]
    assert np.array_equal(pt, pg)
    plain = DataOut(t, output_degree=2)
    plain.add_data_vector(u, "u")
    assert np.abs(plain._patches()[0] - pt).max() > 1e-2
    texts = []
    for d, name in zip(outs, ("port", "gdm")):
        path = tmp_path / f"{name}.vtu"
        d.write_vtu(str(path))
        texts.append(path.read_bytes())
    assert texts[0] == texts[1]


def _ev_cases():
    squeeze = lambda pts: np.stack([pts[:, 0] + 0.1 * np.sin(  # noqa
        np.pi * pts[:, 0] / 1.21)], -1)

    def warp(pts):
        x, y = pts[..., 0], pts[..., 1]
        return np.stack(
            [x + 0.05 * np.sin(np.pi * x / 1.21)
             * np.cos(0.5 * np.pi * y / 1.21),
             y - 0.04 * np.sin(np.pi * y / 1.21)
             * np.cos(0.5 * np.pi * x / 1.21)], axis=-1)

    return {
        "uncut 1D map": dict(fe_degree=3, n_subdivisions_1D=12, dim=1,
                             mapping_fn=squeeze),
        "uncut 2D map": dict(fe_degree=3, n_subdivisions_1D=6, dim=2,
                             mapping_fn=warp),
        "cut 2D map": dict(fe_degree=3, n_subdivisions_1D=8, dim=2,
                           alpha=0.3, mapping_fn=warp, mapping_cut=True),
        "cut 2D exact map": dict(fe_degree=3, n_subdivisions_1D=8, dim=2,
                                 alpha=0.3, mapping_fn=warp,
                                 mapping_cut=True,
                                 mapping_geometry="exact"),
        "align 1D": dict(fe_degree=3, n_subdivisions_1D=20, alpha=0.3,
                         align=True),
        "alpha 1D": dict(fe_degree=5, n_subdivisions_1D=20, alpha=0.25),
    }


@pytest.mark.parametrize("case", list(_ev_cases()))
def test_build_ev_operators_match_gdm(case):
    kw = _ev_cases()[case]
    _, op, M, S = eigen.build_ev_operators(device="cpu", **kw)
    _, gop, Mg, Sg = geigen.build_ev_operators(**kw)
    assert (op is None) == (gop is None)
    assert M.dtype == np.float64 and M.shape == Mg.shape
    assert _rel(M, Mg) <= 1e-12 and _rel(S, Sg) <= 1e-12
    ka, _ = eigen.condition_number(M, rescale=True)
    kb, _ = geigen.condition_number(Mg, rescale=True)
    assert abs(ka - kb) <= 1e-8 * abs(kb)


def test_densify_columns_on_the_device():
    A = np.random.default_rng(0).standard_normal((9, 9))
    At = torch.as_tensor(A)
    D = eigen.densify(lambda v: At.to(v.dtype) @ v, 9, device="cpu")
    assert np.array_equal(D, A)
    D32 = eigen.densify(lambda v: At.to(v.dtype) @ v, 9, device="cpu",
                        dtype=torch.float32)
    assert D32.dtype == np.float64 and _rel(D32, A) <= 1e-6


@pytest.mark.parametrize("argv", [
    ["--compute_kappa_m", "--compute_gev", "--fe_degree", "3",
     "--n_subdivisions", "20", "--alpha", "0.3", "--align", "--write_m",
     "--write_ascii", "--file_prefix", "out"],
    ["--compute_kappa_m", "--compute_gev", "--fe_degree", "3",
     "--n_subdivisions", "8", "--alpha", "0.3", "--dim", "2",
     "--rescale_matrix", "--write_s"],
], ids=["align", "alpha-2d"])
def test_wave_ev_cli_matches_gdm(argv, capsys, tmp_path, monkeypatch):
    outs = []
    for name, main in (("port", lambda a: wave_ev.main(a, device="cpu")),
                       ("gdm", gwave_ev.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        main(list(argv))
        outs.append(capsys.readouterr().out)
    assert "condition number:" in outs[0]

    def numbers(text):
        return np.array([float(w) for w in text.split()
                         if w[0] in "-0123456789"])

    a, b = numbers(outs[0]), numbers(outs[1])
    assert a.shape == b.shape and _rel(a, b) <= 1e-8
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "gdm").iterdir())
    assert files
    for f in files:
        pa = (tmp_path / "port" / f).read_bytes()
        pb = (tmp_path / "gdm" / f).read_bytes()
        if f.endswith("S.dat") and "--write_ascii" not in argv:
            x = np.frombuffer(pa, dtype=[("r", "<u4"), ("c", "<u4"),
                                         ("v", "<f8")])
            y = np.frombuffer(pb, dtype=[("r", "<u4"), ("c", "<u4"),
                                         ("v", "<f8")])
            assert np.array_equal(x[["r", "c"]], y[["r", "c"]])
            assert _rel(x["v"], y["v"]) <= 1e-12
        else:
            assert len(pa) == len(pb)
