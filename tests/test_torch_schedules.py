"""K5 and K3s, and gdm's 3D dispatch, against gdm under x64 on the CPU.

The port's wrappers run their plain twins for CPU tensors.  gdm's
kernels run as gdm's own tests run them (tests/test_pallas_kernel.py):
in interpret mode, float64, where K5's plane coupling and K3s's row
stage are float32 hi/lo products; and against gdm's XLA separable apply
(``laplace_apply_fn(use_pallas="never")``).  Tolerance: 2e-12 of
max|y|, gdm's own for those split products.

The dispatch ``best_padded_laplace`` takes K5 while N0 + 2p <= 512 and
K4 above, as gdm's does; the 3D solve therefore runs K5's twin on the
CPU, with gdm's iteration counts.  Entry points default to the card.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.grid import Grid as GGrid
from gdm.ops import laplace_apply_fn as g_laplace_apply_fn
from gdm.ops.pallas_stencil2 import (
    make_padded_laplace2_stream as g_make2s,
    make_padded_laplace3_mxu as g_make3m)

import gdm_torch
from gdm_torch import device, functional, multigrid, operators, solvers
from gdm_torch.apps import wave_app
from gdm_torch.benchmarks import mxu_micro
from gdm_torch.constraints import Constraints
from gdm_torch.cut import fastapply, fsai
from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.cut.multigrid import CutMultigrid
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil, kernel_route
from gdm_torch.grid import Grid
from gdm_torch.multigrid import PoissonMultigrid
from gdm_torch.ops import cutband, fast, resident, stencil, stencil2, stencil3
from gdm_torch.ops.tensor import SeparableOperator
from gdm_torch.problems import poisson
from gdm_torch.problems.wave import WaveProblem

F64 = torch.float64
TOL = 2e-12


def _rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _gdm_kernel(make, ggrid, u, **kw):
    ap, pad, unpad, _ = make(ggrid, jnp.float64, interpret=True, **kw)
    return np.asarray(unpad(ap(pad(jnp.asarray(u)))))


def _gdm_xla(ggrid, u):
    return np.asarray(g_laplace_apply_fn(ggrid, jnp.float64,
                                         use_pallas="never")(jnp.asarray(u)))


@pytest.mark.parametrize("p,cells", [
    (3, (12, 12, 12)), (5, (10, 9, 11)), (7, (9, 8, 10))])
def test_k5_plain_matches_gdm(p, cells):
    args = (p, cells, (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    grid, ggrid = Grid(*args), GGrid(*args)
    u = np.random.default_rng(p).standard_normal(grid.nodes)
    apply, pad, unpad, shape = stencil3.make_padded_laplace3_mxu(grid, F64,
                                                                 device="cpu")
    assert shape == grid.nodes and apply.kernel is stencil3.laplace3_mxu_apply
    before = stencil3.laplace3_mxu_apply.launches
    y = unpad(apply(pad(torch.as_tensor(u))))
    assert stencil3.laplace3_mxu_apply.launches == before  # no kernel on CPU
    assert _rel(y, _gdm_kernel(g_make3m, ggrid, u, pipelined=True)) <= TOL
    assert _rel(y, _gdm_xla(ggrid, u)) <= TOL


@pytest.mark.parametrize("p,cells", [(3, (40, 72)), (5, (48, 40)),
                                     (7, (32, 33))])
def test_k3s_plain_matches_gdm(p, cells):
    args = (p, cells, (0.0, 0.0), (1.0, 2.0))
    grid, ggrid = Grid(*args), GGrid(*args)
    u = np.random.default_rng(p).standard_normal(grid.nodes)
    apply, pad, unpad, shape = stencil2.make_padded_laplace2_stream(
        grid, F64, device="cpu")
    assert shape == grid.nodes
    assert apply.kernel is stencil2.laplace2_stream_apply
    before = stencil2.laplace2_stream_apply.launches
    y = unpad(apply(pad(torch.as_tensor(u))))
    assert stencil2.laplace2_stream_apply.launches == before
    assert _rel(y, _gdm_kernel(g_make2s, ggrid, u, tile_r=16)) <= TOL
    assert _rel(y, _gdm_xla(ggrid, u)) <= TOL


def test_k3s_four_factor_bands():
    """Four distinct factors: a swap of the axes' A and B factors is
    another operator and must fail against gdm's kernel."""
    args = (3, (37, 45), (0.0, 0.0), (1.0, 1.0))
    grid, ggrid = Grid(*args), GGrid(*args)
    n0, n1 = grid.nodes
    rng = np.random.default_rng(22)
    bands = tuple(rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1))
    u = rng.standard_normal(grid.nodes)
    apply, pad, unpad, _ = stencil2.make_padded_laplace2_stream(
        grid, F64, bands=bands, device="cpu")
    y = unpad(apply(pad(torch.as_tensor(u))))
    want = _gdm_kernel(g_make2s, ggrid, u, tile_r=16, bands=bands)
    assert _rel(y, want) <= TOL
    crossed = (bands[0], bands[3], bands[2], bands[1])
    yc = stencil2.laplace2_stream_apply(
        torch.as_tensor(u), stencil2.laplace2_bands(grid, "cpu", F64,
                                                    crossed))
    assert _rel(yc, want) > 1e-3


@pytest.mark.parametrize("cells,kernel,plain", [
    ((505, 4, 4), "laplace3_mxu_apply", "laplace3_mxu_apply_plain"),
    ((506, 4, 4), "laplace3_apply", "laplace3_apply_plain"),
])
def test_dispatch_boundary(monkeypatch, cells, kernel, plain):
    """N0 + 2p = 512 takes K5, 513 takes K4; on the CPU the public apply
    runs that kernel's twin and launches nothing."""
    grid = Grid(3, cells, (0.0,) * 3, (1.0,) * 3)
    assert grid.nodes[0] + 2 * grid.degree == cells[0] + 7
    apply = fast.best_padded_laplace(grid, F64, device="cpu")[0]
    assert apply.kernel is getattr(stencil3, kernel)
    calls = {name: 0 for name in ("laplace3_mxu_apply_plain",
                                  "laplace3_apply_plain")}
    for name in calls:
        fn = getattr(stencil3, name)

        def spy(u, bt, fn=fn, name=name):
            calls[name] += 1
            return fn(u, bt)

        monkeypatch.setattr(stencil3, name, spy)
    launches = (stencil3.laplace3_apply.launches,
                stencil3.laplace3_mxu_apply.launches)
    u = np.random.default_rng(9).standard_normal(grid.nodes)
    y = fast.laplace_apply_fn(grid, F64, device="cpu")(torch.as_tensor(u))
    assert calls[plain] == 1 and sum(calls.values()) == 1
    assert (stencil3.laplace3_apply.launches,
            stencil3.laplace3_mxu_apply.launches) == launches
    ggrid = GGrid(3, cells, (0.0,) * 3, (1.0,) * 3)
    assert _rel(y, _gdm_xla(ggrid, u)) <= TOL


def test_2d_dispatch_is_k3():
    grid = Grid(3, (16, 20), (0.0, 0.0), (1.0, 1.0))
    assert fast.best_padded_laplace(grid, F64, device="cpu")[0].kernel is (
        stencil2.laplace2_apply)


def _sin_rhs(m, c):
    v = len(m) * np.pi**2
    for x in m:
        v = v * np.sin(np.pi * x)
    return v


@pytest.mark.parametrize("pre,iterations", [("jacobi", 30), ("mg", 8)])
def test_3d_solve_runs_k5_twin(monkeypatch, pre, iterations):
    """The 16^3 solve goes through K5's twin on every level (N0 + 2p <=
    512) and keeps gdm's iteration counts (tests/test_torch_poisson.py
    holds the solutions against gdm's)."""
    calls = {"k5": 0, "k4": 0}
    for key, name in (("k5", "laplace3_mxu_apply_plain"),
                      ("k4", "laplace3_apply_plain")):
        fn = getattr(stencil3, name)

        def spy(u, bt, fn=fn, key=key):
            calls[key] += 1
            return fn(u, bt)

        monkeypatch.setattr(stencil3, name, spy)
    grid = Grid(3, (16, 16, 16), (0.0,) * 3, (1.0,) * 3)
    _, info = poisson.solve(grid, _sin_rhs, rel_tol=1e-10, precondition=pre,
                            device="cpu")
    assert info["iterations"] == iterations
    assert calls["k5"] > 0 and calls["k4"] == 0


ENTRY_POINTS = [
    gdm_torch.entry, poisson.solve, poisson.system, PoissonMultigrid,
    fast.laplace_apply_fn, fast.mass_apply_fn, fast.best_field_laplace,
    fast.best_padded_laplace, stencil2.make_padded_laplace2,
    stencil2.make_padded_laplace2_stream, stencil2.make_padded_laplace2_mxucol,
    stencil2.make_padded_laplace2_fullmxu, stencil2.make_padded_laplace2_hybrid,
    stencil2.make_padded_laplace2_hybp, stencil3.make_padded_laplace3,
    stencil3.make_padded_laplace3_mxu, cutband.make_padded_stencil2,
    resident.make_resident_cg, fastapply.fast_stencil_bundle,
    fsai.verified_fsai_solver, stencil.make_padded_laplace,
    stencil.laplace_2d_fn, fastapply.make_fast_cut_apply,
    fastapply.fast_stencil_apply, operators.mass, operators.laplace,
    operators.advection, operators.lumped_mass_inverse_diagonal,
    operators.elasticity, functional.load_vector, Constraints.none,
    Constraints.zero_boundary, Constraints.periodic, multigrid.make_transfer,
    SeparableOperator.from_banded, stencil2.laplace2_bands,
    stencil3.laplace3_bands, solvers.make_direct_solver, fsai.fsai_cg_solver,
    CutMultigrid, WaveProblem, wave_app.main]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_card_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    g2 = Grid(3, (8, 8), (0.0, 0.0), (1.0, 1.0))
    g2v = Grid(3, (8, 8), (0.0, 0.0), (1.0, 1.0), n_components=2)
    g3 = Grid(3, (6, 6, 6), (0.0,) * 3, (1.0,) * 3)
    gc = Grid(3, (8, 8), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(gc, lambda m: np.sqrt(sum(x**2 for x in m))
                            - 1.0, 3)
    op = CutOperators(geo, INSIDE)
    mass = assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))
    calls = [lambda: gdm_torch.entry(8),
             lambda: poisson.solve(g2, _sin_rhs),
             lambda: poisson.system(g2, _sin_rhs),
             lambda: PoissonMultigrid(g2),
             lambda: fast.laplace_apply_fn(g3),
             lambda: fast.mass_apply_fn(g2),
             lambda: fast.best_field_laplace(g2),
             lambda: stencil3.make_padded_laplace3_mxu(g3),
             lambda: stencil2.make_padded_laplace2_stream(g2),
             lambda: stencil2.make_padded_laplace2_mxucol(g2),
             lambda: stencil2.make_padded_laplace2_fullmxu(g2),
             lambda: stencil2.make_padded_laplace2_hybrid(g2),
             lambda: stencil2.make_padded_laplace2_hybp(g2),
             lambda: cutband.make_padded_stencil2(mass),
             lambda: resident.make_resident_cg(mass),
             lambda: fastapply.fast_stencil_bundle(mass),
             lambda: fsai.verified_fsai_solver(mass),
             lambda: stencil.make_padded_laplace(g2),
             lambda: stencil.laplace_2d_fn(g2),
             lambda: fastapply.make_fast_cut_apply(
                 mass, op, fastapply.kron_pairs(gc, "mass")),
             lambda: fastapply.fast_stencil_apply(mass),
             lambda: operators.mass(g2),
             lambda: operators.laplace(g2),
             lambda: operators.advection(g2, (1.0, 0.5)),
             lambda: operators.lumped_mass_inverse_diagonal(g2),
             lambda: operators.elasticity(g2v),
             lambda: functional.load_vector(g2, _sin_rhs),
             lambda: Constraints.none(g2),
             lambda: Constraints.zero_boundary(g2),
             lambda: Constraints.periodic(g2),
             lambda: multigrid.make_transfer(*multigrid._gd_mid_table(g2, 0)),
             lambda: SeparableOperator.from_banded(g2, []),
             lambda: stencil2.laplace2_bands(g2),
             lambda: stencil3.laplace3_bands(g3),
             lambda: solvers.make_direct_solver(lambda v: v, 4),
             lambda: fsai.fsai_cg_solver(mass, 100, 1e-8, 0.0)]
    calls += [lambda rows=rows: stencil2.make_padded_laplace2(g2, rows=rows)
              for rows in ("vpu", "mxu", "mxu3", "mxu3p")]
    calls += [lambda rows=rows: fast.best_padded_laplace(g2, rows=rows)
              for rows in (None, "mxu3p")]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_run_scan_runs_on_its_problems_device():
    """``WaveProblem.run_scan`` takes gdm's one parameter, ``chunk``, and
    runs where its problem does: on the card by default, raising
    without one; with ``device="cpu"`` on the CPU."""
    from gdm_torch.problems.wave import make_preset

    assert list(inspect.signature(WaveProblem.run_scan).parameters) == [
        "self", "chunk"]
    assert inspect.signature(WaveProblem).parameters[
        "device"].default == "cuda"
    p = make_preset("heat-impl", 1)
    p.n_subdivisions_1D, p.end_t = 10, 0.1
    rows = WaveProblem(p, verbose=False, device="cpu").run_scan()
    assert len(rows[0]) == 3
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WaveProblem(p, verbose=False).run_scan()


@functools.lru_cache(maxsize=None)
def _stencil_op():
    gc = Grid(3, (12, 12), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(gc, lambda m: np.sqrt(sum(x**2 for x in m))
                            - 1.0, 3)
    return gc, assemble_stencil(CutOperators(geo, INSIDE), "mass",
                                0.25 * np.sqrt(3.0))


G2 = Grid(3, (20, 24), (0.0, 0.0), (1.0, 2.0))
G3 = Grid(3, (9, 8, 10), (0.0,) * 3, (1.0, 2.0, 1.5))

# gdm's builder keywords the port takes: (builder, gdm keywords), each
# against the same builder without them
GDM_KEYWORDS = [
    ("stream tile_r", stencil2.make_padded_laplace2_stream, G2,
     {"tile_r": 96}),
    ("laplace3 tile_planes", stencil3.make_padded_laplace3, G3,
     {"tile_planes": 4}),
    ("laplace3_mxu tile_planes1", stencil3.make_padded_laplace3_mxu, G3,
     {"tile_planes1": 3}),
    ("laplace3_mxu chunk", stencil3.make_padded_laplace3_mxu, G3,
     {"chunk": 1024}),
    ("laplace3_mxu pipelined", stencil3.make_padded_laplace3_mxu, G3,
     {"pipelined": True}),
    ("laplace2 mxu_precision None", stencil2.make_padded_laplace2, G2,
     {"rows": "mxu", "mxu_precision": None}),
    ("laplace2 mxu_precision HIGHEST", stencil2.make_padded_laplace2, G2,
     {"rows": "mxu", "mxu_precision": "HIGHEST"}),
    ("laplace2 pipeline_interleave", stencil2.make_padded_laplace2, G2,
     {"rows": "mxu3p", "pipeline_interleave": True}),
    ("laplace2 no pipeline_interleave", stencil2.make_padded_laplace2, G2,
     {"rows": "mxu3p", "pipeline_interleave": False}),
    ("laplace2 static_parity", stencil2.make_padded_laplace2, G2,
     {"rows": "mxu3p", "static_parity": False}),
]


@pytest.mark.parametrize("builder,grid,kw",
                         [c[1:] for c in GDM_KEYWORDS],
                         ids=[c[0] for c in GDM_KEYWORDS])
def test_gdm_builder_keywords_taken(builder, grid, kw):
    """Each of gdm's keywords is taken (no TypeError) and leaves the
    function as it was; K4's tile_planes is its chunk of planes."""
    u = torch.as_tensor(np.random.default_rng(30).standard_normal(
        grid.nodes))
    plain_kw = {k: v for k, v in kw.items() if k == "rows"}
    apply, pad, unpad, shape = builder(grid, F64, device="cpu", **kw)
    ref = builder(grid, F64, device="cpu", **plain_kw)
    assert shape == ref[3]
    assert unpad(apply(pad(u))).equal(ref[2](ref[0](ref[1](u))))
    if "tile_planes" in kw:
        assert apply.options == {"tile_planes": kw["tile_planes"]}


def test_gdm_precision_by_name():
    """gdm's HIGHEST is recognised by name, as jax's enum gives it."""
    from jax.lax import Precision

    for prec in (Precision.HIGHEST, "float32", "highest"):
        stencil2.make_padded_laplace2(G2, F64, rows="mxu",
                                      mxu_precision=prec, device="cpu")
    for prec in (Precision.DEFAULT, Precision.HIGH, "bfloat16"):
        with pytest.raises(ValueError, match="3xTF32"):
            stencil2.make_padded_laplace2(G2, F64, rows="mxu",
                                          mxu_precision=prec, device="cpu")


def test_stencil2_tile_r_taken():
    """K1's builder takes gdm's tile_r and applies the same band."""
    grid, mass = _stencil_op()
    u = torch.as_tensor(np.random.default_rng(31).standard_normal(
        grid.n_nodes))
    outs = []
    for kw in ({}, {"tile_r": 16}, {"tile_r": 64}):
        apply, pad, unpad, _ = cutband.make_padded_stencil2(mass, F64,
                                                            **kw, device="cpu")
        outs.append(unpad(apply(pad(u))))
    assert outs[0].equal(outs[1]) and outs[0].equal(outs[2])


@pytest.mark.parametrize("call,match", [
    (lambda: stencil2.make_padded_laplace2_stream(G2, tile_r=0, device="cpu"),
     "tile_r"),
    (lambda: stencil2.make_padded_laplace2_stream(G2, tile_r=9.5,
                                                  device="cpu"),
     "tile_r"),
    (lambda: stencil3.make_padded_laplace3(G3, tile_planes=-2, device="cpu"),
     "tile_planes"),
    (lambda: stencil3.make_padded_laplace3_mxu(G3, tile_planes1=0,
                                               device="cpu"),
     "tile_planes1"),
    (lambda: stencil3.make_padded_laplace3_mxu(G3, chunk=True, device="cpu"),
     "chunk"),
    (lambda: stencil3.make_padded_laplace3_mxu(G3, pipelined=False,
                                               device="cpu"),
     "pipelined"),
    (lambda: stencil2.make_padded_laplace2(G2, rows="mxu",
                                           mxu_precision="DEFAULT",
                                           device="cpu"),
     "mxu_precision"),
    (lambda: stencil2.make_padded_laplace2(G2, pipeline_interleave=2,
                                           device="cpu"),
     "pipeline_interleave"),
    (lambda: stencil2.make_padded_laplace2(G2, static_parity="yes",
                                           device="cpu"),
     "static_parity"),
    (lambda: cutband.make_padded_stencil2(_stencil_op()[1], tile_r=-64,
                                          device="cpu"), "tile_r"),
    (lambda: stencil3.laplace3_apply(
        torch.zeros(G3.nodes, dtype=F64),
        stencil3.laplace3_bands(G3, "cpu", F64), tile_planes=0),
     "tile_planes"),
], ids=["stream tile_r 0", "stream tile_r 9.5", "laplace3 tile_planes",
        "laplace3_mxu tile_planes1", "laplace3_mxu chunk",
        "laplace3_mxu pipelined False", "mxu_precision DEFAULT",
        "pipeline_interleave 2", "static_parity str", "stencil2 tile_r",
        "laplace3_apply tile_planes"])
def test_gdm_builder_keywords_refused(call, match):
    """A value the card kernels do not satisfy raises ValueError with its
    reason, never TypeError."""
    with pytest.raises(ValueError, match=match):
        call()


# ---- gdm's call forms of fast_stencil_apply and verified_fsai_solver ------

@pytest.fixture(scope="module")
def cut_mass24():
    """The flagship's 24^2 cut mass (the disc of radius 1), with its cut
    operators and Schwarz windows."""
    gc = Grid(3, (24, 24), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(gc, lambda m: np.sqrt(sum(x**2 for x in m))
                            - 1.0, 3)
    op = CutOperators(geo, INSIDE)
    return op, assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))


@pytest.mark.parametrize("form", ["positional", "inactive_identity",
                                  "all of gdm's"])
def test_fast_stencil_apply_takes_gdms_call_forms(cut_mass24, form):
    """gdm's callers' forms, fast_stencil_apply(st, op, "mass") and
    inactive_identity=False, return K1's plain apply, equal to the
    port's own keyword form: the four gdm arguments change nothing."""
    op, st = cut_mass24
    ref = fastapply.fast_stencil_apply(st, device="cpu", dtype=F64)
    if form == "positional":
        apply = fastapply.fast_stencil_apply(st, op, "mass", device="cpu",
                                             dtype=F64)
    elif form == "inactive_identity":
        apply = fastapply.fast_stencil_apply(st, op, "mass",
                                             inactive_identity=False,
                                             device="cpu", dtype=F64)
    else:
        apply = fastapply.fast_stencil_apply(st, op, "mass", 0.01, False,
                                             device="cpu", dtype=F64)
    u = torch.as_tensor(np.random.default_rng(61).standard_normal(
        st.grid.n_nodes))
    before = cutband.band_apply.launches
    assert apply(u).equal(ref(u))
    np.testing.assert_allclose(apply(u).numpy(), st.apply(u).numpy(),
                               rtol=1e-12, atol=1e-12)
    assert cutband.band_apply.launches == before


def test_verified_fsai_solver_takes_gdms_positional_order():
    """gdm's order (st, windows, max_iter, rel_tol, abs_tol, apply_fn, R,
    slack, probe, interpret, resident_max_iter): the sixth positional
    argument is apply_fn, not R, and device and dtype come last."""
    names = list(inspect.signature(fsai.verified_fsai_solver).parameters)
    assert names == ["st", "windows", "max_iter", "rel_tol", "abs_tol",
                     "apply_fn", "R", "slack", "probe", "interpret",
                     "resident_max_iter", "device", "dtype"]


def _counted(fn):
    def apply(u):
        apply.calls += 1
        return fn(u)
    apply.calls = 0
    return apply


@pytest.mark.parametrize("positional", [False, True])
def test_verified_fsai_solver_streamed_cg_runs_apply_fn(cut_mass24,
                                                        positional):
    """apply_fn follows gdm's two routes of the streamed CG
    (gdm/cut/fsai.py:182-235): on the card in 2D the CG runs the band
    through K1 and apply_fn is unused (gdm's TPU route); everywhere else
    it is the operator of a host CG on flat node vectors (gdm's route
    off the TPU).  On the CPU, with the resident path crippled (as
    tests/test_torch_verified.py does), every solve goes to the streamed
    CG, which calls apply_fn on flat vectors; an apply_fn of twice the
    mass halves the answer.  interpret=False is taken.  The sixth
    positional argument lands in apply_fn."""
    op, st = cut_mass24
    assert kernel_route(st.grid, "cuda")
    assert not kernel_route(st.grid, torch.device("cpu"))
    assert not kernel_route(Grid(3, (12,), (0.0,), (1.0,)), "cuda")
    kw = dict(max_iter=200, rel_tol=1e-6, interpret=False,
              resident_max_iter=1, device="cpu", dtype=F64)
    b = torch.as_tensor(np.random.default_rng(62).standard_normal(
        st.grid.n_nodes))
    plain = fsai.verified_fsai_solver(st, op.w_cut, **kw)
    assert plain.path == "streamed"
    x_plain = plain.layout.unpad(plain.solve_padded(plain.layout.pad(b)))
    k1 = fastapply.fast_stencil_apply(st, device="cpu", dtype=F64)
    shapes = set()

    def twice_fn(u):
        shapes.add(tuple(u.shape))
        return 2.0 * k1(u)

    twice = _counted(twice_fn)
    if positional:
        vs = fsai.verified_fsai_solver(
            st, op.w_cut, kw.pop("max_iter"), kw.pop("rel_tol"), 1e-12,
            twice, **kw)
    else:
        vs = fsai.verified_fsai_solver(st, op.w_cut, apply_fn=twice, **kw)
    assert vs.path == "streamed" and twice.calls == 0
    x, info = vs.solve_padded_with_info(vs.layout.pad(b))
    assert info["fallback"] is False and twice.calls >= info["iterations"] > 0
    assert shapes == {(st.grid.n_nodes,)}
    x = vs.layout.unpad(x)
    assert _rel(2.0 * x, x_plain) <= 1e-12


def test_verified_fsai_solver_resident_path_ignores_apply_fn(cut_mass24):
    """The resident path stays on the band: a healthy solve never calls
    apply_fn."""
    op, st = cut_mass24
    twice = _counted(lambda u: 2.0 * st.apply(u))
    vs = fsai.verified_fsai_solver(st, op.w_cut, 60, 1e-5, apply_fn=twice,
                                   interpret=False, device="cpu", dtype=F64)
    assert vs.path == "resident-verified"
    n = st.grid.n_nodes
    vs.solve_padded(vs.layout.pad(torch.as_tensor(
        np.random.default_rng(63).standard_normal(n))))
    assert twice.calls == 0 and vs.fallback_count == 0


# ---- gdm's positional dtype (each builder in gdm's positional form) -------

@functools.lru_cache(maxsize=None)
def _cut12():
    """(grid, cut operators, cut mass) of the disc at 12^2."""
    gc, mass = _stencil_op()
    geo = CutGeometry.build(gc, lambda m: np.sqrt(sum(x**2 for x in m))
                            - 1.0, 3)
    return gc, CutOperators(geo, INSIDE), mass


def _padded(built, u):
    apply, pad, unpad, _ = built
    return unpad(apply(pad(u)))


def _fsai(mass):
    return fsai.fsai_factors(mass)


# (id, gdm's positional call of dtype d, the port's keyword call, a run of
# the built object on u); every call on the CPU
POSITIONAL = [
    ("make_padded_laplace2",
     lambda d: stencil2.make_padded_laplace2(G2, d, None, False, "vpu",
                                             None, None, None, True,
                                             device="cpu"),
     lambda: stencil2.make_padded_laplace2(G2, dtype=F64, device="cpu"),
     _padded, G2),
    ("make_padded_laplace2_stream",
     lambda d: stencil2.make_padded_laplace2_stream(G2, d, 96, False, None,
                                                    device="cpu"),
     lambda: stencil2.make_padded_laplace2_stream(G2, dtype=F64,
                                                  device="cpu"),
     _padded, G2),
    ("make_padded_laplace3",
     lambda d: stencil3.make_padded_laplace3(G3, d, None, False,
                                             device="cpu"),
     lambda: stencil3.make_padded_laplace3(G3, dtype=F64, device="cpu"),
     _padded, G3),
    ("make_padded_laplace2_fullmxu",
     lambda d: stencil2.make_padded_laplace2_fullmxu(G2, d, None, False,
                                                     device="cpu"),
     lambda: stencil2.make_padded_laplace2_fullmxu(G2, dtype=F64,
                                                   device="cpu"),
     _padded, G2),
    ("make_padded_laplace2_hybrid",
     lambda d: stencil2.make_padded_laplace2_hybrid(G2, d, None, None, False,
                                                    device="cpu"),
     lambda: stencil2.make_padded_laplace2_hybrid(G2, dtype=F64,
                                                  device="cpu"),
     _padded, G2),
    ("make_padded_laplace3_mxu",
     lambda d: stencil3.make_padded_laplace3_mxu(G3, d, None, False, 1024,
                                                 True, device="cpu"),
     lambda: stencil3.make_padded_laplace3_mxu(G3, dtype=F64, device="cpu"),
     _padded, G3),
    ("make_padded_laplace2_mxucol",
     lambda d: stencil2.make_padded_laplace2_mxucol(G2, d, None, False,
                                                    device="cpu"),
     lambda: stencil2.make_padded_laplace2_mxucol(G2, dtype=F64,
                                                  device="cpu"),
     _padded, G2),
    ("make_padded_laplace2_hybp",
     lambda d: stencil2.make_padded_laplace2_hybp(G2, d, None, None, False,
                                                  device="cpu"),
     lambda: stencil2.make_padded_laplace2_hybp(G2, dtype=F64, device="cpu"),
     _padded, G2),
    ("best_padded_laplace",
     lambda d: fast.best_padded_laplace(G2, d, False, None, device="cpu"),
     lambda: fast.best_padded_laplace(G2, dtype=F64, device="cpu"),
     _padded, G2),
    ("make_padded_laplace",
     lambda d: stencil.make_padded_laplace(G2, d, None, False, device="cpu"),
     lambda: stencil.make_padded_laplace(G2, dtype=F64, device="cpu"),
     _padded, G2),
    ("laplace_2d_fn",
     lambda d: stencil.laplace_2d_fn(G2, d, device="cpu"),
     lambda: stencil.laplace_2d_fn(G2, dtype=F64, device="cpu"),
     lambda fn, u: fn(u), G2),
    ("laplace_apply_fn",
     lambda d: fast.laplace_apply_fn(G3, d, "auto", device="cpu"),
     lambda: fast.laplace_apply_fn(G3, dtype=F64, device="cpu"),
     lambda fn, u: fn(u), G3),
    ("mass_apply_fn",
     lambda d: fast.mass_apply_fn(G2, d, device="cpu"),
     lambda: fast.mass_apply_fn(G2, dtype=F64, device="cpu"),
     lambda fn, u: fn(u), G2),
    ("make_padded_stencil2",
     lambda d: cutband.make_padded_stencil2(_stencil_op()[1], d, 64, False,
                                            device="cpu"),
     lambda: cutband.make_padded_stencil2(_stencil_op()[1], dtype=F64,
                                          device="cpu"),
     lambda b, u: _padded(b, u.reshape(-1)), "cut"),
    ("make_resident_cg",
     lambda d: resident.make_resident_cg(
         _stencil_op()[1], *_fsai(_stencil_op()[1]), 40, 1e-5, 1e-12, d,
         False, 96 * 1024 * 1024, device="cpu"),
     lambda: resident.make_resident_cg(
         _stencil_op()[1], *_fsai(_stencil_op()[1]), max_iter=40,
         dtype=F64, device="cpu"),
     lambda b, u: b[2](b[0](b[1](u.reshape(-1)))[0]), "cut"),
    ("make_fast_cut_apply",
     lambda d: fastapply.make_fast_cut_apply(
         _cut12()[2], _cut12()[1], fastapply.kron_pairs(_cut12()[0], "mass"),
         "auto", d, False, None, "mxu3p", True, device="cpu"),
     lambda: fastapply.make_fast_cut_apply(
         _cut12()[2], _cut12()[1], fastapply.kron_pairs(_cut12()[0], "mass"),
         dtype=F64, device="cpu"),
     lambda fn, u: fn(u.reshape(-1)), "cut"),
]


@pytest.mark.parametrize("form", [F64, np.float64, "float64"],
                         ids=["torch", "numpy", "name"])
@pytest.mark.parametrize("gdm_call,keyword_call,run,grid",
                         [c[1:] for c in POSITIONAL],
                         ids=[c[0] for c in POSITIONAL])
def test_builders_take_gdms_positional_dtype(gdm_call, keyword_call, run,
                                             grid, form):
    """gdm's positional form, dtype second and gdm's other parameters
    after it (interpret, vmem_budget, use_pallas taken with no effect),
    builds the same apply as the keyword form, in torch's float64."""
    nodes = _stencil_op()[0].nodes if grid == "cut" else grid.nodes
    u = torch.as_tensor(np.random.default_rng(40).standard_normal(nodes))
    y = run(gdm_call(form), u)
    assert y.dtype == F64
    assert y.equal(run(keyword_call(), u))


def test_stage1_micro_takes_gdms_positional_dtype():
    grid = Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0))
    for form in (torch.float32, np.float32, "float32"):
        apply, shape = mxu_micro.make_stage1_micro(grid, "full", form, 16,
                                                   False, device="cpu")
        ref, _ = mxu_micro.make_stage1_micro(grid, "full", tile_r=16,
                                             device="cpu")
        u = torch.as_tensor(np.random.default_rng(41).standard_normal(
            shape), dtype=torch.float32)
        assert apply(u).equal(ref(u))


def test_best_field_laplace_takes_gdms_positional_form():
    """gdm's (grid, use_pallas, min_dofs): "auto", "force" and a min_dofs
    run and change nothing."""
    grid = Grid(3, (16, 20), (0.0, 0.0), (1.0, 1.0))
    u = torch.as_tensor(np.random.default_rng(42).standard_normal(
        grid.nodes + (1,)))
    ref, rode = fast.best_field_laplace(grid, device="cpu", dtype=F64)
    assert rode is False
    for args in (("auto",), ("force", 10), (None, 200_000)):
        apply, _ = fast.best_field_laplace(grid, *args, device="cpu",
                                           dtype=F64)
        assert apply(u).equal(ref(u))


@pytest.mark.parametrize("call", [
    lambda: stencil2.make_padded_laplace2(G2, "cpu", F64),
    lambda: stencil2.make_padded_laplace2_hybp(G2, torch.device("cpu")),
    lambda: stencil3.make_padded_laplace3(G3, None, device="cpu"),
    lambda: fast.best_padded_laplace(G2, "cuda"),
    lambda: fast.laplace_apply_fn(G2, "cpu", F64),
    lambda: fast.mass_apply_fn(G2, "not a dtype", device="cpu"),
    lambda: fast.best_field_laplace(G2, device="cpu", dtype="cpu"),
    lambda: cutband.make_padded_stencil2(_stencil_op()[1], "cpu"),
    lambda: resident.make_resident_cg(_stencil_op()[1], None, None, 40,
                                      1e-5, 1e-12, "cpu"),
    lambda: mxu_micro.make_stage1_micro(G2, "full", "cpu"),
], ids=["laplace2 device", "hybp torch.device", "laplace3 None",
        "dispatch cuda", "apply_fn device", "mass_apply_fn str",
        "field_laplace", "stencil2", "resident", "stage1"])
def test_bad_dtype_raises_value_error(call):
    """Anything that is not a dtype in gdm's dtype position (a device
    from the port's old order among them) raises ValueError, not
    TypeError."""
    with pytest.raises(ValueError, match="dtype"):
        call()


@pytest.mark.parametrize("call", [
    lambda: fast.laplace_apply_fn(G2, F64, "never", device="cpu"),
    lambda: fast.best_field_laplace(G2, "never", device="cpu"),
    lambda: fastapply.make_fast_cut_apply(
        _cut12()[2], _cut12()[1], fastapply.kron_pairs(_cut12()[0], "mass"),
        "never", device="cpu"),
], ids=["laplace_apply_fn", "best_field_laplace", "make_fast_cut_apply"])
def test_use_pallas_never_raises(call):
    with pytest.raises(ValueError, match="plain twin is for the CPU"):
        call()


def test_use_pallas_unknown_raises():
    with pytest.raises(ValueError, match="use_pallas"):
        fast.laplace_apply_fn(G2, F64, "sometimes", device="cpu")


def test_resolve_dtype():
    import jax.numpy as jnp

    for form, want in ((F64, F64), (np.float64, F64), ("float32",
                       torch.float32), (jnp.float32, torch.float32),
                       (np.dtype("float64"), F64), (torch.int32,
                                                    torch.int32)):
        assert device.resolve_dtype(form) == want
    for bad in ("cpu", "cuda", torch.device("cpu"), None, jnp.bfloat16,
                object()):
        with pytest.raises(ValueError, match="dtype"):
            device.resolve_dtype(bad)


# ---- VerifiedSolver in gdm's flat form ---------------------------------

@pytest.mark.parametrize("crippled", [False, True],
                         ids=["resident", "streamed"])
def test_verified_solver_takes_and_returns_flat_vectors(cut_mass24,
                                                        crippled):
    """solve(b) and solve_with_info(b) take gdm's flat node vector and
    return one, equal to the padded method's answer unpadded, with the
    same info keys, on both routes."""
    op, st = cut_mass24
    kw = dict(resident_max_iter=1) if crippled else {}
    vs = fsai.verified_fsai_solver(st, op.w_cut, 200, 1e-6, device="cpu",
                                   dtype=F64, **kw)
    assert vs.path == ("streamed" if crippled else "resident-verified")
    n = st.grid.n_nodes
    b = torch.as_tensor(np.random.default_rng(64).standard_normal(n))
    x_pad, info_pad = vs.solve_padded_with_info(vs.layout.pad(b))
    x, info = vs.solve_with_info(b)
    assert x.shape == (n,) and x.equal(vs.layout.unpad(x_pad))
    assert vs(b).equal(x)
    assert vs.solve_padded(vs.layout.pad(b)).equal(x_pad)
    assert set(info) == set(info_pad) == {"iterations", "residual",
                                          "fallback", "fallback_iterations"}
    assert info == info_pad
    r = st.apply(x) - b
    assert (r.norm() / b.norm()).item() <= 1e-5
