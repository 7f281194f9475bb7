"""The rest of the wave family in the port (gdm_torch.problems.wave)
against live gdm under x64, in float64 on the CPU.

Every run below is ``WaveProblem(make_preset(...), device="cpu",
dtype=torch.float64).run()`` beside gdm's, held in the scaled measure of
tests/test_torch_wave_app.py (max |port - gdm| / max |gdm| per column
over L2, L1 and Linf) within 1e-10, with the per-solve iteration counts
equal where gdm records them:

- ``heat`` (implicit Euler, gdm's host FSAI-CG over the matrix-free
  M + dt S) in 1D and 2D, all 7 rows, ``solver_rows`` equal (12 and 10
  iterations a solve at the full step), and ``heat-impl`` in 1D;
- ``wave-composite`` 1D, all 112 rows of both location slots;
- ``heat-composite`` 1D, cut to end_t = 0.05 (411 rows a slot; the
  preset's 821 take about 20 s in the port's eager CPU loop);
- ``wave-composite`` 2D, cut to end_t = 0.05 (4 rows a slot; the full
  run takes about 13 s in gdm at t = 0.2 and minutes in the port here);
- ``solver_name="direct"`` on ``wave`` 1D, cut to end_t = 0.3.

Also: ``CutOperators.stiffness_matrix_apply`` with and without the
interface Nitsche terms and at two ghost-penalty powers within 1e-12 of
gdm's, and ``fsai_cg_solver``'s route and probe record equal to gdm's on
the CPU (gdm's "resident-unavailable" solver).  The step85 Poisson runs
are in tests/test_torch_cut_multigrid.py, beside the cut multigrid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdm.cut.fsai import fsai_cg_solver as g_fsai_cg_solver
from gdm.cut.geometry import INSIDE as G_INSIDE, CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import assemble_stencil as g_assemble
from gdm.grid import Grid as GGrid
from gdm.problems import wave as gwave

from gdm_torch import solvers
from gdm_torch.cut import fsai
from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil
from gdm_torch.grid import Grid
from gdm_torch.problems import wave

F64 = torch.float64
TOL = 1e-10


def _scaled_dev(port_rows, gdm_rows):
    m = np.asarray(port_rows, np.float64)
    g = np.asarray(gdm_rows, np.float64)
    assert m.shape == g.shape
    assert np.array_equal(m[:, 0], g[:, 0])
    assert np.abs(m[:, 1] - g[:, 1]).max() <= 1e-12
    return (np.abs(m[:, 2:] - g[:, 2:]).max(axis=0)
            / np.abs(g[:, 2:]).max(axis=0))


def _run(name, dim, **changes):
    pt, pg = wave.make_preset(name, dim), gwave.make_preset(name, dim)
    for p in (pt, pg):
        for k, v in changes.items():
            setattr(p, k, v)
    port = wave.WaveProblem(pt, verbose=False, device="cpu", dtype=F64)
    ref = gwave.WaveProblem(pg, verbose=False)
    port.run()
    ref.run()
    return port, ref


@pytest.mark.parametrize("name,dim,iters", [
    ("heat", 1, 12), ("heat", 2, 10), ("heat-impl", 1, 12)])
def test_heat_impl_rows_and_solves_match_gdm(name, dim, iters):
    port, ref = _run(name, dim, print_solver_info=True)
    rows, grows = port.rows[0], ref.rows[0]
    assert len(rows) == len(grows) == 7 and port.rows[1] == []
    assert (_scaled_dev(rows, grows) <= TOL).all()
    # one implicit solve a step, each recorded; the counts are gdm's
    assert port.solver_rows == ref.solver_rows
    assert [r[1] for r in port.solver_rows[0]][:5] == [iters] * 5
    assert port.solver_rows[0][0] == (1, iters, False, 0)
    # gdm's two solvers (the last step is shortened), on gdm's CPU route
    assert len(port.heat_solvers) == 2
    for solve in port.heat_solvers.values():
        assert solve.path == "streamed" and solve.layout is None
        assert solve.probe == {"ok": None, "reason": "resident-unavailable"}
    assert port._solver_meta == ref._solver_meta == []
    final = port.final_solution
    assert final.dtype == F64 and final.shape == (port.grid.n_nodes,)


@pytest.mark.parametrize("name,dim,end_t,n_rows", [
    ("wave-composite", 1, None, 112), ("heat-composite", 1, 0.05, 411),
    ("wave-composite", 2, 0.05, 4)],
    ids=["wave-composite-1d", "heat-composite-1d-cut", "wave-composite-2d-cut"])
def test_composite_rows_match_gdm(name, dim, end_t, n_rows):
    changes = {} if end_t is None else {"end_t": end_t}
    port, ref = _run(name, dim, **changes)
    for slot in (0, 1):
        rows, grows = port.rows[slot], ref.rows[slot]
        assert len(rows) == len(grows) == n_rows
        assert (_scaled_dev(rows, grows) <= TOL).all(), slot
    # gdm's CPU branch for both regions' mass solves
    assert len(port.mass_solvers) == 2 and port._solver_meta == []
    assert port.mass_solver is port.mass_solvers[0]
    u0, u1 = port.final_solution
    assert u0.shape == u1.shape == (port.grid.n_nodes,)
    assert bool(torch.isfinite(u0).all() and torch.isfinite(u1).all())


@pytest.mark.slow
def test_wave_composite_2d_grows_as_gdms():
    """gdm's own 2D wave-composite grows in its outside region from
    t ~ 0.1 under x64 (no reference row exists for it), and the port's
    rows follow gdm's to t = 0.3 (18 rows a slot)."""
    port, ref = _run("wave-composite", 2, end_t=0.3)
    outside = np.asarray(ref.rows[1])[:, 2]
    assert outside[-1] > 1e6 * outside[0]
    for slot in (0, 1):
        assert (_scaled_dev(port.rows[slot], ref.rows[slot]) <= 1e-8).all()


def test_direct_solver_rows_match_gdm():
    port, ref = _run("wave", 1, end_t=0.3, solver_name="direct")
    assert len(port.rows[0]) == 18
    assert (_scaled_dev(port.rows[0], ref.rows[0]) <= TOL).all()


def test_direct_solver_refuses_past_its_limit():
    """make_direct_solver materialises n_dofs^2 entries: past its limit
    it raises ValueError with the reason, before allocating anything."""
    def never(v):
        raise AssertionError("applied")

    with pytest.raises(ValueError, match="past the limit"):
        solvers.make_direct_solver(never, solvers.DIRECT_MAX_DOFS + 1,
                                   device="cpu")
    a = torch.as_tensor(np.random.default_rng(3).standard_normal((6, 6)))
    a = a @ a.T + 6 * torch.eye(6, dtype=F64)
    solve = solvers.make_direct_solver(lambda v: a @ v, 6, device="cpu")
    b = torch.arange(6, dtype=F64)
    assert torch.allclose(a @ solve(b), b, rtol=0, atol=1e-12)


# ---- the operators of the implicit and Poisson paths -----------------------

def _sphere(m):
    return np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - 1.0


@pytest.fixture(scope="module", params=[1, 2])
def ops(request):
    """The heat preset's cut operators, 1D at 40 cells and 2D at 24^2."""
    dim = request.param
    n = 40 if dim == 1 else 24
    args = (3, (n,) * dim, (-1.21,) * dim, (1.21,) * dim)
    top = CutOperators(CutGeometry.build(Grid(*args), _sphere, 3), INSIDE)
    gop = GCutOperators(GCutGeometry.build(GGrid(*args), _sphere, 3),
                        G_INSIDE)
    return top, gop


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("with_nitsche", [True, False])
@pytest.mark.parametrize("gp_power", [3, 1])
def test_stiffness_matrix_apply_matches_gdm(ops, with_nitsche, gp_power):
    top, gop = ops
    u = np.random.default_rng(21).standard_normal(top.grid.n_nodes)
    yt = top.stiffness_matrix_apply(torch.as_tensor(u), 1.5, 15.0,
                                    with_nitsche, gp_power=gp_power)
    yg = gop.stiffness_matrix_apply(jnp.asarray(u), 1.5, 15.0, with_nitsche,
                                    gp_power=gp_power)
    assert yt.dtype == F64 and _rel(yt.numpy(), yg) <= 1e-12
    # the interface Nitsche terms alone
    zt = top._nitsche_matrix_apply(torch.zeros(len(u), dtype=F64),
                                   torch.as_tensor(u), 15.0)
    zg = gop._nitsche_matrix_apply(jnp.zeros(len(u)), jnp.asarray(u), 15.0)
    assert _rel(zt.numpy(), zg) <= 1e-12


def test_stiffness_matrix_apply_is_the_band(ops):
    """The matrix-free stiffness equals its assembled band (interface
    Nitsche, GP h^3, inactive identity), as in gdm."""
    top, _ = ops
    st = assemble_stencil(top, "stiff", 1.5, 15.0, with_nitsche=True)
    u = torch.as_tensor(np.random.default_rng(22).standard_normal(
        top.grid.n_nodes))
    assert _rel(top.stiffness_matrix_apply(u, 1.5, 15.0, True).numpy(),
                st.apply(u).numpy()) <= 1e-12


@pytest.mark.parametrize("windows", [False, True])
def test_fsai_cg_solver_host_route_is_gdms(ops, windows):
    """On the CPU, fsai_cg_solver(resident=True) is gdm's
    "resident-unavailable" solver: path "streamed", gdm's probe record,
    flat vectors through a host CG over apply_fn (FSAI-preconditioned,
    Schwarz over windows), the same answer and iteration count;
    resident=False is gdm's plain FSAI-CG callable."""
    top, gop = ops
    dt = 0.3 * 2.42 / (40 if top.grid.dim == 1 else 24)
    m, s = (assemble_stencil(top, "mass", 0.75), assemble_stencil(
        top, "stiff", 1.5, 15.0, with_nitsche=True, inactive_identity=False))
    gm, gs = (g_assemble(gop, "mass", 0.75), g_assemble(
        gop, "stiff", 1.5, 15.0, with_nitsche=True, inactive_identity=False))
    st = type(m)(top.grid, m.band_host + dt * s.band_host, m.radius)
    gst = type(gm)(gop.grid, gm.band_host + dt * gs.band_host, gm.radius)
    win_t = top.w_cut if windows else None
    win_g = gop.w_cut if windows else None
    calls = []

    def apply_t(v):
        calls.append(tuple(v.shape))
        return st.apply(v)

    vs = fsai.fsai_cg_solver(st, 200, 1e-12, 1e-20, apply_t, windows=win_t,
                             device="cpu", dtype=F64)
    gvs = g_fsai_cg_solver(gst, 200, 1e-12, 1e-20, gst.apply, windows=win_g)
    assert (vs.path, vs.probe) == (gvs.path, gvs.probe) == (
        "streamed", {"ok": None, "reason": "resident-unavailable"})
    b = np.random.default_rng(23).standard_normal(top.grid.n_nodes)
    x, info = vs.solve_with_info(torch.as_tensor(b))
    gx, ginfo = gvs.solve_with_info(jnp.asarray(b))
    assert info["iterations"] == int(ginfo["iterations"]) > 0
    assert info["fallback"] is False and info["fallback_iterations"] == 0
    assert _rel(x.numpy(), gx) <= 1e-11
    assert set(calls) == {(top.grid.n_nodes,)}
    with pytest.raises(ValueError, match="no padded layout"):
        vs.solve_padded(torch.zeros(4, dtype=F64))
    plain = fsai.fsai_cg_solver(st, 200, 1e-12, 1e-20, None, None, False,
                                device="cpu", dtype=F64)
    gplain = g_fsai_cg_solver(gst, 200, 1e-12, 1e-20, resident=False)
    assert _rel(plain(torch.as_tensor(b)).numpy(),
                gplain(jnp.asarray(b))) <= 1e-11


def test_fsai_cg_solver_takes_gdms_positional_order():
    import inspect

    names = list(inspect.signature(fsai.fsai_cg_solver).parameters)
    assert names == ["st", "max_iter", "rel_tol", "abs_tol", "apply_fn",
                     "R", "resident", "windows", "device", "dtype"]
