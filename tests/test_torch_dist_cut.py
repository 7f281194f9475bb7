"""The port's sharded cut operators (gdm_torch.dist.cut) and the
problems' ``mesh=`` against the port's serial runs and gdm's sharded
runs under x64, on the CPU in float64.

gdm's contract (tests/test_distributed_cut.py, after the reference's
rank-count invariance, poisson_02_gdm.mpirun={1,3}.output): a sharded
solve reproduces the single-device error rows.  Held here, at gdm's
cases:

- ``sharded_stencil_apply`` of the disc's cut mass at (dim, cells,
  slots) = (1, 40, 8), (1, 41, 4), (2, 24, 8), (2, 21, 3), node counts
  that do not divide by the slots among them (identity-padded rows),
  against the port's serial ``StencilOperator.apply`` (1e-14) and
  against gdm's sharded apply (1e-12); a shard's layout at least the
  radius wide;
- ``WaveProblem(mesh=device_mesh(n))``: ``wave_0`` (1D wave, 41 nodes
  over 8 slots, end_t = 0.2), the 2D heat-composite at 16^2 over 4
  slots, the deformed 1D heat over 8 slots; rows within rtol 1e-10
  (heat-composite 1e-12, as gdm holds) of the port's serial run and of
  gdm's sharded run, counters and times equal; the final states within
  1e-12 of max |serial| (gdm holds ``wave_0``'s); no verified solver
  with a mesh.

The advection cases are tests/test_torch_dist_advection.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gdm.cut.geometry import INSIDE as G_INSIDE, CutGeometry as GCutGeometry
from gdm.cut.operators import CutOperators as GCutOperators
from gdm.cut.stencil import assemble_stencil as g_assemble_stencil
from gdm.dist.cut import sharded_stencil_apply as g_sharded_stencil_apply
from gdm.dist.mesh import device_mesh as g_device_mesh
from gdm.grid import Grid as GGrid
from gdm.problems import wave as gwave

from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil
from gdm_torch.dist.cut import sharded_stencil_apply
from gdm_torch.dist.mesh import device_mesh
from gdm_torch.grid import Grid
from gdm_torch.problems import wave

F64 = torch.float64
GM = 0.25 * np.sqrt(3.0)
CASES = [(1, 40, 8), (1, 41, 4), (2, 24, 8), (2, 21, 3)]


def _ls(m):
    return np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - 1.0


def _mesh(n):
    return device_mesh(n, device="cpu")


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(
    map(str, c)))
def applies(request):
    dim, n, ndev = request.param
    args = (3, (n,) * dim, (-1.21,) * dim, (1.21,) * dim)
    grid = Grid(*args)
    st = assemble_stencil(CutOperators(CutGeometry.build(grid, _ls, 3),
                                       INSIDE), "mass", GM)
    gst = g_assemble_stencil(GCutOperators(GCutGeometry.build(
        GGrid(*args), _ls, 3), G_INSIDE), "mass", GM)
    u = np.random.default_rng(0).standard_normal(grid.n_nodes)
    ut = torch.as_tensor(u)
    apply = sharded_stencil_apply(st, _mesh(ndev))
    return {"y": apply(ut).numpy(), "serial": st.apply(ut).numpy(),
            "gdm": np.asarray(g_sharded_stencil_apply(
                gst, g_device_mesh(ndev))(jnp.asarray(u))),
            "apply": apply, "st": st, "ndev": ndev}


def test_sharded_apply_matches_serial(applies):
    np.testing.assert_allclose(applies["y"], applies["serial"], rtol=1e-14,
                               atol=1e-14)


def test_sharded_apply_matches_gdm(applies):
    y, g = applies["y"], applies["gdm"]
    assert y.shape == g.shape
    assert np.abs(y - g).max() <= 1e-12 * np.abs(g).max()


def test_sharded_apply_layout(applies):
    apply, st, ndev = applies["apply"], applies["st"], applies["ndev"]
    N0 = st.grid.nodes[0]
    assert apply.loc == max(-(-N0 // ndev), st.radius)
    assert apply.loc * ndev >= N0


def _rows_close(rows1, rows0, rtol):
    assert len(rows1) == len(rows0) > 2
    for r0, r1 in zip(rows0, rows1):
        assert r0[0] == r1[0]
        assert r1[1] == pytest.approx(r0[1], abs=1e-12)
        np.testing.assert_allclose(r1[2:], r0[2:], rtol=rtol, atol=1e-16)


def _squeeze(pts):
    pts = np.asarray(pts, float)
    return pts + 0.04 * np.sin(np.pi * pts / 1.21)


def _wave0(p):
    p.end_t = 0.2


def _heat_composite(p):
    p.n_subdivisions_1D = 16
    p.end_t = p.start_t + 4 * p.cfl * (2.42 / 16) ** p.cfl_pow


def _deformed_heat(p):
    p.end_t = 0.15
    p.mapping_q_cache_function = _squeeze


# name: (preset, dim, changes, slots, rtol)
PROBLEMS = {
    "wave_0": ("wave", 1, _wave0, 8, 1e-10),
    "heat-composite-2d": ("heat-composite", 2, _heat_composite, 4, 1e-12),
    "deformed-heat-1d": ("heat", 1, _deformed_heat, 8, 1e-10),
}


@pytest.fixture(scope="module", params=list(PROBLEMS))
def problem_runs(request):
    name, dim, change, ndev, rtol = PROBLEMS[request.param]
    p, gp = wave.make_preset(name, dim), gwave.make_preset(name, dim)
    change(p)
    change(gp)
    serial = wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64)
    serial.run()
    sharded = wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64,
                               mesh=_mesh(ndev))
    sharded.run()
    gsharded = gwave.WaveProblem(gp, verbose=False,
                                 mesh=g_device_mesh(ndev))
    gsharded.run()
    return {"serial": serial, "sharded": sharded, "gdm": gsharded,
            "rtol": rtol, "name": request.param}


def _slots(prob):
    return [s for s in (0, 1) if prob.rows[s]]


def test_mesh_rows_match_serial(problem_runs):
    r = problem_runs
    assert _slots(r["sharded"]) == _slots(r["serial"])
    for s in _slots(r["serial"]):
        _rows_close(r["sharded"].rows[s], r["serial"].rows[s], r["rtol"])


def test_mesh_rows_match_gdm_sharded(problem_runs):
    r = problem_runs
    assert _slots(r["sharded"]) == [s for s in (0, 1) if r["gdm"].rows[s]]
    for s in _slots(r["sharded"]):
        _rows_close(r["sharded"].rows[s], r["gdm"].rows[s], r["rtol"])


def test_mesh_route(problem_runs):
    """With a mesh no verified solver is built (gdm's mesh branch: the
    Jacobi CG over the sharded apply)."""
    sharded = problem_runs["sharded"]
    assert sharded._solver_meta == []
    assert sharded.mesh.size == PROBLEMS[problem_runs["name"]][3]


def test_final_state_shard_invariant(problem_runs):
    def states(prob):
        sol = prob.final_solution
        return sol if isinstance(sol, tuple) else (sol,)

    for a, b in zip(states(problem_runs["sharded"]),
                    states(problem_runs["serial"])):
        a, b = a.numpy(), b.numpy()
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
