"""K2, the one-launch preconditioned CG (gdm_torch/ops/resident.py),
against gdm's Pallas kernel make_resident_cg in interpret mode.

On CPU the wrapper runs the plain torch version.  In float64 on the same
assembled bands it must take the same number of iterations, give x to
1e-10 relative, and report the same true residual to 1e-4 relative (gdm
stores its stats in float32).  The CUDA kernel against the plain version
is tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gdm.cut.fsai import fsai_factors as g_fsai_factors
from gdm.cut.geometry import INSIDE, CutGeometry
from gdm.cut.operators import CutOperators
from gdm.cut.stencil import StencilOperator as GStencil, assemble_stencil
from gdm.grid import Grid
from gdm.ops.pallas_resident import make_resident_cg as g_resident_cg

from gdm_torch.interop import grid_from, stencil_from
from gdm_torch.ops import resident


def _cut_mass(n, radius=1.0):
    grid = Grid(3, (n, n), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - radius, 3)
    op = CutOperators(geo, INSIDE)
    return assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))


@pytest.fixture(scope="module")
def mass24():
    st = _cut_mass(24)
    G, GT = g_fsai_factors(st)
    tgrid = grid_from(st.grid)
    return (st, G, GT), tuple(stencil_from(s, tgrid) for s in (st, G, GT))


def _gdm_solve(ops, b, **kw):
    solve, pad, unpad, _ = g_resident_cg(*ops, dtype=jnp.float64,
                                         interpret=True, **kw)
    x, stats = solve(pad(jnp.asarray(b)))
    return np.asarray(unpad(x)).reshape(-1), np.asarray(stats)[0, :3]


def _port_solve(ops, b, **kw):
    solve, pad, unpad, _ = resident.make_resident_cg(
        *ops, device="cpu", dtype=torch.float64, **kw)
    x, stats = solve(pad(torch.as_tensor(b)))
    return unpad(x).numpy(), resident.read_stats(stats)


def _check(xg, sg, xt, st):
    assert st["iterations"] == int(sg[1])
    assert np.linalg.norm(xt - xg) <= 1e-10 * np.linalg.norm(xg)
    assert abs(st["residual"] - sg[0]) <= 1e-4 * sg[0]
    assert abs(st["r0"] - sg[2]) <= 1e-6 * sg[2]


def test_fsai_preconditioned_matches_gdm(mass24):
    gops, tops = mass24
    b = np.random.default_rng(0).standard_normal(gops[0].grid.n_nodes)
    kw = dict(max_iter=40, rel_tol=1e-6)
    xg, sg = _gdm_solve(gops, b, **kw)
    xt, st = _port_solve(tops, b, **kw)
    assert 0 < st["iterations"] < 40
    _check(xg, sg, xt, st)


def test_unpreconditioned_matches_gdm():
    """Plain CG (no factors) on an uncut mass, where it converges."""
    st = _cut_mass(16, radius=10.0)  # interface far outside: uncut
    b = np.random.default_rng(2).standard_normal(st.grid.n_nodes)
    kw = dict(max_iter=120, rel_tol=1e-6)
    xg, sg = _gdm_solve((st,), b, **kw)
    xt, stt = _port_solve((stencil_from(st),), b, **kw)
    assert 0 < stt["iterations"] < 120
    _check(xg, sg, xt, stt)


def test_guards_match_gdm(mass24):
    """On -M every p^T A p is negative: both kernels take alpha = 0,
    keep x = x0 and run to max_iter."""
    gops, _ = mass24
    neg = GStencil(gops[0].grid, -gops[0].band_host, gops[0].radius)
    b = np.random.default_rng(4).standard_normal(neg.grid.n_nodes)
    kw = dict(max_iter=3, rel_tol=1e-6)
    xg, sg = _gdm_solve((neg,), b, **kw)
    xt, st = _port_solve((stencil_from(neg),), b, **kw)
    assert st["iterations"] == int(sg[1]) == 3
    assert not xt.any() and not xg.any()
    assert abs(st["residual"] - sg[0]) <= 1e-4 * sg[0]


def test_beta_guard_matches_gdm(mass24):
    """With B = -I (G = I, G^T = -I) every r^T z is negative: both kernels
    take beta = 0, i.e. steepest descent along z, for max_iter steps."""
    gops, _ = mass24
    st = gops[0]
    K = 2 * st.radius + 1
    eye = np.zeros(st.band_host.shape)
    eye[..., K // 2, K // 2] = 1.0
    G = GStencil(st.grid, eye, st.radius)
    GT = GStencil(st.grid, -eye, st.radius)
    b = np.random.default_rng(6).standard_normal(st.grid.n_nodes)
    kw = dict(max_iter=5, rel_tol=1e-12)
    xg, sg = _gdm_solve((st, G, GT), b, **kw)
    xt, stt = _port_solve(tuple(stencil_from(s) for s in (st, G, GT)), b,
                          **kw)
    assert stt["iterations"] == int(sg[1]) == 5
    assert np.linalg.norm(xt - xg) <= 1e-10 * np.linalg.norm(xg)
    assert abs(stt["residual"] - sg[0]) <= 1e-4 * sg[0]


def test_initial_guess_and_early_exit(mass24):
    """x0 = the answer: no iterations, x returned unchanged."""
    _, tops = mass24
    solve, pad, unpad, _ = resident.make_resident_cg(
        *tops, max_iter=40, rel_tol=1e-6, device="cpu", dtype=torch.float64)
    x = torch.as_tensor(
        np.random.default_rng(5).standard_normal(tops[0].grid.n_nodes))
    b = tops[0].apply(x)
    xs, stats = solve(pad(b), pad(x))
    s = resident.read_stats(stats)
    assert s["iterations"] == 0 and torch.equal(unpad(xs), x)
    assert s["residual"] <= 1e-6 * s["r0"] + 1e-12


def test_wrapper_checks(mass24):
    _, tops = mass24
    solve, pad, _, shape = resident.make_resident_cg(
        *tops, device="cpu", dtype=torch.float64)
    b = torch.zeros(shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        solve(b.float())
    with pytest.raises(ValueError):
        solve(b[:, :-1])
    with pytest.raises(ValueError):
        resident.make_resident_cg(tops[0], tops[1], None)


# ---- the kernel's plan: which body, and its shared-memory layout ---------

from gdm_torch.ops.cutband import PaddedLayout  # noqa: E402

FLAGSHIP128 = PaddedLayout(129, 129, 4)   # 137 x 140 cells
N_TAPS = 77 + 41 + 41                      # A, G and G^T of the flagship


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_keeps_flagship_planes_in_shared_memory(itemsize):
    """At 128^2 every block owns 146 cells (19180 over 132 SMs) and keeps
    their slice of all 159 planes beside its window (8 rows of the
    140-cell pitch plus 146 + 8 cells) and its own p, r and x."""
    plan = resident.resident_plan(FLAGSHIP128, N_TAPS, itemsize)
    smem = 192 + itemsize * (159 * 146 + (8 * 140 + 146 + 8) + 3 * 146) \
        + 4 * 159
    assert plan == resident.ResidentPlan("shared", 132, 146, 140, smem)
    assert smem == {4: 100532, 8: 200236}[itemsize] <= resident.H100_SMEM


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_reads_256_planes_from_device_memory(itemsize):
    """The 256^2 wave preset's planes (45 MB in float32) do not fit the
    blocks' shared memory: the device body, each block's 539 cells
    staged at once."""
    layout = PaddedLayout(257, 257, 4)     # 265 x 268 cells
    plan = resident.resident_plan(layout, N_TAPS, itemsize)
    assert (plan.body, plan.chunk, plan.sw) == ("device", 539, 268)
    assert 159 * 539 * itemsize > resident.H100_SMEM
    assert plan.smem == 192 + itemsize * (8 * 268 + 539 + 8) + 4 * 159
    with pytest.raises(ValueError, match="shared body"):
        resident.resident_plan(layout, N_TAPS, itemsize, body="shared")


@pytest.mark.parametrize("n,itemsize,body", [
    (138, 8, "shared"), (140, 8, "device"), (200, 4, "shared"),
    (204, 4, "device")])
def test_plan_switches_bodies_by_bytes(n, itemsize, body):
    """float64 leaves shared memory above ~138^2, float32 above ~200^2."""
    plan = resident.resident_plan(PaddedLayout(n + 1, n + 1, 4), N_TAPS,
                                  itemsize)
    assert plan.body == body and plan.smem <= resident.H100_SMEM


def test_plan_cuts_chunks_to_fit():
    """No size gate: at 4096^2 in float64 the window of a whole range
    does not fit, so the device body stages the largest chunk whose rows
    of the window (shorter than the pitch) do."""
    layout = PaddedLayout(4097, 4097, 4)
    plan = resident.resident_plan(layout, N_TAPS, 8)
    cells = layout.rows * layout.pitch
    assert plan.body == "device" and plan.chunk < -(-cells // 132)
    assert plan.sw == plan.chunk + 8 < layout.pitch
    assert plan.smem <= resident.H100_SMEM < resident._layout_bytes(
        layout, N_TAPS, 8, plan.chunk + 1, False)[0]


def test_plan_forced_body():
    plan = resident.resident_plan(FLAGSHIP128, N_TAPS, 4, body="device")
    assert (plan.body, plan.chunk) == ("device", 146)
    assert plan.smem == 192 + 4 * (8 * 140 + 146 + 8) + 4 * 159
    with pytest.raises(ValueError, match="body"):
        resident.resident_plan(FLAGSHIP128, N_TAPS, 4, body="vmem")


def test_body_keyword_on_cpu(mass24):
    """On CPU tensors ``body`` is checked and the plain version runs."""
    _, tops = mass24
    A, G, GT = (resident.band_planes(s, resident.layout_for(tops[0].grid, 4),
                                     "cpu", torch.float64) for s in tops)
    b = A.layout.pad(torch.as_tensor(
        np.random.default_rng(7).standard_normal(tops[0].grid.n_nodes)))
    x0 = torch.zeros_like(b)
    want, _ = resident.resident_cg_plain(b, x0, A, G, GT, 40, 1e-6)
    for body in (None, "shared", "device"):
        x, _ = resident.resident_cg(b, x0, A, G, GT, 40, 1e-6, body=body)
        assert torch.equal(x, want)
    with pytest.raises(ValueError, match="body"):
        resident.resident_cg(b, x0, A, G, GT, body="vmem")
