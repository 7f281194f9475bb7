"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor gdm, so on a machine with a card and no jax it
runs on its own, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 sums of up to 81 taps in another order (fma against
mul + add) stay within 1e-5 of max|y|; float64 within 1e-12.  CG
iteration counts may differ by 2 in float32 (the kernel sums dots in
double, the plain version in float32) and must be equal in float64.
The separable Laplace kernels K3 and its schedules K3s, K3c, K3f, K3h
and K3p (2D), K4 and K5 (3D) are held to the same 1e-5 / 1e-12 of
max|y| against their plain twins (the tensor-core products of K5 and
of the 2D schedules run as 3xTF32 in float32, K3p's column rows too, and
on the DMMA units in float64); so are K3's row modes K3/mxu (3xTF32) and
K0, while K3/mxu3
and K3/mxu3p, whose float32 row products are bf16x3 (each operand kept
to about 16 significant bits), are held to 1e-4 of max|y| in float32
(1e-12 in float64, DMMA); the split cut apply against K1 to the same
class; the Poisson solve on the card to the CPU float64 solve's
iteration count (float64: equal; float32: within 1).
"""

import dataclasses

import numpy as np
import pytest
import torch

import gdm_torch
from gdm_torch.cut import fastapply
from gdm_torch.cut.fsai import fsai_factors, verified_fsai_solver
from gdm_torch.cut.geometry import INSIDE, OUTSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
from gdm_torch.entry import flagship_operators
from gdm_torch.grid import Grid
from gdm_torch.ops import cutband, fast, resident, stencil, stencil2, stencil3
from gdm_torch.problems import poisson

DTYPES = [torch.float32, torch.float64]
OPS = ["mass", "stiff", "G", "GT", "schwarz"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ops24():
    grid, op, mass, stiff = flagship_operators(24)
    G, GT = fsai_factors(mass)
    ops = {"mass": mass, "stiff": stiff, "G": G, "GT": GT,
           "schwarz": schwarz_band(mass, op.w_cut, torch.float32)}
    return grid, op, ops, cutband.layout_for(grid, 4)


@pytest.fixture(scope="module")
def uncut16():
    """An uncut mass (interface far outside), where plain CG converges."""
    grid = Grid(3, (16, 16), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 10.0, 3)
    mass = assemble_stencil(CutOperators(geo, INSIDE), "mass",
                            0.25 * np.sqrt(3.0))
    return grid, mass, cutband.layout_for(grid, mass.radius)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-12


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", OPS)
def test_band_apply_matches_plain(ops24, cuda_device, name, dtype):
    grid, _, ops, layout = ops24
    bp = cutband.band_planes(ops[name], layout, cuda_device, dtype)
    u = layout.pad(torch.as_tensor(
        np.random.default_rng(0).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    before = cutband.band_apply.launches
    yk = cutband.band_apply(u, bp)
    assert cutband.band_apply.launches == before + 1
    yp = cutband.band_apply_plain(u, bp)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)
    guard = yk.clone()
    layout.interior(guard).zero_()
    assert torch.count_nonzero(guard) == 0


# (n0, n1, r, taps) of synthetic bands whose cutband.k1_plan reaches
# every branch of the kernel between them and test_band_apply_every_plan:
# one tap group and several, 12 and 24 taps in flight, one load round and
# several (tests/test_torch_plans.py holds that on the CPU)
K1_CASES = [
    (25, 25, 4, 77),     # eight groups of 9-10 taps
    (40, 40, 1, 9),      # radius 1: eight groups of one or two taps
    (200, 250, 4, 81),
    (60, 70, 6, 150),    # eight groups of 18-19 taps: 24 in flight
    (50, 40, 8, 250),    # eight groups of 31-32 taps: two rounds of 24
    (300, 600, 4, 5),    # five taps: four groups
    (100, 100, 2, 1),    # one tap: one group
    (513, 513, 4, 77),   # the flagship's 512^2 layout
    (201, 201, 6, 169),  # the DoD masses' layout: every tap of radius 6
]


def _random_band(n0, n1, r, n_taps, dtype, device, seed=0):
    """BandPlanes of ``n_taps`` distinct random offsets within radius r
    (the centre first) with random coefficients on the nodes, zero on
    the guard frame, as band_planes lays them out."""
    rng = np.random.default_rng(seed)
    lay = cutband.PaddedLayout(n0, n1, r)
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if (dy, dx) != (0, 0)]
    pick = rng.choice(len(offs), n_taps - 1, replace=False)
    taps = ((0, 0),) + tuple(sorted(offs[k] for k in pick))
    planes = np.zeros((n_taps,) + lay.shape)
    planes[:, r:r + n0, r:r + n1] = rng.standard_normal((n_taps, n0, n1))
    return cutband.BandPlanes(
        taps, torch.as_tensor(planes, dtype=dtype, device=device),
        torch.as_tensor(np.asarray(taps, np.int32).reshape(-1, 2),
                        device=device), lay)


def _check_band(bp, y, u, dtype):
    yp = cutband.band_apply_plain(u, bp)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= _tol(dtype)
    guard = y.clone()
    bp.layout.interior(guard).zero_()
    assert torch.count_nonzero(guard) == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n0,n1,r,taps", K1_CASES)
def test_band_apply_plans_match_plain(cuda_device, n0, n1, r, taps, dtype):
    """K1 as k1_plan launches it, against the plain version, on random
    bands (u random on the guard frame too, which every tap of a guard
    cell and no tap of a node may reach)."""
    bp = _random_band(n0, n1, r, taps, dtype, cuda_device)
    u = _rand(bp.layout.shape, 1, dtype, cuda_device)
    before = cutband.band_apply.launches
    y = cutband.band_apply(u, bp)
    assert cutband.band_apply.launches == before + 1
    _check_band(bp, y, u, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_band_apply_every_plan(cuda_device, dtype):
    """Every plan k1_plans lists, through the private launch hook."""
    bp = _random_band(200, 250, 4, 77, dtype, cuda_device, seed=2)
    u = _rand(bp.layout.shape, 3, dtype, cuda_device)
    lay = bp.layout
    plans = cutband.k1_plans(lay.rows, lay.pitch, 77, dtype, lay.r)
    assert {pl.groups for pl in plans} == set(cutband.K1_GROUPS)
    for plan in plans:
        _check_band(bp, cutband._launch_plan(u, bp, plan), u, dtype)


def test_band_apply_rejects(ops24, cuda_device):
    grid, _, ops, layout = ops24
    bp = cutband.band_planes(ops["mass"], layout, cuda_device,
                             torch.float32)
    u = torch.zeros(layout.shape, device=cuda_device)
    with pytest.raises(ValueError):
        cutband.band_apply(u.double(), bp)
    with pytest.raises(ValueError):
        cutband.band_apply(u.cpu(), bp)
    bp16 = cutband.band_planes(ops["mass"], layout, cuda_device,
                               torch.float16)
    with pytest.raises(ValueError, match="float32 or float64"):
        cutband.band_apply(u.half(), bp16)


def _check_cg(b, x0, args, dtype, body=None, **modes):
    before = resident.resident_cg.launches
    xk, sk = resident.resident_cg(b, x0, *args, body=body, **modes)
    assert resident.resident_cg.launches == before + 1
    xp, sp = resident.resident_cg_plain(b, x0, *args, **modes)
    sk, sp = resident.read_stats(sk), resident.read_stats(sp)
    assert sk["r0"] == pytest.approx(sp["r0"], rel=1e-6)
    assert 0 < sk["iterations"] < args[3]
    if dtype == torch.float64:
        assert sk["iterations"] == sp["iterations"]
        assert (xk - xp).norm().item() <= 1e-10 * xp.norm().item()
        assert sk["residual"] == pytest.approx(sp["residual"], rel=1e-4)
    else:
        assert abs(sk["iterations"] - sp["iterations"]) <= 2
        assert (xk - xp).norm().item() <= 1e-4 * xp.norm().item()
        assert sk["residual"] == pytest.approx(sp["residual"], rel=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_matches_plain(ops24, cuda_device, dtype):
    grid, _, ops, layout = ops24
    A, G, GT = (cutband.band_planes(ops[k], layout, cuda_device, dtype)
                for k in ("mass", "G", "GT"))
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(1).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    _check_cg(b, torch.zeros_like(b), (A, G, GT, 40, 1e-5, 1e-12), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_unpreconditioned(uncut16, cuda_device, dtype):
    grid, mass, layout = uncut16
    A = cutband.band_planes(mass, layout, cuda_device, dtype)
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(2).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    _check_cg(b, torch.zeros_like(b), (A, None, None, 120, 1e-6, 1e-12),
              dtype)


BODIES = list(resident.BODIES)


def _bodies_cg(b, args, dtype):
    """Both bodies of K2 on one system: each against the plain twin
    (``_check_cg``), each launching its own body once and the other not,
    and the two taking the same number of iterations."""
    iterations = set()
    for body in BODIES:
        before = dict(resident.resident_cg.body_launches)
        _check_cg(b, torch.zeros_like(b), args, dtype, body)
        after = resident.resident_cg.body_launches
        assert {k: after[k] - before[k] for k in BODIES} == {
            k: int(k == body) for k in BODIES}
        _, stats = resident.resident_cg(b, torch.zeros_like(b), *args,
                                        body=body)
        iterations.add(resident.read_stats(stats)["iterations"])
    assert len(iterations) == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_bodies_match_plain(ops24, cuda_device, dtype):
    """K2's shared-memory and device-memory bodies, FSAI-preconditioned."""
    grid, _, ops, layout = ops24
    A, G, GT = (cutband.band_planes(ops[k], layout, cuda_device, dtype)
                for k in ("mass", "G", "GT"))
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(3).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    _bodies_cg(b, (A, G, GT, 40, 1e-5, 1e-12), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_bodies_unpreconditioned(uncut16, cuda_device, dtype):
    grid, mass, layout = uncut16
    A = cutband.band_planes(mass, layout, cuda_device, dtype)
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(4).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    _bodies_cg(b, (A, None, None, 120, 1e-6, 1e-12), dtype)


def test_resident_cg_picks_device_body(cuda_device):
    """At 160^2 in float64 the planes (34.6 MB) do not fit the blocks'
    shared memory: the launcher picks the device body on its own."""
    grid, _, mass, _ = flagship_operators(160)
    G, GT = fsai_factors(mass)
    layout = cutband.layout_for(grid, max(mass.radius, G.radius))
    A, Gp, GTp = (cutband.band_planes(s, layout, cuda_device, torch.float64)
                  for s in (mass, G, GT))
    n_taps = len(A.taps) + len(Gp.taps) + len(GTp.taps)
    assert resident.resident_plan(
        layout, n_taps, 8, *resident.card_limits(
            torch.cuda.current_device())).body == "device"
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(5).standard_normal(grid.n_nodes),
        dtype=torch.float64, device=cuda_device))
    before = dict(resident.resident_cg.body_launches)
    _check_cg(b, torch.zeros_like(b), (A, Gp, GTp, 40, 1e-5, 1e-12),
              torch.float64)
    after = resident.resident_cg.body_launches
    assert (after["device"], after["shared"]) == (before["device"] + 1,
                                                  before["shared"])


def test_resident_cg_rejects_body(ops24, cuda_device):
    grid, _, ops, layout = ops24
    A = cutband.band_planes(ops["mass"], layout, cuda_device, torch.float32)
    b = torch.zeros(layout.shape, device=cuda_device)
    with pytest.raises(ValueError, match="body"):
        resident.resident_cg(b, b, A, body="vmem")


def test_verified_solver_routes_on_card(ops24, cuda_device):
    grid, op, ops, _ = ops24
    vs = verified_fsai_solver(ops["mass"], windows=op.w_cut, max_iter=60,
                              rel_tol=1e-5, device=cuda_device)
    assert vs.path == "resident-verified"
    crippled = verified_fsai_solver(ops["mass"], windows=op.w_cut,
                                    max_iter=200, rel_tol=1e-6,
                                    resident_max_iter=1, device=cuda_device)
    assert crippled.path == "streamed"
    checked = verified_fsai_solver(ops["mass"], windows=op.w_cut,
                                   max_iter=200, rel_tol=1e-6, probe=False,
                                   resident_max_iter=2, device=cuda_device)
    b = vs.layout.pad(torch.as_tensor(
        np.random.default_rng(2).standard_normal(grid.n_nodes),
        dtype=torch.float32, device=cuda_device))
    x_ok, info_ok = vs.solve_padded_with_info(b)
    x_fb, info_fb = checked.solve_padded_with_info(b)
    assert info_ok["fallback"] is False and info_fb["fallback"] is True
    assert checked.fallback_count == 1
    # both answers solve the system to float32-CG accuracy
    bh = vs.layout.unpad(b).cpu().double()
    for x in (x_ok, x_fb):
        r = ops["mass"].apply(vs.layout.unpad(x).cpu().double()) - bh
        assert (r.norm() / bh.norm()).item() <= 1e-4


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_one_band_matches_plain(ops24, cuda_device, dtype, body):
    """K2's one-band mode, z = P r over the assembled Schwarz band, each
    body against the plain twin, counted in ``mode_launches["band"]``."""
    grid, _, ops, layout = ops24
    A, P = (cutband.band_planes(ops[k], layout, cuda_device, dtype)
            for k in ("mass", "schwarz"))
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(7).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    before = resident.resident_cg.mode_launches["band"]
    # rel 1e-4: the float32 solve stops above its true residual's floor
    # (~1.2e-3 here), below which the order of a sum moves it by ~20%
    _check_cg(b, torch.zeros_like(b), (A, None, None, 200, 1e-4, 1e-12),
              dtype, body, P=P)
    assert resident.resident_cg.mode_launches["band"] == before + 1


@pytest.mark.parametrize("mode", ["band", "fsai"])
@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_gate_on_card(ops24, cuda_device, dtype, body, mode):
    """A gate the earlier stats passed: x stays x0 and the stats read
    [0, 0, 0, 0]; one they failed: the launch solves as an ungated one
    does (bit for bit: the kernel's sums have a fixed order), and as the
    plain twin with the same gate."""
    grid, _, ops, layout = ops24
    names = ("mass", "schwarz") if mode == "band" else ("mass", "G", "GT")
    bands = [cutband.band_planes(ops[k], layout, cuda_device, dtype)
             for k in names]
    args = ((bands[0], None, None) if mode == "band" else tuple(bands)) + (
        200, 1e-4, 1e-12)
    kw = {"P": bands[1]} if mode == "band" else {}
    b = layout.pad(torch.as_tensor(
        np.random.default_rng(8).standard_normal(grid.n_nodes), dtype=dtype,
        device=cuda_device))
    x0 = torch.full_like(b, 0.25)
    x_ref, s_ref = resident.resident_cg(b, x0, *args, body=body, **kw)
    for res, opened in ((5e-4, False), (2e-3, True)):
        gate = resident.Gate(torch.tensor([res, 5.0, 1.0, 1.0],
                                          device=cuda_device), 10.0, 1e-4,
                             1e-12)
        before = resident.resident_cg.gated_launches
        x, s = resident.resident_cg(b, x0, *args, body=body, gate=gate, **kw)
        assert resident.resident_cg.gated_launches == before + 1
        xp, sp = resident.resident_cg_plain(b, x0, *args, gate=gate, **kw)
        if opened:
            assert torch.equal(x, x_ref) and torch.equal(s, s_ref)
            assert resident.read_stats(s)["ran"] is True
            _check_cg(b, x0, args, dtype, body, gate=gate, **kw)
        else:
            assert torch.equal(x, x0) and torch.equal(xp, x0)
            assert s.tolist() == sp.tolist() == [0.0, 0.0, 0.0, 0.0]


def test_verified_device_form_on_card(ops24, cuda_device):
    """The verified solver's device form makes no host read (under
    ``set_sync_debug_mode("error")``): on the resident route the gate
    stays closed; with the resident path crippled it opens, the answer
    solves the system, and the fallback folds into ``fallback_count``."""
    grid, op, ops, _ = ops24
    vs = verified_fsai_solver(ops["mass"], windows=op.w_cut, max_iter=200,
                              rel_tol=1e-6, device=cuda_device)
    checked = verified_fsai_solver(ops["mass"], windows=op.w_cut,
                                   max_iter=200, rel_tol=1e-6, probe=False,
                                   resident_max_iter=2, device=cuda_device)
    b = vs.layout.pad(torch.as_tensor(
        np.random.default_rng(9).standard_normal(grid.n_nodes),
        dtype=torch.float32, device=cuda_device))
    for solver in (vs, checked):
        solver.solve_padded_device(b)      # first use: allocations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_ok, s_ok = vs.solve_padded_device(b)
        x_fb, s_fb = checked.solve_padded_device(b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert vs.device_info(s_ok)["fallback"] is False
    assert checked.device_info(s_fb)["fallback"] is True
    assert vs.fallback_count == 0 and checked.fallback_count == 2
    bh = vs.layout.unpad(b).cpu().double()
    for x in (x_ok, x_fb):
        r = ops["mass"].apply(vs.layout.unpad(x).cpu().double()) - bh
        assert (r.norm() / bh.norm()).item() <= 1e-4


@pytest.fixture(scope="module")
def dod_masses():
    """Both regions' ghost-penalised cut masses of the composite DoD
    advection case (200^2 cells, p = 5: radius 6, up to 169 taps) with
    their cut windows; built only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from gdm_torch.problems.advection import composite_app_case

    p = composite_app_case()
    grid = Grid(p.fe_degree, (p.n_subdivisions_1D,) * 2,
                (p.geometry_left,) * 2, (p.geometry_right,) * 2)
    geo = CutGeometry.build(grid, p.level_set_function,
                            p.level_set_fe_degree)
    out = {}
    for name, loc in (("inside", INSIDE), ("outside", OUTSIDE)):
        op = CutOperators(geo, loc)
        out[name] = (assemble_stencil(op, "mass", p.ghost_parameter_M),
                     op.w_cut)
    return grid, out


def _a_norm(A64, v):
    """|v|_A in float64 on the float64 planes ``A64``."""
    v = v.double()
    return (v * cutband.band_apply_plain(v, A64)).sum().sqrt().item()


@pytest.mark.parametrize("region", ["inside", "outside"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_band_apply_dod_masses(dod_masses, cuda_device, region, dtype):
    """K1 on the DoD masses' radius-6 bands (the mass and its Schwarz
    band) against the plain version."""
    grid, masses = dod_masses
    mass, windows = masses[region]
    layout = cutband.layout_for(grid, mass.radius)
    assert mass.radius == 6 and layout.r == 6
    for st in (mass, schwarz_band(mass, windows, dtype)):
        bp = cutband.band_planes(st, layout, cuda_device, dtype)
        assert len(bp.taps) <= 169
        u = _rand(layout.shape, 11, dtype, cuda_device)
        _check_band(bp, cutband.band_apply(u, bp), u, dtype)


@pytest.mark.parametrize("mode", ["fsai", "band"])
@pytest.mark.parametrize("region", ["inside", "outside"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_dod_masses(dod_masses, cuda_device, region, dtype,
                                mode):
    """K2 at the DoD masses' shapes, its FSAI mode and its one-band
    (Schwarz) mode, on the body resident_plan picks (the device body:
    the planes do not fit shared memory), against the plain twin on b =
    A x_ref for a seeded O(1) x_ref, rel 1e-6: iterations within 2 in
    float32 and equal in float64, the A-norm of x - x_plain within 1e-5
    of |x_ref|_A (1e-8 in float64)."""
    grid, masses = dod_masses
    mass, windows = masses[region]
    if mode == "fsai":
        G, GT = fsai_factors(mass)
        layout = cutband.layout_for(grid, max(mass.radius, G.radius))
        A, Gp, GTp = (cutband.band_planes(s, layout, cuda_device, dtype)
                      for s in (mass, G, GT))
        slots, kw = (Gp, GTp), {}
    else:
        layout = cutband.layout_for(grid, mass.radius)
        A, P = (cutband.band_planes(s, layout, cuda_device, dtype)
                for s in (mass, schwarz_band(mass, windows, torch.float32)))
        slots, kw = (None, None), {"P": P}
    n_taps = len(A.taps) + sum(len(s.taps) for s in
                               (slots if mode == "fsai" else (kw["P"],)))
    plan = resident.resident_plan(layout, n_taps, A.planes.element_size(),
                                  *resident.card_limits(
                                      torch.cuda.current_device()))
    assert plan.body == "device"
    x_ref = layout.pad(torch.as_tensor(
        np.random.default_rng(12).standard_normal(grid.n_nodes),
        dtype=torch.float64, device=cuda_device))
    A64 = cutband.band_planes(mass, layout, cuda_device, torch.float64)
    b = cutband.band_apply_plain(x_ref, A64).to(dtype)
    args = (A, *slots, 1000, 1e-6, 1e-12)
    before = dict(resident.resident_cg.body_launches)
    xk, sk = resident.resident_cg(b, torch.zeros_like(b), *args, **kw)
    assert resident.resident_cg.body_launches["device"] == \
        before["device"] + 1
    xp, sp = resident.resident_cg_plain(b, torch.zeros_like(b), *args, **kw)
    sk, sp = resident.read_stats(sk), resident.read_stats(sp)
    assert 0 < sk["iterations"] < 1000
    f64 = dtype == torch.float64
    assert abs(sk["iterations"] - sp["iterations"]) <= (0 if f64 else 2)
    assert _a_norm(A64, xk - xp) <= (1e-8 if f64 else 1e-5) * _a_norm(
        A64, x_ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_entry_step_matches_cpu(cuda_device, dtype):
    step_c, (t, dt, u0, v0) = gdm_torch.entry(24, device="cpu",
                                              dtype=torch.float64)
    uc, vc = step_c(t, dt, u0, v0)
    step_k, (t, dt, u0, v0) = gdm_torch.entry(24, device=cuda_device,
                                              dtype=dtype)
    uk, vk = step_k(t, dt, u0, v0)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for a, b in ((uk, uc), (vk, vc)):
        assert a.device.type == "cuda" and a.dtype == dtype
        assert ((a.cpu().double() - b).norm() / b.norm()).item() <= tol


LAPLACE2_CASES = [
    (3, (40, 72)),     # 2 x 3 tiles of 32 x 32, ragged in both axes
    (5, (48, 40)),
    (3, (200, 130)),   # many tiles
    (15, (40, 33)),    # the largest degree K3 takes
    # stencil2.k3_plan's rows a thread: 8 here, 4 in the next, 2 in the
    # small cases above (tests/test_torch_plans.py holds that on the CPU)
    (3, (300, 1024)),
    (3, (160, 1024)),
]


def _rand(shape, seed, dtype, device):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                           dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", LAPLACE2_CASES)
def test_laplace2_matches_plain(cuda_device, p, cells, dtype):
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 0, dtype, cuda_device)
    before = stencil2.laplace2_apply.launches
    yk = stencil2.laplace2_apply(u, bt)
    assert stencil2.laplace2_apply.launches == before + 1
    yp = stencil2.laplace2_apply_plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_laplace2_four_factor_bands(cuda_device, dtype):
    """Four distinct factors, so a swap of A/B or of the axes fails."""
    grid = Grid(3, (37, 45), (0.0, 0.0), (1.0, 1.0))
    rng = np.random.default_rng(5)
    bands = [rng.standard_normal((n, 7))
             for n in (grid.nodes[0], grid.nodes[1], grid.nodes[0],
                       grid.nodes[1])]
    apply, pad, unpad, shape = stencil2.make_padded_laplace2(
        grid, dtype, bands=bands, device=cuda_device)
    u = _rand(grid.nodes, 1, dtype, cuda_device)
    yk = unpad(apply(pad(u)))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype, bands)
    yp = stencil2.laplace2_apply_plain(u, bt)
    assert _rel(yk, yp) <= _tol(dtype)
    # the plain twin against the dense product on the host
    full = []
    for b in bands:
        n = b.shape[0]
        A = np.zeros((n, n))
        for k in range(7):
            idx = np.arange(max(0, 3 - k), min(n, n + 3 - k))
            A[idx, idx + k - 3] = b[idx, k]
        full.append(A)
    U = u.double().cpu().numpy()
    Y = full[0] @ U @ full[1].T + full[2] @ U @ full[3].T
    assert np.abs(yp.double().cpu().numpy() - Y).max() <= (
        _tol(dtype) * np.abs(Y).max())


LAPLACE3_CASES = [
    (3, (12, 12, 12)),
    (5, (10, 9, 11)),    # anisotropic, one-sided bands
    (3, (40, 20, 70)),   # ragged tiles along every axis, several chunks
    (7, (9, 8, 10)),     # the largest degree K4 takes
    (1, (20, 30, 16)),   # the smallest degree, odd N2
    # long axes 0 and 2 and a short axis 1 (several segments), and a tall
    # single strip of many runs (one chunk in float64)
    (3, (24, 176, 680)),
    (3, (44, 176, 680)),
    (3, (96, 176, 680)),
    (5, (16, 100, 30)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", LAPLACE3_CASES)
def test_laplace3_matches_plain(cuda_device, p, cells, dtype):
    grid = Grid(p, cells, (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    bt = stencil3.laplace3_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 2, dtype, cuda_device)
    before = stencil3.laplace3_apply.launches
    yk = stencil3.laplace3_apply(u, bt)
    assert stencil3.laplace3_apply.launches == before + 1
    yp = stencil3.laplace3_apply_plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_laplace3_every_plan(cuda_device, dtype):
    """Every chunk k4_plans lists gives the same function."""
    grid = Grid(3, (60, 33, 40), (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    bt = stencil3.laplace3_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 21, dtype, cuda_device)
    yp = stencil3.laplace3_apply_plain(u, bt)
    plans = stencil3.k4_plans(grid.nodes, 3, dtype)
    assert len(plans) > 2
    for plan in plans:
        y = stencil3._launch_plan(u, bt, plan)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= _tol(dtype), plan


@pytest.mark.parametrize("dtype", DTYPES)
def test_laplace3_refuses_a_plan_off_its_layout(cuda_device, dtype):
    """The launcher holds the plan to its own layout: shared memory that
    differs from the kernel's count, more rows a run than a thread owns,
    or a strip wider than a warp raise."""
    grid = Grid(3, (60, 33, 40), (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    bt = stencil3.laplace3_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 21, dtype, cuda_device)
    plan = stencil3.k4_plan(grid.nodes, 3, dtype)
    seg, runs, chunks = plan.grid
    for bad in (dataclasses.replace(plan, smem=plan.smem + 16),
                dataclasses.replace(plan, grid=(seg, runs - 1, chunks)),
                dataclasses.replace(plan, strips=1)):
        with pytest.raises(RuntimeError, match="K4"):
            stencil3._launch_plan(u, bt, bad)


def test_laplace_rejects(cuda_device):
    grid = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, torch.float32)
    u = torch.zeros(grid.nodes, device=cuda_device)
    with pytest.raises(ValueError):
        stencil2.laplace2_apply(u.double(), bt)
    with pytest.raises(ValueError):
        stencil2.laplace2_apply(u.t(), bt)   # same shape, not contiguous
    with pytest.raises(ValueError):
        stencil2.laplace2_apply(u[:-1], bt)
    with pytest.raises(ValueError, match="p <= 7"):
        stencil3.laplace3_bands(Grid(9, (9, 9, 9), (0,) * 3, (1,) * 3),
                                cuda_device)


def _sin_rhs(m, c):
    v = len(m) * np.pi**2
    for x in m:
        v = v * np.sin(np.pi * x)
    return v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cells", [(32, 32), (16, 16, 16)])
def test_poisson_mg_on_card(cuda_device, cells, dtype):
    grid = Grid(3, cells, (0.0,) * len(cells), (1.0,) * len(cells))
    # gdm's dispatch: K3 in 2D, K5 in 3D (N0 + 2p = 23 <= 512)
    kernel = stencil2.laplace2_apply if len(cells) == 2 else (
        stencil3.laplace3_mxu_apply)
    before = kernel.launches
    xk, ik = poisson.solve(grid, _sin_rhs, rel_tol=1e-4, precondition="mg",
                           device=cuda_device, dtype=dtype)
    assert kernel.launches > before
    xc, ic = poisson.solve(grid, _sin_rhs, rel_tol=1e-4, precondition="mg",
                           device="cpu")
    if dtype == torch.float64:
        assert ik["iterations"] == ic["iterations"]
    else:
        assert abs(ik["iterations"] - ic["iterations"]) <= 1
    assert ((xk.cpu().double() - xc).norm() / xc.norm()).item() <= (
        1e-10 if dtype == torch.float64 else 1e-4)


LAPLACE3_MXU_CASES = [
    (3, (12, 6, 20)),    # one block, one 16-plane window
    (1, (12, 12, 12)),
    (5, (10, 9, 11)),    # anisotropic, one-sided bands
    (3, (40, 20, 70)),   # ragged tiles along every axis, several windows
    (7, (9, 8, 10)),     # the largest degree K5 takes
    (7, (40, 17, 33)),
    # stencil3.k5_plan picks the box (planes, rows) from the grid of
    # boxes and the u slots a warp from the blocks an SM holds; these and
    # the small cases above reach every box of K5_BOXES and 1, 2 and 3
    # slots over float32 and float64 (tests/test_torch_plans.py holds
    # that on the CPU)
    (3, (39, 191, 351)),
    (3, (69, 191, 351)),
    (3, (32, 64, 64)),
    (3, (32, 32, 64)),
    (3, (16, 32, 32)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", LAPLACE3_MXU_CASES)
def test_laplace3_mxu_matches_plain(cuda_device, p, cells, dtype):
    grid = Grid(p, cells, (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    bt = stencil3.laplace3_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 3, dtype, cuda_device)
    before = stencil3.laplace3_mxu_apply.launches
    yk = stencil3.laplace3_mxu_apply(u, bt)
    assert stencil3.laplace3_mxu_apply.launches == before + 1
    yp = stencil3.laplace3_mxu_apply_plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)
    # and K4, the other schedule of the same operator
    assert _rel(stencil3.laplace3_apply(u, bt), yp) <= _tol(dtype)


DISPATCH_CASES = [
    ((505, 4, 4), "laplace3_mxu_apply"),   # N0 + 2p = 512: K5
    ((506, 4, 4), "laplace3_apply"),       # N0 + 2p = 513: K4
]


@pytest.mark.parametrize("cells,kernel", DISPATCH_CASES)
def test_dispatch_routes_by_plane_count(cuda_device, cells, kernel):
    grid = Grid(3, cells, (0.0,) * 3, (1.0,) * 3)
    other = ({"laplace3_mxu_apply", "laplace3_apply"} - {kernel}).pop()
    before = {k: getattr(stencil3, k).launches for k in (kernel, other)}
    u = _rand(grid.nodes, 4, torch.float32, cuda_device)
    y = fast.laplace_apply_fn(grid, torch.float32, device=cuda_device)(u)
    assert getattr(stencil3, kernel).launches == before[kernel] + 1
    assert getattr(stencil3, other).launches == before[other]
    bt = stencil3.laplace3_bands(grid, cuda_device, torch.float32)
    assert _rel(y, stencil3.laplace3_mxu_apply_plain(u, bt)) <= 1e-5


LAPLACE2_STREAM_CASES = [
    (3, (20, 20)),       # one strip, one tile
    (3, (40, 72)),       # ragged in both axes
    (5, (48, 40)),
    (3, (200, 130)),
    (15, (40, 33)),      # the largest degree K3s takes
    (7, (300, 1000)),
    (3, (1500, 2100)),   # several tiles per segment, ragged last tile
    # stencil2.k3s_plan's strip widths: 64 in the small cases above, 128
    # at (300, 1000), 256 at (1500, 2100) and here, with one strip and
    # with many; float64 rows (8 bytes) shift by one of two elements
    (1, (2048, 2048)),
    (3, (30, 4096)),
    (3, (10, 300)),      # one segment: fewer than 2 x K3S_MIN_SEG rows
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", LAPLACE2_STREAM_CASES)
def test_laplace2_stream_matches_plain(cuda_device, p, cells, dtype):
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 5, dtype, cuda_device)
    before = stencil2.laplace2_stream_apply.launches
    yk = stencil2.laplace2_stream_apply(u, bt)
    assert stencil2.laplace2_stream_apply.launches == before + 1
    yp = stencil2.laplace2_stream_apply_plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_laplace2_stream_every_plan(cuda_device, dtype):
    """Every plan k3s_plans lists, through the private launch hook, on
    rows of 1001 nodes (each 4 or 8 bytes past the last row's 16-byte
    shift)."""
    grid = Grid(3, (300, 1000), (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 8, dtype, cuda_device)
    yp = stencil2.laplace2_stream_apply_plain(u, bt)
    plans = stencil2.k3s_plans(grid.nodes, 3, dtype)
    assert {pl.cols for pl in plans} == set(stencil2.K3S_COLS)
    for plan in plans:
        y = stencil2._launch_plan(u, bt, plan)
        torch.cuda.synchronize()
        assert _rel(y, yp) <= _tol(dtype), plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_laplace2_stream_unaligned_input(cuda_device, offset, dtype):
    """u starting 1, 2 or 3 elements past its storage's start (a view
    into a larger tensor; 4, 8 or 12 bytes past a 16-byte boundary in
    float32, 8, 0 or 8 in float64): the copies' 16-byte middles follow
    the address."""
    grid = Grid(3, (70, 300), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    n = grid.n_nodes
    flat = _rand((n + offset,), 9, dtype, cuda_device)
    u = flat[offset:].view(grid.nodes)
    assert u.is_contiguous()
    y = stencil2.laplace2_stream_apply(u, bt)
    yp = stencil2.laplace2_stream_apply_plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_laplace2_stream_four_factor_bands(cuda_device, dtype):
    """Four distinct factors: a swap of the A and B factors of one axis
    changes the operator, and the kernel must follow."""
    grid = Grid(3, (137, 45), (0.0, 0.0), (1.0, 1.0))
    rng = np.random.default_rng(6)
    n0, n1 = grid.nodes
    bands = [rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1)]
    apply, pad, unpad, _ = stencil2.make_padded_laplace2_stream(
        grid, dtype, bands=bands, device=cuda_device)
    u = _rand(grid.nodes, 7, dtype, cuda_device)
    yk = unpad(apply(pad(u)))
    assert _rel(yk, apply.plain(u)) <= _tol(dtype)
    crossed = (bands[0], bands[3], bands[2], bands[1])
    yc = stencil2.laplace2_stream_apply(
        u, stencil2.laplace2_bands(grid, cuda_device, dtype, crossed))
    assert _rel(yc, yk) > 1e-3


def test_schedule_wrappers_reject(cuda_device):
    g2 = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(g2, cuda_device, torch.float32)
    u = torch.zeros(g2.nodes, device=cuda_device)
    for bad in (u.double(), u.t(), u[:-1], u.cpu()):
        with pytest.raises(ValueError):
            stencil2.laplace2_stream_apply(bad, bt)
    g3 = Grid(3, (6, 6, 6), (0.0,) * 3, (1.0,) * 3)
    bt3 = stencil3.laplace3_bands(g3, cuda_device, torch.float32)
    u3 = torch.zeros(g3.nodes, device=cuda_device)
    for bad in (u3.double(), u3.transpose(0, 2), u3[:-1], u3.cpu()):
        with pytest.raises(ValueError):
            stencil3.laplace3_mxu_apply(bad, bt3)
    bt16 = stencil3.laplace3_bands(g3, cuda_device, torch.float16)
    with pytest.raises(ValueError, match="float32 or float64"):
        stencil3.laplace3_mxu_apply(u3.half(), bt16)


TC_KERNELS = ["mxucol", "fullmxu", "hybrid", "hybp"]
TC_CASES = [
    (1, (20, 20)),       # one block
    (3, (40, 72)),       # ragged in both axes
    (3, (150, 1024)),    # N0 not a multiple of the tile, N1 = 1025 (odd)
    (7, (300, 140)),     # several tiles per strip
    (15, (40, 33)),      # the largest degree, the smallest default tiles
]


def _tc(kernel):
    return (getattr(stencil2, f"laplace2_{kernel}_apply"),
            getattr(stencil2, f"laplace2_{kernel}_apply_plain"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", TC_CASES)
@pytest.mark.parametrize("kernel", TC_KERNELS)
def test_laplace2_tc_matches_plain(cuda_device, kernel, p, cells, dtype):
    """K3c, K3f, K3h and K3p (3xTF32 in float32, DMMA in float64) at
    their default tiles against K3's twin."""
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 8, dtype, cuda_device)
    wrapper, plain = _tc(kernel)
    before = wrapper.launches
    yk = wrapper(u, bt)
    assert wrapper.launches == before + 1
    yp = plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vr", [0, 5, 13, None, 10**6])
@pytest.mark.parametrize("kernel", ["hybrid", "hybp"])
def test_laplace2_split_rows(cuda_device, kernel, vr, dtype):
    """K3h/K3p with the column stage all on the tensor cores (0), split
    inside a 16-row block and inside a k-step of K3p's chunk (5, 13), at
    the default split and all on the FMA units (>= the extended tile),
    over several tiles of a strip."""
    grid = Grid(3, (400, 90), (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 9, dtype, cuda_device)
    wrapper, plain = _tc(kernel)
    yk = wrapper(u, bt, tile_r=48, vpu_rows=vr)
    assert _rel(yk, plain(u, bt)) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", TC_KERNELS)
def test_laplace2_tc_four_factor_bands(cuda_device, kernel, dtype):
    """Four distinct factors at an odd tile: a swap of the A and B
    factors or of the axes would fail."""
    grid = Grid(3, (137, 45), (0.0, 0.0), (1.0, 1.0))
    rng = np.random.default_rng(10)
    n0, n1 = grid.nodes
    bands = [rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1)]
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype, bands)
    u = _rand(grid.nodes, 11, dtype, cuda_device)
    wrapper, plain = _tc(kernel)
    assert _rel(wrapper(u, bt, tile_r=37), plain(u, bt)) <= _tol(dtype)


WINDOW_KERNELS = {"fullmxu": stencil2.laplace2_fullmxu_apply,
                  "v1": stencil.laplace_v1_apply,
                  "mxu": stencil2.laplace2_mxu_apply,
                  "mxu3": stencil2.laplace2_mxu3_apply,
                  "mxu3p": stencil2.laplace2_mxu3p_apply,
                  "hybp": stencil2.laplace2_hybp_apply,
                  "mxucol": stencil2.laplace2_mxucol_apply,
                  "hybrid": stencil2.laplace2_hybrid_apply}
# the rows of the residue test's grid: more units than SMs with each
# kernel's columns a unit (32 for K3f, K0 and the strip kernels, 64 for
# K3/mxu, K3/mxu3 and K3/mxu3p) and its rows (K3p, K3c, K3h: whole tiles
# of 64 rows)
RESIDUE_ROWS = {"fullmxu": 200, "v1": 200, "mxu": 257, "mxu3": 257,
                "mxu3p": 257, "hybp": 257, "mxucol": 257, "hybrid": 257}
# the strip kernels' float64 tiles that do not fit a block at p = 7
UNFIT_F64 = {("hybp", 100), ("mxucol", 100)}


def _window_tol(kernel, dtype):
    """The bf16x3 products of K3/mxu3 and K3/mxu3p in float32: 1e-4; the
    others (K3p's 3xTF32 among them) 1e-5."""
    return _row_tol("mxu3p" if kernel in ("mxu3", "mxu3p") else "mxu",
                    dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n1", [1024, 1025, 1026, 1027])
@pytest.mark.parametrize("kernel", sorted(WINDOW_KERNELS))
def test_window_kernels_row_residues(cuda_device, kernel, n1, dtype):
    """K3f, K0, K3/mxu, K3/mxu3, K3/mxu3p, K3p, K3c and K3h at every
    residue of N1 mod 4 (a row's first element sits N1 i mod 4 elements
    past a 16-byte boundary), with a ragged last row unit and more units
    than SMs (a persistent walk)."""
    grid = Grid(3, (RESIDUE_ROWS[kernel] - 1, n1 - 1), (0.0, 0.0),
                (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, n1, dtype, cuda_device)
    wrapper = WINDOW_KERNELS[kernel]
    tile = stencil2.tc_options(kernel, bt)["tile_r"]
    plan = stencil2.tc_plan(kernel, bt.shape, 3, dtype, tile)
    assert plan.units > torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    assert plan.row_units[-1][1] < 32
    before = wrapper.launches
    yk = wrapper(u, bt)
    assert wrapper.launches == before + 1
    assert _rel(yk, stencil2.laplace2_apply_plain(u, bt)) <= _window_tol(
        kernel, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_r", [16, 37, 64, 100])
@pytest.mark.parametrize("kernel", sorted(WINDOW_KERNELS))
def test_window_kernels_tiles(cuda_device, kernel, tile_r, dtype):
    """K3f, K0, K3/mxu, K3/mxu3, K3/mxu3p, K3p, K3c and K3h with tiles of
    16, 37, 64 and 100 rows (cut into row units of at most 32, window rows
    past a unit zero; the strip kernels' units are the tiles), four band
    factors, p = 7 (K0's largest).  The float64 tiles of 100 rows of K3p
    and K3c do not fit a block and are refused."""
    grid = Grid(7, (150, 90), (0.0, 0.0), (1.0, 1.0))
    rng = np.random.default_rng(tile_r)
    n0, n1 = grid.nodes
    bands = [rng.standard_normal((n, 15)) for n in (n0, n1, n0, n1)]
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype, bands)
    u = _rand(grid.nodes, 21, dtype, cuda_device)
    if stencil2.tc_smem_bytes(kernel, 7, tile_r,
                              bt.a0.element_size()) > stencil2.SMEM_MAX:
        assert (kernel, tile_r) in UNFIT_F64 and dtype == torch.float64
        with pytest.raises(ValueError, match="shared memory"):
            WINDOW_KERNELS[kernel](u, bt, tile_r=tile_r)
        return
    yk = WINDOW_KERNELS[kernel](u, bt, tile_r=tile_r)
    assert _rel(yk, stencil2.laplace2_apply_plain(u, bt)) <= _window_tol(
        kernel, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cells", [(128, 128), (512, 512)])
@pytest.mark.parametrize("kernel", ["mxu", "mxu3", "mxu3p", "hybp", "mxucol",
                                    "hybrid"])
def test_row_kernels_flagship_sizes(cuda_device, kernel, cells, dtype):
    """K3/mxu, K3/mxu3, K3/mxu3p, K3p, K3c and K3h at the split apply's
    flagship sizes: fewer units than SMs at 129^2 nodes (a block a unit),
    more at 513^2."""
    grid = Grid(3, cells, (-1.21, -1.21), (1.21, 1.21))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 23, dtype, cuda_device)
    tile = stencil2.tc_options(kernel, bt)["tile_r"]
    plan = stencil2.tc_plan(kernel, bt.shape, 3, dtype, tile)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (plan.units < sms) == (cells[0] == 128)
    assert plan.blocks <= plan.units
    yk = WINDOW_KERNELS[kernel](u, bt)
    assert _rel(yk, stencil2.laplace2_apply_plain(u, bt)) <= _window_tol(
        kernel, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["mxu", "mxu3", "mxu3p"])
def test_row_kernels_refuse_a_plan_off_their_layout(cuda_device, kernel,
                                                    dtype):
    """The C entries hold the plan to their layout: a column width other
    than 64 or more blocks than units raise."""
    grid = Grid(3, (60, 100), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 25, dtype, cuda_device)
    plan = stencil2.tc_plan(kernel, bt.shape, 3, dtype, 64)
    bad = [dataclasses.replace(plan, cols=48),
           dataclasses.replace(plan, cols=32),
           dataclasses.replace(plan, blocks=plan.units + 1)]
    for b in bad:
        with pytest.raises(RuntimeError, match=kernel):
            stencil2._launch_tc_plan(u, bt, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybp_refuses_a_plan_off_its_layout(cuda_device, dtype):
    """K3p's C entry holds the plan to its layout: runs of tiles a strip
    (segs) of 0 or above the tiles, blocks other than strips x segs, a
    tile count other than the tile's, a negative vpu_rows raise."""
    grid = Grid(3, (200, 100), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 26, dtype, cuda_device)
    plan = stencil2.tc_plan("hybp", bt.shape, 3, dtype, 48)
    assert plan.segs == len(plan.row_units) == 5
    y = stencil2._launch_tc_plan(u, bt, plan, 40)
    assert _rel(y, stencil2.laplace2_apply_plain(u, bt)) <= _tol(dtype)
    bad = [(dataclasses.replace(plan, segs=0, blocks=0), 40),
           (dataclasses.replace(plan, segs=6, blocks=6 * plan.n_cb), 40),
           (dataclasses.replace(plan, blocks=plan.blocks - 1), 40),
           (dataclasses.replace(plan, row_units=plan.row_units[:-1],
                                segs=4, blocks=4 * plan.n_cb), 40),
           (plan, -1)]
    for b, vr in bad:
        with pytest.raises(RuntimeError, match="K3p"):
            stencil2._launch_tc_plan(u, bt, b, vr)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,what", [("mxucol", "K3c"), ("hybrid", "K3h")])
def test_strip_kernels_refuse_a_plan_off_their_layout(cuda_device, kernel,
                                                      what, dtype):
    """The C entries of K3c and K3h hold the plan to their layout, as
    K3p's: runs of tiles a strip (segs) of 0 or above the tiles, blocks
    other than strips x segs, a tile count other than the tile's (and for
    K3h a negative vpu_rows) raise; the plan itself runs."""
    grid = Grid(3, (200, 100), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 27, dtype, cuda_device)
    plan = stencil2.tc_plan(kernel, bt.shape, 3, dtype, 48)
    assert plan.segs == len(plan.row_units) == 5
    y = stencil2._launch_tc_plan(u, bt, plan, 40)
    assert _rel(y, stencil2.laplace2_apply_plain(u, bt)) <= _tol(dtype)
    bad = [(dataclasses.replace(plan, segs=0, blocks=0), 40),
           (dataclasses.replace(plan, segs=6, blocks=6 * plan.n_cb), 40),
           (dataclasses.replace(plan, blocks=plan.blocks - 1), 40),
           (dataclasses.replace(plan, row_units=plan.row_units[:-1],
                                segs=4, blocks=4 * plan.n_cb), 40)]
    if kernel == "hybrid":
        bad.append((plan, -1))
    for b, vr in bad:
        with pytest.raises(RuntimeError, match=what):
            stencil2._launch_tc_plan(u, bt, b, vr)


def test_window_tables_built_once(cuda_device):
    """The window tables are built at the first apply with a Bands2 and
    tile, not at the second; a table build is no launch of the kernel."""
    from gdm_torch.ops import tc_tables

    grid = Grid(3, (90, 70), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, torch.float32)
    u = _rand(grid.nodes, 22, torch.float32, cuda_device)
    for wrapper in WINDOW_KERNELS.values():
        before = wrapper.launches
        y1 = wrapper(u, bt)
        built = tc_tables.tables.builds
        y2 = wrapper(u, bt)
        assert tc_tables.tables.builds == built
        assert wrapper.launches == before + 2
        assert y1.equal(y2)


def test_tc_builders_launch_their_own_kernel(cuda_device):
    """Each public builder launches its own kernel once per apply and no
    other kernel."""
    grid = Grid(3, (100, 70), (0.0, 0.0), (1.0, 1.0))
    u = _rand(grid.nodes, 12, torch.float32, cuda_device)
    wrappers = {k: _tc(k)[0] for k in TC_KERNELS}
    wrappers["k3"] = stencil2.laplace2_apply
    wrappers["k3s"] = stencil2.laplace2_stream_apply
    for kernel in TC_KERNELS:
        make = getattr(stencil2, f"make_padded_laplace2_{kernel}")
        apply, pad, unpad, _ = make(grid, torch.float32, device=cuda_device)
        assert apply.kernel is wrappers[kernel]
        before = {k: w.launches for k, w in wrappers.items()}
        y = unpad(apply(pad(u)))
        after = {k: w.launches for k, w in wrappers.items()}
        assert {k for k in after if after[k] != before[k]} == {kernel}
        assert after[kernel] == before[kernel] + 1
        assert _rel(y, apply.plain(u)) <= 1e-5


def test_tc_wrappers_reject(cuda_device):
    g2 = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    bt = stencil2.laplace2_bands(g2, cuda_device, torch.float32)
    u = torch.zeros(g2.nodes, device=cuda_device)
    for kernel in TC_KERNELS:
        wrapper = _tc(kernel)[0]
        for bad in (u.double(), u.t(), u[:-1], u.cpu()):
            with pytest.raises(ValueError):
                wrapper(bad, bt)
    g15 = Grid(15, (40, 33), (0.0, 0.0), (1.0, 1.0))
    bt15 = stencil2.laplace2_bands(g15, cuda_device, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        stencil2.laplace2_hybp_apply(torch.zeros(g15.nodes, device=cuda_device,
                                                 dtype=torch.float64),
                                     bt15, tile_r=64)


ROW_MODES = ["mxu", "mxu3", "mxu3p"]
ROW_CASES = [
    (1, (20, 20)),       # one block
    (3, (40, 72)),       # ragged in both axes
    (3, (150, 1024)),    # N0 not a multiple of the tile, N1 = 1025 (odd)
    (7, (300, 140)),     # several tiles per strip
    (15, (40, 33)),      # the largest degree, the smallest default tiles
    (3, (1500, 2100)),   # K3/mxu3p: several tiles per segment
]
K0_CASES = [(1, (20, 20)), (3, (40, 72)), (3, (150, 1024)), (7, (300, 140))]


def _row_tol(rows, dtype):
    """bf16x3 row products (K3/mxu3, K3/mxu3p) in float32: 1e-4."""
    if dtype == torch.float32 and rows in ("mxu3", "mxu3p"):
        return 1e-4
    return _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", ROW_CASES)
@pytest.mark.parametrize("rows", ROW_MODES)
def test_laplace2_rows_match_plain(cuda_device, rows, p, cells, dtype):
    """K3/mxu, K3/mxu3 and K3/mxu3p at their default tiles against K3's
    twin."""
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 13, dtype, cuda_device)
    wrapper, plain, _ = stencil2.ROWS[rows]
    before = wrapper.launches
    yk = wrapper(u, bt)
    assert wrapper.launches == before + 1
    yp = plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _row_tol(rows, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,cells", K0_CASES)
def test_laplace_v1_matches_plain(cuda_device, p, cells, dtype):
    """K0 (rows first, 3xTF32 / DMMA) against its twin and K3's."""
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 2.0))
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype)
    u = _rand(grid.nodes, 14, dtype, cuda_device)
    before = stencil.laplace_v1_apply.launches
    yk = stencil.laplace_v1_apply(u, bt)
    assert stencil.laplace_v1_apply.launches == before + 1
    yp = stencil.laplace_v1_apply_plain(u, bt)
    torch.cuda.synchronize()
    assert _rel(yk, yp) <= _tol(dtype)
    assert _rel(yk, stencil2.laplace2_apply_plain(u, bt)) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", ROW_MODES + ["k0"])
def test_laplace2_rows_four_factor_bands(cuda_device, rows, dtype):
    """Four distinct factors at an odd tile: a swap of the A and B
    factors of one axis would fail."""
    grid = Grid(3, (137, 45), (0.0, 0.0), (1.0, 1.0))
    rng = np.random.default_rng(15)
    n0, n1 = grid.nodes
    bands = [rng.standard_normal((n, 7)) for n in (n0, n1, n0, n1)]
    bt = stencil2.laplace2_bands(grid, cuda_device, dtype, bands)
    u = _rand(grid.nodes, 16, dtype, cuda_device)
    if rows == "k0":
        wrapper = stencil.laplace_v1_apply
    else:
        apply, pad, unpad, _ = stencil2.make_padded_laplace2(
            grid, dtype, tile_r=37, rows=rows, bands=bands, device=cuda_device)
        assert unpad(apply(pad(u))).equal(apply.kernel(u, bt, tile_r=37))
        wrapper = stencil2.ROWS[rows][0]
    yk = wrapper(u, bt, tile_r=37)
    assert _rel(yk, stencil2.laplace2_apply_plain(u, bt)) <= _row_tol(rows,
                                                                       dtype)
    crossed = stencil2.laplace2_bands(
        grid, cuda_device, dtype, (bands[0], bands[3], bands[2], bands[1]))
    assert _rel(wrapper(u, crossed, tile_r=37), yk) > 1e-3


def test_row_builders_launch_their_own_kernel(cuda_device):
    """make_padded_laplace2(rows=r), the 2D dispatch and K0's builder
    each launch their own kernel once per apply and no other kernel."""
    grid = Grid(3, (100, 70), (0.0, 0.0), (1.0, 1.0))
    u = _rand(grid.nodes, 17, torch.float32, cuda_device)
    wrappers = {rows: w for rows, (w, _, _) in stencil2.ROWS.items()}
    wrappers["k0"] = stencil.laplace_v1_apply
    wrappers["k3s"] = stencil2.laplace2_stream_apply
    built = {rows: stencil2.make_padded_laplace2(grid, rows=rows,
                                                 device=cuda_device)
             for rows in stencil2.ROWS}
    built["k0"] = stencil.make_padded_laplace(grid, device=cuda_device)
    built["vpu (dispatch)"] = fast.best_padded_laplace(grid,
                                                       device=cuda_device)
    built["mxu3p (dispatch)"] = fast.best_padded_laplace(grid, rows="mxu3p",
                                                         device=cuda_device)
    for name, (apply, pad, unpad, _) in built.items():
        want = name.split()[0]
        assert apply.kernel is wrappers[want]
        before = {k: w.launches for k, w in wrappers.items()}
        y = unpad(apply(pad(u)))
        after = {k: w.launches for k, w in wrappers.items()}
        assert {k for k in after if after[k] != before[k]} == {want}
        assert after[want] == before[want] + 1
        assert _rel(y, apply.plain(u)) <= _row_tol(want, torch.float32)


def test_row_modes_reject(cuda_device):
    g2 = Grid(3, (16, 16), (0.0, 0.0), (1.0, 1.0))
    for bad in ("foo", "MXU3P", ""):
        with pytest.raises(ValueError, match="rows"):
            stencil2.make_padded_laplace2(g2, rows=bad, device=cuda_device)
        with pytest.raises(ValueError, match="rows"):
            fast.best_padded_laplace(g2, rows=bad, device=cuda_device)
    bt = stencil2.laplace2_bands(g2, cuda_device, torch.float32)
    u = torch.zeros(g2.nodes, device=cuda_device)
    for wrapper in [stencil2.ROWS[r][0] for r in ROW_MODES] + [
            stencil.laplace_v1_apply]:
        for bad in (u.double(), u.t(), u[:-1], u.cpu()):
            with pytest.raises(ValueError):
                wrapper(bad, bt)
    g9 = Grid(9, (40, 40), (0.0, 0.0), (1.0, 1.0))
    with pytest.raises(ValueError, match="p <= 7"):
        stencil.make_padded_laplace(g9, device=cuda_device)
    with pytest.raises(ValueError, match="p <= 7"):
        stencil.laplace_v1_apply(torch.zeros(g9.nodes, device=cuda_device),
                                 stencil2.laplace2_bands(g9, cuda_device))
    # K3/mxu3's float64 kernel is K3/mxu's, whose shared memory does not
    # grow with the tile: a tile of 64 fits at p = 15
    g15 = Grid(15, (300, 140), (0.0, 0.0), (1.0, 1.0))
    assert stencil2.make_padded_laplace2(
        g15, torch.float64, tile_r=64,
        rows="mxu3", device=cuda_device)[0].options == {"tile_r": 64}
    with pytest.raises(ValueError, match="shared memory"):
        stencil2.make_padded_laplace2_hybp(g15, torch.float64,
                                           tile_r=64, device=cuda_device)


@pytest.fixture(scope="module")
def flagship64():
    return flagship_operators(64)


@pytest.mark.parametrize("rows", ["mxu3p", "vpu"])
@pytest.mark.parametrize("kind", ["mass", "stiff"])
def test_fast_cut_apply_matches_k1(flagship64, cuda_device, kind, rows):
    """The split cut apply (the separable part on K3 in row mode
    ``rows``, plus the correction rows) against K1's apply of the same
    assembled band, at 64^2, float32."""
    grid, op, mass, stiff = flagship64
    st = mass if kind == "mass" else stiff
    fast_apply = fastapply.make_fast_cut_apply(
        st, op, fastapply.kron_pairs(grid, kind),
        inactive_identity=kind == "mass", rows=rows, device=cuda_device)
    assert fast_apply.n_corrections > 0
    k1 = fastapply.fast_stencil_apply(st, device=cuda_device)
    u = _rand(grid.n_nodes, 18, torch.float32, cuda_device)
    wrapper = stencil2.ROWS[rows][0]
    before = (wrapper.launches, cutband.band_apply.launches)
    y = fast_apply(u)
    assert (wrapper.launches, cutband.band_apply.launches) == (
        before[0] + 1, before[1])
    yk1 = k1(u)
    assert cutband.band_apply.launches == before[1] + 1
    torch.cuda.synchronize()
    assert _rel(y, yk1) <= _row_tol(rows, torch.float32)


TILE_PLANES_CELLS = (40, 20, 70)
TILE_PLANES = [1, 5, 13, 64]


@pytest.mark.parametrize("planes", TILE_PLANES)
def test_laplace3_tile_planes(cuda_device, planes):
    """gdm's tile_planes is K4's chunk of planes per block: any chunk
    gives the same function."""
    grid = Grid(3, TILE_PLANES_CELLS, (0.0, 0.0, 0.0), (1.0, 2.0, 1.5))
    apply, pad, unpad, _ = stencil3.make_padded_laplace3(
        grid, tile_planes=planes, device=cuda_device)
    assert apply.options == {"tile_planes": planes}
    u = _rand(grid.nodes, 19, torch.float32, cuda_device)
    assert _rel(unpad(apply(pad(u))), apply.plain(u)) <= 1e-5


# ---- gdm's micro-benchmarks M1-M5 ------------------------------------------

from gdm_torch.benchmarks import mxu_micro, stream_overlap_micro as som  # noqa: E402

MICRO_WRAPPERS = {"M1": mxu_micro.stage1_micro_apply,
                  "M2": mxu_micro.relayout_apply,
                  "M3": som.stream_micro_apply,
                  "M4": som.auto_micro_apply,
                  "M5": som.sepbuf_micro_apply}


def _launched_only(name, run):
    """Run ``run()`` and check that it launched micro ``name`` once and
    no other micro."""
    before = {k: w.launches for k, w in MICRO_WRAPPERS.items()}
    out = run()
    after = {k: w.launches for k, w in MICRO_WRAPPERS.items()}
    assert {k for k in after if after[k] != before[k]} == {name}
    assert after[name] == before[name] + 1
    return out


M1_CASES = [(3, (40, 40), 16),
            (5, (100, 70), 256),
            (3, (300, 130), 64),
            (3, (600, 40), 600),
            (3, (1024, 1024), 256),   # gdm's own shape
            (3, (300, 1000), 64)]


@pytest.mark.parametrize("p,cells,tile_r", M1_CASES)
@pytest.mark.parametrize("mode", mxu_micro.MODES)
def test_stage1_micro_matches_plain(cuda_device, mode, p, cells, tile_r):
    """M1 against its twin: the column modes within 1e-6 of the sum of
    |terms| (FMAs against multiply-adds), the bf16x3 row modes within 1e-5
    of max|y|, "splitsonly" exactly; ragged N0 (41, 101, 301 and 601
    nodes in tiles of 16, 104, 64 and 600 rows: T_ext = 120 is no
    multiple of 16 and its 64-deep chunks end ragged, and the 600-row
    tiles' ten chunks go round the row kernel's panel ring), gdm's
    1024^2 and 1025 x 1001 nodes in tiles of 64 rows (wider plans)."""
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 1.0))
    apply, shape = mxu_micro.make_stage1_micro(grid, mode, tile_r=tile_r,
                                               device=cuda_device)
    u = _rand(shape, 20, torch.float32, cuda_device)
    y = _launched_only("M1", lambda: apply(u))
    g = apply.geom
    yp = mxu_micro.stage1_micro_plain(u, *apply.tables, mode, g)
    torch.cuda.synchronize()
    err = (y - yp).abs().max().item()
    if mode == "splitsonly":
        assert err == 0.0
    elif mode in mxu_micro.ROW_MODES:
        assert err <= 1e-5 * yp.abs().max().item()
    else:
        assert err <= 1e-6 * mxu_micro.stage1_term_scale(u, *apply.tables,
                                                         mode, g)
    assert not y[:g.h].any() and not y[g.h + g.rp:].any()


@pytest.mark.parametrize("mode", ["rowsonly", "dotsonly"])
@pytest.mark.parametrize("p,cells,tile_r", M1_CASES[1:3])
def test_stage1_rows_every_plan(cuda_device, mode, p, cells, tile_r):
    """Every plan of M1's row kernel (each N with one and two
    warpgroups) gives the twin's function within 1e-5 of max|y|, zero
    guard rows included."""
    grid = Grid(p, cells, (0.0, 0.0), (1.0, 1.0))
    apply, shape = mxu_micro.make_stage1_micro(grid, mode, tile_r=tile_r,
                                               device=cuda_device)
    g = apply.geom
    u = _rand(shape, 22, torch.float32, cuda_device)
    yp = mxu_micro.stage1_micro_plain(u, *apply.tables, mode, g)
    plans = mxu_micro.stage1_row_plans(g, mode)
    assert {pl.n for pl in plans} == {32, 64, 96, 128}
    assert mxu_micro.stage1_row_plan(g, mode) in plans
    for plan in plans:
        y = mxu_micro._launch_row_plan(u, *apply.tables, mode, g, plan)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        assert err <= 1e-5 * yp.abs().max().item(), plan


def test_stage1_row_plans_reach_every_branch(cuda_device):
    """The card cases' default row plans take 32 columns and more, with
    one and two warpgroups."""
    picked = set()
    for p, cells, tile_r in M1_CASES:
        grid = Grid(p, cells, (0.0, 0.0), (1.0, 1.0))
        for mode in ("rowsonly", "dotsonly"):
            g = mxu_micro.make_stage1_micro(grid, mode, tile_r=tile_r,
                                            device=cuda_device)[0].geom
            pl = mxu_micro.stage1_row_plan(g, mode)
            picked.add((pl.n == 32, pl.wgs))
    assert picked == {(True, 1), (True, 2), (False, 1), (False, 2)}


RELAYOUT_CASES = [((32, 16), 3), ((48, 256), 5), ((100, 70), 1),
                  ((512, 128), 64)]
# (shape, steps) of test_relayout_every_plan, run at the card's SMs and at
# RELAYOUT_FEW_SMS
RELAYOUT_PLAN_CASES = [((100, 70), 7), ((512, 128), 64)]
RELAYOUT_FEW_SMS = 3


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,steps", RELAYOUT_CASES)
def test_relayout_matches_plain(cuda_device, shape, steps, dtype, pad):
    """M2: x^T exactly, at ragged sub-tiles and both pitches."""
    x = _rand(shape, 21, torch.float32, cuda_device).to(dtype)
    y = _launched_only("M2", lambda: mxu_micro.relayout_apply(x, steps, pad))
    assert y.equal(mxu_micro.relayout_apply_plain(x, steps))
    assert y.equal(x.t())


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,steps", RELAYOUT_PLAN_CASES)
@pytest.mark.parametrize("sms", [132, RELAYOUT_FEW_SMS])
def test_relayout_every_plan(cuda_device, shape, steps, dtype, pad, sms):
    """Every plan of ``relayout_plans`` (each warps a block), at the
    card's SMs and at RELAYOUT_FEW_SMS (a warp's range then spans several sub-tiles and
    starts at odd and even steps), gives x^T exactly."""
    x = _rand(shape, 25, torch.float32, cuda_device).to(dtype)
    for plan in mxu_micro.relayout_plans(*shape, steps, dtype, sms):
        y = mxu_micro._launch_relayout_plan(x, steps, pad, plan)
        torch.cuda.synchronize()
        assert y.equal(x.t()), plan


STREAM_CASES = [(40, 60, 16), (300, 250, 96), (1000, 1000, 96)]


@pytest.mark.parametrize("nb,nsplit", [(2, 1), (2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("n0,n1,tile_r", STREAM_CASES)
@pytest.mark.parametrize("mode", som.MODES)
def test_stream_micro_matches_plain(cuda_device, mode, n0, n1, tile_r, nb,
                                    nsplit):
    """M3 against its twin: "dma" and "dma_out" exactly, "both" within
    1e-6 of the sum of |terms|, the sinks within 1e-5 of their sum of
    |terms|; ragged N0, wrapped columns (u is nonzero everywhere)."""
    apply, shape, _ = som.make_micro(mode, n0, n1, tile_r, nb=nb,
                                     nsplit=nsplit, device=cuda_device)
    u = _rand(shape, 22, torch.float32, cuda_device)
    y = _launched_only("M3", lambda: apply(u))
    g = apply.geom
    yp = som.stream_micro_plain(u, apply.coef, g, mode)
    torch.cuda.synchronize()
    assert y.shape == yp.shape
    if mode in ("dma", "dma_out"):
        assert y.equal(yp)
    elif mode == "both":
        scale = som.stream_term_scale(u, apply.coef)
        assert (y - yp).abs().max().item() <= 1e-6 * scale
    else:
        per = g.tile_r * g.sw
        scale = per * (som.stream_term_scale(u, apply.coef)
                       if mode == "compute" else u.abs().max().item())
        assert (y - yp).abs().max().item() <= 1e-5 * scale


# (nb, nsplit) of test_stream_micro_every_plan, run at the card's SMs and
# at STREAM_FEW_SMS
STREAM_PLAN_RINGS = [(2, 1), (3, 2)]
STREAM_FEW_SMS = 2


@pytest.mark.parametrize("nb,nsplit", STREAM_PLAN_RINGS)
@pytest.mark.parametrize("sms", [132, STREAM_FEW_SMS])
@pytest.mark.parametrize("n0,n1,tile_r", STREAM_CASES)
@pytest.mark.parametrize("mode", som.MODES)
def test_stream_micro_every_plan(cuda_device, mode, n0, n1, tile_r, sms, nb,
                                 nsplit):
    """Every plan of ``m3_plans`` (strips of 128, 64 and 32 columns) at the
    card's SMs and at STREAM_FEW_SMS (a block then streams a run of units through its
    ring, across strips) against the twin at the plan's strip: "dma" and
    "dma_out" exactly, "both" within 1e-6 of the sum of |terms|, the
    sinks within 1e-5 of theirs."""
    apply, shape, _ = som.make_micro(mode, n0, n1, tile_r, nb=nb,
                                     nsplit=nsplit, device=cuda_device)
    u = _rand(shape, 26, torch.float32, cuda_device)
    for plan in som.m3_plans(n0, n1, tile_r, 7, nb, nsplit, sms):
        g = dataclasses.replace(apply.geom, sw=plan.sw)
        y = som._launch_m3_plan(u, apply.coef, g, mode, plan)
        yp = som.stream_micro_plain(u, apply.coef, g, mode)
        torch.cuda.synchronize()
        assert y.shape == yp.shape, plan
        err = (y - yp).abs().max().item()
        if mode in ("dma", "dma_out"):
            assert err == 0.0, plan
        elif mode == "both":
            assert err <= 1e-6 * som.stream_term_scale(u, apply.coef), plan
        else:
            scale = g.tile_r * g.sw * (
                som.stream_term_scale(u, apply.coef) if mode == "compute"
                else u.abs().max().item())
            assert err <= 1e-5 * scale, plan


@pytest.mark.parametrize("mode", ["both", "dma"])
def test_stream_micro_deepest_ring(cuda_device, mode):
    """The deepest ring the plan takes, nb = 8 slots of nsplit = 8 box
    chunks each (72 mbarriers), at 300 x 250: the plan's shared memory is
    the kernel's layout, and the outputs are the twin's."""
    apply, shape, _ = som.make_micro(mode, 300, 250, 96, nb=8, nsplit=8,
                                     device=cuda_device)
    u = _rand(shape, 27, torch.float32, cuda_device)
    y = _launched_only("M3", lambda: apply(u))
    yp = som.stream_micro_plain(u, apply.coef, apply.geom, mode)
    torch.cuda.synchronize()
    if mode == "dma":
        assert y.equal(yp)
    else:
        scale = som.stream_term_scale(u, apply.coef)
        assert (y - yp).abs().max().item() <= 1e-6 * scale


# M4's units are whole rows: Rp = 48, 384, 1056 and 1089 rows (W2 = 128,
# 256, 1024, 1152) in units of 32, 16, 4 and 4 rows in "dma" (48 and 1089
# not a multiple) and 48, 32, 8 and 7 in "both" (1089 not a multiple)
AUTO_CASES = STREAM_CASES + [(1000, 1100, 99)]


@pytest.mark.parametrize("n0,n1,tile_r", AUTO_CASES)
@pytest.mark.parametrize("mode", som.AUTO_MODES)
def test_auto_micro_matches_plain(cuda_device, mode, n0, n1, tile_r):
    """M4 against its twin: "dma" exactly, "both" within 1e-6 of the sum
    of |terms|."""
    apply, shape, _ = som.make_auto_micro(mode, n0, n1, tile_r,
                                          device=cuda_device)
    u = _rand(shape, 23, torch.float32, cuda_device)
    y = _launched_only("M4", lambda: apply(u))
    yp = som.auto_micro_plain(u, apply.coef, apply.geom, mode)
    torch.cuda.synchronize()
    if mode == "dma":
        assert y.equal(yp)
    else:
        scale = som.stream_term_scale(u, apply.coef)
        assert (y - yp).abs().max().item() <= 1e-6 * scale


@pytest.mark.parametrize("nb", [2, 3])
def test_stream_micro_modes_share_grid(cuda_device, nb):
    """Every M3 mode reserves the same shared memory, so all five run
    the same number of blocks and their times compare."""
    blocks = set()
    for mode in som.MODES:
        apply, shape, _ = som.make_micro(mode, 1000, 1000, 96, nb=nb,
                                         device=cuda_device)
        apply(torch.zeros(shape, device=cuda_device))
        blocks.add(som.stream_micro_apply.blocks)
    assert len(blocks) == 1


@pytest.mark.parametrize("n0,n1,tile_r", STREAM_CASES)
@pytest.mark.parametrize("mode", som.SEPBUF_MODES)
def test_sepbuf_micro_matches_plain(cuda_device, mode, n0, n1, tile_r):
    """M5 against its twin, exactly."""
    apply, shape, _ = som.make_sepbuf_micro(mode, n0, n1, tile_r,
                                            device=cuda_device)
    u = _rand(shape, 24, torch.float32, cuda_device)
    y = _launched_only("M5", lambda: apply(u))
    assert y.equal(som.sepbuf_micro_plain(u, apply.geom, mode))


def test_micro_wrappers_reject(cuda_device):
    """A wrong dtype, shape or a non-contiguous input raises."""
    grid = Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0))
    m1, shape1 = mxu_micro.make_stage1_micro(grid, "full", tile_r=16,
                                             device=cuda_device)
    m3, shape3, _ = som.make_micro("both", 40, 60, 16, device=cuda_device)
    m4, shape4, _ = som.make_auto_micro("dma", 40, 60, 16,
                                        device=cuda_device)
    m5, shape5, _ = som.make_sepbuf_micro("dma", 40, 60, 16,
                                          device=cuda_device)
    for apply, shape in ((m1, shape1), (m3, shape3), (m4, shape4),
                         (m5, shape5)):
        u = torch.zeros(shape, device=cuda_device)
        wide = torch.zeros((shape[0], 2 * shape[1]), device=cuda_device)
        for bad in (u.double(), wide[:, ::2], u[:-1], u.half()):
            with pytest.raises(ValueError):
                apply(bad)
    x = torch.zeros((32, 64), device=cuda_device)
    for bad in (x.double(), x.t(), x.half()):
        with pytest.raises(ValueError):
            mxu_micro.relayout_apply(bad)


def _cut_warp(pts):
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[..., 0], pts[..., 1]
    return np.stack(
        [x + 0.05 * np.sin(np.pi * x / 1.21) * np.cos(0.5 * np.pi * y / 1.21),
         y - 0.04 * np.sin(np.pi * y / 1.21) * np.cos(0.5 * np.pi * x / 1.21)],
        axis=-1)


@pytest.fixture(scope="module")
def deformed_bands():
    """The deformed bands of the deformation slice: the Dirichlet-
    condensed deformed stiffness on the unit square at 40^2 (radius 3,
    49 taps) and the flagship disc's cut mass and stiffness at 24^2
    under a vertex map (radius 4, per-cell full-cell matrices), with
    the mass's cut windows; built only where there is a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from gdm_torch import deform
    from gdm_torch.constraints import Constraints

    g = Grid(3, (40, 40), (0.0, 0.0), (1.0, 1.0))
    mask = np.asarray(Constraints.zero_boundary(g, device="cpu")
                      .full_mask).reshape(-1)
    dirichlet = deform.dirichlet_band(deform.laplace_band(g, _cut_warp),
                                      mask)
    grid = Grid(3, (24, 24), (-1.21, -1.21), (1.21, 1.21))
    geo = CutGeometry.build(
        grid, lambda m: np.sqrt(sum(x**2 for x in m)) - 1.0, 3)
    op = CutOperators(geo, INSIDE, mapping_fn=_cut_warp)
    mass = assemble_stencil(op, "mass", 0.25 * np.sqrt(3.0))
    stiff = assemble_stencil(op, "stiff", 0.5 * np.sqrt(3.0), 15.0,
                             with_nitsche=True)
    return {"dirichlet": dirichlet, "mass": mass, "stiff": stiff,
            "windows": op.w_cut}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["dirichlet", "mass", "stiff"])
def test_band_apply_deformed_bands(deformed_bands, cuda_device, name, dtype):
    """K1 on the deformed bands against the plain version: the radius-3
    Dirichlet band fills all 49 taps (k1_plan at a tap count no earlier
    case has), the cut bands carry per-cell entries."""
    st = deformed_bands[name]
    layout = cutband.layout_for(st.grid, st.radius)
    bp = cutband.band_planes(st, layout, cuda_device, dtype)
    if name == "dirichlet":
        assert st.radius == 3 and layout.r == 3 and len(bp.taps) == 49
    u = _rand(layout.shape, 21, dtype, cuda_device)
    before = cutband.band_apply.launches
    y = cutband.band_apply(u, bp)
    assert cutband.band_apply.launches == before + 1
    _check_band(bp, y, u, dtype)


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_resident_cg_one_band_deformed_mass(deformed_bands, cuda_device,
                                            dtype, body):
    """K2's one-band mode on the deformed cut mass with its Schwarz band,
    each body against the plain twin on b = A x_ref for a seeded O(1)
    x_ref, rel 1e-6 (as test_resident_cg_dod_masses: a random b leaves
    the float32 solve at its residual floor, where the order of a sum
    moves the residual by tens of percent): iterations within 2 in
    float32 and equal in float64, the A-norm of x - x_plain within 1e-5
    of |x_ref|_A (1e-8 in float64), counted in mode "band"."""
    mass = deformed_bands["mass"]
    layout = cutband.layout_for(mass.grid, mass.radius)
    A, P = (cutband.band_planes(s, layout, cuda_device, dtype)
            for s in (mass, schwarz_band(mass, deformed_bands["windows"],
                                         dtype)))
    A64 = cutband.band_planes(mass, layout, cuda_device, torch.float64)
    x_ref = layout.pad(torch.as_tensor(
        np.random.default_rng(22).standard_normal(mass.grid.n_nodes),
        dtype=torch.float64, device=cuda_device))
    b = cutband.band_apply_plain(x_ref, A64).to(dtype)
    args = (A, None, None, 1000, 1e-6, 1e-12)
    before = resident.resident_cg.mode_launches["band"]
    xk, sk = resident.resident_cg(b, torch.zeros_like(b), *args, P=P,
                                  body=body)
    assert resident.resident_cg.mode_launches["band"] == before + 1
    xp, sp = resident.resident_cg_plain(b, torch.zeros_like(b), *args, P=P)
    sk, sp = resident.read_stats(sk), resident.read_stats(sp)
    assert 0 < sk["iterations"] < 1000
    f64 = dtype == torch.float64
    assert abs(sk["iterations"] - sp["iterations"]) <= (0 if f64 else 2)
    assert _a_norm(A64, xk - xp) <= (1e-8 if f64 else 1e-5) * _a_norm(
        A64, x_ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_deformed_on_card(cuda_device, dtype):
    """poisson.solve_deformed with the never-cut multigrid at 32^2 on the
    card (CG apply and every level through K1) against the CPU float64
    solve: iterations equal in float64 and within one in float32, the
    solution within 1e-10 (float64) and 1e-5 (float32) relative."""
    g = Grid(3, (32, 32), (0.0, 0.0), (1.0, 1.0))

    def rhs(m, c):
        return 2 * np.pi**2 * np.sin(np.pi * m[0]) * np.sin(np.pi * m[1])

    def warp(pts):
        s = 0.08 * np.sin(2 * np.pi * pts[:, 0]) * np.sin(2 * np.pi * pts[:, 1])
        return np.stack([pts[:, 0] + s, pts[:, 1] - 0.5 * s], -1)

    rel = 1e-10 if dtype == torch.float64 else 1e-6
    xc, ic = poisson.solve_deformed(g, warp, rhs, rel_tol=rel,
                                    precondition="mg", device="cpu")
    before = cutband.band_apply.launches
    xk, ik = poisson.solve_deformed(g, warp, rhs, rel_tol=rel,
                                    precondition="mg", device=cuda_device,
                                    dtype=dtype)
    assert cutband.band_apply.launches > before
    assert xk.device.type == "cuda" and xk.dtype == dtype
    f64 = dtype == torch.float64
    assert abs(ik["iterations"] - ic["iterations"]) <= (0 if f64 else 1)
    d = ((xk.cpu().double() - xc).norm() / xc.norm()).item()
    assert d <= (1e-10 if f64 else 1e-5)
