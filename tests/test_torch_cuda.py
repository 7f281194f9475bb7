"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor gdm, so on a machine with a card and no jax it
runs on its own, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 sums of up to 81 taps in another order (fma against
mul + add) stay within 1e-5 of max|y|; float64 within 1e-12.  CG
iteration counts may differ by 2 in float32 (the kernel sums dots in
double, the plain version in float32) and must be equal in float64.
"""

import numpy as np
import pytest
import torch

import gdm_torch
from gdm_torch.cut.fsai import fsai_factors, verified_fsai_solver
from gdm_torch.cut.geometry import INSIDE, CutGeometry
from gdm_torch.cut.operators import CutOperators
from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
from gdm_torch.entry import flagship_operators
from gdm_torch.grid import Grid
from gdm_torch.ops import cutband, resident

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


def _check_cg(b, x0, args, dtype):
    before = resident.resident_cg.launches
    xk, sk = resident.resident_cg(b, x0, *args)
    assert resident.resident_cg.launches == before + 1
    xp, sp = resident.resident_cg_plain(b, x0, *args)
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
    x_ok, info_ok = vs.solve_with_info(b)
    x_fb, info_fb = checked.solve_with_info(b)
    assert info_ok["fallback"] is False and info_fb["fallback"] is True
    assert checked.fallback_count == 1
    # both answers solve the system to float32-CG accuracy
    bh = vs.layout.unpad(b).cpu().double()
    for x in (x_ok, x_fb):
        r = ops["mass"].apply(vs.layout.unpad(x).cpu().double()) - bh
        assert (r.norm() / bh.norm()).item() <= 1e-4


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
