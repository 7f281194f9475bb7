"""K2's one-band mode and its gate (gdm_torch.ops.resident), on the CPU,
through their plain twin, and the verified solver's device form
(``VerifiedSolver.solve_padded_device``) built on them.

K2's one-band mode, z = P r, is gdm's streamed CG (a ``lax.while_loop``
over the band kernel, preconditioned by the assembled Schwarz band) in
one launch; its gate is gdm's ``lax.cond`` fallback on an earlier
solve's stats.  In float64 on the wave app's 2D mass at 16 cells a
side: the one-band solve takes the host CG's iterations over the same
band apply and preconditioner, x within 1e-12 of max|x|; a one-tap
Jacobi band is ``solvers.jacobi_preconditioner``'s CG; a closed gate
leaves x at x0 and writes stats [0, 0, 0, 0], an open one solves as an
ungated launch; the band of heat-impl's M + dt S is its matrix-free
system within 1e-12.  The device form's tally, read once a chunk,
gives the counters the sums of its solves' stats.  The kernel against
this twin is in tests/test_torch_cuda.py (skipped without a card).
"""

import numpy as np
import pytest
import torch

from gdm_torch import profiling, solvers
from gdm_torch.cut import fsai
from gdm_torch.cut.stencil import assemble_stencil, schwarz_band
from gdm_torch.ops import cutband, resident
from gdm_torch.problems import scan, wave

F64 = torch.float64


@pytest.fixture(scope="module")
def mass16():
    """The wave preset's 2D mass at 16 cells a side, its Schwarz band,
    its layout and a seeded right-hand side."""
    p = wave.make_preset("wave", 2)
    p.n_subdivisions_1D = 16
    prob = wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64)
    op = prob.op_in
    mass = assemble_stencil(op, "mass", p.ghost_parameter_M)
    lay = cutband.layout_for(prob.grid, mass.radius)
    b = lay.pad(torch.as_tensor(np.random.default_rng(5).standard_normal(
        prob.grid.n_nodes), dtype=F64))
    return {"prob": prob, "mass": mass, "lay": lay, "b": b,
            "schwarz": schwarz_band(mass, op.w_cut, F64)}


def _planes(st, lay):
    return cutband.band_planes(st, lay, "cpu", F64)


def _against_host_cg(A, P, precond, b, tols):
    x, stats = resident.resident_cg_plain(b, torch.zeros_like(b), A,
                                          None, None, *tols, P=P)
    s = resident.read_stats(stats)
    xh, info = solvers.cg(lambda v: cutband.band_apply_plain(v, A), b,
                          precond=precond, max_iter=tols[0],
                          rel_tol=tols[1], abs_tol=tols[2])
    assert s["ran"] and s["iterations"] == info["iterations"] > 3
    assert (x - xh).abs().max().item() <= 1e-12 * xh.abs().max().item()
    return s


def test_one_band_is_the_host_schwarz_cg(mass16):
    """K2's one-band mode over the assembled Schwarz band: the host CG
    (``solvers.cg``) over the same band apply and preconditioner."""
    A = _planes(mass16["mass"], mass16["lay"])
    P = _planes(mass16["schwarz"], mass16["lay"])
    s = _against_host_cg(A, P, lambda r: cutband.band_apply_plain(r, P),
                         mass16["b"], (500, 1e-10, 1e-30))
    assert s["residual"] <= 1e-9 * s["r0"]


def test_jacobi_as_a_one_tap_band(mass16):
    """``jacobi_band``'s one tap is 1 / diag (zeros as 1): its CG is
    ``solvers.jacobi_preconditioner``'s."""
    prob, lay = mass16["prob"], mass16["lay"]
    diag = prob.op_in.mass_diagonal(prob.params.ghost_parameter_M)
    diag[:3] = 0.0   # the zero rule, on entries whose rows are inactive
    J = resident.jacobi_band(diag, prob.grid, "cpu", F64, lay)
    assert J.taps == ((0, 0),)
    pre = solvers.jacobi_preconditioner(torch.as_tensor(diag, dtype=F64))
    A = _planes(mass16["mass"], lay)
    _against_host_cg(A, J, lambda r: lay.pad(pre(lay.unpad(r))),
                     mass16["b"], (800, 1e-10, 1e-30))


def test_gate(mass16):
    """A closed gate (the earlier solve passed gdm's check) leaves x at
    x0 and writes stats [0, 0, 0, 0]; an open one solves exactly as the
    ungated launch does."""
    A = _planes(mass16["mass"], mass16["lay"])
    P = _planes(mass16["schwarz"], mass16["lay"])
    b = mass16["b"]
    x0 = torch.full_like(b, 0.25)
    args = (A, None, None, 200, 1e-8, 1e-30)
    x_ref, s_ref = resident.resident_cg_plain(b, x0, *args, P=P)
    passed = torch.tensor([5e-4, 5.0, 1.0, 1.0])   # 5e-4 <= 10 * 1e-4
    failed = torch.tensor([2e-3, 5.0, 1.0, 1.0])   # 2e-3 > 10 * 1e-4
    for stats, opened in ((passed, False), (failed, True)):
        gate = resident.Gate(stats, 10.0, 1e-4, 1e-12)
        assert gate.opened() is opened
        x, s = resident.resident_cg(b, x0, *args, P=P, gate=gate)
        if opened:
            assert torch.equal(x, x_ref) and torch.equal(s, s_ref)
            assert resident.read_stats(s)["ran"] is True
        else:
            assert torch.equal(x, x0) and x is not x0
            assert s.tolist() == [0.0, 0.0, 0.0, 0.0]
            assert resident.read_stats(s)["ran"] is False


def test_wrapper_refuses_mixed_modes(mass16):
    A = _planes(mass16["mass"], mass16["lay"])
    b = mass16["b"]
    with pytest.raises(ValueError, match="not both"):
        resident.resident_cg(b, b, A, A, A, P=A)
    with pytest.raises(ValueError, match="gate"):
        resident.resident_cg(b, b, A, P=A, gate=resident.Gate(
            torch.zeros(3), 10.0, 1e-6, 1e-12))
    with pytest.raises(ValueError, match="not both"):
        resident.make_resident_cg(mass16["mass"], mass16["mass"],
                                  mass16["mass"], P=mass16["mass"],
                                  device="cpu")


def test_make_resident_cg_one_band(mass16):
    """``make_resident_cg(..., P=band)``: the one-band solve, with its
    gate by keyword."""
    mass, lay = mass16["mass"], mass16["lay"]
    solve, pad, unpad, shape = resident.make_resident_cg(
        mass, max_iter=300, rel_tol=1e-9, abs_tol=1e-30, dtype=F64,
        device="cpu", layout=lay, P=mass16["schwarz"])
    assert shape == lay.shape
    x, s = solve(mass16["b"])
    xr, sr = resident.resident_cg_plain(
        mass16["b"], torch.zeros_like(mass16["b"]), _planes(mass, lay),
        None, None, 300, 1e-9, 1e-30, P=_planes(mass16["schwarz"], lay))
    assert torch.equal(x, xr) and torch.equal(s, sr)
    closed = resident.Gate(s, 10.0, 1e-6, 1e-12)
    xg, sg = solve(mass16["b"], gate=closed)
    assert not bool(xg.any()) and not bool(sg.any())


@pytest.mark.parametrize("dt", [0.01815, 0.0045])
def test_heat_impl_band_is_its_system(mass16, dt):
    """The band of M + dt S (heat-impl's K2 operator on the card) applied
    to v equals the matrix-free system_apply(v, dt) within 1e-12 of
    max|y|, inactive rows included."""
    p = wave.make_preset("heat", 2)
    p.n_subdivisions_1D = 16
    prob = wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64)
    st = prob._heat_system_band(dt)
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(
        prob.grid.n_nodes), dtype=F64)
    y_mf = prob._heat_system_apply(v, dt)
    y_band = st.apply(v)
    scale = y_mf.abs().max().item()
    assert (y_band - y_mf).abs().max().item() <= 1e-12 * scale
    inactive = torch.as_tensor(prob.op_in.inactive)
    assert bool(inactive.any())
    assert torch.allclose(y_band[inactive], y_mf[inactive], rtol=0,
                          atol=1e-12 * scale)


def _verified(mass16, **kw):
    op = mass16["prob"].op_in
    return fsai.verified_fsai_solver(
        mass16["mass"], windows=op.w_cut, max_iter=300, rel_tol=1e-9,
        abs_tol=1e-30, device="cpu", dtype=F64, **kw)


def test_device_form_on_the_resident_route(mass16):
    """"resident-verified": the device form's answer is the resident
    FSAI solve's, its fallback row zero (the gate closed), no fallback
    counted; a crippled resident path (one iteration) opens the gate:
    the answer is K2's one-band Schwarz CG from zero, and the fallback
    counts on the device and folds into ``fallback_count``."""
    b = mass16["b"]
    vs = _verified(mass16)
    assert vs.path == "resident-verified"
    x, stats = vs.solve_padded_device(b)
    assert stats.shape == (2, len(resident.STATS))
    xr, sr = vs._resident(b)
    assert torch.equal(x, xr) and torch.equal(stats[0], sr)
    assert not bool(stats[1].any())
    info = vs.device_info(stats)
    assert info["fallback"] is False and info["fallback_iterations"] == 0
    assert info["iterations"] == resident.read_stats(sr)["iterations"]
    assert vs.fallback_count == 0

    bad = _verified(mass16, probe=False, resident_max_iter=1)
    x, stats = bad.solve_padded_device(b)
    info = bad.device_info(stats)
    assert info["iterations"] == 1 and info["fallback"] is True
    A = _planes(mass16["mass"], vs.layout)
    P = _planes(mass16["schwarz"], vs.layout)
    xs, ss = resident.resident_cg_plain(b, torch.zeros_like(b), A, None,
                                        None, 300, 1e-9, 1e-30, P=P)
    assert torch.equal(x, xs) and torch.equal(stats[1], ss)
    assert bad.tally[1, 1].item() == 1.0
    bad.solve_padded_device(b)
    assert bad.fallback_count == 2 and not bool(bad.tally.any())
    bad.fold_tally([0, 0, 0, 3])
    assert bad.fallback_count == 5


def test_device_form_on_the_streamed_route(mass16):
    """"streamed" (the probe missed): one one-band launch from x0, the
    fallback row zero; the flat form pads and unpads; a solver without
    a layout has no device form."""
    b = mass16["b"]
    vs = _verified(mass16, resident_max_iter=1)
    assert vs.path == "streamed"
    x0 = torch.full_like(b, 0.5)
    x, stats = vs.solve_padded_device(b, x0)
    A = _planes(mass16["mass"], vs.layout)
    P = _planes(mass16["schwarz"], vs.layout)
    xs, ss = resident.resident_cg_plain(b, x0, A, None, None, 300, 1e-9,
                                        1e-30, P=P)
    assert torch.equal(x, xs) and torch.equal(stats[0], ss)
    assert not bool(stats[1].any()) and vs.fallback_count == 0
    lay = vs.layout
    xf, _ = vs.solve_device(lay.unpad(b), lay.unpad(x0))
    assert torch.equal(xf, lay.unpad(x))
    host = fsai.fsai_cg_solver(mass16["mass"], 50, 1e-8, 1e-30,
                               device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="device form"):
        host.solve_padded_device(b)


@pytest.mark.parametrize("route", ["resident-verified", "fallback",
                                   "streamed"])
def test_tally_counts_the_solves_stats(mass16, route):
    """The device form's tally, folded by a chunk's one read
    (``scan.scan_chunk``), gives the host counters the sums of the stats
    its solves returned: the solves, the fallbacks, and the iterations
    of K2's one-band and FSAI launches apart (row 0 is the one-band CG
    on "streamed", the FSAI solve behind which row 1's one-band CG is
    gated on "resident-verified"); the tally is zero after the read."""
    kw = {"resident-verified": {},
          "fallback": {"probe": False, "resident_max_iter": 1},
          "streamed": {"resident_max_iter": 1}}[route]
    vs = _verified(mass16, **kw)
    assert vs.path == ("streamed" if route == "streamed"
                       else "resident-verified")
    b, kept = mass16["b"], []

    def step(y, t, dt):
        x, stats = vs.solve_padded_device(b * (1.0 + t), y)
        kept.append(stats)
        return x

    def errs(y, t):
        return y.abs().max().reshape(1, 1)

    before = profiling.counters()
    ts = np.arange(3) * 0.5
    scan.scan_chunk(step, errs, torch.zeros_like(b), ts, np.full(3, 0.5),
                    (vs,))
    got = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    st = torch.stack(kept).double()
    it, ran = resident.STATS.index("iterations"), resident.STATS.index("ran")
    kinds = vs._device_form().kinds
    want = {"solves": 3, "fallbacks": int(st[:, 1, ran].sum()),
            "k2.band_iterations": 0, "k2.fsai_iterations": 0}
    for row, kind in enumerate(kinds):
        want[f"k2.{kind}_iterations"] += int(st[:, row, it].sum())
    assert got == want
    # the gate stays closed behind a resident solve that passed
    assert (want["k2.band_iterations"] > 0) == (route != "resident-verified")
    assert (want["fallbacks"] > 0) == (route == "fallback")
    assert not bool(vs.tally.any())
    assert vs.fallback_count == want["fallbacks"]
