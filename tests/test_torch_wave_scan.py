"""The port's ``WaveProblem.run_scan`` against live gdm under x64 and
against its own ``run()``, in float64 on the CPU.

gdm's ``run_scan`` (gdm/problems/wave.py:659-821) runs the whole time
loop as chunked ``lax.scan`` programs and fills ``rows`` in
``postprocess``'s format; the port's runs the same bodies in chunks on
the run's device.  On the CPU both take gdm's CPU branch (Jacobi CG to
the presets' rel 1e-14; heat-impl warm-started from u), so:

- gdm's five 1D cases of tests/test_wave_scan.py (20 cells, 5 steps):
  every row within 1e-10 of gdm's ``run_scan`` in the scaled measure of
  tests/test_torch_wave_app.py (max |port - gdm| / max |gdm| per column),
  and within rtol 1e-10 of the port's own ``run()`` (gdm's test);
- 2D ``wave``, ``heat-rk`` and ``heat-impl`` at 16 cells a side for 3
  steps, within 1e-10 of gdm's ``run_scan`` and of the port's ``run()``
  (heat-impl 1e-9: gdm's own ``run()`` and ``run_scan()`` differ by
  6.5e-10 there, a cold against a warm start);
- chunks of 2 and of 128 give the same rows; heat-impl's short last
  step agrees with ``run()`` (gdm's test_scan_heat_impl_final_short_step);
- "poisson" delegates to ``run()``; per-step VTU output raises;
- the presets' data functions on tensors equal their numpy values
  within 1e-14, ``error_norms_tensor`` equals ``error_norms``, and
  ``run_scan``'s refusal of a data function that gives no tensor.

The card's route (K2's one-band mode, the verified solver's device
form) is rehearsed here on the plain twins, with the route forced; two
such calls while recording give each call's spans, the mass solver
built anew in each, the tally's count of every solve, and one routing
record a region.
"""

import numpy as np
import pytest
import torch

from gdm.problems import wave as gwave

from gdm_torch import profiling
from gdm_torch.cut import stencil
from gdm_torch.problems import wave

F64 = torch.float64
TOL = 1e-10
CASES = [("heat-rk", False), ("heat-impl", False), ("wave", False),
         ("heat-composite", True), ("wave-composite", True)]


def _scaled_dev(port_rows, gdm_rows):
    m = np.asarray(port_rows, np.float64)
    g = np.asarray(gdm_rows, np.float64)
    assert m.shape == g.shape
    assert np.array_equal(m[:, 0], g[:, 0])
    assert np.abs(m[:, 1] - g[:, 1]).max() <= 1e-12
    return (np.abs(m[:, 2:] - g[:, 2:]).max(axis=0)
            / np.abs(g[:, 2:]).max(axis=0))


def _rows_close(a, b, rtol=1e-10):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        np.testing.assert_allclose(ra[1:], rb[1:], rtol=rtol, atol=1e-16)


def _shorten(params, n_steps):
    dt = params.cfl * ((params.geometry_right - params.geometry_left)
                       / params.n_subdivisions_1D) ** params.cfl_pow
    params.end_t = params.start_t + n_steps * dt


def _params(module, name, dim, cells, steps):
    p = module.make_preset(name, dim)
    p.n_subdivisions_1D = cells
    _shorten(p, steps)
    return p


def _port(p):
    return wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64)


@pytest.mark.parametrize("name,composite", CASES, ids=[c[0] for c in CASES])
def test_1d_rows_match_gdm_and_run(name, composite):
    prob = _port(_params(wave, name, 1, 20, 5))
    rows = prob.run_scan(chunk=3)      # a chunk boundary inside the run
    grows = gwave.WaveProblem(_params(gwave, name, 1, 20, 5),
                              verbose=False).run_scan(chunk=3)
    own = _port(_params(wave, name, 1, 20, 5)).run()
    for slot in range(2 if composite else 1):
        assert len(rows[slot]) == 6
        assert all(isinstance(x, float) for r in rows[slot] for x in r[1:])
        assert (_scaled_dev(rows[slot], grows[slot]) <= TOL).all()
        _rows_close(rows[slot], own[slot])
    if not composite:
        assert rows[1] == []
    final = prob.final_solution
    finals = final if composite else (final,)
    assert all(f.dtype == F64 and f.shape == (prob.grid.n_nodes,)
               for f in finals)


@pytest.mark.parametrize("name", ["wave", "heat-rk", "heat-impl"])
def test_2d_rows_match_gdm_and_run(name):
    rows = _port(_params(wave, name, 2, 16, 3)).run_scan(chunk=2)[0]
    grows = gwave.WaveProblem(_params(gwave, name, 2, 16, 3),
                              verbose=False).run_scan(chunk=2)[0]
    assert len(rows) == 4
    assert (_scaled_dev(rows, grows) <= TOL).all()
    # heat-impl: run() cold-starts each solve, run_scan warm-starts it
    # (gdm's bodies), both to rel 1e-14 of their own ||r0||; gdm's own
    # run() and run_scan() rows differ by 6.5e-10 here
    _rows_close(rows, _port(_params(wave, name, 2, 16, 3)).run()[0],
                rtol=1e-9 if name == "heat-impl" else 1e-10)


def test_chunks_give_equal_rows():
    p = _params(wave, "heat-rk", 1, 20, 5)
    a, b = _port(p), _port(p)
    assert a.run_scan(chunk=2) == b.run_scan(chunk=128)
    assert torch.equal(a.final_solution, b.final_solution)


def test_heat_impl_final_short_step():
    """The shortened last step gets its own step size, as in run()."""
    p = wave.make_preset("heat-impl", 1)
    p.n_subdivisions_1D = 20
    dt = p.cfl * (2.42 / 20)
    p.end_t = p.start_t + 3.5 * dt
    rows = _port(p).run_scan()[0]
    assert len(rows) == 5 and abs(rows[-1][1] - p.end_t) <= 1e-12
    _rows_close(_port(p).run()[0], rows)


def test_poisson_delegates_and_vtu_raises(tmp_path):
    p = wave.make_preset("step85", 1)
    p.n_subdivisions_1D = 20
    scan, run = _port(p), _port(p)
    assert scan.run_scan() == run.run()
    assert torch.equal(scan.final_solution, run.final_solution)
    p = _params(wave, "wave", 1, 20, 2)
    p.output_vtu_dir = str(tmp_path)
    with pytest.raises(ValueError, match="per-step VTU output requires run"):
        _port(p).run_scan()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("name", ["step85", "heat", "heat-rk", "wave",
                                  "heat-composite", "wave-composite"])
def test_data_functions_on_tensors(name, dim):
    """Each preset's data function on tensor points (t a Python float)
    gives a tensor equal to its numpy value within 1e-14 (relative; and
    absolute near its zeros)."""
    p = wave.make_preset(name, dim)
    rng = np.random.default_rng(dim)
    pts = rng.uniform(-1.71, 1.71, size=(40, 9, dim))
    for field in ("function_domain_dbc", "function_interface_dbc",
                  "function_rhs", "exact_solution"):
        fn = getattr(p, field)
        if fn is None:
            continue
        for t in (0.0, 0.3, 1.7):
            a = fn(torch.as_tensor(pts), t)
            b = np.asarray(fn(pts, t), np.float64)
            assert isinstance(a, torch.Tensor) and a.dtype == F64
            assert a.shape == b.shape == (40, 9), field
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-14,
                                       atol=1e-14, err_msg=field)


def test_bessel_j0_is_scipys():
    import scipy.special

    from gdm_torch import special

    x = np.linspace(-40.0, 40.0, 20001)
    np.testing.assert_allclose(special.bessel_j0(torch.as_tensor(x)).numpy(),
                               scipy.special.j0(x), rtol=0, atol=3e-15)


def test_error_norms_tensor_form():
    prob = _port(_params(wave, "wave", 2, 16, 1))
    op, g = prob.op_in, prob.params.exact_solution
    u = prob.interpolate_exact(0.2) + 1e-3 * torch.as_tensor(
        np.random.default_rng(4).standard_normal(prob.grid.n_nodes))
    e = op.error_norms_tensor(u, g, 0.4)
    assert e.shape == (3,) and e.dtype == F64
    assert tuple(e.tolist()) == op.error_norms(u, g, 0.4)


def test_run_scan_refuses_a_host_data_function():
    """A data function that gives no tensor on the run's device would put
    a host evaluation into every stage: the check names it."""
    p = _params(wave, "wave", 1, 20, 2)
    g = p.exact_solution
    p.exact_solution = lambda pts, t: np.asarray(g(np.asarray(pts), t))
    prob = _port(p)
    with pytest.raises(ValueError, match="params.exact_solution"):
        prob._check_data_functions()
    _port(_params(wave, "wave", 1, 20, 2))._check_data_functions()


@pytest.mark.parametrize("name", ["wave", "heat", "wave-composite"])
def test_card_route_rehearsed_on_the_twins(monkeypatch, name):
    """The card's 2D route, forced here onto the plain twins: K2's
    one-band mode on the band of M + dt S with its Jacobi band (heat),
    the verified solver's device form for the masses (its resident FSAI
    path clamped to rel 1e-6, as in gdm).  Float64 rows within 1e-5 of
    the CPU route's, no fallback."""
    p = _params(wave, name, 2, 16, 3)
    ref = _port(p).run_scan(chunk=2)
    monkeypatch.setattr(stencil, "kernel_route",
                        lambda grid, device: grid.dim == 2)
    prob = _port(p)
    rows = prob.run_scan(chunk=2)
    for slot in (0, 1) if p.composite else (0,):
        assert len(rows[slot]) == 4
        assert (_scaled_dev(rows[slot], ref[slot]) <= 1e-5).all()
    if name == "heat":
        assert list(prob.heat_bands) == [float(prob._schedule()[1][0])]
    else:
        solvers = getattr(prob, "mass_solvers", (prob.mass_solver,))
        assert all(v.path == "resident-verified" and v.fallback_count == 0
                   for v in solvers)


def test_rebuilt_solvers_spans_and_tally(monkeypatch):
    """The card's 2D route rehearsed on the twins, two run_scan calls
    while recording: each call's ``scan.prepare`` builds the mass solver
    again (``setup.mass_solver`` with ``.assemble``, ``.fsai``,
    ``.schwarz``, ``.probe`` and ``setup.device_form``), the chunks'
    reads count every solve (4 a step), and one routing record and one
    solver sample a region stay."""
    p = _params(wave, "wave", 2, 16, 3)
    monkeypatch.setattr(stencil, "kernel_route",
                        lambda grid, device: grid.dim == 2)
    prob = _port(p)
    profiling.reset()
    before = profiling.counters()
    with profiling.recording():
        prob.run_scan(chunk=2)
        prob.run_scan(chunk=2)
    sp = profiling.spans()
    calls = [i for i, s in enumerate(sp) if s.name == "scan.call"]
    assert len(calls) == 2
    for c in calls:
        assert sp[c].attrs == {"steps": 3, "chunk": 2}
        kids = [s.name for s in sp if s.parent == c]
        assert kids == ["scan.prepare", "scan.chunk", "scan.chunk",
                        "scan.rows"]
        prepare = next(i for i, s in enumerate(sp)
                       if s.parent == c and s.name == "scan.prepare")
        (build,) = [i for i, s in enumerate(sp) if s.parent == prepare
                    and s.name == "setup.mass_solver"]
        assert sp[build].attrs == {"region": "inside"}
        assert [s.name for s in sp if s.parent == build] == [
            "setup.mass_solver.assemble", "setup.mass_solver.fsai",
            "setup.mass_solver.schwarz", "setup.mass_solver.probe",
            "setup.device_form"]
    got = profiling.counters()
    assert got["solves"] - before.get("solves", 0) == 2 * 3 * 4
    assert got["fallbacks"] == before.get("fallbacks", 0)
    assert got["k2.fsai_iterations"] > before.get("k2.fsai_iterations", 0)
    assert [m["loc"] for m in prob._solver_meta] == ["inside"]
    assert prob._solver_meta[0]["path"] == prob.mass_solver.path
    assert list(prob._solver_sample) == [0]
