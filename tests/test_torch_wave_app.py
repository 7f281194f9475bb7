"""The port's wave application (gdm_torch.problems.wave) against live gdm
under x64, in float64 on the CPU.

The explicit path, ``WaveProblem(make_preset(...)).run()``, gives the
reference's error rows (counter, t, L2, L1, Linf).  On the CPU both gdm
and the port solve the mass with Jacobi CG over the band apply to the
presets' rel 1e-14 (gdm's CPU branch), so every row agrees within 1e-10
in the scaled measure of tests/test_tpu_goldens_artifact.py:
max |port - gdm| / max |gdm| per column, over L2, L1 and Linf.

- ``wave`` 1D: all 112 rows; ``heat-rk`` 1D: all 821 rows.
- ``wave`` 2D: cut to end_t = 0.2, its first 13 rows (12 steps): the
  full 112 rows take about 26 s in gdm and about 2 minutes in the port's
  eager CPU loop here, past this file's share of the test budget.

Every preset's scalar parameters equal gdm's and its data functions
(numpy here, jnp in gdm) agree with gdm's on sample points at several t.
The option that is not ported (``mesh=``) raises NotImplementedError
naming what it waits for; a deformed mapping (1D wave) gives gdm's
rows.  The other simulation
types and options are held in tests/test_torch_wave_family.py,
tests/test_torch_cut_multigrid.py and tests/test_torch_wave_io.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdm.problems import wave as gwave

from gdm_torch import timestepping
from gdm_torch.problems import wave

F64 = torch.float64
TOL = 1e-10
PRESETS = ["step85", "heat", "heat-rk", "heat-impl", "heat-composite",
           "wave", "wave-composite"]
FUNCTIONS = ("function_domain_dbc", "function_interface_dbc",
             "function_rhs", "exact_solution", "level_set_function")


def _scaled_dev(port_rows, gdm_rows):
    m = np.asarray(port_rows, np.float64)
    g = np.asarray(gdm_rows, np.float64)
    assert m.shape == g.shape
    assert np.array_equal(m[:, 0], g[:, 0])
    assert np.abs(m[:, 1] - g[:, 1]).max() <= 1e-12
    return (np.abs(m[:, 2:] - g[:, 2:]).max(axis=0)
            / np.abs(g[:, 2:]).max(axis=0))


def _rows(name, dim, end_t=None):
    pt, pg = wave.make_preset(name, dim), gwave.make_preset(name, dim)
    if end_t is not None:
        pt.end_t = pg.end_t = end_t
    port = wave.WaveProblem(pt, verbose=False, device="cpu", dtype=F64)
    rows = port.run()
    assert rows[1] == []
    return port, rows[0], gwave.WaveProblem(pg, verbose=False).run()[0]


@pytest.mark.parametrize("name,dim,end_t,n_rows", [
    ("wave", 1, None, 112), ("heat-rk", 1, None, 821), ("wave", 2, 0.2, 13)],
    ids=["wave-1d", "heat-rk-1d", "wave-2d-cut"])
def test_rows_match_gdm(name, dim, end_t, n_rows):
    port, rows, grows = _rows(name, dim, end_t)
    assert len(rows) == len(grows) == n_rows
    assert all(isinstance(x, float) for row in rows for x in row[1:])
    assert (_scaled_dev(rows, grows) <= TOL).all()
    # the CPU run takes gdm's CPU branch: Jacobi CG, no verified solver
    assert port._solver_meta == [] and not hasattr(port.mass_solver, "path")
    final = port.final_solution
    assert final.dtype == F64 and final.shape == (port.grid.n_nodes,)
    assert bool(torch.isfinite(final).all())


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("name", PRESETS)
def test_presets_carry_gdms_parameters(name, dim):
    pt, pg = wave.make_preset(name, dim), gwave.make_preset(name, dim)
    for field in dataclasses.fields(wave.WaveParams):
        a, b = getattr(pt, field.name), getattr(pg, field.name)
        if field.name in FUNCTIONS:
            assert (a is None) == (b is None), field.name
        elif not callable(b):
            assert a == b, field.name
    assert [f.name for f in dataclasses.fields(wave.WaveParams)] == [
        f.name for f in dataclasses.fields(gwave.WaveParams)]
    rng = np.random.default_rng(dim)
    pts = rng.uniform(-1.21, 1.21, size=(7, 5, dim))
    for field in FUNCTIONS[:-1]:
        fa, fb = getattr(pt, field), getattr(pg, field)
        if fa is None:
            continue
        for t in (0.0, 0.3, 1.7):
            a = np.asarray(fa(pts, t), np.float64)
            b = np.asarray(fb(pts, t), np.float64)
            assert a.shape == b.shape == (7, 5), field
            np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-15,
                                       err_msg=field)
    mesh = [pts[..., d] for d in range(dim)]
    np.testing.assert_array_equal(pt.level_set_function(mesh),
                                  pg.level_set_function(mesh))


def test_exact_time_derivative():
    g = wave.make_preset("wave", 1).exact_solution
    gg = gwave.make_preset("wave", 1).exact_solution
    pts = np.linspace(-1.0, 1.0, 9)[:, None]
    np.testing.assert_allclose(
        wave._exact_time_derivative(g)(pts, 0.4),
        np.asarray(gwave._exact_time_derivative(gg)(pts, 0.4)),
        rtol=1e-9, atol=1e-9)


def test_schedule_is_gdms():
    pt, pg = wave.make_preset("wave", 1), gwave.make_preset("wave", 1)
    ts, dts = wave.WaveProblem(pt, verbose=False, device="cpu",
                               dtype=F64)._schedule()
    gts, gdts = gwave.WaveProblem(pg, verbose=False)._schedule()
    assert len(ts) == len(gts) == 111
    np.testing.assert_array_equal(ts, np.asarray(gts))
    np.testing.assert_array_equal(dts, np.asarray(gdts))


def test_rk_step_takes_a_tensor():
    """heat-rk's state is one tensor, wave-rk's a tuple: one step of
    each form agrees."""
    y = torch.as_tensor(np.random.default_rng(3).standard_normal(5))

    def f(t, u):
        return -u * (1.0 + t)

    one = timestepping.rk_step(f, 0.2, 0.1, y)
    (tup,) = timestepping.rk_step(lambda t, yy: (f(t, yy[0]),), 0.2, 0.1,
                                  (y,))
    assert isinstance(one, torch.Tensor) and one.equal(tup)


def test_verbose_rows_print_as_gdms(capsys):
    p = wave.make_preset("wave", 1)
    p.end_t = 0.05
    rows = wave.WaveProblem(p, device="cpu", dtype=F64).run()[0]
    out = capsys.readouterr().out.splitlines()
    assert out == ["%5d %8.5f %14.8e %14.8e %14.8e" % r for r in rows]


def _problem(name="wave", dim=1, **changes):
    p = wave.make_preset(name, dim)
    for k, v in changes.items():
        setattr(p, k, v)
    return wave.WaveProblem(p, verbose=False, device="cpu", dtype=F64)


def test_unknown_simulation_type_raises_value_error():
    with pytest.raises(ValueError, match="nope"):
        _problem(simulation_type="nope").run()


@pytest.mark.parametrize("call,match", [
    (lambda: wave.WaveProblem(wave.make_preset("wave", 1), verbose=False,
                              mesh=object(), device="cpu"), "dist/cut.py"),
], ids=["mesh"])
def test_unported_options_raise(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()


def _squeeze(pts):
    pts = np.asarray(pts, dtype=np.float64)
    return pts + 0.04 * np.sin(np.pi * pts / 1.21)


def test_deformed_wave_rows_match_gdm():
    """A deformed mapping runs (gdm_torch.deform re-metrics the cut
    tables): the wave preset in 1D under a vertex map, to t = 0.5, every
    row within 1e-10 of gdm's, and apart from the undeformed rows."""
    pt, pg = wave.make_preset("wave", 1), gwave.make_preset("wave", 1)
    for p in (pt, pg):
        p.end_t = 0.5
        p.mapping_q_cache_function = _squeeze
    rows = wave.WaveProblem(pt, verbose=False, device="cpu",
                            dtype=F64).run()[0]
    grows = gwave.WaveProblem(pg, verbose=False).run()[0]
    assert len(rows) == len(grows) > 20
    assert (_scaled_dev(rows, grows) <= TOL).all()
    plain = _problem(end_t=0.5).run()[0]
    assert np.abs(np.asarray(rows)[:, 2] - np.asarray(plain)[:, 2]).max() \
        > 1e-6


def test_defaults_to_the_card():
    import inspect

    sig = inspect.signature(wave.WaveProblem.__init__).parameters
    assert sig["device"].default == "cuda"
    assert sig["dtype"].default == torch.float32
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wave.WaveProblem(wave.make_preset("wave", 1), verbose=False)


def test_dtype_in_gdms_forms():
    for dtype in (np.float64, "float64"):
        assert wave.WaveProblem(wave.make_preset("wave", 1), verbose=False,
                                device="cpu", dtype=dtype).dtype == F64
    with pytest.raises(ValueError, match="dtype"):
        wave.WaveProblem(wave.make_preset("wave", 1), verbose=False,
                         device="cpu", dtype="cpu")


def test_solver_sample_rows_on_the_verified_route():
    """With print_solver_info, each row records one sample of the
    verified solver (the card's 2D route registers it; here it is
    registered on a CPU verified solver): gdm's flat-vector
    solve_with_info of M u."""
    from gdm_torch.cut.fsai import verified_fsai_solver
    from gdm_torch.cut.stencil import assemble_stencil

    prob = _problem("wave", 2, end_t=0.02, print_solver_info=True)
    op = prob.op_in
    gm = prob.params.ghost_parameter_M
    vs = verified_fsai_solver(assemble_stencil(op, "mass", gm),
                              windows=op.w_cut, max_iter=60, rel_tol=1e-5,
                              device="cpu", dtype=F64)
    prob._register_solver_sample(op, vs, gm)
    u = prob.interpolate_exact(0.0)
    prob.postprocess(0.0, u)
    (counter, it, fb, itf), = prob.solver_rows[0]
    assert counter == 0 and it > 0 and fb is False and itf == 0
