"""The port's cut advection family against live gdm under x64, in
float64 on the CPU.

- ``AdvectionOperators``: ``compute_rhs`` (weak, with boundary values;
  composite, against the other block), ``compute_rhs_strong`` and the
  surface error norms against gdm's on both regions of the composite
  case's geometry cut to 12 cells a side, at p = 3 and p = 5, within
  1e-12 relative (of max |gdm|); the surface norms' tensor form; an
  uncut problem (no cut cells: zero surface norms, as gdm);
- ``AdvectionProblem.run()`` rows against gdm's ``run()`` (rtol 1e-10,
  atol 1e-14, as tests/test_advection_scan.py) on
  ``convergence_case(3, 10, 0.4, 0.0, 5.0)`` for 3 steps, the composite
  case at 12 cells a side and p = 3 for 4 steps, and the strong-BC
  advection_02 case at n = 10 (also against its pinned values,
  tests/test_advection02.py);
- the final row of ``convergence_case(3, 40, 0.4, 0.0, 1.0)`` against
  ``tests/data/cpu_oracle_rows.json["adv_conv_p3_40_rot5"]`` with gdm's
  ``_check`` tolerances (tests/test_advection_app.py);
- the cases' data functions on tensors against their numpy values, the
  constructor's refusal of a ``mesh=`` that is not the port's
  ``dist.mesh.Mesh`` (TypeError; the mesh runs are held in
  tests/test_torch_dist_cut.py) and both CLIs on the CPU;
- the verified solver's resident tolerance floor by dtype on a probe.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gdm.problems import advection as gadv

from gdm_torch.problems import advection as adv

F64 = torch.float64
HERE = os.path.dirname(__file__)
PHI = np.pi / 36 * 5
XS = 0.2001
A = (2 * np.cos(PHI), 2 * np.sin(PHI))


def _mini(module, p=3, steps=4):
    params = module.composite_app_case()
    params.n_subdivisions_1D = 12
    params.fe_degree = p
    params.end_t = steps * (2.0 / 12) * 0.2 / 4.0
    return params


def _conv(module, steps=3):
    params = module.convergence_case(3, 10, 0.4, 0.0, 5.0)
    params.end_t = steps * (1.0 / 10) * 0.4 / 2.0
    return params


def _sin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else jnp.sin(x)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else jnp.cos(x)


def _x_hat(pts, t):
    return np.cos(PHI) * (pts[..., 0] - t * A[0] - XS) + np.sin(PHI) * (
        pts[..., 1] - t * A[1])


def strong_exact(pts, t):
    return _sin(np.sqrt(2) * np.pi * _x_hat(pts, t) / (1 - XS))


def strong_exact_der(pts, t):
    return (_cos(np.sqrt(2) * np.pi * _x_hat(pts, t) / (1 - XS))
            * (np.sqrt(2) * np.pi / (1 - XS))
            * (np.cos(PHI) * (-A[0]) + np.sin(PHI) * (-A[1])))


def strong_params(module, n=10, end_t=0.1, strong=True):
    """tests/test_advection02.py's uncut advection_02 configuration (a
    level set of -1 everywhere: no cut cells)."""
    return module.AdvectionParams(
        fe_degree=3, n_subdivisions_1D=n, geometry_left=0.0,
        geometry_right=1.0, ghost_parameter_M=0.0, ghost_parameter_A=0.0,
        start_t=0.0, end_t=end_t, cfl=0.1, max_val=2.0, advection=A,
        exact_solution=strong_exact, exact_solution_der=strong_exact_der,
        level_set_fe_degree=1,
        level_set_function=lambda m: np.full_like(np.asarray(m[0]), -1.0),
        dim=2, strong_bc=strong)


def _port(params):
    return adv.AdvectionProblem(params, device="cpu", dtype=F64)


def rows_close(a, b, rtol=1e-10):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        np.testing.assert_allclose(ra[1:], rb[1:], rtol=rtol, atol=1e-14)


def _rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("p", [3, 5])
def test_operators_match_gdm(p):
    """compute_rhs (weak with boundary values, composite against the
    other block), compute_rhs_strong and the surface norms on both
    regions: within 1e-12 of gdm's."""
    g = gadv.AdvectionProblem(_mini(gadv, p))
    m = _port(_mini(adv, p))
    rng = np.random.default_rng(p)
    n = m.grid.n_nodes
    assert g.grid.n_nodes == n
    u, w = rng.standard_normal(n), rng.standard_normal(n)
    for gadvop, madvop in ((g.adv_in, m.adv_in), (g.adv_out, m.adv_out)):
        mo = madvop.ops
        assert len(mo.cut_ids) and len(mo.b_win)
        bs = rng.standard_normal(mo.surf_w.shape)
        bb = rng.standard_normal(mo.b_w.shape)
        ut, wt = torch.as_tensor(u), torch.as_tensor(w)
        pairs = [
            (gadvop.compute_rhs(jnp.asarray(u), jnp.asarray(bs),
                                jnp.asarray(bb), 0.5),
             madvop.compute_rhs(ut, torch.as_tensor(bs), bb, 0.5)),
            (gadvop.compute_rhs(jnp.asarray(u), None, jnp.asarray(bb), 0.5,
                                u_other=jnp.asarray(w)),
             madvop.compute_rhs(ut, None, torch.as_tensor(bb), 0.5,
                                u_other=wt)),
            (gadvop.compute_rhs_strong(jnp.asarray(u), 0.5),
             madvop.compute_rhs_strong(ut, 0.5)),
        ]
        for ref, got in pairs:
            assert got.dtype == F64 and got.shape == (n,)
            assert _rel(got.numpy(), ref) <= 1e-12
        ue = m.interpolate_exact(0.05) + 1e-3 * wt
        ref = gadvop.surface_error_norms(jnp.asarray(ue.numpy()),
                                         g.params.exact_solution, 0.05)
        got = madvop.surface_error_norms(ue, m.params.exact_solution, 0.05)
        assert all(isinstance(x, float) for x in got)
        np.testing.assert_allclose(got, [float(x) for x in ref], rtol=1e-12)
        e = madvop.surface_error_norms_tensor(ue, m.params.exact_solution,
                                              0.05)
        assert e.shape == (3,) and tuple(e.tolist()) == got


def test_uncut_problem_operators():
    """No cut cells (the advection_02 configuration): zero surface norms
    as gdm's, and the RHS forms within 1e-12 of gdm's."""
    g = gadv.AdvectionProblem(strong_params(gadv, 6))
    m = _port(strong_params(adv, 6))
    assert len(m.op_in.cut_ids) == 0 and m.op_in.w_cut.shape[0] == 0
    u = np.random.default_rng(0).standard_normal(m.grid.n_nodes)
    ut = torch.as_tensor(u)
    bb = np.random.default_rng(1).standard_normal(m.op_in.b_w.shape)
    assert m.adv_in.surface_error_norms(ut, strong_exact, 0.0) == (0.0,) * 3
    assert _rel(m.adv_in.compute_rhs(ut, np.zeros((0, 1)), bb, 0.0).numpy(),
                g.adv_in.compute_rhs(jnp.asarray(u), jnp.zeros((0, 1)),
                                     jnp.asarray(bb), 0.0)) <= 1e-12
    assert _rel(m.adv_in.compute_rhs_strong(ut).numpy(),
                g.adv_in.compute_rhs_strong(jnp.asarray(u))) <= 1e-12


@pytest.mark.parametrize("case", ["convergence", "composite", "strong"])
def test_run_matches_gdm(case):
    make = {"convergence": _conv, "composite": _mini,
            "strong": strong_params}[case]
    ref = gadv.AdvectionProblem(make(gadv)).run()
    prob = _port(make(adv))
    rows = prob.run()
    for slot in (0, 1):
        rows_close(rows[slot], ref[slot])
    assert len(rows[0]) == {"convergence": 4, "composite": 5,
                            "strong": 21}[case]
    assert len(rows[1]) == (len(rows[0]) if case == "composite" else 0)
    if case == "strong":
        # tests/test_advection02.py's pins of the strong path
        np.testing.assert_allclose(rows[0][0][2], 9.3086325796e-4, rtol=1e-3)
        np.testing.assert_allclose(rows[0][-1][2], 2.9849417041987e-3,
                                   rtol=1e-3)
    finals = (prob.u0, prob.u1) if case == "composite" else (prob.u,)
    assert all(f.dtype == F64 and f.shape == (prob.grid.n_nodes,)
               for f in finals)


def _check(got, golden, rtol_vol=2e-4, rtol_surf=2e-3):
    """gdm's tolerances (tests/test_advection_app.py::_check)."""
    np.testing.assert_allclose(
        [got[i] for i in (0, 1)], [golden[i] for i in (0, 1)],
        rtol=rtol_vol)
    np.testing.assert_allclose(
        [got[i] for i in (3, 4)], [golden[i] for i in (3, 4)],
        rtol=rtol_surf)
    np.testing.assert_allclose(
        [got[i] for i in (2, 5)], [golden[i] for i in (2, 5)], rtol=1e-2)


def test_convergence_40_final_row_against_the_oracle():
    with open(os.path.join(HERE, "data", "cpu_oracle_rows.json")) as f:
        oracle = json.load(f)["adv_conv_p3_40_rot5"]["final_row"]
    prob = _port(adv.convergence_case(3, 40, 0.4, 0.0, 1.0))
    r = prob.run()[0][-1]
    assert r[0] == oracle[0] and abs(r[1] - oracle[1]) <= 1e-12
    _check(r[2:], oracle[2:])
    print("40^2 final row against the x64 oracle, largest relative gap "
          f"{max(abs(a - b) / abs(b) for a, b in zip(r[2:], oracle[2:])):.2e}")


@pytest.mark.parametrize("case", ["convergence", "composite"])
def test_data_functions_on_tensors(case):
    """The cases' data functions on tensor points (t a Python float)
    give tensors equal to their numpy values within 1e-14, and gdm's."""
    p = _conv(adv) if case == "convergence" else adv.composite_app_case()
    gp = _conv(gadv) if case == "convergence" else gadv.composite_app_case()
    pts = np.random.default_rng(7).uniform(-1.0, 1.0, size=(30, 7, 2))
    for field in ("exact_solution", "exact_solution_der"):
        for t in (0.0, 0.013, 0.4):
            a = getattr(p, field)(torch.as_tensor(pts), t)
            b = np.asarray(getattr(p, field)(pts, t), np.float64)
            c = np.asarray(getattr(gp, field)(pts, t), np.float64)
            assert isinstance(a, torch.Tensor) and a.dtype == F64
            assert a.shape == b.shape == c.shape == (30, 7)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-14, atol=1e-14)
            np.testing.assert_allclose(b, c, rtol=1e-14, atol=1e-14)


def test_refusals():
    with pytest.raises(TypeError, match="device_mesh"):
        adv.AdvectionProblem(_conv(adv), mesh=object(), device="cpu")
    p = _mini(adv)
    p.strong_bc = True
    prob = _port(p)
    for run in (prob.run, prob.run_scan):
        with pytest.raises(ValueError, match="non-composite"):
            run()


def test_clis_on_the_cpu(monkeypatch, capsys):
    """Both CLIs take gdm's argv and print the reference's table; the
    runs are cut short here by shrinking the cases (their arguments and
    loops are gdm's)."""
    from gdm_torch.apps import advection_app, advection_convergence

    small = adv.convergence_case

    def tiny(fe, n, cfl, fr, factor):
        p = small(fe, 10, cfl, fr, factor)
        p.end_t = 0.01
        return p

    monkeypatch.setattr(adv, "convergence_case", tiny)
    assert advection_convergence.main(["parallel-ramp-degree", "--quick"],
                                      device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["fe_degree", "cfl", "n_subdivision", "rot_0",
                              "rot_1", "error_2", "error_1", "error_inf",
                              "error_2_face", "error_1_face",
                              "error_inf_face"]
    assert len([ln for ln in out if ln.strip()]) == 3
    with pytest.raises(SystemExit, match="unknown case"):
        advection_convergence.main(["no-such-case"], device="cpu")

    app = adv.composite_app_case

    def app_small():
        p = app()
        p.n_subdivisions_1D, p.fe_degree, p.end_t = 12, 3, 0.002
        return p

    monkeypatch.setattr(adv, "composite_app_case", app_small)
    # --quick keeps gdm's p = 3 and 50^2 (t_end 0.05), which the CPU takes
    # minutes for; the patched case stands in for it, so without --quick
    assert advection_app.main([], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-3].split()[:2] == ["block", "error_2"]
    assert [ln.split()[0] for ln in out[-2:]] == ["0", "1"]


@pytest.mark.parametrize("dtype", [torch.float32, F64],
                         ids=["float32", "float64"])
def test_resident_floor_on_the_probe(dtype):
    """The verified solver's resident tolerance floors by dtype
    (``cut.fsai.RESIDENT_FLOORS``) at the advection params' rel 1e-14,
    abs 1e-20, on the convergence case's mass: float32 takes gdm's (rel
    1e-6, abs 1e-12) and misses its probe, as on the card; float64 asks
    rel 1e-12 (abs the params' 1e-20, above its floor 1e-24) of the
    probe's ||r0|| and meets it, so its run stays on the resident
    route."""
    from gdm_torch.cut import fsai
    from gdm_torch.cut.stencil import assemble_stencil

    p = adv.convergence_case(3, 10, 0.4, 0.0, 5.0)
    op = adv.AdvectionProblem(p, device="cpu", dtype=dtype).op_in
    st = assemble_stencil(op, "mass", p.ghost_parameter_M)
    vs = fsai.verified_fsai_solver(
        st, windows=op.w_cut, max_iter=p.solver_max_iterations,
        rel_tol=p.solver_rel_tolerance, abs_tol=p.solver_abs_tolerance,
        device="cpu", dtype=dtype)
    rel, abs_ = {torch.float32: (1e-6, 1e-12), F64: (1e-12, 1e-20)}[dtype]
    r0 = np.linalg.norm(np.random.default_rng(0).standard_normal(
        st.grid.n_nodes).astype(np.float32).astype(np.float64))
    print(dtype, vs.path, vs.probe)
    assert vs.probe["tol"] == pytest.approx(max(abs_, rel * r0), rel=1e-6)
    assert vs.path == ("streamed" if dtype == torch.float32
                       else "resident-verified")
    if dtype == F64:
        assert vs.probe["residual"] <= 10 * vs.probe["tol"]
