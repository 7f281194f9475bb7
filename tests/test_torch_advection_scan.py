"""The port's ``AdvectionProblem.run_scan`` and its checkpoints, in
float64 on the CPU, against its own ``run()`` and live gdm under x64.

gdm's ``run_scan`` (gdm/problems/advection.py:409-600) runs the whole
horizon as chunked ``lax.scan`` programs with an optional checkpoint
between chunks; the port's runs the same bodies in chunks on the run's
device, with the checkpoint in gdm's file format (gdm_torch/checkpoint.py).

- ``run_scan`` against ``run()`` (rtol 1e-10, atol 1e-14, gdm's
  tests/test_advection_scan.py) for the convergence case (3 steps), the
  composite case at 12 cells a side and p = 3 (4 steps) and the
  strong-BC advection_02 case at n = 10 (6 steps); chunks of 1 and of
  128 give equal rows;
- checkpoint and resume reproduce the uninterrupted run within 1e-12
  (gdm's tests/test_checkpoint_resume.py), composite and single; a
  checkpoint gdm's ``run_scan`` wrote after two chunks resumes here and
  one written here resumes in gdm, each within 1e-10 of gdm's full run;
  the file holds gdm's keys;
- the card's route rehearsed on the plain twins of K1 and K2, with
  ``cut.stencil.kernel_route`` forced: the composite case at 12 cells a
  side and p = 5 (the DoD degree, radius-6 bands), float64 at gdm's
  tolerances within 1e-8 of gdm's rows (6.4e-14 in a rehearsal: both
  probes miss at the float64 floor rel 1e-12, so every solve is K2's
  one-band Schwarz CG at rel 1e-14), float32 at the DoD script's
  settings (rel 1e-6, max_iter 400) within 5e-4 (1.8e-4 in a
  rehearsal); the routing logged;
- ``run_scan``'s refusal of a data function that gives no tensor;
- a checkpoint after a short last chunk resumes at the horizon's end;
- the spans of a run_scan (``gdm_torch.profiling``) while recording.
"""

import json

import numpy as np
import pytest
import torch

from gdm.problems import advection as gadv

from gdm_torch import profiling
from gdm_torch.cut import stencil
from gdm_torch.problems import advection as adv

F64 = torch.float64
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


def _strong(module):
    """tests/test_advection02.py's strong-BC configuration (no cut
    cells) to t = 0.03 (gdm's tests/test_advection_scan.py), its data
    functions numpy or torch as the points are."""
    def x_hat(pts, t):
        return np.cos(PHI) * (pts[..., 0] - t * A[0] - XS) + np.sin(PHI) * (
            pts[..., 1] - t * A[1])

    def sin(x):
        return torch.sin(x) if isinstance(x, torch.Tensor) else np.sin(x)

    def cos(x):
        return torch.cos(x) if isinstance(x, torch.Tensor) else np.cos(x)

    def exact(pts, t):
        return sin(np.sqrt(2) * np.pi * x_hat(pts, t) / (1 - XS))

    def exact_der(pts, t):
        return (cos(np.sqrt(2) * np.pi * x_hat(pts, t) / (1 - XS))
                * (np.sqrt(2) * np.pi / (1 - XS))
                * (np.cos(PHI) * (-A[0]) + np.sin(PHI) * (-A[1])))

    return module.AdvectionParams(
        fe_degree=3, n_subdivisions_1D=10, geometry_left=0.0,
        geometry_right=1.0, ghost_parameter_M=0.0, ghost_parameter_A=0.0,
        start_t=0.0, end_t=0.03, cfl=0.1, max_val=2.0, advection=A,
        exact_solution=exact, exact_solution_der=exact_der,
        level_set_fe_degree=1,
        level_set_function=lambda m: np.full_like(np.asarray(m[0]), -1.0),
        dim=2, strong_bc=True)


def _port(params, dtype=F64):
    return adv.AdvectionProblem(params, device="cpu", dtype=dtype)


def rows_close(a, b, rtol=1e-10, atol=1e-14):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        np.testing.assert_allclose(ra[1:], rb[1:], rtol=rtol, atol=atol)


def scaled_dev(port_rows, gdm_rows):
    """max |port - gdm| / max |gdm| over each error column."""
    m = np.asarray(port_rows, np.float64)
    g = np.asarray(gdm_rows, np.float64)
    assert m.shape == g.shape and np.array_equal(m[:, 0], g[:, 0])
    assert np.abs(m[:, 1] - g[:, 1]).max() <= 1e-12
    return (np.abs(m[:, 2:] - g[:, 2:]).max(axis=0)
            / np.abs(g[:, 2:]).max(axis=0))


@pytest.mark.parametrize("case", ["convergence", "composite", "strong"])
def test_scan_matches_run(case):
    make = {"convergence": _conv, "composite": _mini, "strong": _strong}[case]
    run = _port(make(adv)).run()
    prob = _port(make(adv))
    rows = prob.run_scan(chunk=2)
    for slot in (0, 1):
        rows_close(rows[slot], run[slot])
    assert len(rows[1]) == (len(rows[0]) if case == "composite" else 0)
    assert all(isinstance(x, float) for r in rows[0] for x in r[1:])


def test_chunks_give_equal_rows():
    a, b = _port(_conv(adv)), _port(_conv(adv))
    assert a.run_scan(chunk=1) == b.run_scan(chunk=128)
    assert torch.equal(a.u, b.u)


@pytest.mark.parametrize("case", ["composite", "single"])
def test_resume_reproduces_rows(tmp_path, case):
    """A run stopped after two chunks (its horizon cut to their steps)
    and run again over the whole horizon from its checkpoint gives the
    uninterrupted run's rows."""
    make = _mini if case == "composite" else _conv
    ck = str(tmp_path / "run.ckpt")
    full = _port(make(adv, steps=3)).run_scan(chunk=1)
    _port(make(adv, steps=2)).run_scan(chunk=1, checkpoint_path=ck)
    with np.load(ck) as z:
        n_leaves = 3 if case == "composite" else 2
        assert sorted(z.files) == sorted(
            [f"leaf_{i}" for i in range(n_leaves)] + ["__time__",
                                                      "__meta__"])
        es = z[f"leaf_{n_leaves - 1}"]
        assert es.shape == ((3, 2, 6) if case == "composite" else (3, 6))
    prob = _port(make(adv, steps=3))
    resumed = prob.run_scan(chunk=1, checkpoint_path=ck)
    for slot in (0, 1):
        assert len(resumed[slot]) == len(full[slot])
        rows_close(resumed[slot], full[slot], rtol=1e-12, atol=1e-16)


def test_checkpoints_cross_between_gdm_and_the_port(tmp_path):
    """gdm's run_scan checkpoint after two chunks resumes in the port,
    and the port's resumes in gdm: both within 1e-10 of gdm's full
    run."""
    full = gadv.AdvectionProblem(_conv(gadv, 6)).run_scan(chunk=2)
    ck = str(tmp_path / "gdm.ckpt")
    gadv.AdvectionProblem(_conv(gadv, 4)).run_scan(chunk=2,
                                                   checkpoint_path=ck)
    prob = _port(_conv(adv, 6))
    rows_close(prob.run_scan(chunk=2, checkpoint_path=ck)[0], full[0])
    assert prob.u.dtype == F64 and prob.u.shape == (prob.grid.n_nodes,)
    ck = str(tmp_path / "port.ckpt")
    _port(_conv(adv, 4)).run_scan(chunk=2, checkpoint_path=ck)
    rows = gadv.AdvectionProblem(_conv(gadv, 6)).run_scan(
        chunk=2, checkpoint_path=ck)
    rows_close(rows[0], full[0])


@pytest.fixture(scope="module")
def gdm_p5_rows():
    return gadv.AdvectionProblem(_mini(gadv, p=5, steps=2)).run_scan(chunk=2)


@pytest.mark.parametrize("dtype,limit,steps",
                         [(torch.float64, 1e-8, 2), (torch.float32, 5e-4, 1)],
                         ids=["float64", "float32"])
def test_card_route_rehearsed_on_the_twins(monkeypatch, gdm_p5_rows, dtype,
                                           limit, steps):
    """The card's 2D route, forced onto the plain twins of K1 and K2 at
    p = 5: the verified solvers' device form in every stage, rows
    within ``limit`` of gdm's CPU rows, no fallback."""
    monkeypatch.setattr(stencil, "kernel_route",
                        lambda grid, device: grid.dim == 2)
    p = _mini(adv, p=5, steps=steps)
    if dtype == torch.float32:
        p.solver_rel_tolerance, p.solver_max_iterations = 1e-6, 400
    prob = _port(p, dtype)
    rows = prob.run_scan(chunk=2)
    print("routing", prob._solver_meta)
    assert [m["loc"] for m in prob._solver_meta] == ["inside", "outside"]
    assert all(v.fallback_count == 0 for v in prob.mass_solvers)
    for slot in (0, 1):
        assert len(rows[slot]) == steps + 1
        dev = scaled_dev(rows[slot], gdm_p5_rows[slot][:steps + 1])
        print(f"slot {slot} {dtype}: scaled deviation {dev.max():.3e}")
        assert (dev <= limit).all()


def test_run_scan_refuses_a_host_data_function():
    p = _conv(adv)
    g = p.exact_solution
    p.exact_solution = lambda pts, t: np.asarray(g(np.asarray(pts), t))
    from gdm_torch.problems import scan

    with pytest.raises(ValueError, match="params.exact_solution"):
        scan.check_data_functions(p, ("exact_solution", "exact_solution_der"),
                                  2, torch.device("cpu"), F64)
    scan.check_data_functions(_conv(adv), ("exact_solution",
                                           "exact_solution_der"),
                              2, torch.device("cpu"), F64)


def test_resume_after_a_short_last_chunk(tmp_path):
    """A checkpoint of a horizon that is not a multiple of the chunk
    (3 steps in chunks of 2) names its next step as the horizon's end,
    so a resume over a longer horizon gives the uninterrupted run's rows
    and state."""
    ck = str(tmp_path / "run.ckpt")
    full = _port(_conv(adv, steps=5))
    full_rows = full.run_scan(chunk=2)
    _port(_conv(adv, steps=3)).run_scan(chunk=2, checkpoint_path=ck)
    with np.load(ck) as z:
        assert json.loads(bytes(z["__meta__"]).decode())["next_s"] == 3
    prob = _port(_conv(adv, steps=5))
    rows = prob.run_scan(chunk=2, checkpoint_path=ck)
    assert len(rows[0]) == len(full_rows[0]) == 6
    rows_close(rows[0], full_rows[0], rtol=1e-12, atol=1e-16)
    torch.testing.assert_close(prob.u, full.u, rtol=1e-12, atol=1e-16)


def test_run_scan_spans():
    """With recording on, a composite run_scan of 3 steps in chunks of 2
    gives one ``scan.call`` over ``scan.prepare`` (with each region's
    ``setup.mass_solver`` and its ``.assemble``), two ``scan.chunk``s,
    each with ``scan.enqueue`` and ``scan.read``, and ``scan.rows``;
    the constructor's ``setup.geometry`` and ``setup.operators``."""
    profiling.reset()
    with profiling.recording():
        prob = _port(_mini(adv, steps=3))
        prob.run_scan(chunk=2)
    sp = profiling.spans()
    kids = {i: [sp[j] for j in range(len(sp)) if sp[j].parent == i]
            for i in range(len(sp))}
    tops = [s for s in sp if s.parent is None]
    assert [s.name for s in tops] == ["setup.geometry", "setup.operators",
                                      "setup.operators", "scan.call"]
    assert [s.attrs["region"] for s in tops[1:3]] == ["inside", "outside"]
    call = sp.index(tops[-1])
    assert sp[call].attrs == {"steps": 3, "chunk": 2}
    assert [s.name for s in kids[call]] == ["scan.prepare", "scan.chunk",
                                            "scan.chunk", "scan.rows"]
    prepare = sp.index(kids[call][0])
    solvers = [s for s in kids[prepare] if s.name == "setup.mass_solver"]
    assert [s.attrs["region"] for s in solvers] == ["inside", "outside"]
    for s in solvers:
        assert [k.name for k in kids[sp.index(s)]] == [
            "setup.mass_solver.assemble"]
    chunks = [sp.index(s) for s in kids[call][1:3]]
    assert [sp[c].attrs["steps"] for c in chunks] == [2, 1]
    for c in chunks:
        assert [k.name for k in kids[c]] == ["scan.enqueue", "scan.read"]
        assert sp[c].start <= kids[c][0].start <= kids[c][1].end <= sp[c].end
