"""Cut-cell wave/heat application: the explicit time loops.

Port of gdm/problems/wave.py (the reference wave application,
applications/wave/): ``WaveParams`` and the named presets of
wave-app.cc, the discretisation (level-set interpolation and cut
classification, host numpy), and the explicit RK4 loops of the
``wave-rk`` and ``heat-rk`` simulation types (problem.h:72-128,
280-346) with the reference's error rows.

Each RK stage builds the right-hand side, ``compute_rhs`` minus the
assembled stiffness band (K1 on the card in 2D), and solves with the
ghost-penalised cut mass.  The mass solve follows gdm's own dispatch on
whether its fused kernels are there: a CUDA run of a 2D grid takes gdm's
TPU branch, the verified FSAI solver (K2, checked per solve, with the
streamed Schwarz CG over K1 as fallback); any other run takes gdm's CPU
branch, Jacobi CG over ``best_solver_apply``.  Both solve to the
parameters' tolerances.  The other simulation types, composites and VTU
output raise NotImplementedError naming what they wait for.

Function convention: scalar field functions take (pts, t), pts a numpy
array of physical points shaped (..., dim) and t a float, and return
numpy arrays (gdm's take a traced t and return jnp).  Entry points run
on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as _device
from .. import solvers, timestepping
from ..cut.geometry import INSIDE, OUTSIDE, CutGeometry
from ..cut.operators import CutOperators
from ..grid import Grid


@dataclasses.dataclass
class WaveParams:
    """Mirror of the reference Parameters struct
    (applications/wave/include/gdm/wave/parameters.h)."""

    simulation_type: str = "poisson"
    fe_degree: int = 3
    n_components: int = 1
    composite: bool = False
    n_subdivisions_1D: int = 40
    geometry_left: float = -1.21
    geometry_right: float = 1.21
    ghost_parameter_M: float = -1.0
    ghost_parameter_A: float = -1.0
    nitsche_parameter: float = -1.0
    function_domain_dbc: Optional[Callable] = None
    function_interface_dbc: Optional[Callable] = None
    function_rhs: Optional[Callable] = None
    exact_solution: Optional[Callable] = None
    start_t: float = 0.0
    end_t: float = 0.1
    cfl: float = 0.3
    cfl_pow: float = 1.0
    solver_name: str = "CG"
    solver_max_iterations: int = 1000
    solver_abs_tolerance: float = 1e-20
    solver_rel_tolerance: float = 1e-14
    level_set_fe_degree: int = 3
    level_set_function: Optional[Callable] = None
    output_fe_degree: int = 3
    # gdm writes solution_{i,o}_<counter>.vtu per step when set; the
    # port raises until gdm/io/vtu.py is ported
    output_vtu_dir: Optional[str] = None
    # vertex deformation (gdm threads it through every cut table); the
    # port raises until gdm/deform.py is ported
    mapping_q_cache_function: Optional[Callable] = None
    mapping_geometry: str = "q1"
    # print a reference-style " [L] solved in N" line per solve sample
    # (problem.h:492) and record (counter, iterations, fallback,
    # fallback_iterations) in WaveProblem.solver_rows
    print_solver_info: bool = False
    dim: int = 1


def sphere_signed_distance(mesh_list):
    return np.sqrt(sum(np.asarray(m) ** 2 for m in mesh_list)) - 1.0


def make_preset(name: str, dim: int) -> WaveParams:
    """Named presets of wave-app.cc:9-354."""
    import scipy.special

    p = WaveParams(dim=dim)
    if name == "step85":
        p.simulation_type = "poisson"
        p.fe_degree = 3
        p.ghost_parameter_M = -1.0
        p.ghost_parameter_A = 0.5
        p.nitsche_parameter = 5.0 * p.fe_degree
        p.function_interface_dbc = lambda pts, t: np.full(pts.shape[:-1], 1.0)
        p.function_rhs = lambda pts, t: np.full(pts.shape[:-1], 4.0)
        p.exact_solution = lambda pts, t: np.asarray(
            1.0 - 2.0 / dim * ((pts**2).sum(-1) - 1.0))
        p.end_t = 0.1
    elif name in ("heat", "heat-rk", "heat-impl"):
        p.simulation_type = "heat-impl" if name == "heat" else name
        p.fe_degree = 3
        p.ghost_parameter_M = 0.75
        p.ghost_parameter_A = 1.5
        p.nitsche_parameter = 5.0 * p.fe_degree

        def g(pts, t):
            if dim == 1:
                return pts[..., 0] ** 9 * math.exp(-t)
            return pts[..., 0] ** 9 * pts[..., 1] ** 8 * math.exp(-t)

        def f(pts, t):
            if dim == 1:
                return -(pts[..., 0] ** 7) * math.exp(-t) * (pts[..., 0] ** 2
                                                             + 72)
            x, y = pts[..., 0], pts[..., 1]
            return (-(x**7) * y**6 * math.exp(-t)
                    * (x**2 * y**2 + 72 * y**2 + 56 * x**2))

        p.function_interface_dbc = g
        p.function_rhs = f
        p.exact_solution = g
        if p.simulation_type == "heat-rk":
            p.cfl = 0.3 / p.fe_degree / p.fe_degree
            p.cfl_pow = 2.0
        else:
            p.cfl = 0.3
            p.cfl_pow = 1.0
    elif name == "heat-composite":
        p = make_preset("heat-rk", dim)
        p.simulation_type = "heat-rk"
        p.composite = True
        p.function_domain_dbc = p.function_interface_dbc
        p.function_interface_dbc = None
        return p
    elif name in ("wave", "wave-composite"):
        p.simulation_type = "wave-rk"
        p.fe_degree = 3
        p.composite = name == "wave-composite"
        p.ghost_parameter_M = 0.25 * np.sqrt(3.0)
        p.ghost_parameter_A = 0.50 * np.sqrt(3.0)
        p.nitsche_parameter = 5.0 * p.fe_degree

        def g(pts, t):
            r = np.linalg.norm(np.asarray(pts), axis=-1)
            if dim == 1:
                wn = 1.5 * np.pi
                return np.cos(wn * r) * math.cos(wn * t)
            wn = 3.0 * np.pi
            return scipy.special.j0(wn * r) * math.cos(wn * t)

        if p.composite:
            p.function_domain_dbc = g
        else:
            p.function_interface_dbc = g
        p.function_rhs = None
        p.exact_solution = g
        p.start_t = 0.0
        p.end_t = 2.0
        p.cfl = 0.3
        p.cfl_pow = 1.0
    else:
        raise ValueError(f"unknown preset {name}")
    p.level_set_fe_degree = p.fe_degree
    p.level_set_function = sphere_signed_distance
    return p


def _exact_time_derivative(g, eps=1e-6):
    return lambda pts, t: (g(pts, t + eps) - g(pts, t - eps)) / (2 * eps)


class WaveProblem:
    """Cut wave/heat solver (reference: applications/wave/include/gdm/
    wave/problem.h), on ``device`` in ``dtype``.

    ``mesh`` is gdm's domain decomposition over a device mesh; it waits
    for gdm/dist/cut.py and raises NotImplementedError when given.
    ``rows`` holds the postprocess rows (counter, t, L2, L1, Linf) per
    location slot, ``solver_rows`` the solver samples when
    ``params.print_solver_info``, and ``_solver_meta`` the routing of
    each verified mass solver (``path``, ``probe``); the solver itself
    is ``mass_solver`` after a run.
    """

    def __init__(self, params: WaveParams, verbose: bool = True,
                 mesh=None, device="cuda", dtype=torch.float32):
        if mesh is not None:
            raise NotImplementedError(
                "the domain-decomposed time loops (mesh=) wait for "
                "gdm/dist/cut.py (sharded_stencil_apply), which is not "
                "ported yet")
        self.device = _device.resolve(device)
        self.dtype = _device.resolve_dtype(dtype)
        self.params = params
        self.verbose = verbose
        self.mesh = mesh
        self.rows = {0: [], 1: []}
        self.solver_rows = {0: [], 1: []}
        self._solver_sample = {}
        self._solver_meta = []
        self.mass_solver = None
        dim = params.dim
        self.grid = Grid(
            params.fe_degree,
            (params.n_subdivisions_1D,) * dim,
            (params.geometry_left,) * dim,
            (params.geometry_right,) * dim,
        )
        self.geo = CutGeometry.build(
            self.grid, params.level_set_function, params.level_set_fe_degree
        )
        self.dx = (params.geometry_right - params.geometry_left) / \
            params.n_subdivisions_1D
        map_kw = dict(mapping_fn=params.mapping_q_cache_function,
                      geometry=params.mapping_geometry)
        self.op_in = CutOperators(self.geo, INSIDE, **map_kw)
        self.op_out = (
            CutOperators(self.geo, OUTSIDE, **map_kw)
            if params.composite else None
        )

    # -- helpers --------------------------------------------------------
    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.grid.n_nodes, dtype=self.dtype,
                           device=self.device)

    def interpolate_exact(self, t: float) -> torch.Tensor:
        """The exact solution at the nodes (a deformed mapping raises in
        the constructor, through CutOperators)."""
        pts = np.stack(self.grid.node_coords_mesh(), axis=-1)
        vals = self.params.exact_solution(pts, t)
        return torch.as_tensor(np.asarray(vals).reshape(-1),
                               dtype=self.dtype, device=self.device)

    def _mass_solver(self, op: CutOperators):
        gm = self.params.ghost_parameter_M
        pp = self.params
        if pp.solver_name == "direct":
            raise NotImplementedError(
                "solver_name='direct' waits for solvers.make_direct_solver, "
                "which is not ported yet")
        from ..cut.stencil import assemble_stencil, best_solver_apply

        if self.device.type == "cuda" and self.grid.dim == 2:
            # gdm's TPU branch: the whole FSAI-preconditioned CG as one
            # launch (K2), probe-routed and true-residual-checked per
            # solve, with the streamed Schwarz CG over K1 as fallback
            from ..cut.fsai import verified_fsai_solver

            st = assemble_stencil(op, "mass", gm)
            vs = verified_fsai_solver(
                st, windows=op.w_cut,
                max_iter=pp.solver_max_iterations,
                rel_tol=pp.solver_rel_tolerance,
                abs_tol=pp.solver_abs_tolerance,
                device=self.device, dtype=self.dtype,
            )
            self._register_solver_sample(op, vs, gm)
            self._solver_meta.append(
                {"loc": "inside" if op is self.op_in else "outside",
                 "path": vs.path, "probe": vs.probe})
            return vs

        # gdm's CPU branch: Jacobi CG over the band (or matrix-free) apply
        apply_fn = best_solver_apply(op, "mass", gm)
        pre = solvers.jacobi_preconditioner(torch.as_tensor(
            op.mass_diagonal(gm), dtype=self.dtype, device=self.device))

        def solve(b):
            x, info = solvers.cg(
                apply_fn, b, precond=pre,
                max_iter=pp.solver_max_iterations,
                abs_tol=pp.solver_abs_tolerance,
                rel_tol=pp.solver_rel_tolerance,
            )
            return x

        return solve

    def _register_solver_sample(self, op, vs, gm):
        """Per-output-row solver-health sample: solve M x = M u at the
        row's state and record the verified solver's iteration count and
        fallback flag (the '[L] solved in N' stand-in of gdm's jitted
        stages)."""
        slot = 0 if op is self.op_in else 1

        def sample(u, gm=gm, op=op, vs=vs):
            return vs.solve_with_info(op.mass_apply(u, gm))[1]

        self._solver_sample[slot] = sample

    def _record_solver_info(self, slot, counter, info):
        it = int(info["iterations"])
        fb = bool(info["fallback"])
        itf = int(info["fallback_iterations"])
        self.solver_rows[slot].append((counter, it, fb, itf))
        if self.verbose:
            print(" [L] solved in %d%s"
                  % (itf if fb else it, " (fallback)" if fb else ""))

    def postprocess(self, t, u, location=INSIDE):
        op = self.op_in if location == INSIDE else self.op_out
        slot = 0 if location == INSIDE else 1
        l2, l1, linf = op.error_norms(u, self.params.exact_solution, t)
        counter = len(self.rows[slot])
        self.rows[slot].append((counter, t, l2, l1, linf))
        if self.verbose:
            print("%5d %8.5f %14.8e %14.8e %14.8e" % (counter, t, l2, l1,
                                                      linf))
        if self.params.print_solver_info and slot in self._solver_sample:
            self._record_solver_info(
                slot, counter, self._solver_sample[slot](u))
        if self.params.output_vtu_dir is not None:
            raise NotImplementedError(
                "output_vtu_dir: the per-step VTU output waits for "
                "gdm/io/vtu.py, which is not ported yet")

    # -- main dispatch --------------------------------------------------
    def run(self):
        pp = self.params
        st = pp.simulation_type
        waits = {
            "poisson": "WaveProblem._run_poisson (with cut/multigrid.py)",
            "heat-impl": "WaveProblem._run_heat_impl (with "
                         "CutOperators.stiffness_matrix_apply and "
                         "cut/fsai.py's fsai_cg_solver)",
        }
        if st in ("heat-rk", "wave-rk") and not pp.composite:
            self._run_explicit(heat=st == "heat-rk")
        elif st in ("heat-rk", "wave-rk"):
            raise NotImplementedError(
                f"the composite {st} run waits for "
                f"WaveProblem._run_explicit_composite and "
                f"_interface_coupling, which are not ported yet")
        elif st in waits:
            raise NotImplementedError(
                f"simulation_type={st!r} waits for {waits[st]}, which is "
                f"not ported yet")
        else:
            raise ValueError(st)
        return self.rows

    def _stiffness_diag(self) -> np.ndarray:
        pp = self.params
        return self.op_in.stiffness_diagonal(
            pp.ghost_parameter_A, pp.nitsche_parameter,
            with_nitsche=pp.function_interface_dbc is not None)

    # -- heat / wave explicit -------------------------------------------
    def _rhs_fn(self, op: CutOperators):
        pp = self.params
        K = 2 * (self.grid.degree + 1) + 1
        if self.grid.n_nodes * K**self.grid.dim <= 3e7:
            # the u-linear ("impl") part of the matrix-free RHS has stencil
            # sparsity: assemble it once; per-stage work = one band apply
            # + the time-dependent forcing terms
            from ..cut.fastapply import fast_stencil_apply
            from ..cut.stencil import assemble_stencil

            S = assemble_stencil(
                op, "stiff", pp.ghost_parameter_A, pp.nitsche_parameter,
                with_nitsche=pp.function_interface_dbc is not None,
                gp_power=1,
                with_bdry_nitsche=pp.function_domain_dbc is not None,
                inactive_identity=False,
            )
            if self.device.type == "cuda" and self.grid.dim == 2:
                S_apply = fast_stencil_apply(
                    S, op, "stiff", inactive_identity=False,
                    device=self.device, dtype=self.dtype)
            else:
                S_apply = S.apply

            def rhs(u, t):
                forcing = op.compute_rhs(
                    u, t, False, rhs_fn=pp.function_rhs,
                    interface_dbc=pp.function_interface_dbc,
                    domain_dbc=pp.function_domain_dbc,
                    gamma_A=pp.ghost_parameter_A,
                    nitsche_gamma=pp.nitsche_parameter,
                )
                return forcing - S_apply(u)

            return rhs

        def rhs(u, t):
            return op.compute_rhs(
                u, t, True, rhs_fn=pp.function_rhs,
                interface_dbc=pp.function_interface_dbc,
                domain_dbc=pp.function_domain_dbc,
                gamma_A=pp.ghost_parameter_A,
                nitsche_gamma=pp.nitsche_parameter,
            )

        return rhs

    def explicit_step(self, heat: bool):
        """(step, y0, delta_t) of the explicit loop on the inside region:
        ``step(t, dt, y)`` is one classical RK4 step of the heat
        (``heat=True``, y = u) or wave (y = (u, v)) system, and y0 the
        state at start_t.  Builds the mass solver (``mass_solver``) and
        the RHS once."""
        pp = self.params
        op = self.op_in
        msolve = self.mass_solver = self._mass_solver(op)
        rhs = self._rhs_fn(op)

        if heat:
            def f(t, u):
                return msolve(rhs(u, t))
            y0 = self.interpolate_exact(pp.start_t)
        else:
            def f(t, y):
                u, v = y
                return (v, msolve(rhs(u, t)))
            y0 = (self.interpolate_exact(pp.start_t), self._zeros())

        def step(t, dt, y):
            return timestepping.rk_step(f, t, dt, y)

        return step, y0, pp.cfl * self.dx**pp.cfl_pow

    def _run_explicit(self, heat: bool):
        step, y0, delta_t = self.explicit_step(heat)
        extract = (lambda y: y) if heat else (lambda y: y[0])
        y = self._time_loop(step, y0, delta_t, extract)
        self.final_solution = y if heat else y[0]

    def _time_loop(self, step, y0, delta_t, extract):
        pp = self.params
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        y = y0
        self.postprocess(pp.start_t, extract(y))
        while not time.is_at_end():
            t, dt = time.get_current_time(), time.get_next_step_size()
            y = step(t, dt, y)
            self.postprocess(t + dt, extract(y))
            time.advance_time()
        return y

    def _schedule(self):
        """The reference DiscreteTime step sequence (times, step sizes),
        precomputed on the host (fixed desired step; the final step is
        shortened to land on end_t — problem.h:76-77 + dealii::
        DiscreteTime semantics)."""
        pp = self.params
        delta_t = pp.cfl * self.dx ** pp.cfl_pow
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        ts, dts = [], []
        while not time.is_at_end():
            ts.append(time.get_current_time())
            dts.append(time.get_next_step_size())
            time.advance_time()
        return np.asarray(ts), np.asarray(dts)
