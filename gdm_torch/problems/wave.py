"""Cut-cell wave/heat/Poisson application.

Port of gdm/problems/wave.py (the reference wave application,
applications/wave/): ``WaveParams`` and the named presets of
wave-app.cc, the discretisation (level-set interpolation and cut
classification, host numpy), the simulation-type dispatch of
problem.h:39-440 (the step85 Poisson solve, the explicit RK4 loops of
``wave-rk`` and ``heat-rk`` on one region or on both regions coupled
across the interface, and the implicit-Euler ``heat-impl`` loop), the
reference's error rows and its per-step VTU output.

Each RK stage builds the right-hand side, ``compute_rhs`` minus the
assembled stiffness band (K1 on the card in 2D), and solves with the
ghost-penalised cut mass.  The solves follow gdm's own dispatch on
whether its fused kernels are there, read as the device asked for: a
CUDA run of a 2D grid takes gdm's TPU branch (the verified FSAI solver:
K2, checked per solve, with the streamed CG over K1 as fallback); any
other run takes gdm's CPU branch (Jacobi CG over ``best_solver_apply``
for the mass, the host FSAI-CG over the matrix-free operator for
heat-impl).  The Poisson solve is CG with Jacobi or, with
``solver_name="MG"``, the cut multigrid (its level bands through K1 on
the card in 2D).  All solve to the parameters' tolerances.  gdm's
whole-trajectory device loop (``run_scan``) and the domain-decomposed
and deformed runs are not ported yet.

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
    # when set, every postprocess step writes solution_{i,o}_<counter>.vtu
    # into this directory (reference problem.h:617-657 writes one per step)
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
    ``params.print_solver_info`` (heat-impl: every implicit solve), and
    ``_solver_meta`` the routing of each verified mass solver (``path``,
    ``probe``).  After a run the solvers are ``mass_solver`` (the
    inside region's; ``mass_solvers`` holds both of a composite run),
    ``heat_solvers`` (heat-impl, one per distinct step size) and, for
    the Poisson solve, ``multigrid`` (with ``solver_name="MG"``) and
    ``poisson_info`` (the CG's iterations and residual).
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

    def _kernel_route(self) -> bool:
        """gdm's test for its fused kernels, read as the device asked
        for (``cut.stencil.kernel_route``): a CUDA run of a 2D grid takes
        gdm's TPU branches (K1, K2)."""
        from ..cut import stencil

        return stencil.kernel_route(self.grid, self.device)

    def _mass_solver(self, op: CutOperators):
        gm = self.params.ghost_parameter_M
        pp = self.params
        if pp.solver_name == "direct":
            return solvers.make_direct_solver(
                lambda v: op.mass_apply(v, gm), self.grid.n_nodes,
                device=self.device, dtype=self.dtype)
        from ..cut.stencil import assemble_stencil, best_solver_apply

        if self._kernel_route():
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
            import os

            tag = "i" if location == INSIDE else "o"
            path = os.path.join(self.params.output_vtu_dir,
                                f"solution_{tag}_{counter}.vtu")
            _write_step_vtu(self, u, t, path, location)

    # -- main dispatch --------------------------------------------------
    def run(self):
        pp = self.params
        st = pp.simulation_type
        if st == "poisson":
            self._run_poisson()
        elif st in ("heat-rk", "wave-rk") and not pp.composite:
            self._run_explicit(heat=st == "heat-rk")
        elif st in ("heat-rk", "wave-rk"):
            self._run_explicit_composite(heat=st == "heat-rk")
        elif st == "heat-impl":
            self._run_heat_impl()
        else:
            raise ValueError(st)
        return self.rows

    # -- poisson --------------------------------------------------------
    def _run_poisson(self):
        pp = self.params
        op = self.op_in
        ga, gn = pp.ghost_parameter_A, pp.nitsche_parameter
        with_nitsche = pp.function_interface_dbc is not None

        if pp.function_domain_dbc is not None:
            # compute_rhs adds domain-boundary Nitsche RHS terms, so the
            # LHS must carry the matching boundary-face Nitsche matrix
            # (stiffness_matrix_apply has only the interface terms); the
            # stencil-band assembly has both (K1 on the card in 2D)
            from ..cut.stencil import assemble_stencil, routed_apply

            S = assemble_stencil(op, "stiff", ga, gn,
                                 with_nitsche=with_nitsche,
                                 with_bdry_nitsche=True)
            apply_fn = routed_apply(S)
            K = 2 * (self.grid.degree + 1) + 1
            center = (K ** self.grid.dim - 1) // 2
            diag_np = np.asarray(
                S.band_host.reshape(self.grid.n_nodes, -1)[:, center])
        else:
            def apply_fn(v):
                return op.stiffness_matrix_apply(v, ga, gn,
                                                 with_nitsche=with_nitsche)
            diag_np = self._stiffness_diag()

        if pp.solver_name == "MG":
            # mesh-independent multilevel preconditioner for the cut
            # stiffness system — the reference's AMG role
            # (problem.h:461-469); see gdm_torch/cut/multigrid.py
            from ..cut.multigrid import cut_poisson_multigrid

            mg = cut_poisson_multigrid(
                op, ga, gn, pp.level_set_function,
                level_set_degree=pp.level_set_fe_degree,
                with_nitsche=with_nitsche,
                with_bdry_nitsche=pp.function_domain_dbc is not None,
                device=self.device, dtype=self.dtype)
            self.multigrid = mg
            precond = mg.precondition
        else:
            precond = solvers.jacobi_preconditioner(torch.as_tensor(
                diag_np, dtype=self.dtype, device=self.device))

        b = op.compute_rhs(
            self._zeros(), 0.0, False, rhs_fn=pp.function_rhs,
            interface_dbc=pp.function_interface_dbc,
            domain_dbc=pp.function_domain_dbc, nitsche_gamma=gn)
        u, self.poisson_info = solvers.cg(
            apply_fn, b, precond=precond,
            max_iter=pp.solver_max_iterations,
            abs_tol=pp.solver_abs_tolerance,
            rel_tol=pp.solver_rel_tolerance)
        self.final_solution = u
        self.postprocess(0.0, u)

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
            if self._kernel_route():
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

    def _run_explicit_composite(self, heat: bool):
        pp = self.params
        delta_t = pp.cfl * self.dx**pp.cfl_pow
        ops = (self.op_in, self.op_out)
        solves = (self._mass_solver(ops[0]), self._mass_solver(ops[1]))
        self.mass_solvers = solves
        self.mass_solver = solves[0]
        rhss = (self._rhs_fn(ops[0]), self._rhs_fn(ops[1]))
        tau = 0.5 * pp.nitsche_parameter
        couple = pp.function_interface_dbc is None

        def coupled_rhs(u0, u1, t):
            r0 = rhss[0](u0, t)
            r1 = rhss[1](u1, t)
            if couple:
                r0, r1 = _interface_coupling(self.op_in, r0, r1, u0, u1, tau)
            return r0, r1

        if heat:
            def f(t, y):
                u0, u1 = y
                r0, r1 = coupled_rhs(u0, u1, t)
                return (solves[0](r0), solves[1](r1))
            y0 = (self.interpolate_exact(pp.start_t),
                  self.interpolate_exact(pp.start_t))
        else:
            def f(t, y):
                u0, u1, v0, v1 = y
                r0, r1 = coupled_rhs(u0, u1, t)
                return (v0, v1, solves[0](r0), solves[1](r1))
            y0 = (self.interpolate_exact(pp.start_t),
                  self.interpolate_exact(pp.start_t), self._zeros(),
                  self._zeros())

        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        y = y0
        self.postprocess(pp.start_t, y[0], INSIDE)
        self.postprocess(pp.start_t, y[1], OUTSIDE)
        while not time.is_at_end():
            t, dt = time.get_current_time(), time.get_next_step_size()
            y = timestepping.rk_step(f, t, dt, y)
            self.postprocess(t + dt, y[0], INSIDE)
            self.postprocess(t + dt, y[1], OUTSIDE)
            time.advance_time()
        self.final_solution = y[:2]

    # -- heat implicit --------------------------------------------------
    def _run_heat_impl(self):
        pp = self.params
        op = self.op_in
        delta_t = pp.cfl * self.dx**pp.cfl_pow
        ga, gn = pp.ghost_parameter_A, pp.nitsche_parameter
        gm = pp.ghost_parameter_M
        with_nitsche = pp.function_interface_dbc is not None

        def system_apply(v, dt):
            return op.mass_apply(v, gm) + dt * (
                op.stiffness_matrix_apply(v, ga, gn, with_nitsche)
                - torch.where(op.table("inactive", v), v, 0.0))

        # (M + dt S) in stencil-band form for the FSAI factorisation —
        # the reference ILU-preconditions this system (problem.h:210-279)
        from ..cut.fsai import fsai_cg_solver
        from ..cut.stencil import StencilOperator, assemble_stencil

        st_m = assemble_stencil(op, "mass", gm)
        st_s = assemble_stencil(op, "stiff", ga, gn,
                                with_nitsche=with_nitsche,
                                inactive_identity=False)
        self.heat_solvers = {}

        def make_step(dt):
            st_sys = StencilOperator(
                self.grid, st_m.band_host + dt * st_s.band_host,
                st_m.radius)
            solve = fsai_cg_solver(
                st_sys, pp.solver_max_iterations,
                pp.solver_rel_tolerance, pp.solver_abs_tolerance,
                apply_fn=lambda v: system_apply(v, dt),
                device=self.device, dtype=self.dtype)
            self.heat_solvers[dt] = solve

            def step(t_next, u):
                b = op.compute_rhs(
                    u, t_next, False, rhs_fn=pp.function_rhs,
                    interface_dbc=pp.function_interface_dbc,
                    domain_dbc=pp.function_domain_dbc,
                    nitsche_gamma=gn,
                )
                b = dt * b + op.mass_apply(u, gm)
                # a cold start, as gdm's run() (its run_scan warm-starts)
                return solve.solve_with_info(b)

            return step

        steps = {}
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        u = self.interpolate_exact(pp.start_t)
        self.postprocess(pp.start_t, u)
        while not time.is_at_end():
            t, dt = time.get_current_time(), time.get_next_step_size()
            if dt not in steps:
                steps[dt] = make_step(dt)
            u, sinfo = steps[dt](t + dt, u)
            self.postprocess(t + dt, u)
            if pp.print_solver_info:
                # heat-impl records its actual per-step implicit solve,
                # the reference's per-solve " [L] solved in N"
                # (problem.h:492, heat_0.output)
                self._record_solver_info(0, len(self.rows[0]) - 1, sinfo)
            time.advance_time()
        self.final_solution = u

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


def _write_step_vtu(problem: "WaveProblem", sol, t, path: str,
                    location=INSIDE):
    """One postprocess-step VTU: solution + level_set + analytical_solution
    over the subdomain's cells (reference problem.h:617-657)."""
    from ..io import DataOut

    pp = problem.params
    out = DataOut(problem.grid, pp.output_fe_degree)
    out.add_data_vector(sol, "solution")
    if pp.level_set_function is not None:
        mesh = problem.grid.node_coords_mesh()
        ls_vals = pp.level_set_function(mesh)
        out.add_data_vector(np.asarray(ls_vals).reshape(-1), "level_set")
    out.add_data_vector(problem.interpolate_exact(t), "analytical_solution")
    out.add_cell_data(np.zeros(problem.grid.n_cells), "ranks")
    inverse = OUTSIDE if location == INSIDE else INSIDE
    out.set_cell_selection(problem.geo.locations_flat != inverse)
    out.write_vtu(path)


def write_solution_vtu(problem: "WaveProblem", path: str, location=INSIDE):
    """VTU of the final solution + analytical field over the subdomain
    (reference problem.h:617-657)."""
    sol = problem.final_solution
    if isinstance(sol, tuple):
        sol = sol[0 if location == INSIDE else 1]
    _write_step_vtu(problem, sol, problem.params.end_t, path, location)


def _interface_coupling(op_in: CutOperators, r0, r1, u0, u1, tau):
    """Composite interface flux coupling (wave stiffness.h:422-574)."""
    V = op_in.table("V_surf", u0)
    nrm = op_in.table("surf_n", u0)  # inside-outward orientation
    w = op_in.table("surf_w", u0)
    win = op_in.table("w_cut", u0)
    h = op_in.h_min
    u0w = u0[win]
    u1w = u1[win]
    u0q = torch.einsum("nqi,ni->nq", V, u0w)
    u1q = torch.einsum("nqi,ni->nq", V, u1w)
    Gn = torch.einsum("nqdi,nqd->nqi", op_in.table("G_surf", u0), nrm)
    g0q = torch.einsum("nqi,ni->nq", Gn, u0w)
    g1q = torch.einsum("nqi,ni->nq", Gn, u1w)
    jump = u0q - u1q
    avg = 0.5 * (g0q + g1q)
    a = -0.5 * torch.einsum("nqi,nq,nq->ni", Gn, jump, w)
    b = torch.einsum("nqi,nq,nq->ni", V, avg, w)
    c = (tau / h) * torch.einsum("nqi,nq,nq->ni", V, jump, w)
    c0 = -(a - b + c)
    c1 = -(a + b - c)
    flat = win.reshape(-1)
    r0 = r0.index_add(0, flat, c0.reshape(-1))
    r1 = r1.index_add(0, flat, c1.reshape(-1))
    return r0, r1
