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
the card in 2D).  All solve to the parameters' tolerances.

``run_scan`` is gdm's whole-trajectory loop: the same rows, with the
host out of the loop where the card can take it.  On a CUDA run of a 2D
grid a chunk of steps enqueues kernel launches and tensor ops alone and
reads its error rows once at its end: the mass solves through the
verified solver's device form (K2's one-band Schwarz CG, gated behind
the resident FSAI solve where its probe passed), heat-impl's warm-started
Jacobi CG as K2's one-band mode on the band of M + dt S, the data
functions on device point tables.  Elsewhere its solves are the host CG
of ``run()``'s CPU branch.  A grid deformation
(``mapping_q_cache_function``) re-metrics the cut tables
(gdm_torch.deform) and takes the same paths: its bands are new shapes
for the same kernels.  ``mesh=`` runs gdm's domain-decomposed
routes (``gdm_torch.dist``): the band applies of the mass CG and of the
right-hand side split along grid axis 0 over the mesh's slots.

Function convention: scalar field functions take (pts, t), pts an array
of physical points shaped (..., dim) and t a Python float.  The
operators call them on their point tables, torch tensors on the run's
device; ``interpolate_exact`` and the VTU output on numpy points.  The
presets take both and return the same kind (gdm's take numpy points and
a traced t and return jnp).  Entry points run on the card unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import device as _device
from .. import solvers, special, timestepping
from ..cut.geometry import INSIDE, OUTSIDE, CutGeometry
from ..cut.operators import CutOperators
from ..grid import Grid
from . import scan


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
    # vertex deformation (reference parameters.h mapping_q_cache_function,
    # threaded through all assembly at discretization.h:57-74): the cut
    # is generated in UNDEFORMED coordinates and the deformation
    # re-metrics every quadrature table (cut/operators.py).
    # mapping_geometry="q1" matches MappingQCache(1); "exact"
    # (beyond-reference) samples the true map at quadrature points.
    mapping_q_cache_function: Optional[Callable] = None
    mapping_geometry: str = "q1"
    # print a reference-style " [L] solved in N" line per solve sample
    # (problem.h:492) and record (counter, iterations, fallback,
    # fallback_iterations) in WaveProblem.solver_rows
    print_solver_info: bool = False
    dim: int = 1


def sphere_signed_distance(mesh_list):
    return np.sqrt(sum(np.asarray(m) ** 2 for m in mesh_list)) - 1.0


def _full(pts, value):
    """``value`` at every point of ``pts`` (numpy or a tensor)."""
    if isinstance(pts, torch.Tensor):
        return pts.new_full(pts.shape[:-1], value)
    return np.full(pts.shape[:-1], value)


def _exp(t):
    return torch.exp(t) if isinstance(t, torch.Tensor) else math.exp(t)


def _cos(t):
    return torch.cos(t) if isinstance(t, torch.Tensor) else math.cos(t)


def _radius(pts):
    """|x| of each point (numpy or a tensor)."""
    if isinstance(pts, torch.Tensor):
        return torch.linalg.vector_norm(pts, dim=-1)
    return np.linalg.norm(np.asarray(pts), axis=-1)


def make_preset(name: str, dim: int) -> WaveParams:
    """Named presets of wave-app.cc:9-354.  Their data functions take
    numpy points (and give numpy) or tensor points (and give tensors on
    the points' device: torch.exp, torch.cos and ``special.bessel_j0``,
    scipy's j0 to 2e-15 where torch.special.bessel_j0 is not),
    with t a Python float or a tensor."""
    import scipy.special

    p = WaveParams(dim=dim)
    if name == "step85":
        p.simulation_type = "poisson"
        p.fe_degree = 3
        p.ghost_parameter_M = -1.0
        p.ghost_parameter_A = 0.5
        p.nitsche_parameter = 5.0 * p.fe_degree
        p.function_interface_dbc = lambda pts, t: _full(pts, 1.0)
        p.function_rhs = lambda pts, t: _full(pts, 4.0)

        def exact(pts, t):
            u = 1.0 - 2.0 / dim * ((pts**2).sum(-1) - 1.0)
            return u if isinstance(pts, torch.Tensor) else np.asarray(u)

        p.exact_solution = exact
        p.end_t = 0.1
    elif name in ("heat", "heat-rk", "heat-impl"):
        p.simulation_type = "heat-impl" if name == "heat" else name
        p.fe_degree = 3
        p.ghost_parameter_M = 0.75
        p.ghost_parameter_A = 1.5
        p.nitsche_parameter = 5.0 * p.fe_degree

        def g(pts, t):
            if dim == 1:
                return pts[..., 0] ** 9 * _exp(-t)
            return pts[..., 0] ** 9 * pts[..., 1] ** 8 * _exp(-t)

        def f(pts, t):
            if dim == 1:
                return -(pts[..., 0] ** 7) * _exp(-t) * (pts[..., 0] ** 2
                                                         + 72)
            x, y = pts[..., 0], pts[..., 1]
            return (-(x**7) * y**6 * _exp(-t)
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
            r = _radius(pts)
            wn = 1.5 * np.pi if dim == 1 else 3.0 * np.pi
            if isinstance(pts, torch.Tensor):
                radial = (torch.cos(wn * r) if dim == 1
                          else special.bessel_j0(wn * r))
            else:
                radial = (np.cos(wn * r) if dim == 1
                          else scipy.special.j0(wn * r))
            return radial * _cos(wn * t)

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

    ``mesh``: optional ``gdm_torch.dist.mesh.Mesh`` (``device_mesh(n)``;
    anything else raises TypeError).  When given, the port takes gdm's
    mesh routes on every device: no verified solver and no K2 bundle;
    the mass solve is Jacobi CG (``solvers.cg``) over the band apply
    domain-decomposed along grid axis 0 with a halo exchange
    (``dist.cut.sharded_stencil_apply``: K1 on each CUDA shard of a 2D
    grid, the plain tap loop elsewhere), and so are the RHS stiffness
    and the step85 band with domain-boundary Nitsche terms; the forcing
    terms and the CG's vectors stay whole on ``device``.  heat-impl
    ignores the mesh, as gdm's does.  Shards may share a card (a mesh of
    more slots than cards), where gdm's mesh has a device a shard.  The
    rows equal the serial run's to rounding (the CG's dot products are
    the same; the shards' sums are the serial apply's in exact
    arithmetic).  ``run_scan`` with a mesh runs the same host CG, so
    its chunks read the card inside every solve.
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
            from ..dist.mesh import check_mesh

            check_mesh(mesh)
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
        """The exact solution at the nodes: at their deformed positions
        under a mapping (reference problem.h:448-455: VectorTools::
        interpolate runs under the deformed mapping)."""
        if self.params.mapping_q_cache_function is not None:
            from .. import deform

            pts = deform.deformed_node_positions(
                self.grid, self.params.mapping_q_cache_function)
        else:
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

    def _maybe_shard(self, stencil_op):
        """The stencil apply, domain-decomposed over ``self.mesh`` if
        set (gdm's hook), else routed on the tensor (K1 for a CUDA
        tensor of a 2D grid)."""
        if self.mesh is None:
            from ..cut.stencil import routed_apply

            return routed_apply(stencil_op)
        from ..dist.cut import sharded_stencil_apply

        return sharded_stencil_apply(stencil_op, self.mesh)

    def _mass_solver(self, op: CutOperators):
        gm = self.params.ghost_parameter_M
        pp = self.params
        if pp.solver_name == "direct":
            return solvers.make_direct_solver(
                lambda v: op.mass_apply(v, gm), self.grid.n_nodes,
                device=self.device, dtype=self.dtype)
        from ..cut.stencil import assemble_stencil, best_solver_apply

        if self.mesh is None and self._kernel_route():
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

        # gdm's CPU branch and mesh branch: Jacobi CG over the band (or
        # matrix-free) apply, or over the sharded band apply
        if self.mesh is not None:
            apply_fn = self._maybe_shard(assemble_stencil(op, "mass", gm))
        else:
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
            from ..cut.stencil import assemble_stencil

            S = assemble_stencil(op, "stiff", ga, gn,
                                 with_nitsche=with_nitsche,
                                 with_bdry_nitsche=True)
            apply_fn = self._maybe_shard(S)
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
        if (self.mesh is not None
                or self.grid.n_nodes * K**self.grid.dim <= 3e7):
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
            if self.mesh is not None:
                S_apply = self._maybe_shard(S)
            elif self._kernel_route():
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
    def _heat_system_apply(self, v, dt):
        """M v + dt (S v - inactive v): heat-impl's system, matrix-free."""
        pp, op = self.params, self.op_in
        return op.mass_apply(v, pp.ghost_parameter_M) + dt * (
            op.stiffness_matrix_apply(
                v, pp.ghost_parameter_A, pp.nitsche_parameter,
                pp.function_interface_dbc is not None)
            - torch.where(op.table("inactive", v), v, 0.0))

    def _heat_system_band(self, dt):
        """M + dt S in stencil-band form (the mass and the stiffness
        bands assembled once per problem)."""
        from ..cut.stencil import StencilOperator, assemble_stencil

        pp, op = self.params, self.op_in
        if not hasattr(self, "_heat_bands"):
            self._heat_bands = (
                assemble_stencil(op, "mass", pp.ghost_parameter_M),
                assemble_stencil(op, "stiff", pp.ghost_parameter_A,
                                 pp.nitsche_parameter,
                                 with_nitsche=pp.function_interface_dbc
                                 is not None,
                                 inactive_identity=False))
        st_m, st_s = self._heat_bands
        return StencilOperator(self.grid, st_m.band_host + dt * st_s.band_host,
                               st_m.radius)

    def _heat_rhs(self, u, t_next, dt):
        """dt * rhs(t_next) + M u: heat-impl's right-hand side."""
        pp, op = self.params, self.op_in
        b = op.compute_rhs(
            u, t_next, False, rhs_fn=pp.function_rhs,
            interface_dbc=pp.function_interface_dbc,
            domain_dbc=pp.function_domain_dbc,
            nitsche_gamma=pp.nitsche_parameter)
        return dt * b + op.mass_apply(u, pp.ghost_parameter_M)

    def _run_heat_impl(self):
        pp = self.params
        delta_t = pp.cfl * self.dx**pp.cfl_pow

        # (M + dt S) in stencil-band form for the FSAI factorisation —
        # the reference ILU-preconditions this system (problem.h:210-279)
        from ..cut.fsai import fsai_cg_solver

        self.heat_solvers = {}

        def make_step(dt):
            st_sys = self._heat_system_band(dt)
            solve = fsai_cg_solver(
                st_sys, pp.solver_max_iterations,
                pp.solver_rel_tolerance, pp.solver_abs_tolerance,
                apply_fn=lambda v: self._heat_system_apply(v, dt),
                device=self.device, dtype=self.dtype)
            self.heat_solvers[dt] = solve

            def step(t_next, u):
                # a cold start, as gdm's run() (its run_scan warm-starts)
                return solve.solve_with_info(self._heat_rhs(u, t_next, dt))

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

    # -- the whole trajectory -------------------------------------------
    def run_scan(self, chunk: int = 128):
        """The whole time loop in chunks of ``chunk`` steps, gdm's
        device-resident counterpart of :meth:`run` (its ``lax.scan``
        chunks, gdm/problems/wave.py:659-821), for every time-dependent
        simulation type.  Populates ``self.rows`` in :meth:`postprocess`'s
        format (no solver rows) and ``self.final_solution``, and returns
        ``self.rows``.  ``"poisson"`` delegates to :meth:`run` (one
        solve); per-step VTU output needs the host in the loop and
        raises ValueError.

        On a CUDA run of a 2D grid no operation inside a chunk waits on
        the card: the host walks the schedule, which it knows in advance
        (``_schedule``), and passes t and dt as Python floats; the RK
        stages' mass solves run through the verified solver's device
        form and heat-impl's solves as K2 on the band of M + dt S; a
        chunk's error rows and the solvers' fallback counters are read
        once at its end.  A data function that gives anything but a
        tensor on the run's device raises ValueError there.  Off the
        card, and in 1D on the card, the solves are the host CG of
        ``run()``'s CPU branch (heat-impl: gdm's warm-started Jacobi CG
        over the matrix-free M + dt S).  With a ``mesh`` the RK stages'
        mass solves are gdm's mesh route, the host Jacobi CG over the
        sharded apply: each solve reads the card three times an
        iteration, so a chunk's host reads grow with its solves'
        iterations.
        """
        pp = self.params
        st = pp.simulation_type
        if st == "poisson":
            self.run()
            return self.rows
        if pp.output_vtu_dir is not None:
            raise ValueError("per-step VTU output requires run()")
        if self.device.type == "cuda":
            self._check_data_functions()
        ts, dts = self._schedule()
        chunk = max(1, min(chunk, len(ts)))
        if st == "heat-impl":
            step, y, slots, keep = self._scan_heat_impl(dts)
            verified = ()
        elif st in ("heat-rk", "wave-rk"):
            step, y, slots, keep, verified = self._scan_explicit(
                st == "heat-rk")
        else:
            raise ValueError(st)
        ops = (self.op_in, self.op_out)[:len(slots(y))]

        def errs(y, t):
            return torch.stack([o.error_norms_tensor(u, pp.exact_solution, t)
                                for o, u in zip(ops, slots(y))])

        parts = [errs(y, pp.start_t)[None].tolist()]
        for s0 in range(0, len(ts), chunk):
            y, rows = self._scan_chunk(step, errs, y, ts[s0:s0 + chunk],
                                       dts[s0:s0 + chunk], verified)
            parts.append(rows)
        self.final_solution = keep(y)
        rows = [r for part in parts for r in part]
        for k, row_slots in enumerate(rows):
            t = float(pp.start_t if k == 0 else ts[k - 1] + dts[k - 1])
            for slot, e in enumerate(row_slots):
                row = (k, t) + tuple(float(x) for x in e)
                self.rows[slot].append(row)
                if self.verbose:
                    print("%5d %8.5f %14.8e %14.8e %14.8e" % row)
        return self.rows

    # the chunk loop, shared with the advection problem (``problems.scan``)
    _scan_chunk = staticmethod(scan.scan_chunk)

    def _check_data_functions(self):
        """On a CUDA run: each data function, called on device points,
        gives a tensor on the run's device (``scan.check_data_functions``)."""
        scan.check_data_functions(
            self.params, ("function_rhs", "function_interface_dbc",
                          "function_domain_dbc", "exact_solution"),
            self.grid.dim, self.device, self.dtype)

    def _scan_explicit(self, heat: bool):
        """(step, y0, slots, keep, verified) of the explicit RK4 loop on
        one region or on both coupled: the state's error slots, its final
        solution and the solves whose device fallback counters the
        chunks read (those with a device form)."""
        pp = self.params
        one = not pp.composite
        ops = (self.op_in,) if one else (self.op_in, self.op_out)
        vss = tuple(self._mass_solver(o) for o in ops)
        if not one:
            self.mass_solvers = vss
        self.mass_solver = vss[0]
        solves = tuple(scan.scan_solve(v) for v in vss)
        rhss = tuple(self._rhs_fn(o) for o in ops)
        n = len(ops)
        u0 = self.interpolate_exact(pp.start_t)
        tau = 0.5 * pp.nitsche_parameter
        couple = not one and pp.function_interface_dbc is None

        def rhs(us, t):
            rs = tuple(r(u, t) for r, u in zip(rhss, us))
            if couple:
                rs = _interface_coupling(self.op_in, *rs, *us, tau)
            return rs

        if self._kernel_route():
            rhs((u0,) * n, pp.start_t)   # moves the RHS's tables to the card

        if heat:
            def f(t, y):
                return tuple(s(r) for s, r in zip(solves, rhs(y, t)))
            y0 = (u0,) * n
        else:
            def f(t, y):
                return y[n:] + tuple(s(r) for s, r in
                                     zip(solves, rhs(y[:n], t)))
            y0 = (u0,) * n + (self._zeros(),) * n

        def step(y, t, dt):
            return timestepping.rk_step(f, t, dt, y)

        slots = lambda y: y[:n]  # noqa: E731
        keep = (lambda y: y[0]) if one else slots
        return step, y0, slots, keep, scan.verified(vss, solves)

    def _scan_heat_impl(self, dts):
        """(step, u0, slots, keep) of implicit Euler with gdm's run_scan
        body: b = dt rhs + M u, solved from x0 = u by Jacobi CG on
        M + dt S (on the card in 2D as K2 in one-band mode on its band,
        one band and one Jacobi band per distinct dt)."""
        pp = self.params
        op = self.op_in
        mdiag = op.mass_diagonal(pp.ghost_parameter_M)
        sdiag = self._stiffness_diag() - 1.0 * op.inactive
        tols = (pp.solver_max_iterations, pp.solver_rel_tolerance,
                pp.solver_abs_tolerance)
        u0 = self.interpolate_exact(pp.start_t)
        step_sizes = sorted(set(float(d) for d in dts))
        if self._kernel_route():
            from ..ops import resident
            from ..ops.cutband import band_planes, layout_for

            systems = {dt: self._heat_system_band(dt) for dt in step_sizes}
            lay = layout_for(self.grid, max(st.radius
                                            for st in systems.values()))
            self.heat_bands = {
                dt: (band_planes(st, lay, self.device, self.dtype),
                     resident.jacobi_band(mdiag + dt * sdiag, self.grid,
                                          self.device, self.dtype, lay))
                for dt, st in systems.items()}
            self._heat_rhs(u0, pp.start_t, step_sizes[0])  # moves tables

            def solve(b, u, dt):
                A, P = self.heat_bands[dt]
                x, _ = resident.resident_cg(lay.pad(b), lay.pad(u), A,
                                            None, None, *tols, P=P)
                return lay.unpad(x)
        else:
            pres = {dt: solvers.jacobi_preconditioner(torch.as_tensor(
                mdiag + dt * sdiag, dtype=self.dtype, device=self.device))
                for dt in step_sizes}

            def solve(b, u, dt):
                pre = pres[dt]
                x, _ = solvers.cg(
                    lambda v: self._heat_system_apply(v, dt), b, x0=u,
                    precond=pre, max_iter=tols[0], rel_tol=tols[1],
                    abs_tol=tols[2])
                return x

        def step(u, t, dt):
            # x0 = u: gdm's run_scan warm start (the reference's SolverCG
            # starts from the incoming solution vector, problem.h:269)
            return solve(self._heat_rhs(u, t + dt, dt), u, dt)

        return step, u0, lambda u: (u,), lambda u: u


def _write_step_vtu(problem: "WaveProblem", sol, t, path: str,
                    location=INSIDE):
    """One postprocess-step VTU: solution + level_set + analytical_solution
    over the subdomain's cells (reference problem.h:617-657)."""
    from ..io import DataOut

    pp = problem.params
    # reference problem.h:618 builds DataOut with the (possibly
    # deformed) mapping: patch points land in deformed space
    out = DataOut(problem.grid, pp.output_fe_degree,
                  mapping_fn=pp.mapping_q_cache_function,
                  geometry=pp.mapping_geometry)
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
