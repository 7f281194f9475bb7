"""Cut advection application: single-domain and composite two-domain
problems with RK-evolved boundary conditions.

Port of gdm/problems/advection.py (the reference's applications/
advection/: problem.h, advection-app.cc, advection-convergence.cc):
upwind embedded fluxes, boundary values as extra ODE blocks, a mass
solve per stage and region, 6-column error rows (volume and surface
L2/L1/Linf).

The mass solves follow gdm's dispatch on whether its fused kernels are
there, read as the device asked for (``cut.stencil.kernel_route``): a
CUDA run of a 2D grid takes gdm's TPU branch, the verified FSAI solver
(K2, checked per solve, the streamed Schwarz CG over K1 as fallback);
any other run takes gdm's CPU branch, Schwarz-preconditioned CG over the
band apply.  ``run_scan`` is gdm's whole-trajectory loop with its
checkpointing: on the card in 2D a chunk of steps is kernel launches
and tensor ops alone, the mass solves through the verified solver's
device form, one host read a chunk (``problems.scan``).

Function convention: ``exact_solution`` and ``exact_solution_der`` take
(pts, t), pts an array of physical points shaped (..., dim) and t a
Python float.  The operators call them on their point tables, torch
tensors on the run's device; ``interpolate_exact`` on numpy points.  The
cases here take both and return the same kind (gdm's return jnp).
Entry points run on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import checkpoint
from .. import device as _device
from .. import profiling, solvers, timestepping
from ..cut.advection import AdvectionOperators
from ..cut.geometry import INSIDE, OUTSIDE, CutGeometry
from ..cut.operators import CutOperators, _like
from ..grid import Grid
from . import scan


@dataclasses.dataclass
class AdvectionParams:
    """Mirror of applications/advection/include/gdm/advection/parameters.h."""

    fe_degree: int = 3
    n_components: int = 1
    composite: bool = False
    n_subdivisions_1D: int = 40
    geometry_left: float = 0.0
    geometry_right: float = 1.0
    ghost_parameter_M: float = 0.5
    ghost_parameter_A: float = 0.5
    exact_solution: Optional[Callable] = None
    exact_solution_der: Optional[Callable] = None
    start_t: float = 0.0
    end_t: float = 0.1
    cfl: float = 0.4
    solver_max_iterations: int = 1000
    solver_abs_tolerance: float = 1e-20
    solver_rel_tolerance: float = 1e-14
    max_val: float = 2.0
    advection: tuple = (1.0, 0.0)
    advection_1: tuple = (0.0, 0.0)
    # strong nodal Dirichlet BC on the lower (inflow) surfaces instead of
    # the weak upwind flux (prototypes/advection_02_gdm.cc:148,207-216,
    # alpha=1.0 path); non-composite only
    strong_bc: bool = False
    level_set_fe_degree: int = 1
    level_set_function: Optional[Callable] = None
    dim: int = 2


def _sin(x):
    return torch.sin(x) if isinstance(x, torch.Tensor) else np.sin(x)


def _cos(x):
    return torch.cos(x) if isinstance(x, torch.Tensor) else np.cos(x)


def plane_signed_distance(point, normal):
    n = np.asarray(normal) / np.linalg.norm(normal)
    p0 = np.asarray(point)

    def fn(mesh_list):
        return sum(
            (np.asarray(m) - p0[d]) * n[d] for d, m in enumerate(mesh_list)
        )

    return fn


def convergence_case(fe_degree: int, n_subdivisions_1D: int, cfl: float,
                     factor_rotation: float, factor: float) -> AdvectionParams:
    """Setup of advection-convergence.cc:123-185 ("DoD stabilization"
    rotated-ramp convergence study).  Its data functions take numpy
    points (and give numpy) or tensor points (and give tensors on the
    points' device)."""
    increment = 5.0
    phi = (np.pi * increment / 180.0) * factor
    phi_add = (np.pi * increment / 180.0) * factor_rotation
    x_shift = 0.2001
    a = (2.0 * np.cos(phi + phi_add), 2.0 * np.sin(phi + phi_add))
    c, s = float(np.cos(phi)), float(np.sin(phi))
    k = math.sqrt(2.0) * math.pi

    def x_hat(pts, t):
        pos0 = pts[..., 0] - t * a[0]
        pos1 = pts[..., 1] - t * a[1]
        return c * (pos0 - x_shift) + s * pos1

    def exact(pts, t):
        return _sin(k * x_hat(pts, t) / (1.0 - x_shift))

    def exact_der(pts, t):
        return (
            _cos(k * x_hat(pts, t) / (1.0 - x_shift))
            * (k / (1.0 - x_shift))
            * (c * (-a[0]) + s * (-a[1]))
        )

    p = AdvectionParams(
        fe_degree=fe_degree,
        n_subdivisions_1D=n_subdivisions_1D,
        geometry_left=0.0,
        geometry_right=1.0,
        ghost_parameter_M=0.5,
        ghost_parameter_A=0.5,
        start_t=0.0,
        end_t=0.1,
        cfl=cfl,
        max_val=2.0,
        advection=a,
        exact_solution=exact,
        exact_solution_der=exact_der,
        level_set_fe_degree=1,
        level_set_function=plane_signed_distance(
            (x_shift, 0.0), (np.sin(phi), -np.cos(phi))
        ),
        dim=2,
    )
    return p


def composite_app_case() -> AdvectionParams:
    """Setup of advection-app.cc:86-154 (composite "DoD" case).  Its
    data functions take numpy points or tensor points, as
    ``convergence_case``'s."""
    factor = 27.0
    increment = 5.0
    phi = (np.pi * increment / 180.0) * factor
    x_shift = 0.25

    def exact(pts, t):
        d2 = (pts[..., 0] + 0.3) ** 2 + (pts[..., 1] + 0.3) ** 2
        if isinstance(pts, torch.Tensor):
            return torch.clamp(0.3 - torch.sqrt(d2), min=0.0)
        return np.maximum(0.0, 0.3 - np.sqrt(d2))

    def exact_der(pts, t):
        if isinstance(pts, torch.Tensor):
            return pts.new_zeros(pts.shape[:-1])
        return np.zeros(np.shape(pts)[:-1])

    return AdvectionParams(
        fe_degree=5,
        composite=True,
        n_subdivisions_1D=200,
        geometry_left=-1.0,
        geometry_right=1.0,
        ghost_parameter_M=0.5,
        ghost_parameter_A=0.5,
        start_t=0.0,
        end_t=0.6,
        cfl=0.2,
        max_val=4.0,
        advection=(3.0, 1.0),
        advection_1=(1.0, 2.0),
        exact_solution=exact,
        exact_solution_der=exact_der,
        level_set_fe_degree=1,
        level_set_function=plane_signed_distance(
            (x_shift, 0.0), (np.sin(phi), -np.cos(phi))
        ),
        dim=2,
    )


ROW_FORMAT = "%5d %8.5f %14.8e %14.8e %14.8e | %14.8e %14.8e %14.8e"


class AdvectionProblem:
    """Cut advection solver (reference: applications/advection/), on
    ``device`` in ``dtype``.

    ``mesh``: optional ``gdm_torch.dist.mesh.Mesh`` (``device_mesh(n)``;
    anything else raises TypeError).  When given, the mass solves take
    gdm's mesh route on every device: no verified solver; CG with the
    cut-window Schwarz-Jacobi preconditioner (``solvers.cg``) over the
    band apply domain-decomposed along grid axis 0 with a halo exchange
    (``dist.cut.sharded_stencil_apply``: K1 on each CUDA shard of a 2D
    grid, the plain tap loop elsewhere); the upwind flux and boundary
    terms and the CG's vectors stay whole on ``device``.  Shards may
    share a card (a mesh of more slots than cards).  ``run_scan`` with
    a mesh runs the same host CG, so its chunks read the card inside
    every solve.  ``rows`` holds the postprocess rows
    (counter, t, L2, L1, Linf, surface L2, L1, Linf) per location slot;
    ``_solver_meta`` the routing of each region's verified mass solver
    (``loc``, ``path``, ``probe``; one entry a region); ``mass_solvers``
    the mass solves of the latest run (one a region; built at the first
    run and kept for later runs at the same solver parameters).
    """

    def __init__(self, params: AdvectionParams, verbose: bool = False,
                 mesh=None, *, device="cuda", dtype=torch.float32):
        if mesh is not None:
            from ..dist.mesh import check_mesh

            check_mesh(mesh)
        self.device = _device.resolve(device)
        self.dtype = _device.resolve_dtype(dtype)
        self.params = params
        self.verbose = verbose
        self.mesh = mesh
        pp = params
        dim = pp.dim
        self.grid = Grid(
            pp.fe_degree,
            (pp.n_subdivisions_1D,) * dim,
            (pp.geometry_left,) * dim,
            (pp.geometry_right,) * dim,
        )
        with profiling.span("setup.geometry"):
            self.geo = CutGeometry.build(
                self.grid, pp.level_set_function, pp.level_set_fe_degree
            )
        self.dx = (pp.geometry_right - pp.geometry_left) / pp.n_subdivisions_1D
        with profiling.span("setup.operators", region="inside"):
            self.op_in = CutOperators(self.geo, INSIDE)
            self.adv_in = AdvectionOperators(self.op_in, pp.advection)
        self.op_out = self.adv_out = None
        if pp.composite:
            with profiling.span("setup.operators", region="outside"):
                self.op_out = CutOperators(self.geo, OUTSIDE)
                self.adv_out = AdvectionOperators(self.op_out, pp.advection_1)
        self.rows = {0: [], 1: []}
        # measured routing decisions of the verified mass solvers
        # (per-domain path + probe evidence), for rows/artifacts
        self._solver_meta = []
        self.mass_solvers = ()
        self._empty = torch.empty(0, dtype=self.dtype, device=self.device)
        self._mass_cache = {}

    def interpolate_exact(self, t):
        mesh = self.grid.node_coords_mesh()
        pts = np.stack(mesh, axis=-1)
        vals = self.params.exact_solution(pts, t)
        return torch.as_tensor(np.array(vals, np.float64).reshape(-1),
                               dtype=self.dtype, device=self.device)

    def _kernel_route(self) -> bool:
        """gdm's test for its fused kernels, read as the device asked
        for (``cut.stencil.kernel_route``)."""
        from ..cut import stencil

        return stencil.kernel_route(self.grid, self.device)

    def _mass_solver(self, op):
        """The mass solve of ``op``'s region, built once per problem and
        solver parameters (a later run reuses it: on the card its set-up,
        the FSAI factors, the Schwarz band and the probe, takes ~9 s a
        region at the DoD size; span ``setup.mass_solver``)."""
        pp = self.params
        key = (op is self.op_in, pp.ghost_parameter_M,
               pp.solver_max_iterations, pp.solver_rel_tolerance,
               pp.solver_abs_tolerance)
        if key not in self._mass_cache:
            with profiling.span("setup.mass_solver", region=scan.region(op)):
                self._mass_cache[key] = self._build_mass_solver(op)
        return self._mass_cache[key]

    def _build_mass_solver(self, op):
        pp = self.params
        gm = pp.ghost_parameter_M
        from ..cut.stencil import (assemble_stencil,
                                   schwarz_jacobi_preconditioner)

        with profiling.span("setup.mass_solver.assemble"):
            st = assemble_stencil(op, "mass", gm)
        K = 2 * (op.grid.degree + 1) + 1
        if self.mesh is not None:
            from ..dist.cut import sharded_stencil_apply

            apply_fn = sharded_stencil_apply(st, self.mesh)
            # cut-window Schwarz: point-Jacobi CG stalls on the
            # near-singular GP'd cut mass matrix of badly cut p=5
            # configurations (the reference leans on ILU here,
            # parameters.h:32)
            pre = schwarz_jacobi_preconditioner(st, op.w_cut,
                                                dtype=self.dtype)

            def solve(b):
                x, _ = solvers.cg(
                    apply_fn, b, precond=pre,
                    max_iter=pp.solver_max_iterations,
                    abs_tol=pp.solver_abs_tolerance,
                    rel_tol=pp.solver_rel_tolerance,
                )
                return x

            return solve
        if self._kernel_route():
            # gdm's TPU branch: probe-routed, true-residual-verified
            # resident FSAI-CG (K2) with the streamed Schwarz CG over K1
            # as fallback (cut/fsai.py).  gdm found the float32 resident
            # solve's recurrence residual passing 1e-6 while the true
            # residual grows on the DoD composite's p=5 GP'd cut mass;
            # the probe and the per-solve check catch that here too.
            from ..cut.fsai import verified_fsai_solver

            vs = verified_fsai_solver(
                st, windows=op.w_cut,
                max_iter=pp.solver_max_iterations,
                rel_tol=pp.solver_rel_tolerance,
                abs_tol=pp.solver_abs_tolerance,
                device=self.device, dtype=self.dtype,
            )
            scan.note_routing(self._solver_meta, op, vs)
            return vs

        if op.grid.n_nodes * K**op.grid.dim <= 3e7:
            from ..cut.fastapply import fast_stencil_apply

            apply_fn = fast_stencil_apply(
                st, op, "mass", device=self.device,
                dtype=self.dtype) or st.apply
        else:
            apply_fn = lambda v: op.mass_apply(v, gm)  # noqa: E731
        # cut-window Schwarz-preconditioned CG (the reference's ILU
        # role, parameters.h:32)
        pre = schwarz_jacobi_preconditioner(st, op.w_cut, dtype=self.dtype)

        def solve(b):
            x, _ = solvers.cg(
                apply_fn, b, precond=pre,
                max_iter=pp.solver_max_iterations,
                abs_tol=pp.solver_abs_tolerance,
                rel_tol=pp.solver_rel_tolerance,
            )
            return x

        return solve

    def _errs(self, u, t, slot):
        """(6,) tensor of (L2, L1, Linf, surface L2, L1, Linf) of slot
        ``slot``'s u at t, on u's device."""
        op, adv = ((self.op_in, self.adv_in) if slot == 0
                   else (self.op_out, self.adv_out))
        g = self.params.exact_solution
        return torch.cat([op.error_norms_tensor(u, g, t),
                          adv.surface_error_norms_tensor(u, g, t)])

    def _append_row(self, slot, counter, t, e):
        row = (counter, t) + tuple(float(x) for x in e)
        self.rows[slot].append(row)
        if self.verbose:
            print(ROW_FORMAT % row)

    def postprocess(self, t, u, location=INSIDE):
        slot = 0 if location == INSIDE else 1
        l2, l1, li, fl2, fl1, fli = self._errs(u, t, slot).tolist()
        self._append_row(slot, len(self.rows[slot]), t,
                         (l2, l1, li, fl2, fl1, fli))
        return (li, l1, l2, fli, fl1, fl2)

    def run(self):
        pp = self.params
        if pp.strong_bc and pp.composite:
            raise ValueError("strong_bc supports non-composite runs only "
                             "(as in the reference prototype)")
        delta_t = self.dx * pp.cfl / pp.max_val
        if pp.composite:
            return self._run_composite(delta_t)
        return self._run_single(delta_t)

    def _bc_values(self, adv: AdvectionOperators, t):
        """(bc_surf, bc_bdry) = exact solution at the collected points,
        tensors on the run's device (the data function called on the
        cached point tables)."""
        return self._bc_eval(adv, self.params.exact_solution, t)

    def _bc_der(self, adv: AdvectionOperators, t):
        return self._bc_eval(adv, self.params.exact_solution_der, t)

    def _bc_eval(self, adv, fn, t):
        ops = adv.ops
        like = self._empty

        def at(name, n):
            if not n:
                return like.new_zeros((0, 1))
            return _like(fn(ops.table(name, like), t), like)

        return (at("surf_phys_q", len(ops.cut_ids)),
                at("b_phys", len(ops.b_win)))

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.grid.n_nodes, dtype=self.dtype,
                           device=self.device)

    def _bdry_nodes(self):
        """Flat node indices on the lower surface of every axis (the
        reference constrains surfaces d*2, advection_02_gdm.cc:207-216)
        and their physical coordinates, as tensors on the run's device
        (built once)."""
        if not hasattr(self, "_bdry"):
            grid = self.grid
            mesh = grid.node_coords_mesh()
            mask = np.zeros(grid.nodes, dtype=bool)
            for d in range(grid.dim):
                sl = [slice(None)] * grid.dim
                sl[d] = 0
                mask[tuple(sl)] = True
            idx = np.where(mask.reshape(-1))[0]
            pts = np.stack([np.asarray(m).reshape(-1)[idx] for m in mesh],
                           axis=-1)
            self._bdry = (
                torch.as_tensor(idx, dtype=torch.int64, device=self.device),
                torch.as_tensor(pts, dtype=self.dtype, device=self.device))
        return self._bdry

    def _strong_f(self, msolve):
        """(f, gvals) of the strong-Dirichlet stage (advection_02_gdm.cc
        weak_bc=false, alpha=1.0): the stage vector's boundary nodes set
        to exact(t), the derivative zeroed there.  Out of place: the RK
        tableau still holds the stage vectors."""
        pp = self.params
        adv = self.adv_in
        bidx, bpts = self._bdry_nodes()

        def gvals(t):
            return _like(pp.exact_solution(bpts, t), bpts)

        def f(t, u):
            u0 = u.index_copy(0, bidx, gvals(t))
            k = msolve(adv.compute_rhs_strong(u0, pp.ghost_parameter_A))
            return k.index_fill(0, bidx, 0.0)

        return f, gvals

    def _run_single_strong(self, delta_t):
        """Strong-Dirichlet time loop: per RK stage the boundary nodes of
        the stage vector are overwritten with exact(t_stage), the stage
        derivative is zeroed there, and after each step the solution's
        boundary nodes are set to exact(t+dt) (constraints_dbc.distribute)."""
        pp = self.params
        msolve = self._mass_solver(self.op_in)
        self.mass_solvers = (msolve,)
        f, gvals = self._strong_f(msolve)
        bidx = self._bdry_nodes()[0]

        u = self.interpolate_exact(pp.start_t)
        err = self.postprocess(pp.start_t, u)
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        while (not time.is_at_end()) and err[2] < 1.0:
            t, dt = time.get_current_time(), time.get_next_step_size()
            u = timestepping.rk_step(f, t, dt, u).index_copy(
                0, bidx, gvals(t + dt))
            err = self.postprocess(t + dt, u)
            time.advance_time()
        self.u = u
        return self.rows

    def _run_single(self, delta_t):
        pp = self.params
        if pp.strong_bc:
            return self._run_single_strong(delta_t)
        adv = self.adv_in
        msolve = self._mass_solver(self.op_in)
        self.mass_solvers = (msolve,)

        def f(t, y):
            bs, bb, u = y
            dbs, dbb = self._bc_der(adv, t)
            r = adv.compute_rhs(u, bs, bb, pp.ghost_parameter_A)
            return (dbs, dbb, msolve(r))

        u = self.interpolate_exact(pp.start_t)
        err = self.postprocess(pp.start_t, u)
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        while (not time.is_at_end()) and err[2] < 1.0:
            t, dt = time.get_current_time(), time.get_next_step_size()
            bs, bb = self._bc_values(adv, t)
            bs, bb, u = timestepping.rk_step(f, t, dt, (bs, bb, u))
            err = self.postprocess(t + dt, u)
            time.advance_time()
        self.u = u
        return self.rows

    def _composite_f(self, solves):
        """The composite's RK right-hand side over (bb0, u0, bb1, u1):
        each block's upwind surface flux against the other block."""
        pp = self.params

        def f(t, y):
            bb0, u0, bb1, u1 = y
            _, dbb0 = self._bc_der(self.adv_in, t)
            _, dbb1 = self._bc_der(self.adv_out, t)
            r0 = self.adv_in.compute_rhs(u0, None, bb0, pp.ghost_parameter_A,
                                         u_other=u1)
            r1 = self.adv_out.compute_rhs(u1, None, bb1,
                                          pp.ghost_parameter_A, u_other=u0)
            return (dbb0, solves[0](r0), dbb1, solves[1](r1))

        return f

    def _run_composite(self, delta_t):
        pp = self.params
        solves = (self._mass_solver(self.op_in),
                  self._mass_solver(self.op_out))
        self.mass_solvers = solves
        f = self._composite_f(solves)

        u0 = self.interpolate_exact(pp.start_t)
        u1 = self.interpolate_exact(pp.start_t)
        err = self.postprocess(pp.start_t, u0, INSIDE)
        err = self.postprocess(pp.start_t, u1, OUTSIDE)
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        while (not time.is_at_end()) and err[2] < 1.0:
            t, dt = time.get_current_time(), time.get_next_step_size()
            _, bb0 = self._bc_values(self.adv_in, t)
            _, bb1 = self._bc_values(self.adv_out, t)
            bb0, u0, bb1, u1 = timestepping.rk_step(f, t, dt,
                                                    (bb0, u0, bb1, u1))
            err = self.postprocess(t + dt, u0, INSIDE)
            err = self.postprocess(t + dt, u1, OUTSIDE)
            time.advance_time()
        self.u0, self.u1 = u0, u1
        return self.rows

    # -- the whole trajectory -------------------------------------------
    def _schedule(self):
        """The DiscreteTime step sequence (times, step sizes) of
        :meth:`run`, precomputed on the host."""
        pp = self.params
        delta_t = self.dx * pp.cfl / pp.max_val
        time = timestepping.DiscreteTime(pp.start_t, pp.end_t, delta_t)
        ts, dts = [], []
        while not time.is_at_end():
            ts.append(time.get_current_time())
            dts.append(time.get_next_step_size())
            time.advance_time()
        return np.asarray(ts), np.asarray(dts)

    def run_scan(self, chunk: int = 128, checkpoint_path: str = None,
                 checkpoint_every: int = 1):
        """The whole time loop in chunks of ``chunk`` steps, gdm's
        device-resident counterpart of :meth:`run` (its ``lax.scan``
        chunks, gdm/problems/advection.py:409-600), for the weak-BC,
        strong-BC and composite bodies: the same step sizes, RK stages
        and error rows, without ``run()``'s divergence guard.  Populates
        and returns ``self.rows``.

        On a CUDA run of a 2D grid no operation inside a chunk waits on
        the card: the host walks the schedule and passes t and dt as
        Python floats, the mass solves run through the verified solver's
        device form (``VerifiedSolver.solve_device``), the boundary
        values come from the data functions on device point tables, and
        a chunk's error rows and the solvers' fallback counters are read
        once at its end.  A data function that gives anything but a
        tensor on the run's device raises ValueError there.  Elsewhere
        the solves are the host CG of ``run()``'s CPU branch.

        checkpoint_path: when set, the state and the error trajectory
        are written there after every ``checkpoint_every`` chunks (and
        after the last), atomically, in gdm's format (``checkpoint``),
        and an existing checkpoint is RESUMED from (at its
        ``meta["next_s"]``) instead of restarting the horizon; a
        checkpoint gdm wrote resumes here too.

        Spans (``profiling``): ``scan.call`` (``steps``, ``chunk``) over
        ``scan.prepare`` (the data functions' check, the schedule, the
        solvers at the first call, the first error rows, the
        checkpoint's load), the chunks (``scan.chunk``), each
        ``scan.checkpoint_save`` and ``scan.rows``.
        """
        pp = self.params
        if pp.strong_bc and pp.composite:
            raise ValueError("strong_bc supports non-composite runs only "
                             "(as in the reference prototype)")
        with profiling.span("scan.call") as call:
            with profiling.span("scan.prepare"):
                if self.device.type == "cuda":
                    scan.check_data_functions(
                        pp, ("exact_solution", "exact_solution_der"),
                        self.grid.dim, self.device, self.dtype)
                ts, dts = self._schedule()
                chunk = max(1, min(chunk, len(ts)))
                n_slots = 2 if pp.composite else 1
                ops = (self.op_in, self.op_out)[:n_slots]
                vss = tuple(self._mass_solver(o) for o in ops)
                self.mass_solvers = vss
                solves = tuple(scan.scan_solve(v) for v in vss)
                step, y = self._scan_body(solves)

                def errs(y, t):
                    us = y if pp.composite else (y,)
                    return torch.stack([self._errs(u, t, k)
                                        for k, u in enumerate(us)])

                parts = [errs(y, pp.start_t)[None].tolist()]  # moves tables
                start = 0
                if checkpoint_path and os.path.exists(checkpoint_path):
                    like = ((tuple(y) if pp.composite else (y,))
                            + (np.zeros(1),))
                    state, _, meta = checkpoint.load(checkpoint_path, like)
                    y = tuple(state[:2]) if pp.composite else state[0]
                    es_prev = np.asarray(state[-1], np.float64)
                    parts = [es_prev.reshape(len(es_prev), n_slots,
                                             -1).tolist()]
                    start = int(meta["next_s"])
                verified = scan.verified(vss, solves)
                call.set(steps=len(ts) - start, chunk=chunk)
            for ci, s in enumerate(range(start, len(ts), chunk)):
                y, rows = self._scan_chunk(step, errs, y, ts[s:s + chunk],
                                           dts[s:s + chunk], verified)
                parts.append(rows)
                end = min(s + chunk, len(ts))
                if checkpoint_path and ((ci + 1) % checkpoint_every == 0
                                        or end >= len(ts)):
                    with profiling.span("scan.checkpoint_save"):
                        es = np.asarray([r for part in parts for r in part])
                        checkpoint.save(
                            checkpoint_path,
                            (tuple(y) if pp.composite else (y,))
                            + (es if pp.composite else es[:, 0],),
                            float(ts[end - 1] + dts[end - 1]),
                            meta={"next_s": end})
            with profiling.span("scan.rows"):
                if pp.composite:
                    self.u0, self.u1 = y
                else:
                    self.u = y
                rows = [r for part in parts for r in part]
                for k, row_slots in enumerate(rows):
                    t = float(pp.start_t if k == 0
                              else ts[k - 1] + dts[k - 1])
                    for slot, e in enumerate(row_slots):
                        self._append_row(slot, k, t, e)
        return self.rows

    _scan_chunk = staticmethod(scan.scan_chunk)

    def _scan_body(self, solves):
        """(step, y0) of gdm's scan bodies: ``step(y, t, dt)`` one RK4
        step with the boundary values taken at t (composite: y = (u0,
        u1); weak BC: y = u, the surface and boundary values evolved
        through the stages; strong BC: y = u, the nodal constraint at
        each stage and after the step)."""
        pp = self.params
        u0 = self.interpolate_exact(pp.start_t)
        if pp.composite:
            f = self._composite_f(solves)
            for adv in (self.adv_in, self.adv_out):
                self._warm(adv, u0, True)

            def step(y, t, dt):
                _, bb0 = self._bc_values(self.adv_in, t)
                _, bb1 = self._bc_values(self.adv_out, t)
                _, u0, _, u1 = timestepping.rk_step(
                    f, t, dt, (bb0, y[0], bb1, y[1]))
                return (u0, u1)

            return step, (u0, u0)
        if pp.strong_bc:
            f, gvals = self._strong_f(solves[0])
            bidx = self._bdry_nodes()[0]
            gvals(pp.start_t)
            self.adv_in.compute_rhs_strong(u0, pp.ghost_parameter_A)

            def step(u, t, dt):
                return timestepping.rk_step(f, t, dt, u).index_copy(
                    0, bidx, gvals(t + dt))

            return step, u0
        adv = self.adv_in

        def f(t, y):
            bs, bb, u = y
            dbs, dbb = self._bc_der(adv, t)
            r = adv.compute_rhs(u, bs, bb, pp.ghost_parameter_A)
            return (dbs, dbb, solves[0](r))

        self._warm(adv, u0, False)

        def step(u, t, dt):
            bs, bb = self._bc_values(adv, t)
            return timestepping.rk_step(f, t, dt, (bs, bb, u))[2]

        return step, u0

    def _warm(self, adv, u, composite):
        """One right-hand side and one evaluation of each data function
        on ``adv``'s tables, at start_t: set-up moves every table they
        read to the device, so no chunk copies one."""
        pp = self.params
        bs, bb = self._bc_values(adv, pp.start_t)
        self._bc_der(adv, pp.start_t)
        adv.compute_rhs(u, None if composite else bs, bb,
                        pp.ghost_parameter_A, u_other=u if composite else None)
