"""Uncut Poisson problem on the full hypercube (zero Dirichlet BC).

Port of gdm/problems/poisson.py: the matrix-free stiffness apply and
CG, in 2D and 3D on the card through the kernel gdm's dispatch picks
(ops.fast.best_field_laplace: K3 in 2D, K5 or K4 in 3D) for the CG
operator and every multigrid level.  ``solve`` and ``system`` run on
the card unless the caller passes ``device="cpu"``.

``system_deformed``/``solve_deformed`` solve on a vertex-deformed grid
(gdm_torch.deform): the deformed stiffness band, Dirichlet-condensed,
assembled on the host; on a CUDA tensor of a 2D grid its CG apply and
every level of the never-cut multigrid go through the cut-band kernel
(K1), elsewhere (the CPU, 3D) through the plain tap loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import device as _device
from .. import operators, solvers
from ..constraints import Constraints
from ..functional import load_vector
from ..grid import Grid
from ..ops.fast import best_field_laplace


@dataclasses.dataclass
class PoissonSystem:
    """The constrained system of one Poisson problem, ready for CG: the
    operator, the right-hand side and the preconditioner on the device.
    A deformed system also holds its condensed band (``band``), the map
    from the CG's flat vector to the field (``finalize``) and the host
    set-up's seconds by stage (``setup_s``)."""
    apply: object
    b: torch.Tensor
    precond: object
    constraints: Constraints
    finalize: object = None
    band: object = None
    setup_s: dict = dataclasses.field(default_factory=dict)

    def run(self, rel_tol: float = 1e-12, abs_tol: float = 1e-20,
            max_iter: int = 10000):
        x, info = solvers.cg(self.apply, self.b, precond=self.precond,
                             max_iter=max_iter, abs_tol=abs_tol,
                             rel_tol=rel_tol)
        finalize = self.finalize or self.constraints.finalize_solution
        return finalize(x), info


def system(grid: Grid, rhs_fn, precondition="jacobi", device="cuda",
           dtype=torch.float64) -> PoissonSystem:
    """Set up -Laplace(u) = f, u = 0 on the boundary (see ``solve``)."""
    device = _device.resolve(device)
    cons = Constraints.zero_boundary(grid, device=device)
    base_apply, _ = best_field_laplace(grid, device=device, dtype=dtype)
    b = cons.constrain_rhs(load_vector(grid, rhs_fn, device=device,
                                       dtype=dtype))
    if callable(precondition):
        precond = precondition
    elif precondition == "mg":
        from ..multigrid import PoissonMultigrid

        precond = PoissonMultigrid(grid, device, dtype).precondition
    elif precondition in ("jacobi", True):
        diag = np.where(cons.full_mask, 1.0,
                        operators.laplace(grid, device="cpu").diagonal())
        precond = solvers.jacobi_preconditioner(
            torch.as_tensor(diag, dtype=dtype, device=device))
    elif precondition in ("none", None, False):
        precond = None
    else:
        raise ValueError(f"unknown precondition {precondition!r}: use "
                         f"'jacobi', 'mg', 'none' or a callable")
    return PoissonSystem(cons.constrain_operator(base_apply), b, precond,
                         cons)


def solve(
    grid: Grid,
    rhs_fn,
    rel_tol: float = 1e-12,
    abs_tol: float = 1e-20,
    max_iter: int = 10000,
    precondition="jacobi",
    device="cuda",
    dtype=torch.float64,
):
    """Solve -Laplace(u) = f, u = 0 on the boundary, on ``device`` in
    ``dtype``.

    precondition: "jacobi" | "mg" (geometric multigrid V-cycle; mesh-
    independent ~7 CG iterations; requires even cell counts) | "none" |
    a prebuilt preconditioner callable (e.g. PoissonMultigrid(grid,
    device, dtype).precondition) to amortize setup across solves.

    Returns (solution field of shape grid.nodes + (1,), info dict with
    the CG's iterations and final recurrence residual as Python numbers).
    """
    return system(grid, rhs_fn, precondition, device, dtype).run(
        rel_tol, abs_tol, max_iter)


def system_deformed(grid: Grid, mapping_fn, rhs_fn, geometry: str = "q1",
                    precondition="jacobi", device="cuda",
                    dtype=torch.float64) -> PoissonSystem:
    """Set up Poisson with zero Dirichlet BC on a vertex-deformed grid
    (see ``solve_deformed``): the host assembly of gdm, then the band,
    the right-hand side and the preconditioner on ``device`` in
    ``dtype``.  ``setup_s`` holds the seconds of each host stage
    ("assembly", "dirichlet", "load", "preconditioner")."""
    from .. import deform
    from ..cut.stencil import routed_apply

    assert grid.n_components == 1
    device = _device.resolve(device)
    dtype = _device.resolve_dtype(dtype)
    setup_s = {}
    t0 = time.perf_counter()
    A = deform.laplace_band(grid, mapping_fn, geometry=geometry)
    t1 = time.perf_counter()
    cons = Constraints.zero_boundary(grid, device=device)
    mask = np.asarray(cons.full_mask).reshape(-1)
    Abc = deform.dirichlet_band(A, mask)
    t2 = time.perf_counter()
    b = np.asarray(deform.load_vector(grid, mapping_fn, rhs_fn,
                                      geometry=geometry))
    b[mask] = 0.0
    t3 = time.perf_counter()
    setup_s.update(assembly=t1 - t0, dirichlet=t2 - t1, load=t3 - t2)

    if callable(precondition):
        precond = precondition
    elif precondition == "mg":
        precond = deform.multigrid_preconditioner(Abc, device=device,
                                                  dtype=dtype)
    elif precondition in ("jacobi", True):
        K = 2 * A.radius + 1
        center = (K**grid.dim - 1) // 2
        diag = Abc.band_host.reshape(grid.n_nodes, -1)[:, center]
        precond = solvers.jacobi_preconditioner(
            torch.as_tensor(diag, dtype=dtype, device=device))
    elif precondition in ("none", None, False):
        precond = None
    else:
        raise ValueError(f"unknown precondition {precondition!r}: use "
                         f"'jacobi', 'mg', 'none' or a callable")
    setup_s["preconditioner"] = time.perf_counter() - t3
    nodes = grid.nodes
    return PoissonSystem(
        routed_apply(Abc), torch.as_tensor(b, dtype=dtype, device=device),
        precond, cons, finalize=lambda x: x.reshape(nodes + (1,)),
        band=Abc, setup_s=setup_s)


def solve_deformed(
    grid: Grid,
    mapping_fn,
    rhs_fn,
    geometry: str = "q1",
    rel_tol: float = 1e-12,
    abs_tol: float = 1e-20,
    max_iter: int = 10000,
    precondition="jacobi",
    device="cuda",
    dtype=torch.float64,
):
    """Poisson with zero Dirichlet BC on a vertex-deformed grid, on
    ``device`` in ``dtype``.

    The reference threads Parameters::mapping_q_cache_function through
    every wave-app assembly (wave/discretization.h:57-74); this is the
    uncut counterpart: gdm_torch.deform band operators, Dirichlet-
    condensed, solved by CG.  geometry="q1" matches MappingQCache(1)
    semantics (2nd-order cap); "exact" (beyond-reference) restores the
    full GD order.  precondition: "jacobi" | "mg" (Galerkin geometric
    V-cycle on the deformed band, ~15 iterations flat in n; needs even
    cell counts) | "none" | a prebuilt preconditioner callable (e.g.
    deform.multigrid_preconditioner(Abc) amortized across solves); any
    other value raises ValueError.

    Returns (solution field of shape grid.nodes + (1,), info dict with
    the CG's iterations and final recurrence residual as Python numbers).
    """
    return system_deformed(grid, mapping_fn, rhs_fn, geometry, precondition,
                           device, dtype).run(rel_tol, abs_tol, max_iter)
