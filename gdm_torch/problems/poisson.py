"""Uncut Poisson problem on the full hypercube (zero Dirichlet BC).

Port of gdm/problems/poisson.py: the matrix-free stiffness apply and
CG, in 2D and 3D on the card through the kernel gdm's dispatch picks
(ops.fast.best_field_laplace: K3 in 2D, K5 or K4 in 3D) for the CG
operator and every multigrid level.  ``solve`` and ``system`` run on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

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
    operator, the right-hand side and the preconditioner on the device."""
    apply: object
    b: torch.Tensor
    precond: object
    constraints: Constraints

    def run(self, rel_tol: float = 1e-12, abs_tol: float = 1e-20,
            max_iter: int = 10000):
        x, info = solvers.cg(self.apply, self.b, precond=self.precond,
                             max_iter=max_iter, abs_tol=abs_tol,
                             rel_tol=rel_tol)
        return self.constraints.finalize_solution(x), info


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


def solve_deformed(grid: Grid, mapping_fn, rhs_fn, **kwargs):
    """Poisson on a vertex-deformed grid (gdm.problems.poisson
    .solve_deformed) is not ported yet."""
    raise NotImplementedError(
        "solve_deformed needs the deformation module, gdm/deform.py, "
        "which is not ported yet")
