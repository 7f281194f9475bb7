"""Sharded uncut Poisson solver (capability parity with
tests/poisson_02_gdm.cc: a distributed, assembly-free solve whose
printed solution is invariant to the number of shards).

Port of gdm/dist/poisson.py.  gdm has two paths: ``"auto"`` jits the
single-controller operator on sharded inputs and lets XLA's SPMD
partitioner insert the halo exchanges, ``"shard_map"`` exchanges the
sharded axis's halos explicitly (``dist.halo``).  torch has no SPMD
partitioner, so both modes take the explicit halo path here.  The CG's
vectors are whole on the mesh's first slot's device, as gdm's single
controller sees them; only the axis-0 band applies are split.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import operators, solvers
from ..constraints import Constraints
from ..functional import load_vector
from ..grid import Grid
from ..ops.tensor import apply_banded
from .halo import banded_apply_sharded
from .mesh import Mesh, check_mesh

MODES = ("auto", "shard_map")


def solve(grid: Grid, rhs_fn, mesh: Mesh, mode: str = "shard_map",
          rel_tol: float = 1e-12, max_iter: int = 10000):
    """Solve -lap u = f, u = 0 on the boundary, sharded over the mesh's
    axis 'x', in float64 (gdm runs it under x64).  Returns (solution
    field of shape grid.nodes + (1,), info dict with the CG's iterations
    and residual), on the first slot's device."""
    if mode not in MODES:
        raise ValueError(mode)
    device = check_mesh(mesh).devices[0]
    dtype = torch.float64
    A = operators.laplace(grid, device=device, dtype=dtype)
    cons = Constraints.zero_boundary(grid, device=device)
    b = cons.constrain_rhs(load_vector(grid, rhs_fn, device=device,
                                       dtype=dtype))
    diag = np.where(cons.full_mask, 1.0, A.diagonal())

    def apply_fn(u):
        u = cons.distribute(u)
        out = [torch.zeros_like(u[..., 0])
               for _ in range(grid.n_components)]
        for (ci, cj, coeff, _), bands in zip(A.terms, A._bands):
            v = u[..., cj]
            # sharded axis 0 via explicit halo exchange
            v = banded_apply_sharded(v, bands[0], mesh, mesh.axis)
            for d in range(1, grid.dim):
                v = apply_banded(v, bands[d], d)
            out[ci] = out[ci] + coeff * v
        return cons.compress(torch.stack(out, dim=-1))

    pre = solvers.jacobi_preconditioner(
        torch.as_tensor(diag, dtype=dtype, device=device))
    x, info = solvers.cg(apply_fn, b, precond=pre, max_iter=max_iter,
                         rel_tol=rel_tol)
    return cons.finalize_solution(x), info
