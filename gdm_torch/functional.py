"""Nodal load vectors for analytic functions.

Port of gdm/functional.py.  The integrand is evaluated on the host in
float64 (numpy), integrated against the test functions in float64 on
``device`` and cast to ``dtype`` at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .grid import Grid
from .ops.tensor import integrate_to_nodes, quad_points_1d


def quad_mesh(grid: Grid, nq: int = None):
    pts = [quad_points_1d(grid, d, nq) for d in range(grid.dim)]
    return np.meshgrid(*pts, indexing="ij")


def load_vector(grid: Grid, fn, t=None, nq: int = None, device="cuda",
                dtype=torch.float64) -> torch.Tensor:
    """F_a = (phi_a, f) over the full domain, a field on ``device`` (the
    card unless ``device="cpu"`` is asked for).

    fn(coords_list, component[, t]) -> array over the quadrature mesh.
    """
    device = _device.resolve(device)
    mesh = quad_mesh(grid, nq)
    comps = []
    for c in range(grid.n_components):
        val = fn(mesh, c) if t is None else fn(mesh, c, t)
        comps.append(np.broadcast_to(np.asarray(val, dtype=np.float64),
                                     mesh[0].shape))
    F = torch.as_tensor(np.stack(comps, axis=-1), device=device)
    return integrate_to_nodes(F, grid, nq=nq).to(dtype)
