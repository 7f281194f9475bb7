"""Builders for uncut (full-domain) GD operators as SeparableOperators.

Port of gdm/operators.py: the same Kronecker factors of banded 1D
matrices (host numpy, gdm_torch/ops1d.py), applied in torch on
``device`` in ``dtype``.  Every builder runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from . import device as _device
from .grid import Grid
from .ops.tensor import SeparableOperator
from .ops1d import assemble_1d

F64 = torch.float64


def _per_axis(grid: Grid, kind_per_axis, nq=None):
    return [assemble_1d(grid.degree, grid.cells[d], grid.h[d], *kind_per_axis[d],
                        nq)
            for d in range(grid.dim)]


def mass(grid: Grid, nq: int = None, device="cuda",
         dtype=F64) -> SeparableOperator:
    """(v, u) per component."""
    bands = _per_axis(grid, [(0, 0)] * grid.dim, nq)
    terms = [(c, c, 1.0, bands) for c in range(grid.n_components)]
    return SeparableOperator.from_banded(grid, terms, device, dtype)


def laplace(grid: Grid, nq: int = None, device="cuda",
            dtype=F64) -> SeparableOperator:
    """(grad v, grad u) per component."""
    terms = []
    for c in range(grid.n_components):
        for d in range(grid.dim):
            kinds = [(1, 1) if e == d else (0, 0) for e in range(grid.dim)]
            terms.append((c, c, 1.0, _per_axis(grid, kinds, nq)))
    return SeparableOperator.from_banded(grid, terms, device, dtype)


def advection(grid: Grid, velocity, nq: int = None, device="cuda",
              dtype=F64) -> SeparableOperator:
    """(v, a . grad u) per component, constant velocity vector ``a``."""
    terms = []
    for c in range(grid.n_components):
        for d in range(grid.dim):
            if velocity[d] == 0.0:
                continue
            kinds = [(0, 1) if e == d else (0, 0) for e in range(grid.dim)]
            terms.append((c, c, float(velocity[d]),
                          _per_axis(grid, kinds, nq)))
    return SeparableOperator.from_banded(grid, terms, device, dtype)


def lumped_mass_inverse_diagonal(grid: Grid, nq: int = None, device="cuda",
                                 dtype=F64) -> torch.Tensor:
    """Inverted row-sum (lumped) mass matrix as a diagonal field:
    diag[i] = 1 / sum_j M[i, j], computed matrix-free as 1 / (M @ ones)."""
    device = _device.resolve(device)
    M = mass(grid, nq, device, dtype)
    ones = torch.ones(grid.field_shape, dtype=dtype, device=device)
    return 1.0 / M.apply(ones)


def elasticity(grid: Grid, nq: int = None, device="cuda",
               dtype=F64) -> SeparableOperator:
    """2 (eps(v), eps(u)) for a dim-component displacement field (the
    symmetric-gradient form; see gdm/operators.py::elasticity)."""
    dim = grid.dim
    if grid.n_components != dim:
        raise ValueError(f"elasticity needs {dim} components, the grid has "
                         f"{grid.n_components}")
    terms = []
    # 2 * sum_i (d_i v_i)(d_i u_i)
    for i in range(dim):
        kinds = [(1, 1) if e == i else (0, 0) for e in range(dim)]
        terms.append((i, i, 2.0, _per_axis(grid, kinds, nq)))
    # cross terms: for i != j, (d_j v_i + d_i v_j)(d_j u_i + d_i u_j)
    for i in range(dim):
        for j in range(dim):
            if i == j:
                continue
            # (d_j v_i)(d_j u_i)
            kinds = [(1, 1) if e == j else (0, 0) for e in range(dim)]
            terms.append((i, i, 1.0, _per_axis(grid, kinds, nq)))
            # (d_j v_i)(d_i u_j): test derivative along j, trial along i
            kinds = [(1 if e == j else 0, 1 if e == i else 0)
                     for e in range(dim)]
            terms.append((i, j, 1.0, _per_axis(grid, kinds, nq)))
    return SeparableOperator.from_banded(grid, terms, device, dtype)
