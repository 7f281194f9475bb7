"""GD basis tables at arbitrary (per-cell) points — used for cut-cell
volume/surface quadrature and face terms."""

from __future__ import annotations

import numpy as np

from . import basis
from .grid import Grid


def cell_axis_categories(grid: Grid, flat_cell_ids: np.ndarray) -> np.ndarray:
    """(n, dim) per-axis categories for flat (axis-0-fastest) cell ids."""
    out = np.empty((len(flat_cell_ids), grid.dim), dtype=np.int64)
    rem = np.asarray(flat_cell_ids, dtype=np.int64).copy()
    for d in range(grid.dim):
        idx = rem % grid.cells[d]
        rem //= grid.cells[d]
        out[:, d] = grid.categories(d)[idx]
    return out


def cell_axis_indices(grid: Grid, flat_cell_ids: np.ndarray) -> np.ndarray:
    out = np.empty((len(flat_cell_ids), grid.dim), dtype=np.int64)
    rem = np.asarray(flat_cell_ids, dtype=np.int64).copy()
    for d in range(grid.dim):
        out[:, d] = rem % grid.cells[d]
        rem //= grid.cells[d]
    return out


def windows_c_order(grid: Grid, flat_cell_ids: np.ndarray) -> np.ndarray:
    """Dof windows (n, (p+1)^dim) as NODE indices into the C-order raveled
    field array u.reshape(nodes).  Local dof ordering axis-0-fastest
    (matching the reference, system.h:222-245)."""
    p = grid.degree
    idx = cell_axis_indices(grid, flat_cell_ids)
    dim = grid.dim
    # per-axis offsets
    offs = []
    for d in range(dim):
        offs.append(grid.offsets(d)[idx[:, d]])  # (n,)
    # C-order strides of the node array
    strides = [1] * dim
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * grid.nodes[d + 1]
    n = len(flat_cell_ids)
    m = (p + 1) ** dim
    win = np.zeros((n, m), dtype=np.int64)
    for loc in range(m):
        remloc = loc
        node = np.zeros(n, dtype=np.int64)
        for d in range(dim):
            ld = remloc % (p + 1)
            remloc //= p + 1
            node += (offs[d] + ld) * strides[d]
        win[:, loc] = node
    return win.astype(np.int32)


def basis_at_points(
    grid: Grid, cats: np.ndarray, pts_ref: np.ndarray, derivs=None
) -> np.ndarray:
    """Evaluate all (p+1)^dim cell shape functions at per-cell points.

    cats: (n, dim) per-axis categories; pts_ref: (n, Q, dim) reference
    points; derivs: per-axis derivative orders (default zeros).
    Returns (n, Q, m) with local dofs ordered axis-0-fastest.  Physical
    derivative scaling (1/h^deriv) IS included.
    """
    derivs = derivs if derivs is not None else (0,) * grid.dim
    p = grid.degree
    n, Q, dim = pts_ref.shape
    out = np.ones((n, Q, 1))
    for d in range(dim):
        # values of the p+1 1D functions for each cell's category at its pts
        vals = np.empty((n, Q, p + 1))
        for c in range(max(p, 1)):
            sel = cats[:, d] == c
            if not sel.any():
                continue
            vals[sel] = basis.shape_at(p, c, pts_ref[sel].reshape(-1, dim)[:, d],
                                       derivs[d]).reshape(-1, Q, p + 1)
        vals *= grid.h[d] ** (-derivs[d])
        # combine: local ordering axis-0-fastest => the new (higher) axis
        # must vary slower than everything accumulated so far
        out = (vals[:, :, :, None] * out[:, :, None, :]).reshape(n, Q, -1)
    return out


def gradients_at_points(grid: Grid, cats, pts_ref) -> np.ndarray:
    """(n, Q, dim, m) physical gradients."""
    outs = []
    for d in range(grid.dim):
        derivs = tuple(1 if e == d else 0 for e in range(grid.dim))
        outs.append(basis_at_points(grid, cats, pts_ref, derivs))
    return np.stack(outs, axis=2)
