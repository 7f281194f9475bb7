"""Per-cell polynomial level-set interpolant.

The reference interpolates the analytic level set onto an FE_Q(p) field
(Gauss-Lobatto support points) and generates cut quadrature / cell
classification from that *polynomial* geometry, not the analytic one
(applications/wave/include/gdm/wave/discretization.h:80-97).  Matching
that is essential for reproducing golden error norms, so we do the same:
each cell carries the tensor-product Lagrange interpolant on GLL nodes.
"""

from __future__ import annotations

import numpy as np

from . import quadrature
from .grid import Grid


class LevelSetInterpolant:
    """Tensor GLL interpolant of an analytic function, per cell.

    nodal values stored as array of shape (n_0, q, n_1, q, ..., ) with
    q = degree+1 GLL points per axis (cell-major interleaved).
    """

    def __init__(self, grid: Grid, fn, degree: int):
        self.grid = grid
        self.degree = degree
        q = degree + 1
        self.q = q
        self.nodes = tuple(quadrature.gauss_lobatto_points(q))
        dim = grid.dim
        axes_pts = []
        for d in range(dim):
            lo = grid.cell_lower_1d(d)  # (n_d,)
            pts = lo[:, None] + np.asarray(self.nodes)[None, :] * grid.h[d]
            axes_pts.append(pts.reshape(-1))  # (n_d*q,)
        mesh = np.meshgrid(*axes_pts, indexing="ij")
        vals = np.asarray(fn(mesh), dtype=np.float64)
        # reshape to (n_0, q, n_1, q, ...)
        shape = []
        for d in range(dim):
            shape += [grid.cells[d], q]
        self.nodal = vals.reshape(shape)

    # -- evaluation ------------------------------------------------------
    def cell_nodal(self, cell_idx) -> np.ndarray:
        """Nodal tensor of one cell: shape (q,)*dim."""
        sl = []
        for d, i in enumerate(cell_idx):
            sl += [i, slice(None)]
        return self.nodal[tuple(sl)]

    def eval_matrix(self, pts, deriv=0) -> np.ndarray:
        """(n_pts, q) Lagrange eval matrix at reference points."""
        return quadrature.lagrange_eval_matrix(
            self.nodes, tuple(np.atleast_1d(pts)), deriv
        )

    def eval_cell(self, cell_idx, pts_ref: np.ndarray, deriv=None) -> np.ndarray:
        """Evaluate interpolant (or a mixed derivative w.r.t. *reference*
        coords) of one cell at points (n_pts, dim).  Returns (n_pts,)."""
        dim = self.grid.dim
        deriv = deriv if deriv is not None else (0,) * dim
        nod = self.cell_nodal(cell_idx)  # (q,)*dim
        pts_ref = np.atleast_2d(pts_ref)
        # vectorized over points: per-axis evaluation matrices (P, q),
        # contracted against the nodal tensor
        v = nod[None, ...]  # (1, q, q, ...)
        for d in range(dim):
            E = self.eval_matrix(tuple(pts_ref[:, d]), deriv[d])  # (P, q)
            # contract current leading nodal axis (axis 1) with E
            v = np.einsum("pq,pq...->p...", E, v) if v.shape[0] > 1 else \
                np.einsum("pq,xq...->p...", E, v)
        return v

    def gradient_phys(self, cell_idx, pts_ref: np.ndarray) -> np.ndarray:
        """Physical-space gradient at reference points: (n_pts, dim)."""
        dim = self.grid.dim
        g = np.empty((len(np.atleast_2d(pts_ref)), dim))
        for d in range(dim):
            deriv = tuple(1 if e == d else 0 for e in range(dim))
            g[:, d] = self.eval_cell(cell_idx, pts_ref, deriv) / self.grid.h[d]
        return g

    def line_nodal(self, cell_idx, height_axis: int, base_ref) -> np.ndarray:
        """Restrict to a line of constant base coords: returns (q,) nodal
        values along `height_axis` GLL nodes.

        base_ref: reference coordinates of the non-height axes, given as a
        dict axis->coord or (for 2D) a scalar for the single base axis.
        """
        dim = self.grid.dim
        nod = self.cell_nodal(cell_idx)
        # contract all axes except height_axis
        v = nod
        # process axes in decreasing order to keep indices stable
        for d in range(dim - 1, -1, -1):
            if d == height_axis:
                continue
            coord = base_ref[d] if hasattr(base_ref, "__getitem__") else base_ref
            E = self.eval_matrix((coord,), 0)
            v = np.moveaxis(v, d, -1) @ E[0]
        return v
