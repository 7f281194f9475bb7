"""Structured GD grid: node/dof bookkeeping, stencil windows, categories.

TPU-native replacement for the reference's GDM::System (reference:
include/gdm/system.h:339-827).  There is no triangulation object: on a
structured tensor-product grid every quantity is pure index arithmetic.

Conventions
-----------
* A *field* is an array of shape ``(N_0, ..., N_{dim-1}, C)`` where
  ``N_d = cells[d] + 1`` is the number of node planes along axis d and C is
  the number of components.
* The reference's global dof numbering (lexicographic, axis 0 fastest,
  components interleaved; reference include/gdm/fe.h:339-397 and
  system.h:242-244) is only materialized when converting to/from flat
  "reference order" vectors for golden-output comparison.
* Per-cell stencil window along axis d starts at
  ``offset_d = 0 if i < p//2 else min(n_d, i + p//2 + 1) - p``
  (reference system.h:209-216) and the cell category along axis d is
  ``i if i < p//2 else (p//2 if i < n_d - p//2 else p + i - n_d)``
  (reference system.h:404-424).  The category equals ``i - offset_d``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def offsets_1d(n_cells: int, p: int) -> np.ndarray:
    """Stencil window start node per cell (1 axis)."""
    i = np.arange(n_cells)
    off = np.minimum(n_cells, i + p // 2 + 1) - p
    off = np.where(i < p // 2, 0, off)
    return off.astype(np.int32)


def categories_1d(n_cells: int, p: int) -> np.ndarray:
    """Cell category per cell (1 axis); equals i - offset."""
    i = np.arange(n_cells)
    cat = np.where(
        i < p // 2, i, np.where(i < n_cells - p // 2, p // 2, p + i - n_cells)
    )
    return cat.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Structured tensor-product GD grid."""

    degree: int
    cells: tuple
    lower: tuple
    upper: tuple
    n_components: int = 1

    def __post_init__(self):
        assert self.degree % 2 == 1, "GD degree must be odd"
        for n in self.cells:
            assert n >= self.degree, "need at least p cells per axis"

    # --- basic geometry -------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.cells)

    @property
    def nodes(self) -> tuple:
        return tuple(n + 1 for n in self.cells)

    @property
    def h(self) -> tuple:
        return tuple(
            (u - l) / n for l, u, n in zip(self.lower, self.upper, self.cells)
        )

    @property
    def n_nodes(self) -> int:
        return int(np.prod(self.nodes))

    @property
    def n_dofs(self) -> int:
        return self.n_nodes * self.n_components

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cells))

    def node_coords_1d(self, axis: int) -> np.ndarray:
        return np.linspace(self.lower[axis], self.upper[axis], self.nodes[axis])

    def cell_lower_1d(self, axis: int) -> np.ndarray:
        return self.node_coords_1d(axis)[:-1]

    @property
    def field_shape(self) -> tuple:
        return self.nodes + (self.n_components,)

    # --- stencil bookkeeping -------------------------------------------
    def offsets(self, axis: int) -> np.ndarray:
        return offsets_1d(self.cells[axis], self.degree)

    def categories(self, axis: int) -> np.ndarray:
        return categories_1d(self.cells[axis], self.degree)

    @functools.cached_property
    def cell_windows(self) -> np.ndarray:
        """Flat (node-major, axis-0-fastest) dof window per cell.

        Returns int32 array of shape (n_cells, (p+1)^dim) giving, for every
        cell (cells enumerated axis-0-fastest like the reference's
        active-cell index), the *node* indices of its stencil window in the
        reference's lexicographic node numbering.  Within a cell, local dofs
        are ordered axis-0-fastest (reference system.h:222-245).
        """
        p = self.degree
        dim = self.dim
        per_axis_windows = []  # axis d: (n_cells_d, p+1) node index
        for d in range(dim):
            off = self.offsets(d)
            per_axis_windows.append(off[:, None] + np.arange(p + 1)[None, :])
        # node strides, axis 0 fastest
        strides = np.cumprod([1] + [self.nodes[d] for d in range(dim - 1)])
        # build by broadcasting: result[c0, c1, ..., m0, m1, ...]
        idx = 0
        for d in range(dim):
            w = per_axis_windows[d] * strides[d]  # (n_d, p+1)
            cell_shape = [1] * dim
            cell_shape[d] = self.cells[d]
            loc_shape = [1] * dim
            loc_shape[d] = p + 1
            idx = idx + w.reshape(cell_shape + loc_shape)
        # cells axis-0-fastest -> order (c_{dim-1}, ..., c_0) row-major;
        # same for local dofs
        perm = list(range(dim - 1, -1, -1)) + list(range(2 * dim - 1, dim - 1, -1))
        idx = np.transpose(idx, perm)
        return idx.reshape(self.n_cells, (p + 1) ** dim).astype(np.int32)

    @functools.cached_property
    def cell_category_ids(self) -> np.ndarray:
        """Combined category id per cell (base-p, axis 0 fastest; reference
        system.h:422), cells enumerated axis-0-fastest."""
        p = self.degree
        dim = self.dim
        cat = 0
        for d in range(dim):
            c = self.categories(d).astype(np.int64) * (p**d)
            shape = [1] * dim
            shape[d] = self.cells[d]
            cat = cat + c.reshape(shape)
        cat = np.transpose(cat, list(range(dim - 1, -1, -1)))
        return cat.reshape(self.n_cells).astype(np.int32)

    # --- reference-order (de)serialization -------------------------------
    def to_reference_vector(self, field: np.ndarray) -> np.ndarray:
        """Field (N_0,...,N_{dim-1},C) -> flat reference-ordered dof vector."""
        field = np.asarray(field)
        assert field.shape == self.field_shape, (field.shape, self.field_shape)
        perm = list(range(self.dim - 1, -1, -1)) + [self.dim]
        return np.transpose(field, perm).reshape(-1)

    def from_reference_vector(self, vec: np.ndarray) -> np.ndarray:
        vec = np.asarray(vec)
        assert vec.size == self.n_dofs
        shape = tuple(self.nodes[d] for d in range(self.dim - 1, -1, -1)) + (
            self.n_components,
        )
        arr = vec.reshape(shape)
        perm = list(range(self.dim - 1, -1, -1)) + [self.dim]
        return np.transpose(arr, perm)

    # --- masks ------------------------------------------------------------
    def boundary_mask(self, surfaces=None) -> np.ndarray:
        """Boolean mask over field shape: True on constrained boundary nodes.

        `surfaces` follows the reference convention (system.h:468-508):
        surface = 2*d + s with s=0 the lower and s=1 the upper plane along
        axis d.  None = all surfaces.
        """
        if surfaces is None:
            surfaces = range(2 * self.dim)
        mask = np.zeros(self.field_shape, dtype=bool)
        for surface in surfaces:
            d, s = divmod(surface, 2)
            sl = [slice(None)] * (self.dim + 1)
            sl[d] = 0 if s == 0 else self.nodes[d] - 1
            mask[tuple(sl)] = True
        return mask

    def node_coords_mesh(self) -> list:
        """List of dim arrays of shape nodes: coordinates of every node."""
        axes = [self.node_coords_1d(d) for d in range(self.dim)]
        return list(np.meshgrid(*axes, indexing="ij"))

    def eval_on_nodes(self, fn, t=None) -> np.ndarray:
        """Interpolate an analytic function onto the nodes.

        `fn(coords_list, component[, t])` -> array of shape nodes.
        Equivalent of GDM::VectorTools::interpolate (vector_tools.h:11-23).
        """
        mesh = self.node_coords_mesh()
        out = np.zeros(self.field_shape)
        for c in range(self.n_components):
            out[..., c] = _call_fn(fn, mesh, c, t)
        return out


def _call_fn(fn, coords, component, t):
    if t is None:
        return fn(coords, component)
    return fn(coords, component, t)
