"""Build the port's objects from another implementation's state.

The port's "weights" are its assembled operators.  These functions take
any objects that carry the same plain attributes as gdm's — a grid with
``degree/cells/lower/upper`` (and optionally ``n_components``), a
stencil operator with ``grid``, ``band_host`` and ``radius``, a
separable operator with ``grid`` and ``terms`` of (ci, cj, coeff, bands)
— and return the port's ``Grid``, ``StencilOperator`` and
``SeparableOperator`` over copies of the same numpy arrays, so two
implementations can be run on identical bands.  Nothing here imports the other implementation.
"""

from __future__ import annotations

import numpy as np

from .cut.stencil import StencilOperator
from .grid import Grid
from .ops.tensor import SeparableOperator


def grid_from(g) -> Grid:
    return Grid(int(g.degree), tuple(int(c) for c in g.cells),
                tuple(float(x) for x in g.lower),
                tuple(float(x) for x in g.upper),
                int(getattr(g, "n_components", 1)))


def stencil_from(st, grid: Grid = None) -> StencilOperator:
    """``grid`` (default: converted from ``st.grid``) lets several
    operators share one port Grid."""
    if grid is None:
        grid = grid_from(st.grid)
    return StencilOperator(grid, np.asarray(st.band_host, np.float64),
                           int(st.radius))


def separable_from(op, grid: Grid = None) -> SeparableOperator:
    """The port's float64 CPU SeparableOperator over copies of ``op``'s
    terms; ``grid`` as in ``stencil_from``."""
    if grid is None:
        grid = grid_from(op.grid)
    terms = [(int(ci), int(cj), float(co),
              tuple(np.array(b, dtype=np.float64) for b in bands))
             for (ci, cj, co, bands) in op.terms]
    return SeparableOperator(grid, terms)
