"""Constraints as structured masks.

Port of gdm/constraints.py.  Dirichlet constraints are a boolean node
mask; periodicity along axis d makes the last node plane a copy of the
first (distribute) and folds the last plane's contributions back onto
the first (compress).  The masks are kept twice: as numpy arrays on the
host (``dirichlet_mask``, ``full_mask``, as in gdm) and as bool tensors
on ``device`` for the applies.  Every method returns a new tensor and
leaves its argument untouched, and accepts leading batch axes in front
of the field axes (N_0, ..., N_{dim-1}, C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as _device
from .grid import Grid


@dataclasses.dataclass
class Constraints:
    grid: Grid
    dirichlet_mask: np.ndarray  # bool field: True = Dirichlet-constrained
    periodic_axes: tuple = ()
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._any_dirichlet = bool(self.dirichlet_mask.any())
        self._any_full = bool(self.full_mask.any())
        self.dirichlet_t = torch.as_tensor(self.dirichlet_mask,
                                           device=self.device)
        self.full_t = torch.as_tensor(self.full_mask, device=self.device)
        # a 0-dim zero for torch.where: a Python 0.0 there costs a fill
        # kernel per call on a CUDA device; a 0-dim tensor takes the
        # other operand's dtype
        self._zero = torch.zeros((), device=self.device)

    # the builders run on the card unless device="cpu" is asked for
    @staticmethod
    def none(grid: Grid, device="cuda") -> "Constraints":
        return Constraints(grid, np.zeros(grid.field_shape, dtype=bool),
                           device=_device.resolve(device))

    @staticmethod
    def zero_boundary(grid: Grid, surfaces=None,
                      device="cuda") -> "Constraints":
        return Constraints(grid, grid.boundary_mask(surfaces),
                           device=_device.resolve(device))

    @staticmethod
    def periodic(grid: Grid, axes=None, device="cuda") -> "Constraints":
        axes = tuple(range(grid.dim)) if axes is None else tuple(axes)
        mask = np.zeros(grid.field_shape, dtype=bool)
        return Constraints(grid, mask, periodic_axes=axes,
                           device=_device.resolve(device))

    @property
    def full_mask(self) -> np.ndarray:
        """All constrained (non-free) dofs: Dirichlet + periodic slaves."""
        mask = self.dirichlet_mask.copy()
        for d in self.periodic_axes:
            sl = [slice(None)] * (self.grid.dim + 1)
            sl[d] = self.grid.nodes[d] - 1
            mask[tuple(sl)] = True
        return mask

    def _axis(self, d: int) -> int:
        """Field axis d, counted from the end (leading batch axes)."""
        return d - self.grid.dim - 1

    def _copy_first_to_last(self, u: torch.Tensor) -> torch.Tensor:
        u = u.clone()
        for d in self.periodic_axes:
            ax = self._axis(d)
            u.narrow(ax, u.shape[ax] - 1, 1).copy_(u.narrow(ax, 0, 1))
        return u

    # ------------------------------------------------------------------
    def distribute(self, u: torch.Tensor) -> torch.Tensor:
        """Set constrained entries from their masters (periodic copy,
        Dirichlet -> 0; use finalize_solution for inhomogeneous values)."""
        if self.periodic_axes:
            u = self._copy_first_to_last(u)
        if self._any_dirichlet:
            u = torch.where(self.dirichlet_t, self._zero, u)
        return u

    def compress(self, y: torch.Tensor) -> torch.Tensor:
        """Fold constrained-row contributions onto their masters (adjoint
        of distribute), then zero the constrained rows."""
        if self.periodic_axes:
            y = y.clone()
            for d in self.periodic_axes:
                ax = self._axis(d)
                y.narrow(ax, 0, 1).add_(y.narrow(ax, y.shape[ax] - 1, 1))
        if self._any_full:
            y = torch.where(self.full_t, self._zero, y)
        return y

    def constrain_operator(self, apply_fn):
        """Wrap an operator so it acts on the free subspace."""

        def wrapped(u):
            return self.compress(apply_fn(self.distribute(u)))

        return wrapped

    def constrain_rhs(self, b, apply_fn=None, values=None):
        """Eliminate constraints from a load vector.

        values: field of inhomogeneous Dirichlet values (optional); then
        b := b - A g  with g the constrained extension of the values.
        """
        if values is not None and apply_fn is not None:
            values = torch.as_tensor(values, dtype=b.dtype, device=b.device)
            g = torch.where(self.dirichlet_t, values, self._zero)
            b = b - apply_fn(g)
        return self.compress(b)

    def finalize_solution(self, x, values=None):
        """Insert constrained values into the solved free-dof vector."""
        if self.periodic_axes:
            x = self._copy_first_to_last(x)
        if values is None:
            if self._any_dirichlet:
                x = torch.where(self.dirichlet_t, self._zero, x)
            return x
        values = torch.as_tensor(values, dtype=x.dtype, device=x.device)
        return torch.where(self.dirichlet_t, values, x)
