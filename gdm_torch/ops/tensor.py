"""Tensor-product (sum-factorization) GD operators in torch.

Port of gdm/ops/tensor.py.  All uncut GD operators factor over axes;
the device work is width-(2p+1) stencil sweeps along each grid axis
plus small per-axis contractions:

* ``apply_banded``       - banded 1D matvec along one axis of a field
* ``SeparableOperator``  - sums of Kronecker terms (mass, Laplace,
                           advection, elasticity blocks, ...)
* ``evaluate_at_quad``   - field -> values/derivatives on the tensor
                           quadrature grid (sum-factorized gather)
* ``integrate_to_nodes`` - adjoint: quadrature-grid integrand -> nodal
                           load vector (the (v, f) functional)

Fields have shape (N_0, ..., N_{dim-1}, C) as in gdm.  ``apply`` also
takes leading batch axes, (..., N_0, ..., N_{dim-1}, C), which the
multigrid uses to build its dense coarse operator in one call.  This is
the plain path of the 2D and 3D Laplace kernels (gdm_torch/ops/stencil2.py,
stencil3.py): their torch twins are built from ``apply_banded``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import basis, quadrature
from .. import device as _device
from ..grid import Grid


def apply_banded(u: torch.Tensor, band: torch.Tensor, axis: int):
    """Apply a banded 1D matrix along ``axis`` of ``u``.

    band: (N, 2p+1) with band[a, k] = entry (a, a+k-p), on u's device and
    dtype.  Equivalent to gdm's zero padding followed by one sliced
    multiply-add per tap: each tap adds only over the rows whose
    neighbour a+k-p lies inside [0, N), the rest would add band * 0.
    """
    axis = axis % u.ndim
    N, W = band.shape
    p = (W - 1) // 2
    y = torch.zeros_like(u)
    bshape = [1] * u.ndim
    for k in range(W):
        d = k - p
        lo, hi = max(0, -d), min(N, N - d)
        if hi <= lo:
            continue
        bshape[axis] = hi - lo
        coef = band[lo:hi, k].reshape(bshape)
        # in place into this call's own output
        y.narrow(axis, lo, hi - lo).addcmul_(coef,
                                             u.narrow(axis, lo + d, hi - lo))
    return y


@dataclasses.dataclass
class SeparableOperator:
    """Operator  A = sum_t coeff_t * (B_t^0 (x) ... (x) B_t^{d-1})  acting on
    fields of shape (N_0, ..., N_{d-1}, C) with a component map (ci, cj):
    term reads component cj, accumulates into component ci.

    ``terms`` holds the bands as float64 numpy arrays (the host copy, as
    gdm keeps them); the apply uses copies on ``device`` in ``dtype``.
    """

    grid: Grid
    # each term: (ci, cj, coeff, tuple of (N_d, 2p+1) band arrays)
    terms: list
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._bands = [
            tuple(torch.as_tensor(b, dtype=self.dtype, device=self.device)
                  for b in bands)
            for (_, _, _, bands) in self.terms
        ]

    @staticmethod
    def from_banded(grid: Grid, terms, device="cuda",
                    dtype=torch.float64) -> "SeparableOperator":
        """terms: list of (ci, cj, coeff, [Banded1D per axis]); on the
        card unless ``device="cpu"`` is asked for."""
        device = _device.resolve(device)
        conv = [
            (ci, cj, float(co), tuple(np.asarray(b.band, np.float64)
                                      for b in bs))
            for (ci, cj, co, bs) in terms
        ]
        return SeparableOperator(grid, conv, device, dtype)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        dim = self.grid.dim
        out = [torch.zeros_like(u[..., 0])
               for _ in range(self.grid.n_components)]
        for (ci, cj, coeff, _), bands in zip(self.terms, self._bands):
            v = u[..., cj]
            for d in range(dim):
                v = apply_banded(v, bands[d], d - dim)
            out[ci] = out[ci] + coeff * v
        return torch.stack(out, dim=-1)

    def __call__(self, u):
        return self.apply(u)

    def diagonal(self) -> np.ndarray:
        """Matrix diagonal as a numpy field (for Jacobi preconditioning)."""
        diag = np.zeros(self.grid.field_shape)
        for ci, cj, coeff, bands in self.terms:
            if ci != cj:
                continue
            ds = [b[:, (b.shape[1] - 1) // 2] for b in bands]
            term = ds[0]
            for dnext in ds[1:]:
                term = np.multiply.outer(term, dnext)
            diag[..., ci] += coeff * term
        return diag

    def dense(self) -> np.ndarray:
        """Materialize as dense (n_dofs, n_dofs) in reference dof order.

        Only for small grids (tests, eigenvalue tooling)."""
        g = self.grid
        n = g.n_dofs
        eye = np.eye(n)
        U = np.stack([g.from_reference_vector(eye[:, j]) for j in range(n)])
        Y = self.apply(torch.as_tensor(U, dtype=self.dtype,
                                       device=self.device))
        Y = Y.cpu().double().numpy()
        return np.stack([g.to_reference_vector(Y[j]) for j in range(n)],
                        axis=1)


# ---------------------------------------------------------------------------
# evaluate / integrate (sum factorization)
# ---------------------------------------------------------------------------


def quad_points_1d(grid: Grid, axis: int, nq: int = None) -> np.ndarray:
    """Physical quadrature point coordinates along one axis, shape
    (n_cells*nq,), cell-major."""
    p = grid.degree
    nq = nq if nq is not None else p + 1
    x, _ = quadrature.gauss(nq)
    lo = grid.cell_lower_1d(axis)
    return (lo[:, None] + x[None, :] * grid.h[axis]).reshape(-1)


def _axis_tables(grid: Grid, axis: int, deriv: int, nq: int):
    """Per-cell shape tables along an axis: (n_cells, nq, p+1) float64."""
    p = grid.degree
    x, w = quadrature.gauss(nq)
    T = basis.shape_table(p, x, deriv)  # (ncat, q, m)
    cat = grid.categories(axis)
    scale = grid.h[axis] ** (-deriv)
    return T[cat] * scale, w


def _windows(grid: Grid, axis: int, device) -> torch.Tensor:
    """Flat (n_cells*(p+1),) node index of every cell's stencil window."""
    win = grid.offsets(axis)[:, None] + np.arange(grid.degree + 1)[None, :]
    return torch.as_tensor(win.reshape(-1), dtype=torch.int64, device=device)


def evaluate_at_quad(u: torch.Tensor, grid: Grid, derivs, nq: int = None):
    """Evaluate a field (or its mixed derivative) at the tensor quadrature
    grid.

    derivs: tuple of per-axis derivative orders.
    Returns a tensor of shape (n_cells_0*nq, ..., n_cells_{d-1}*nq, C).
    """
    p = grid.degree
    nq = nq if nq is not None else p + 1
    v = u
    for d in range(grid.dim):
        T, _ = _axis_tables(grid, d, derivs[d], nq)  # (n_d, q, m)
        n_d = grid.cells[d]
        # gather windows along axis d: (..., n_d, m, ...)
        vw = v.index_select(d, _windows(grid, d, v.device))
        vw = vw.reshape(v.shape[:d] + (n_d, p + 1) + v.shape[d + 1:])
        # contract m with the table -> (..., n_d, q, ...), merge to n_d*q
        vw_m = vw.movedim((d, d + 1), (0, 1))
        vq = torch.einsum("nqm,nm...->nq...",
                          torch.as_tensor(T, dtype=v.dtype, device=v.device),
                          vw_m)
        vq = vq.movedim((0, 1), (d, d + 1))
        v = vq.reshape(v.shape[:d] + (n_d * nq,) + v.shape[d + 1:])
    return v


def integrate_to_nodes(f_quad: torch.Tensor, grid: Grid, derivs=None,
                       nq: int = None):
    """Adjoint of evaluate_at_quad: integrate ``f_quad`` (values on the
    tensor quadrature grid, INCLUDING the user's integrand but NOT the
    quadrature weights/JxW) against test functions; returns a nodal field.

    Computes  F_a = sum_q f(x_q) phi_a^(derivs)(x_q) w_q prod_d h_d.
    """
    p = grid.degree
    nq = nq if nq is not None else p + 1
    derivs = derivs if derivs is not None else (0,) * grid.dim
    v = f_quad
    for d in range(grid.dim):
        T, w = _axis_tables(grid, d, derivs[d], nq)
        Tw = T * (w[None, :, None] * grid.h[d])  # fold JxW of this axis
        n_d = grid.cells[d]
        v2 = v.reshape(v.shape[:d] + (n_d, nq) + v.shape[d + 1:])
        vq = v2.movedim((d, d + 1), (0, 1))
        contrib = torch.einsum(
            "nqm,nq...->nm...",
            torch.as_tensor(Tw, dtype=v.dtype, device=v.device), vq)
        # scatter-add the windows onto the nodes along the leading axis
        contrib = contrib.reshape((n_d * (p + 1),) + contrib.shape[2:])
        nodes = contrib.new_zeros((grid.nodes[d],) + contrib.shape[1:])
        nodes.index_add_(0, _windows(grid, d, v.device), contrib)
        v = nodes.movedim(0, d)
    return v.contiguous()


def l2_error_squared_per_cell(u: torch.Tensor, grid: Grid, exact_fn, t=None,
                              nq: int = None) -> torch.Tensor:
    """Per-cell squared L2 error vs an analytic function, over full cells,
    in float64 on u's device.  Returns (n_cells_0, ..., n_cells_{d-1})."""
    p = grid.degree
    nq = nq if nq is not None else p + 1
    dim = grid.dim
    uq = evaluate_at_quad(u, grid, (0,) * dim, nq)  # (..., C)
    pts = [quad_points_1d(grid, d, nq) for d in range(dim)]
    mesh = np.meshgrid(*pts, indexing="ij")
    _, w = quadrature.gauss(nq)
    jxw = np.ones(())
    for d in range(dim):
        shape = [1] * dim
        shape[d] = grid.cells[d] * nq
        jxw = jxw * np.tile(w * grid.h[d], grid.cells[d]).reshape(shape)
    err2 = torch.zeros(uq.shape[:-1], dtype=torch.float64, device=u.device)
    for c in range(grid.n_components):
        ex = exact_fn(mesh, c) if t is None else exact_fn(mesh, c, t)
        ex = torch.as_tensor(np.asarray(ex, np.float64), device=u.device)
        err2 += (uq[..., c].double() - ex) ** 2
    err2 = err2 * torch.as_tensor(jxw, device=u.device)
    # sum within cells
    for d in range(dim):
        err2 = err2.reshape(
            err2.shape[:d] + (grid.cells[d], nq) + err2.shape[d + 1:]
        ).sum(dim=d + 1)
    return err2


def l2_error(u: torch.Tensor, grid: Grid, exact_fn, t=None,
             nq: int = None) -> float:
    return float(torch.sqrt(torch.sum(
        l2_error_squared_per_cell(u, grid, exact_fn, t, nq))))
