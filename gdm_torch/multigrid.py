"""Matrix-free geometric multigrid for uncut GD Poisson problems.

Port of gdm/multigrid.py: a symmetric V-cycle preconditioner for CG on
the zero-BC GD Laplacian.  Factor-2 coarsening of the node lattice
while the per-axis cell count stays even; prolongation P = the GD
degree-p interpolant at coarse-cell midpoints; restriction R = P^T (no
1/2: weak-form operators carry the h scaling); weighted-Jacobi
smoothing; a dense direct solve on the coarsest level.  Fields carry
the trailing component axis (grid.nodes + (1,)).

Every level's operator apply is ``ops.fast.best_field_laplace``: the
kernel gdm's dispatch picks for the level (K3 in 2D; K5 in 3D while
N0 + 2p <= 512, else K4), on a CUDA device, and its plain twin on the
CPU.  The transfers are plain torch slice multiply-adds, as gdm computes
them outside Pallas.  The coarsest
dense inverse is built on the host in float64 from the exact operator
and cast; the coarse solve is one matrix-vector product, which must not
run in TF32 (checked on every call).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import basis, operators
from . import device as _device
from .constraints import Constraints
from .grid import Grid
from .ops.fast import best_field_laplace


def _gd_mid_table(grid: Grid, axis: int):
    """(n_cells, p+1) GD shape values at each cell's midpoint + window
    offsets: the degree-p prolongation stencil for the odd fine nodes."""
    T = basis.shape_table(grid.degree, np.array([0.5]), 0)[:, 0, :]
    return T[grid.categories(axis)], grid.offsets(axis)


def _realigned_band(table, offsets):
    """Re-key the (n_cells, p+1) windowed stencil T[c, k] (window start
    offsets[c]) as a cell-relative band Tb[c, j] with global index
    c + lo + j, so the transfers are static slice multiply-adds."""
    table = np.asarray(table)
    offsets = np.asarray(offsets)
    n_cells, p1 = table.shape
    c = np.arange(n_cells)
    rel = offsets[:, None] + np.arange(p1)[None, :] - c[:, None]
    lo, hi = int(rel.min()), int(rel.max())
    Tb = np.zeros((n_cells, hi - lo + 1), table.dtype)
    Tb[c[:, None], rel - lo] = table
    return Tb, lo


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One axis's realigned transfer band on a device: coefficient
    column j of ``band`` couples cell c to coarse node c + lo + j."""
    band: torch.Tensor   # (n_cells, width)
    lo: int
    cols: tuple          # the columns j with any nonzero coefficient


def make_transfer(table, offsets, device="cuda",
                  dtype=torch.float64) -> Transfer:
    """The transfer band of (table, offsets) on ``device`` (the card
    unless ``device="cpu"`` is asked for)."""
    device = _device.resolve(device)
    Tb, lo = _realigned_band(table, offsets)
    cols = tuple(j for j in range(Tb.shape[1]) if Tb[:, j].any())
    return Transfer(torch.as_tensor(Tb, dtype=dtype, device=device), lo,
                    cols)


def _axis_slice(ndim, axis, sl):
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


def _taps(tr: Transfer, n_cells: int, nc: int, ndim: int, axis: int):
    """(j, c0, length, coef) per nonzero column: cells [c0, c0+length)
    whose coarse node c + lo + j lies inside [0, nc); coef broadcasts
    along ``axis``."""
    shape = [1] * ndim
    for j in tr.cols:
        s = tr.lo + j
        c0, c1 = max(0, -s), min(n_cells, nc - s)
        if c1 <= c0:
            continue
        shape[axis] = c1 - c0
        yield j, c0, c1 - c0, tr.band[c0:c1, j].reshape(shape)


def prolong(u: torch.Tensor, axis: int, tr: Transfer,
            n_fine_nodes: int) -> torch.Tensor:
    nc = u.shape[axis]
    n_cells = nc - 1
    if n_fine_nodes != 2 * nc - 1:
        raise ValueError(
            f"gd_prolong_axis: n_fine_nodes={n_fine_nodes} must equal "
            f"2*n_coarse_nodes - 1 = {2 * nc - 1} (uniform 2:1 nested "
            f"refinement)")
    shape = list(u.shape)
    shape[axis] = n_fine_nodes
    out = u.new_empty(shape)
    # out[2i] = u[i], out[2c+1] = sum_j band[c, j] u[c + lo + j]
    out[_axis_slice(u.ndim, axis, slice(0, None, 2))] = u
    mid = out[_axis_slice(u.ndim, axis, slice(1, None, 2))]
    mid.zero_()
    for j, c0, n, coef in _taps(tr, n_cells, nc, u.ndim, axis):
        mid.narrow(axis, c0, n).addcmul_(
            coef, u.narrow(axis, c0 + tr.lo + j, n))
    return out


def restrict(y: torch.Tensor, axis: int, tr: Transfer) -> torch.Tensor:
    odd = y[_axis_slice(y.ndim, axis, slice(1, None, 2))]
    n_cells = odd.shape[axis]
    nc = n_cells + 1
    acc = y[_axis_slice(y.ndim, axis, slice(0, None, 2))].clone()
    for j, c0, n, coef in _taps(tr, n_cells, nc, y.ndim, axis):
        acc.narrow(axis, c0 + tr.lo + j, n).addcmul_(
            coef, odd.narrow(axis, c0, n))
    return acc


def gd_prolong_axis(u, axis, table, offsets, n_fine_nodes):
    """Prolong ``u`` along ``axis`` with gdm's (table, offsets) stencil."""
    return prolong(u, axis, make_transfer(table, offsets, u.device, u.dtype),
                   n_fine_nodes)


def gd_restrict_axis(y, axis, table, offsets):
    """Variational restriction R = P^T along ``axis`` (no 1/2)."""
    return restrict(y, axis, make_transfer(table, offsets, y.device,
                                           y.dtype))


@dataclasses.dataclass
class Level:
    grid: Grid
    apply: object            # constrained field-shaped Laplace apply
    mask: torch.Tensor       # bool field: constrained dofs
    w_diag: torch.Tensor     # omega / diag on free dofs, omega elsewhere
    transfers: tuple         # per axis, from this level to the next finer


class PoissonMultigrid:
    """Symmetric V-cycle preconditioner for the zero-BC GD Laplacian."""

    def __init__(self, grid: Grid, device="cuda", dtype=torch.float64,
                 n_smooth: int = 2, omega: float = 0.6, coarsest: int = 8):
        if grid.n_components != 1:
            raise ValueError("PoissonMultigrid takes scalar fields")
        self.device = _device.resolve(device)
        self.n_smooth = n_smooth
        self.omega = omega
        self.levels = []
        g = grid
        while True:
            cons = Constraints.zero_boundary(g, device=self.device)
            diag = np.where(cons.full_mask, 1.0,
                            operators.laplace(g, device="cpu").diagonal())
            base_apply, _ = best_field_laplace(g, device=self.device,
                                                dtype=dtype)
            self.levels.append(Level(
                g, cons.constrain_operator(base_apply), cons.full_t,
                # omega * (1 / diag), the product gdm's smoother forms
                torch.as_tensor(omega * (1.0 / diag), dtype=dtype,
                                device=self.device),
                tuple(make_transfer(*_gd_mid_table(g, d), self.device,
                                    dtype) for d in range(g.dim))))
            if min(g.cells) // 2 < coarsest or any(c % 2 for c in g.cells):
                break
            g = Grid(g.degree, tuple(c // 2 for c in g.cells), g.lower,
                     g.upper, 1)
        if len(self.levels) == 1:
            raise ValueError(
                "PoissonMultigrid: grid %s cannot be coarsened (odd or "
                "too-small cell count); use even cell counts >= %d or a "
                "Jacobi preconditioner" % (grid.cells, 2 * coarsest))
        # a 0-dim zero for torch.where (a Python 0.0 costs a fill kernel)
        self.zero = torch.zeros((), device=self.device)
        self.coarse_inv = torch.as_tensor(
            _coarse_inverse(self.levels[-1].grid), dtype=dtype,
            device=self.device)

    def _smooth(self, lvl: Level, u, b, iters):
        for _ in range(iters):
            r = b - lvl.apply(u)
            u.addcmul_(lvl.w_diag, r)  # in place: u is this cycle's own
        return u

    def _coarse_solve(self, b):
        if self.coarse_inv.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "PoissonMultigrid: torch.backends.cuda.matmul.allow_tf32 is "
                "on; the coarse solve must run in full float32")
        return torch.mv(self.coarse_inv, b.reshape(-1)).reshape(b.shape)

    def _vcycle(self, k, b):
        if k == len(self.levels) - 1:
            return self._coarse_solve(b)
        lvl = self.levels[k]
        coarse = self.levels[k + 1]
        u = self._smooth(lvl, torch.zeros_like(b), b, self.n_smooth)
        rc = b - lvl.apply(u)
        for d in range(lvl.grid.dim):
            rc = restrict(rc, d, coarse.transfers[d])
        ec = self._vcycle(k + 1, torch.where(coarse.mask, self.zero, rc))
        e = ec
        for d in range(lvl.grid.dim):
            e = prolong(e, d, coarse.transfers[d], lvl.grid.nodes[d])
        u = u + torch.where(lvl.mask, self.zero, e)
        return self._smooth(lvl, u, b, self.n_smooth)

    def precondition(self, r):
        """r: field of shape grid.nodes + (1,) (zero on constrained dofs)."""
        return self._vcycle(0, r)


def _coarse_inverse(gc: Grid) -> np.ndarray:
    """The dense inverse of the constrained exact Laplace on ``gc``, in
    float64 on the host, with identity rows and columns on the
    constrained dofs (as gdm builds it)."""
    cons = Constraints.zero_boundary(gc, device="cpu")
    apply_exact = cons.constrain_operator(
        operators.laplace(gc, device="cpu").apply)
    n = gc.n_dofs
    eye = torch.eye(n, dtype=torch.float64).reshape((n,) + gc.field_shape)
    Ad = apply_exact(eye).reshape(n, n).numpy().T.copy()
    mask = cons.full_mask.reshape(-1)
    Ad[mask, :] = 0.0
    Ad[:, mask] = 0.0
    Ad[np.where(mask)[0], np.where(mask)[0]] = 1.0
    return np.linalg.inv(Ad)
