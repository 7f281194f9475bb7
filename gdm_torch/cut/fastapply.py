"""Fast paths for the cut stencil-band operators (2D).

Port of gdm/cut/fastapply.py.

``fast_stencil_bundle`` and ``fast_stencil_apply`` are the band apply of
K1 (gdm_torch/ops/cutband.py): the bundle on the padded layout, so
solver loops and the RK state run entirely in that layout with no
per-call pad/unpad (the flagship path), the flat apply for callers that
keep node vectors.

``make_fast_cut_apply`` is gdm's split apply.  Away from the interface
an assembled cut operator is exactly two Kronecker pairs of 1D GD bands
(``kron_pairs``):

    mass       M0 (x) M1
    stiffness  S0 (x) M1 + M0 (x) S1
    M + dt*S   (M0 + dt*S0) (x) M1 + dt*M0 (x) S1

so it is applied as

    y = where(inactive, u, A0 U A1^T + B0 U B1^T) + scatter(corr . u_win)

with the separable part on K3 in the row mode its caller names
(gdm_torch/ops/stencil2.py, ``make_padded_laplace2(rows=..., bands=...)``;
gdm's default ``"mxu3p"``) and the correction rows, an O(interface) set
found geometrically on the host (``_standard_mask``), as a torch gather,
einsum and ``index_add_``.  The correction values are the assembled row
minus the separable row, so the split is exact to roundoff.  The K3
wrappers launch the kernel for a CUDA tensor and run the plain twin for
a CPU tensor; there is no other switch (gdm's ``use_pallas``,
``interpret`` and ``GDM_DISABLE_PALLAS`` have no counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..grid import Grid
from ..ops.cutband import PaddedLayout, make_padded_stencil2
from ..ops.stencil2 import make_padded_laplace2
from ..ops1d import mass_1d, stiffness_1d
from .operators import CutOperators
from .stencil import StencilOperator


def kron_pairs(grid: Grid, kind: str, dt: float = None):
    """The separable Kronecker pairs [(A0, A1), ...] of a cut operator
    kind ("mass", "stiff" or "heat_impl", M + dt*S), as numpy bands."""
    S0 = stiffness_1d(grid.degree, grid.cells[0], grid.h[0]).band
    M0 = mass_1d(grid.degree, grid.cells[0], grid.h[0]).band
    S1 = stiffness_1d(grid.degree, grid.cells[1], grid.h[1]).band
    M1 = mass_1d(grid.degree, grid.cells[1], grid.h[1]).band
    if kind == "mass":
        return [(M0, M1)]
    if kind == "stiff":
        return [(S0, M1), (M0, S1)]
    if kind == "heat_impl":
        return [(M0 + dt * S0, M1), (dt * M0, S1)]
    raise ValueError(kind)


def _standard_mask(op: CutOperators) -> np.ndarray:
    """Nodes whose assembled row equals the separable row: every cell
    containing the node is full-inside, and the node is in no ghost
    penalty or boundary-Nitsche window."""
    grid = op.grid
    N = grid.n_nodes
    p = grid.degree
    # per-axis window multiplicity of each node (every cell's window)
    cnt1d = []
    for d in range(grid.dim):
        c = np.zeros(grid.nodes[d], np.int64)
        for o in grid.offsets(d):
            c[o : o + p + 1] += 1
        cnt1d.append(c)
    cnt_all = np.multiply.outer(cnt1d[0], cnt1d[1]).reshape(-1)
    cnt_full = np.zeros(N, np.int64)
    if len(op.w_full):
        np.add.at(cnt_full, op.w_full.reshape(-1), 1)
    flagged = np.zeros(N, bool)
    for w in (op.gp_win, op.b_win):
        if len(w):
            flagged[w.reshape(-1)] = True
    return (~op.inactive) & (cnt_full == cnt_all) & ~flagged


def make_fast_cut_apply(st: StencilOperator, op: CutOperators, pairs,
                        device="cuda", dtype=torch.float32, tile_r=None,
                        rows: str = "mxu3p", inactive_identity: bool = True):
    """Flat-vector apply equal to ``st.apply`` (to roundoff), built as the
    separable Kronecker part on K3 plus O(interface) correction rows, on
    ``device`` (the card unless ``device="cpu"`` is asked for).

    rows, tile_r: K3's row mode and the card's tile, as in
    ``make_padded_laplace2`` (gdm's TPU tile of 96 rows does not carry
    over).  inactive_identity: whether ``st`` carries the 0->1 identity
    on inactive rows (solver operators) or zero rows there (the explicit
    RHS stiffness assembled with inactive_identity=False).  The apply's
    ``separable`` attribute is K3's apply, ``n_corrections`` the number
    of correction rows.
    """
    device = _device.resolve(device)
    grid = st.grid
    if grid.dim != 2:
        raise ValueError(f"the split cut apply is 2D; the grid is "
                         f"{grid.dim}D")
    p = grid.degree
    r = st.radius
    K1 = 2 * p + 1
    K2 = 2 * r + 1
    N0, N1 = grid.nodes

    # ---- correction rows (host) ------------------------------------------
    custom = ~_standard_mask(op) & ~op.inactive
    cidx = np.where(custom)[0]
    i0 = cidx // N1
    i1 = cidx % N1
    # separable rows embedded into the (K2, K2) band at offset r - p
    sep = np.zeros((len(cidx), K2, K2))
    e = r - p
    for a0, a1 in pairs:
        sep[:, e : e + K1, e : e + K1] += np.einsum("na,nb->nab", a0[i0],
                                                    a1[i1])
    band = np.asarray(st.band_host).reshape(N0 * N1, K2, K2)
    corr = (band[cidx] - sep).reshape(len(cidx), K2 * K2)
    # window node indices (clipped; out-of-range taps have corr == 0)
    dy, dx = np.meshgrid(np.arange(K2) - r, np.arange(K2) - r,
                         indexing="ij")
    t0 = np.clip(i0[:, None, None] + dy[None], 0, N0 - 1)
    t1 = np.clip(i1[:, None, None] + dx[None], 0, N1 - 1)
    cwin = (t0 * N1 + t1).reshape(len(cidx), K2 * K2)

    corr_d = torch.as_tensor(corr, dtype=dtype, device=device)
    cwin_d = torch.as_tensor(cwin, dtype=torch.int64, device=device)
    cidx_d = torch.as_tensor(cidx, dtype=torch.int64, device=device)
    inactive_d = torch.as_tensor(op.inactive, device=device)

    # ---- separable part --------------------------------------------------
    a0, a1 = pairs[0]
    b0, b1 = pairs[1] if len(pairs) > 1 else (np.zeros_like(a0),
                                              np.zeros_like(a1))
    sep_apply, pad, unpad, _ = make_padded_laplace2(
        grid, device, dtype, tile_r=tile_r, rows=rows,
        bands=(a0, a1, b0, b1))

    def apply(u_flat: torch.Tensor) -> torch.Tensor:
        y = unpad(sep_apply(pad(u_flat.reshape(N0, N1)))).reshape(-1)
        if inactive_identity:
            y = torch.where(inactive_d, u_flat, y)
        else:
            y = y.masked_fill(inactive_d, 0.0)
        if len(cidx):
            y = y.index_add_(0, cidx_d,
                             torch.einsum("nq,nq->n", corr_d,
                                          u_flat[cwin_d]))
        return y

    apply.separable = sep_apply
    apply.n_corrections = len(cidx)
    return apply


def fast_stencil_apply(st: StencilOperator, op=None, kind: str = None,
                       dt: float = None, inactive_identity: bool = True,
                       device="cuda", dtype=torch.float32):
    """K1's flat-vector apply of ``st`` for a 2D grid, None otherwise
    (callers keep ``st.apply``), on the card unless ``device="cpu"`` is
    asked for.  ``op``, ``kind``, ``dt`` and ``inactive_identity`` take
    gdm's call forms in gdm's positions, ``fast_stencil_apply(st, op,
    kind)`` and ``inactive_identity=False``, and have no effect: gdm
    reads none of them (its split apply stays opt-in through
    ``make_fast_cut_apply``).  ``op`` and ``kind`` default to None,
    which gdm's callers never rely on."""
    device = _device.resolve(device)
    if st.grid.dim != 2:
        return None
    apply_padded, pad, unpad, _ = make_padded_stencil2(st, device, dtype)

    def apply(u_flat: torch.Tensor) -> torch.Tensor:
        return unpad(apply_padded(pad(u_flat)))

    return apply


def fast_stencil_bundle(st: StencilOperator, device="cuda",
                        dtype=torch.float32, layout: PaddedLayout = None):
    """(apply_padded, pad, unpad) of K1 for ``st`` on ``layout``: pad
    takes a flat node vector, unpad returns one.  Guard zeros contribute
    nothing to CG dot products and the layout is closed under the
    apply."""
    apply_padded, pad, unpad, _ = make_padded_stencil2(st, device, dtype,
                                                       layout)
    return apply_padded, pad, unpad
