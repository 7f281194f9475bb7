"""Assembled structured-stencil form of cut operators.

Port of gdm/cut/stencil.py.  Any cut operator (mass, stiffness,
M + dt*S) has the sparsity of the grid's stencil graph: node i couples
only to nodes within a fixed offset radius r = p+1 (cell windows + one
ghost-penalty neighbor cell), so it is stored as a generalized band
band[node, offset] and applied with (2r+1)^dim shifted multiply-adds.

Assembly (``assemble_stencil``, ``schwarz_band``) is host numpy, as in
gdm.  ``StencilOperator.apply`` is the plain torch band apply on flat
node vectors; the hand-written CUDA apply on the padded layout is
gdm_torch.ops.cutband (K1).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..grid import Grid
from .operators import CutOperators


class StencilOperator:
    """y[i] = sum_off band[i, off] * u[i + off] on the node lattice."""

    def __init__(self, grid: Grid, band: np.ndarray, radius: int):
        self.grid = grid
        self.radius = radius
        # private copy: a caller-side mutation of the input array must
        # not desync the host band from the cached device copies
        self.band_host = np.array(band)  # np f64, nodes + (2r+1,)*dim
        self._band = {}
        self._taps = {}

    def band_tensor(self, device, dtype) -> torch.Tensor:
        """The band as a tensor, cached per (device, dtype)."""
        key = (torch.device(device), dtype)
        if key not in self._band:
            self._band[key] = torch.as_tensor(self.band_host, dtype=dtype,
                                              device=device)
        return self._band[key]

    def _tap_views(self, device, dtype) -> list:
        """[(band[..., tap], slice of the padded input), ...] in gdm's
        tap order (axis 0's offset fastest), cached per (device, dtype)."""
        key = (torch.device(device), dtype)
        if key not in self._taps:
            band = self.band_tensor(device, dtype)
            nodes = self.grid.nodes
            K = 2 * self.radius + 1
            taps = []
            for idx in itertools.product(range(K), repeat=self.grid.dim):
                idx = idx[::-1]
                sl = tuple(slice(i, i + n) for i, n in zip(idx, nodes))
                taps.append((band[(Ellipsis,) + idx], sl))
            self._taps[key] = taps
        return self._taps[key]

    def apply(self, u_flat: torch.Tensor) -> torch.Tensor:
        nodes = self.grid.nodes
        r = self.radius
        u = u_flat.reshape(nodes)
        up = torch.nn.functional.pad(u, [r, r] * len(nodes))
        y = torch.zeros(nodes, dtype=u.dtype, device=u.device)
        for b, sl in self._tap_views(u.device, u.dtype):
            # in place: y is this call's own accumulator
            y += b * up[sl]
        return y.reshape(-1)


def _tap_table(window, grid, radius):
    """(m, m) tap indices for ONE window's (output, input) node pairs."""
    dim = grid.dim
    K = 2 * radius + 1
    w = np.asarray(window, np.int64)
    coords = np.stack(np.unravel_index(w, grid.nodes), axis=0)  # (dim, m)
    off = np.zeros((len(w), len(w)), dtype=np.int64)
    for d in range(dim):
        off = off * K + (coords[d][None, :] - coords[d][:, None] + radius)
    return off


def _window_in_band(window, grid, radius):
    """True iff every per-axis coordinate offset within this window lies
    in [-radius, radius] — the precondition for the shared-tap-table
    fast path (flat relative indices are only unambiguous then)."""
    coords = np.stack(np.unravel_index(np.asarray(window, np.int64),
                                       grid.nodes), axis=0)  # (dim, m)
    span = coords.max(axis=1) - coords.min(axis=1)
    return bool((span <= radius).all())


def _accumulate(band_flat, windows, mats, grid, radius):
    """band_flat: (n_nodes, K^dim); windows (n, m); mats (n, m, m).

    Every window this is called with is an axis-aligned contiguous node
    block, so the relative (output, input) tap table is the SAME for
    all n windows — computed once from the first window (verified in
    O(n*m); general per-window path as fallback).  The scatter-add is a
    single bincount on the fused (row, tap) index."""
    dim = grid.dim
    K = 2 * radius + 1
    n, m = windows.shape
    rel = windows - windows[:, :1]
    if n and (rel == rel[0]).all() and _window_in_band(windows[0], grid,
                                                       radius):
        off = _tap_table(windows[0], grid, radius)        # (m, m)
        idx = (windows[:, :, None].astype(np.int64) * band_flat.shape[1]
               + off[None, :, :])
    else:
        # general path: per-window per-axis offsets
        strides = [1] * dim
        for d in range(dim - 2, -1, -1):
            strides[d] = strides[d + 1] * grid.nodes[d + 1]
        wi = windows[:, :, None].astype(np.int64)
        wj = windows[:, None, :].astype(np.int64)
        off_flat = np.zeros((n, m, m), dtype=np.int64)
        rem_i, rem_j = wi.copy(), wj.copy()
        for d in range(dim):
            ci = rem_i // strides[d]
            cj = rem_j // strides[d]
            rem_i = rem_i % strides[d]
            rem_j = rem_j % strides[d]
            delta = cj - ci
            assert (np.abs(delta) <= radius).all(), (
                "window pair offset exceeds the band radius — the "
                "accumulated entry has no band slot")
            off_flat = off_flat * K + (delta + radius)
        idx = wi * band_flat.shape[1] + off_flat
    band_flat += np.bincount(
        idx.reshape(-1), weights=np.asarray(mats, np.float64).reshape(-1),
        minlength=band_flat.size).reshape(band_flat.shape)


def assemble_stencil(op: CutOperators, kind: str, gamma: float,
                     nitsche_gamma: float = 0.0, with_nitsche: bool = False,
                     gp_power: int = 3, with_bdry_nitsche: bool = False,
                     inactive_identity: bool = True) -> StencilOperator:
    """Assemble the cut mass ('mass') or stiffness ('stiff') operator into
    stencil-band form (including ghost penalty and, optionally, the 0->1
    inactive identity and the domain-boundary Nitsche terms of the
    matrix-free RHS path)."""
    grid = op.grid
    dim = grid.dim
    p = grid.degree
    radius = p + 1  # GP couples adjacent cell windows
    K = 2 * radius + 1
    band = np.zeros((grid.n_nodes, K**dim))

    if kind == "mass":
        if len(op.full_ids):
            _accumulate(band, op.w_full, op.A_mass[op.cat_full], grid, radius)
        if len(op.cut_ids):
            mats = np.einsum("nqi,nqj,nq->nij", op.V_cut, op.V_cut, op.vol_w)
            _accumulate(band, op.w_cut, mats, grid, radius)
    elif kind == "stiff":
        if len(op.full_ids):
            _accumulate(band, op.w_full, op.A_stiff[op.cat_full], grid, radius)
        if len(op.cut_ids):
            mats = np.einsum("nqdi,nqdj,nq->nij", op.G_cut, op.G_cut,
                             op.vol_w)
            if with_nitsche:
                Gn = np.einsum("nqdi,nqd->nqi", op.G_surf, op.surf_n)
                mats = mats + np.einsum(
                    "nqi,nqj,nq->nij",
                    (nitsche_gamma / op.h_min) * op.V_surf - Gn,
                    op.V_surf, op.surf_w)
                mats = mats - np.einsum("nqi,nqj,nq->nij", Gn, op.V_surf,
                                        op.surf_w).transpose(0, 2, 1)
            _accumulate(band, op.w_cut, mats, grid, radius)
    else:
        raise ValueError(kind)

    if with_bdry_nitsche and len(op.b_win):
        Gn = np.einsum("nqdi,nqd->nqi", op.b_G, op.b_normal_q)
        mats = np.einsum(
            "nqi,nqj,nq->nij",
            (nitsche_gamma / op.h_min) * op.b_V - Gn, op.b_V, op.b_w)
        mats = mats - np.einsum("nqi,nqj,nq->nij", Gn, op.b_V,
                                op.b_w).transpose(0, 2, 1)
        _accumulate(band, op.b_win, mats, grid, radius)

    if len(op.gp_win):
        scale = gamma * op.h_min**gp_power
        _accumulate(band, op.gp_win, scale * op.gp_mat, grid, radius)

    center = (K**dim - 1) // 2
    if inactive_identity:
        band[op.inactive, center] += 1.0

    return StencilOperator(grid, band.reshape(grid.nodes + (K,) * dim),
                           radius)


def _local_blocks(band_flat, windows, grid, radius):
    """Extract exact global submatrices A[win, win] (n, m, m) from the
    band form (entries farther than `radius` on any axis are 0)."""
    dim = grid.dim
    K = 2 * radius + 1
    n, m = windows.shape
    strides = [1] * dim
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * grid.nodes[d + 1]
    wi = windows[:, :, None].astype(np.int64)
    wj = windows[:, None, :].astype(np.int64)
    off_flat = np.zeros((n, m, m), dtype=np.int64)
    valid = np.ones((n, m, m), dtype=bool)
    rem_i, rem_j = wi.copy(), wj.copy()
    for d in range(dim):
        ci = rem_i // strides[d]
        cj = rem_j // strides[d]
        rem_i = rem_i % strides[d]
        rem_j = rem_j % strides[d]
        delta = cj - ci
        valid &= np.abs(delta) <= radius
        off_flat = off_flat * K + np.clip(delta + radius, 0, K - 1)
    rows = np.broadcast_to(wi, (n, m, m))
    loc = np.where(valid, band_flat[rows, off_flat], 0.0)
    return loc


def _schwarz_blocks(st: StencilOperator, windows, dtype):
    """(jac, windows, inv) of the additive Schwarz(+Jacobi)
    preconditioner: point Jacobi on the rows no window covers (0 on
    covered rows, 1 where the diagonal is 0: inactive), the windows as
    an int array and their dense block inverses A[w, w]^{-1} (None
    without windows).  For float32 a relative ridge of ~f32 eps is added
    to every block before inversion: the exact inverse of a kappa~1e12
    block rounds to garbage (possibly indefinite) in f32, which
    destabilizes preconditioned CG; the ridge caps the block condition
    at ~1e7 — everything f32 can express — while still resolving the bad
    modes far beyond point Jacobi.  (gdm decides this from its global
    float width; here the caller states it.)"""
    grid = st.grid
    K = 2 * st.radius + 1
    band_flat = np.asarray(st.band_host, np.float64).reshape(
        grid.n_nodes, K**grid.dim)
    diag = band_flat[:, (K**grid.dim - 1) // 2]
    covered = np.zeros(grid.n_nodes, dtype=bool)
    windows = np.asarray(windows)
    inv = None
    if windows.size:
        covered[windows.reshape(-1)] = True
        loc = _local_blocks(band_flat, windows, grid, st.radius)
        if dtype == torch.float32:
            m = loc.shape[-1]
            d = np.einsum("nii->ni", loc)
            ridge = 1e-7 * d.max(axis=1)
            loc = loc + ridge[:, None, None] * np.eye(m)
        inv = np.linalg.inv(loc)
    safe = np.where(diag == 0.0, 1.0, diag)
    return np.where(covered, 0.0, 1.0 / safe), windows, inv


def schwarz_band(st: StencilOperator, windows,
                 dtype: torch.dtype = torch.float32) -> StencilOperator:
    """The additive Schwarz(+Jacobi) preconditioner ASSEMBLED into
    stencil-band form.

    B = sum_w R_w^T A[w, w]^{-1} R_w  (+ point Jacobi on uncovered rows)
    has exactly the window-stencil sparsity, padded here to the
    operator's radius so B shares its padded kernel layout.  ``dtype``
    is the working precision B will be applied in (``_schwarz_blocks``).
    """
    grid = st.grid
    K = 2 * st.radius + 1
    jac, windows, inv = _schwarz_blocks(st, windows, dtype)
    bandB = np.zeros((grid.n_nodes, K**grid.dim))
    if inv is not None:
        _accumulate(bandB, windows, inv, grid, st.radius)
    bandB[:, (K**grid.dim - 1) // 2] += jac
    return StencilOperator(grid, bandB.reshape(grid.nodes + (K,) * grid.dim),
                           st.radius)


def schwarz_jacobi_preconditioner(st: StencilOperator, windows,
                                  dtype: torch.dtype = torch.float64):
    """The same B as ``schwarz_band`` in gather form, gdm's host route of
    the streamed CG: exact dense solves of the window submatrices
    (batched (m, m) inverses, applied as gather -> einsum -> index_add_)
    plus point Jacobi, on flat node vectors.  ``dtype`` is the working
    precision (``_schwarz_blocks``); the tables move to the residual's
    device and dtype at its first call.  (gdm's ``overlap_weighted``
    scaling has no caller and is not ported.)"""
    host = dict(zip(("jac", "win", "inv"), _schwarz_blocks(st, windows,
                                                           dtype)))
    cache = {}

    def precondition(r):
        key = (r.device, r.dtype)
        if key not in cache:
            cache[key] = {k: torch.as_tensor(
                v, device=r.device,
                dtype=torch.int64 if k == "win" else r.dtype)
                for k, v in host.items() if v is not None}
        t = cache[key]
        z = t["jac"] * r
        if "inv" not in t:
            return z
        win = t["win"]
        zl = torch.einsum("nij,nj->ni", t["inv"], r[win])
        return z.index_add_(0, win.reshape(-1), zl.reshape(-1))

    return precondition


def kernel_route(grid, device) -> bool:
    """gdm's platform rule for its fused kernels, read as the device
    asked for: a CUDA run of a 2D grid takes gdm's TPU branches (K1,
    K2); every other run takes gdm's branches off the TPU.  The one
    copy of the rule: ``routed_apply``, ``fsai``'s solvers and
    ``WaveProblem`` all ask it through this module."""
    return torch.device(device).type == "cuda" and grid.dim == 2


def routed_apply(st: StencilOperator, other=None):
    """The apply of ``st`` on flat node vectors, routed on the tensor as
    ``best_solver_apply`` routes: where ``kernel_route`` holds for the
    tensor's device, through K1 (``fastapply.fast_stencil_apply``, built
    per device and dtype at its first call); elsewhere ``other``
    (default: the plain band apply ``st.apply``)."""
    from .fastapply import fast_stencil_apply

    if other is None:
        other = st.apply
    k1 = {}

    def apply(u: torch.Tensor) -> torch.Tensor:
        if kernel_route(st.grid, u.device):
            key = (u.device, u.dtype)
            if key not in k1:
                k1[key] = fast_stencil_apply(st, device=u.device,
                                             dtype=u.dtype)
            return k1[key](u)
        return other(u)

    return apply


def best_solver_apply(op: CutOperators, kind: str, gamma: float,
                      nitsche_gamma: float = 0.0,
                      with_nitsche: bool = False,
                      max_band_entries: float = 3e7):
    """The fastest apply of the cut operator ``kind`` ("mass" or
    "stiff") for solver inner loops, on flat node vectors.

    gdm picks its route once, from the platform: on a TPU in 2D its
    fused kernel.  Here the route follows the tensor (``routed_apply``):
    a CUDA tensor of a 2D grid goes through K1; any other tensor takes
    the stencil-band apply while the band holds at most
    ``max_band_entries`` entries, else the matrix-free apply
    (``CutOperators.mass_apply`` or ``stiffness_matrix_apply``), as gdm
    does off the TPU.
    """
    grid = op.grid
    K = 2 * (grid.degree + 1) + 1
    banded = grid.n_nodes * K**grid.dim <= max_band_entries
    if kind == "mass":
        def free(v):
            return op.mass_apply(v, gamma)
    else:
        def free(v):
            return op.stiffness_matrix_apply(v, gamma, nitsche_gamma,
                                             with_nitsche)
    if not banded and grid.dim != 2:
        return free
    st = assemble_stencil(op, kind, gamma, nitsche_gamma, with_nitsche)
    return routed_apply(st, None if banded else free)
