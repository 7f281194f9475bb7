"""Mesh-independent multilevel preconditioning for CUT systems.

Port of gdm/cut/multigrid.py.  The reference CG-solves its cut
stiffness and (M + dt S) systems with black-box Trilinos AMG
(problem.h:457-502); point-Jacobi CG on them needs O(n) iterations.

* **Galerkin hierarchy** (host scipy, verbatim from gdm): A_{k+1} =
  P^T A_k P with P the uncut degree-p GD interpolation assembled as a
  host sparse matrix.  The Galerkin coarse matrices are well
  conditioned because prolongated coarse functions are smooth.
* **Symmetric V-cycle** with per-level Chebyshev(cheb_degree) (default)
  or damped-Richardson smoothing over a cut-window Schwarz + point
  Jacobi inner preconditioner, lambda_max(S A) by a 30-step host power
  iteration (or, with ``estimator="lanczos"``, also CG-Lanczos; any
  other estimator raises ValueError).
* **Coarsest level**: the dense inverse of the Galerkin operator, one
  matrix-vector product, which must not run in TF32 on the card.

Each level's band apply follows the tensor, as ``best_solver_apply``
does: on a CUDA tensor of a 2D grid it is K1 on that level's band
(``make_padded_stencil2``; the Galerkin coarse bands reach radius 5),
elsewhere the plain tap apply.  The transfers are the uncut multigrid's
(gdm_torch/multigrid.py), the Schwarz solves gather -> einsum ->
index_add_.  Tables live on ``device`` in ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..grid import Grid
from ..multigrid import _gd_mid_table, make_transfer, prolong, restrict
from .geometry import INTERSECTED, classify_cells
from .levelset import LevelSetInterpolant
from .stencil import StencilOperator, assemble_stencil, routed_apply
from .tables import windows_c_order

ESTIMATORS = ("power", "lanczos")


def _band_to_sparse(st: StencilOperator):
    """Stencil-band operator -> scipy CSR (host)."""
    import scipy.sparse as sp

    grid = st.grid
    dim = grid.dim
    K = 2 * st.radius + 1
    N = grid.n_nodes
    band = np.asarray(st.band_host).reshape(N, -1)
    coords = np.stack(np.unravel_index(np.arange(N), grid.nodes), -1)
    strides = np.ones(dim, np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * grid.nodes[d + 1]
    rows, cols, vals = [], [], []
    for flat_off in range(band.shape[1]):
        rem = flat_off
        off = np.zeros(dim, np.int64)
        for d in range(dim - 1, -1, -1):
            off[d] = rem % K - st.radius
            rem //= K
        v = band[:, flat_off]
        nz = v != 0.0
        if not nz.any():
            continue
        tgt = coords[nz] + off
        ok = np.all((tgt >= 0) & (tgt < np.asarray(grid.nodes)), axis=1)
        r = np.where(nz)[0][ok]
        rows.append(r)
        cols.append((tgt[ok] * strides).sum(axis=1))
        vals.append(v[r])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N))


def _prolong_sparse(fine: Grid, coarse: Grid):
    """Host sparse P (n_fine, n_coarse) matching the device transfers
    (prolong with the coarse grid's mid tables), as a kron of per-axis
    1D prolongations."""
    import scipy.sparse as sp

    P = None
    for d in range(fine.dim):
        tab, off = _gd_mid_table(coarse, d)
        nc = coarse.nodes[d]
        nf = fine.nodes[d]
        p1 = tab.shape[1]
        rows = list(2 * np.arange(nc))
        cols = list(np.arange(nc))
        vals = [1.0] * nc
        for c in range(coarse.cells[d]):
            for j in range(p1):
                rows.append(2 * c + 1)
                cols.append(off[c] + j)
                vals.append(tab[c, j])
        P1 = sp.csr_matrix((vals, (rows, cols)), shape=(nf, nc))
        P = P1 if P is None else sp.kron(P, P1, format="csr")
    return P


def _lambda_max_lanczos(A, s_apply, n_iter: int = 25, seed: int = 0):
    """lambda_max(S A) via the Lanczos tridiagonal of a preconditioned-
    CG run (deal.II PreconditionChebyshev's EigenvalueAlgorithm::lanczos
    semantics): run n_iter CG iterations on A with preconditioner S and
    take the largest eigenvalue of T with T[k,k] = 1/alpha_k +
    beta_{k-1}/alpha_{k-1}, T[k,k+1] = sqrt(beta_k)/alpha_k.

    Not the default: gdm measured 44 against the power iteration's 26
    CG iterations at 256^2 step85 with identical fine-level estimates
    (the estimator note in CutMultigrid).  Reachable via
    CutMultigrid(estimator="lanczos")."""
    from scipy.linalg import eigh_tridiagonal

    rng = np.random.default_rng(seed)
    r = rng.standard_normal(A.shape[0])
    z = s_apply(r)
    rz = float(r @ z)
    p = z.copy()
    alphas, betas = [], []
    for _ in range(n_iter):
        Ap = A @ p
        pAp = float(p @ Ap)
        if pAp <= 0.0 or rz <= 0.0:
            break
        alpha = rz / pAp
        r = r - alpha * Ap
        z = s_apply(r)
        rz_new = float(r @ z)
        if rz_new <= 0.0:
            alphas.append(alpha)
            betas.append(0.0)
            break
        beta = rz_new / rz
        alphas.append(alpha)
        betas.append(beta)
        p = z + beta * p
        rz = rz_new
    m = len(alphas)
    if m == 0:
        return 0.0
    diag = np.array([1.0 / alphas[k]
                     + (betas[k - 1] / alphas[k - 1] if k else 0.0)
                     for k in range(m)])
    if m == 1:
        return float(diag[0])
    off = np.array([np.sqrt(max(betas[k], 0.0)) / alphas[k]
                    for k in range(m - 1)])
    return float(eigh_tridiagonal(diag, off, select="i",
                                  select_range=(m - 1, m - 1))[0][-1])


def _cut_windows(grid: Grid, level_set_function, level_set_degree):
    """Intersected-cell dof windows from the level's own classification
    (geometry only — no quadrature)."""
    ls = LevelSetInterpolant(grid, level_set_function, level_set_degree)
    locations = classify_cells(ls)
    loc_flat = np.transpose(
        locations, list(range(grid.dim - 1, -1, -1))).reshape(-1)
    cut_ids = np.where(loc_flat == INTERSECTED)[0].astype(np.int64)
    if not len(cut_ids):
        return np.zeros((0, (grid.degree + 1) ** grid.dim), np.int64)
    return windows_c_order(grid, cut_ids)


def _sparse_to_band(A, grid: Grid) -> StencilOperator:
    """Host CSR (structured-stencil sparsity) -> StencilOperator."""
    Ac = A.tocoo()
    coords_r = np.stack(np.unravel_index(Ac.row, grid.nodes), -1)
    coords_c = np.stack(np.unravel_index(Ac.col, grid.nodes), -1)
    delta = coords_c - coords_r
    radius = int(np.abs(delta).max()) if len(delta) else 1
    K = 2 * radius + 1
    band = np.zeros((grid.n_nodes, K**grid.dim))
    off = np.zeros(len(delta), np.int64)
    for d in range(grid.dim):
        off = off * K + (delta[:, d] + radius)
    np.add.at(band, (Ac.row, off), Ac.data)
    return StencilOperator(grid, band.reshape(grid.nodes + (K,) * grid.dim),
                           radius)


class CutMultigrid:
    """Symmetric V-cycle preconditioner for an assembled cut operator
    (StencilOperator).  SPD; use as CG preconditioner via
    :meth:`precondition` on flat node vectors.

    gdm's parameters in gdm's order, then ``device`` (the card unless
    ``device="cpu"`` is asked for) and ``dtype`` of the level tables.
    ``levels[k]`` holds the level's ``grid``, ``band`` (its
    StencilOperator), ``apply``, ``lmax``, ``omega`` and, where the
    level has cut cells, ``win`` and ``inv`` (the Schwarz windows and
    their dense block inverses)."""

    def __init__(self, st: StencilOperator, level_set_function,
                 level_set_degree: int = None, coarsest: int = 16,
                 n_smooth: int = 2, smoother: str = "chebyshev",
                 cheb_degree: int = 4, cheb_range: float = 20.0,
                 estimator: str = "power", device="cuda",
                 dtype=torch.float64):
        if estimator not in ESTIMATORS:
            raise ValueError(
                f"CutMultigrid: estimator={estimator!r} is not one of "
                f"{ESTIMATORS} (gdm takes any other value as 'power')")
        self.device = _device.resolve(device)
        self.dtype = dtype = _device.resolve_dtype(dtype)
        grid = st.grid
        deg = (level_set_degree if level_set_degree is not None
               else grid.degree)
        self.n_smooth = n_smooth
        self.smoother = smoother
        self.cheb_degree = cheb_degree
        self.cheb_range = cheb_range
        self.estimator = estimator

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        A = _band_to_sparse(st)
        self.levels = []
        g = grid
        first = True
        while True:
            win = _cut_windows(g, level_set_function, deg)
            diag = A.diagonal()
            covered = np.zeros(g.n_nodes, bool)
            band = st if first else _sparse_to_band(A, g)
            lvl = {"grid": g, "band": band, "apply": routed_apply(band)}
            first = False
            inv_h = None
            if win.size:
                covered[win.reshape(-1)] = True
                Ad = A.toarray() if g.n_nodes <= 4096 else None
                blocks = np.empty((len(win), win.shape[1], win.shape[1]))
                for i, w in enumerate(win):
                    sub = (Ad[np.ix_(w, w)] if Ad is not None
                           else A[w][:, w].toarray())
                    blocks[i] = sub
                inv_h = np.linalg.inv(blocks)
                lvl["win"] = torch.as_tensor(win, dtype=torch.int64,
                                             device=self.device)
                lvl["inv"] = dev(inv_h)
            safe = np.where(diag <= 0.0, 1.0, diag)
            jac_h = np.where(covered, 0.0, 1.0 / safe)
            lvl["jac"] = dev(jac_h)

            def s_apply(w_, jac_h=jac_h, inv_h=inv_h, win=win):
                z = jac_h * w_
                if inv_h is not None:
                    zl = np.einsum("nij,nj->ni", inv_h, w_[win])
                    np.add.at(z, win.reshape(-1), zl.reshape(-1))
                return z

            # lambda_max(S A) by 30-step power iteration, as gdm: its
            # CG-Lanczos variant (estimator="lanczos") measured worse
            # (44 against 26 CG iterations at 256^2 step85; the response
            # is a knife edge in the coarse-level Chebyshev intervals)
            rng = np.random.default_rng(0)
            v = rng.standard_normal(g.n_nodes)
            lam_p = 1.0
            for _ in range(30):
                z = s_apply(A @ v)
                lam_p = np.linalg.norm(z)
                v = z / lam_p
            lam = lam_p
            if self.estimator == "lanczos":
                lam = max(lam_p, _lambda_max_lanczos(A, s_apply))
            lvl["omega"] = 1.0 / (1.15 * lam)
            lvl["lmax"] = lam
            self.levels.append(lvl)
            if min(g.cells) // 2 < coarsest or any(c % 2 for c in g.cells):
                break
            gc = Grid(g.degree, tuple(c // 2 for c in g.cells), g.lower,
                      g.upper, 1)
            P = _prolong_sparse(g, gc)
            A = (P.T @ (A @ P)).tocsr()
            lvl["transfers"] = tuple(
                make_transfer(*_gd_mid_table(gc, d), self.device, dtype)
                for d in range(g.dim))
            g = gc
        if len(self.levels) == 1:
            raise ValueError(
                "CutMultigrid: grid %s cannot be coarsened; use even cell "
                "counts >= %d" % (grid.cells, 2 * coarsest))
        self.coarse_inv = dev(np.linalg.inv(A.toarray()))

    def _schwarz(self, lvl, r):
        z = lvl["jac"] * r
        if "win" in lvl:
            win = lvl["win"]
            zl = torch.einsum("nij,nj->ni", lvl["inv"], r[win])
            z = z.index_add_(0, win.reshape(-1), zl.reshape(-1))
        return z

    def _smooth(self, lvl, u, b):
        if self.smoother == "chebyshev":
            return self._smooth_cheb(lvl, u, b)
        for _ in range(self.n_smooth):
            u = u + lvl["omega"] * self._schwarz(lvl, b - lvl["apply"](u))
        return u

    def _smooth_cheb(self, lvl, u, b):
        """Chebyshev(cheb_degree) acceleration of the Schwarz/Jacobi-
        preconditioned iteration over [lmax/cheb_range, 1.1*lmax]
        (deal.II PreconditionChebyshev semantics), as gdm."""
        lmax = 1.1 * lvl["lmax"]
        lmin = lmax / self.cheb_range
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        d = self._schwarz(lvl, b - lvl["apply"](u)) / theta
        u = u + d
        for _ in range(self.cheb_degree - 1):
            z = self._schwarz(lvl, b - lvl["apply"](u))
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            u = u + d
            rho = rho_new
        return u

    def _coarse_solve(self, b):
        if self.coarse_inv.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "CutMultigrid: torch.backends.cuda.matmul.allow_tf32 is on; "
                "the coarse solve must run in full float32")
        return torch.mv(self.coarse_inv, b)

    def _vcycle(self, k, b):
        lvl = self.levels[k]
        if k == len(self.levels) - 1:
            return self._coarse_solve(b)
        u = self._smooth(lvl, torch.zeros_like(b), b)
        r = (b - lvl["apply"](u)).reshape(lvl["grid"].nodes)
        for d in range(lvl["grid"].dim):
            r = restrict(r, d, lvl["transfers"][d])
        ec = self._vcycle(k + 1, r.reshape(-1))
        e = ec.reshape(self.levels[k + 1]["grid"].nodes)
        for d in range(lvl["grid"].dim):
            e = prolong(e, d, lvl["transfers"][d], lvl["grid"].nodes[d])
        return self._smooth(lvl, u + e.reshape(-1), b)

    def precondition(self, r):
        """r: flat (n_nodes,) residual."""
        return self._vcycle(0, r)


def cut_poisson_multigrid(op, gamma_A: float, nitsche_gamma: float,
                          level_set_function, level_set_degree=None,
                          with_nitsche: bool = True,
                          with_bdry_nitsche: bool = False,
                          **kw) -> CutMultigrid:
    """V-cycle preconditioner for the cut stiffness system (step85 / wave
    spatial operator; reference AMG role problem.h:461-469).
    op: CutOperators of the fine level; ``kw`` goes to CutMultigrid
    (``device`` and ``dtype`` among them)."""
    st = assemble_stencil(op, "stiff", gamma_A, nitsche_gamma,
                          with_nitsche=with_nitsche,
                          with_bdry_nitsche=with_bdry_nitsche)
    return CutMultigrid(st, level_set_function,
                        level_set_degree=level_set_degree, **kw)


def cut_heat_impl_multigrid(op, dt: float, gamma_M: float, gamma_A: float,
                            nitsche_gamma: float, level_set_function,
                            level_set_degree=None,
                            with_nitsche: bool = True,
                            **kw) -> CutMultigrid:
    """V-cycle preconditioner for the implicit-Euler system M + dt*S
    (reference problem.h:210-279)."""
    m = assemble_stencil(op, "mass", gamma_M)
    s = assemble_stencil(op, "stiff", gamma_A, nitsche_gamma,
                         with_nitsche=with_nitsche,
                         inactive_identity=False)
    st = StencilOperator(op.grid, m.band_host + dt * s.band_host, m.radius)
    return CutMultigrid(st, level_set_function,
                        level_set_degree=level_set_degree, **kw)
