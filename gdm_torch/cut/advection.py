"""Matrix-free cut advection operator (upwind embedded/boundary fluxes,
BC values as extra ODE unknowns).

Port of gdm/cut/advection.py (reference: applications/advection/include/
gdm/advection/stiffness.h).  Weak form with alpha=0 (stiffness.h:256,
408-417):
    r(v) = (u a, grad v)_K
         + <(a.n) (-(a.n >= 0 ? u^- : u^+)), v>_{surface + boundary}
         - gamma_A h^2 <[d_n v],[d_n u]>_GP-faces
The boundary values u^+ live in their own blocks and evolve through RK
stages with d(bc)/dt = exact_solution_der (stiffness.h:285-289).

GP counting: the reference visits faces twice with 0.5 (stiffness.h:585),
we enumerate once -> net scale gamma_A * h^2.

The applies are torch (gather -> einsum -> index_add_) on the device of
their input.  Every host array, the operators' tables and the ones
derived here (the full cells' gathered advection matrices, G . a on the
cut cells' points, the fluxes a.n), comes through ``CutOperators.table``:
one copy to the device per (device, dtype).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops1d import local_matrices_1d
from .operators import CutOperators, _like


class AdvectionOperators:
    """Wraps a CutOperators data set with advection-specific applies.

    velocity: constant advection vector for this location's subdomain.
    """

    def __init__(self, ops: CutOperators, velocity):
        self.ops = ops
        self.a = np.asarray(velocity, dtype=np.float64)
        # per-point fluxes a.n on the embedded surface and boundary faces
        self.flux_surf = np.einsum("nqd,d->nq", ops.surf_n, self.a)
        self.flux_bdry = np.einsum("nd,d->n", ops.b_normal, self.a)[:, None] * \
            np.ones_like(ops.b_w)
        # the tables derived here, named apart per velocity (two
        # AdvectionOperators may wrap one CutOperators)
        self._tag = repr(tuple(float(x) for x in self.a))
        self._derived = {
            "full": lambda: self._full_matrices()[ops.cat_full],
            "full_strong": lambda: self._full_matrices_strong()[ops.cat_full],
            "Ga_cut": lambda: np.einsum("nqdi,d->nqi", ops.G_cut, self.a),
            "flux_surf": lambda: self.flux_surf,
            "flux_bdry": lambda: self.flux_bdry,
        }

    def table(self, name: str, u: torch.Tensor) -> torch.Tensor:
        """The operators' table ``name`` on u's device in u's dtype, or
        one derived here: ``"full"``/``"full_strong"`` the full cells'
        gathered (m, m) matrices of the weak/strong form, ``"Ga_cut"``
        G . a at the cut cells' volume points, ``"flux_surf"`` and
        ``"flux_bdry"`` a.n at the surface and boundary-face points."""
        make = self._derived.get(name)
        if make is None:
            return self.ops.table(name, u)
        return self.ops.table(f"adv_{name}{self._tag}", u, host=make)

    # -- rhs ------------------------------------------------------------
    def compute_rhs(self, u, bc_surf, bc_bdry, gamma_A, u_other=None):
        """Advection RHS for one location.

        bc_surf: (n_cut, Qs) boundary values at embedded-surface quadrature
        points (used when u_other is None, i.e. non-composite);
        bc_bdry: (n_bf, Qb) values at domain-boundary face points.
        u_other: the other block's node vector (composite coupling).
        Values may be tensors or numpy arrays.
        """
        ops = self.ops
        tab = self.table
        y = torch.zeros_like(u)

        # (I) cell term (u a, grad v)
        if len(ops.full_ids):
            win = tab("w_full", u)
            y = ops._scatter(y, win, ops.cell_matvec(u, win, tab("full", u)))
        if len(ops.cut_ids):
            win = tab("w_cut", u)
            uq = torch.einsum("nqi,ni->nq", tab("V_cut", u), u[win])
            y = ops._scatter(y, win, torch.einsum(
                "nqi,nq,nq->ni", tab("Ga_cut", u), uq, tab("vol_w", u)))

        # (II) embedded-surface upwind flux
        if len(ops.cut_ids):
            V = tab("V_surf", u)
            win = tab("w_cut", u)
            flux = tab("flux_surf", u)
            um = torch.einsum("nqi,ni->nq", V, u[win])
            if u_other is not None:
                up = torch.einsum("nqi,ni->nq", V, u_other[win])
            else:
                up = _like(bc_surf, u)
            upwind = torch.where(flux >= 0.0, um, up)
            y = ops._scatter(y, win, torch.einsum(
                "nqi,nq,nq->ni", V, -flux * upwind, tab("surf_w", u)))

        # (III) domain-boundary upwind flux
        if len(ops.b_win):
            V = tab("b_V", u)
            win = tab("b_win", u)
            flux = tab("flux_bdry", u)
            um = torch.einsum("nqi,ni->nq", V, u[win])
            upwind = torch.where(flux >= 0.0, um, _like(bc_bdry, u))
            y = ops._scatter(y, win, torch.einsum(
                "nqi,nq,nq->ni", V, -flux * upwind, tab("b_w", u)))

        # (IV) ghost penalty, h^2 scaling
        return ops._gp_apply(y, u, -gamma_A * ops.h_min**2)

    def compute_rhs_strong(self, u, gamma_A=0.0):
        """Advection RHS in the alpha=1 (non-integrated-by-parts) form
        used by the reference's STRONG-Dirichlet path
        (prototypes/advection_02_gdm.cc:424-427 with alpha=1.0,
        weak_bc=false): r(v) = -(a . grad u, v)_K, no boundary-face flux
        terms; boundary values are enforced nodally by the caller."""
        ops = self.ops
        tab = self.table
        y = torch.zeros_like(u)
        if len(ops.full_ids):
            win = tab("w_full", u)
            y = ops._scatter(y, win, ops.cell_matvec(u, win,
                                                     tab("full_strong", u)))
        if len(ops.cut_ids):
            win = tab("w_cut", u)
            gq = torch.einsum("nqi,ni->nq", tab("Ga_cut", u), u[win])
            y = ops._scatter(y, win, torch.einsum(
                "nqi,nq,nq->ni", tab("V_cut", u), -gq, tab("vol_w", u)))
        return ops._gp_apply(y, u, -gamma_A * ops.h_min**2)

    def _cell_matrices(self, deriv, sign):
        """(ncat^dim, m, m) cell matrices: sum over the velocity's nonzero
        axes dd of the Kronecker product with ``sign * a[dd]`` times the
        1D matrix of derivative ``deriv`` on axis dd and the 1D mass
        times h on the others."""
        grid = self.ops.grid
        p = grid.degree
        dim = grid.dim
        ncat = max(p, 1)
        A00 = local_matrices_1d(p, 0, 0, self.ops.nq)
        Ad = local_matrices_1d(p, *deriv, self.ops.nq)
        mats = np.zeros(((ncat,) * dim) + ((p + 1) ** dim, (p + 1) ** dim))
        for combo in np.ndindex(*([ncat] * dim)):
            total = 0.0
            for dd in range(dim):
                if self.a[dd] == 0.0:
                    continue
                term = np.ones((1, 1))
                for d in range(dim):
                    if d == dd:
                        f = Ad[combo[d]] * (sign * self.a[dd])  # h^0
                    else:
                        f = A00[combo[d]] * grid.h[d]
                    term = np.kron(f, term)
                total = total + term
            mats[combo] = total
        m = (p + 1) ** dim
        return np.transpose(
            mats, tuple(range(dim - 1, -1, -1)) + (dim, dim + 1)
        ).reshape(-1, m, m)

    def _full_matrices_strong(self):
        """(ncat^dim, m, m) cell matrices -(a . grad u, v)."""
        if not hasattr(self, "_full_mats_strong"):
            self._full_mats_strong = self._cell_matrices((0, 1), -1.0)
        return self._full_mats_strong

    def _full_matrices(self):
        """(ncat^dim, m, m) cell advection matrices (u a, grad v)."""
        if not hasattr(self, "_full_mats"):
            self._full_mats = self._cell_matrices((1, 0), 1.0)
        return self._full_mats

    # -- surface error norms --------------------------------------------
    def surface_error_norms(self, u, exact_fn, t):
        """(L2, L1, Linf) of u - exact on the embedded surface, as Python
        floats (zeros without cut cells): ``surface_error_norms_tensor``
        and one read."""
        return tuple(self.surface_error_norms_tensor(u, exact_fn, t).tolist())

    def surface_error_norms_tensor(self, u, exact_fn, t):
        """(L2, L1, Linf) on the embedded surface as a (3,) tensor on u's
        device, no host read (the counterpart of
        ``CutOperators.error_norms_tensor``); ``exact_fn`` is called on
        the cached table of surface points."""
        ops = self.ops
        if not len(ops.cut_ids):
            return u.new_zeros(3)
        w = ops.table("surf_w", u)
        uq = torch.einsum("nqi,ni->nq", ops.table("V_surf", u),
                          u[ops.table("w_cut", u)])
        d = uq - _like(exact_fn(ops.table("surf_phys_q", u), t), u)
        l2 = torch.sqrt(torch.sum(d * d * w))
        l1 = torch.sum(d.abs() * w)
        linf = torch.where(w > 0, d.abs(), 0.0).max()
        return torch.stack([l2, l1, linf])
