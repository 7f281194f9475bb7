"""Cut-cell (CutFEM) operator tables and the matrix-free right-hand side.

Port of gdm/cut/operators.py.  The constructor's host tables (numpy,
verbatim) feed the band assembly in gdm_torch.cut.stencil.  The
device-side operations of the wave application, ``compute_rhs``,
``mass_apply`` (with ``cell_matvec``) and ``error_norms``, are torch
(gather -> einsum -> index_add_) on the device of their input, with the
host tables moved there once per (device, dtype) and cached.  gdm's
matrix-free ``stiffness_matrix_apply`` waits for the implicit heat
solve, and the deformed-grid constructor argument ``mapping_fn`` raises
until gdm/deform.py is ported.

Operators of the reference wave application:

* cut mass matrix  (applications/wave/include/gdm/wave/mass.h:47-249):
  cell integral over the subdomain + ghost penalty gamma_M*h^3
  <[d_n v],[d_n u]> on faces adjacent to intersected cells + the 0->1
  diagonal fixup for untouched dofs.
* cut stiffness matrix (…/wave/stiffness.h:589-799): cell (grad v, grad u)
  + Nitsche interface terms - <v,d_n u> - <d_n v,u> + gamma_D/h <v,u>
  + ghost penalty gamma_A*h^3.
* matrix-free RHS / operator action (…/wave/stiffness.h:42-407): cell
  -(grad v, grad u) + (v, f); Nitsche surface with time-dependent g_D;
  Nitsche on (cut) domain-boundary faces; ghost-penalty action with
  gamma_A*h^1 scaling (the reference's explicit path scales GP by h, its
  matrix path by h^3 — reproduced faithfully).

Ghost-penalty counting: the reference loops cells and visits every
penalized interior face from BOTH sides with a 0.5 factor (mass.h:181-232),
netting 1.0x per face; we enumerate each face once, so the scales here
carry no 0.5 (verified digit-exact against the heat_0 golden).

Geometry tables are precomputed host-side by gdm_torch.cut.geometry.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import quadrature
from ..grid import Grid
from ..ops1d import local_matrices_1d
from .geometry import INSIDE, OUTSIDE, CutGeometry
from .tables import (
    basis_at_points,
    cell_axis_categories,
    cell_axis_indices,
    gradients_at_points,
    windows_c_order,
)


def _combined_local_matrices(grid: Grid, kind: str, nq: int) -> np.ndarray:
    """(ncat^dim, m, m) full-cell local matrices by combined category id
    (base-p, axis 0 fastest).  kind: 'mass' or 'stiff'."""
    p = grid.degree
    dim = grid.dim
    ncat = max(p, 1)
    A00 = local_matrices_1d(p, 0, 0, nq)
    A11 = local_matrices_1d(p, 1, 1, nq)
    mats = np.zeros(((ncat,) * dim) + ((p + 1) ** dim, (p + 1) ** dim))
    # build per-axis factors; combined local ordering axis-0-fastest
    for combo in np.ndindex(*([ncat] * dim)):
        terms = []
        if kind == "mass":
            term = np.ones((1, 1))
            for d in range(dim):
                f = A00[combo[d]] * grid.h[d]
                term = np.kron(f, term)  # higher axis slower
            terms.append(term)
        else:  # stiffness sum_d
            for dd in range(dim):
                term = np.ones((1, 1))
                for d in range(dim):
                    if d == dd:
                        f = A11[combo[d]] / grid.h[d]
                    else:
                        f = A00[combo[d]] * grid.h[d]
                    term = np.kron(f, term)
                terms.append(term)
        mats[combo] = sum(terms)
    # combined category id is base-p with axis 0 fastest -> F-order ravel
    # of the leading dim axes
    m = (p + 1) ** dim
    return np.transpose(
        mats, tuple(range(dim - 1, -1, -1)) + (dim, dim + 1)
    ).reshape(-1, m, m)


def _combined_cat_ids(cats: np.ndarray, p: int) -> np.ndarray:
    """(n, dim) per-axis categories -> flat combined id, axis 0 fastest."""
    ncat = max(p, 1)
    out = np.zeros(len(cats), dtype=np.int64)
    stride = 1
    for d in range(cats.shape[1]):
        out += cats[:, d] * stride
        stride *= ncat
    return out


def _pad2(arrs, fill=0.0):
    """Pad a list of variable-length arrays (along axis 0) to a common
    length; returns (stacked, lengths)."""
    if not arrs:
        return np.zeros((0, 0)), np.zeros(0, dtype=np.int64)
    mx = max(a.shape[0] for a in arrs) or 1
    out = []
    for a in arrs:
        pad = [(0, mx - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad, constant_values=fill))
    return np.stack(out), np.array([a.shape[0] for a in arrs])


def _like(a, u):
    """``a`` (numpy or tensor) as a tensor on u's device, in u's dtype."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, dtype=u.dtype, device=u.device)


def _to_device(a: np.ndarray, device, dtype) -> torch.Tensor:
    """A host table as a tensor on ``device`` (one host-to-device copy)."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


# host tables that are indices (int64 on the device) or masks (bool)
_INDEX_TABLES = ("w_full", "w_cut", "gp_win", "b_win", "cat_full")
_MASK_TABLES = ("inactive",)


class CutOperators:
    """Host tables + the torch RHS for one location (INSIDE or OUTSIDE).

    ``mapping_fn``/``geometry`` keep gdm's signature; a deformation
    (``mapping_fn`` not None) raises NotImplementedError until
    gdm/deform.py is ported, so ``geometry`` is unused and ``w_q_cell``
    (gdm's per-cell full-cell JxW of a deformed run) is None.

    The device-side methods read the host tables through ``table``,
    which moves each to the device once per (device, dtype) and keeps
    it, as ``StencilOperator.band_tensor`` does for the band.
    """

    def __init__(self, geo: CutGeometry, location: int = INSIDE, nq: int = None,
                 mapping_fn=None, geometry: str = "q1"):
        grid = geo.grid
        assert grid.n_components == 1, "cut path supports scalar fields"
        if mapping_fn is not None:
            raise NotImplementedError(
                "deformed cut operators (mapping_fn) are not ported yet: "
                "they wait for gdm/deform.py")
        self.grid = grid
        self.w_q_cell = None  # per-cell full-cell JxW (deformed runs only)
        self._tables = {}
        self.geo = geo
        self.location = location
        p = grid.degree
        dim = grid.dim
        self.nq = nq if nq is not None else p + 1
        self.h_min = min(grid.h)
        loc_flat = geo.locations_flat
        inverse = OUTSIDE if location == INSIDE else INSIDE
        same = location

        # ---- full (same-side, uncut) cells --------------------------------
        full_ids = np.where(loc_flat == same)[0].astype(np.int32)
        self.full_ids = full_ids
        self.w_full = windows_c_order(grid, full_ids)
        cats_full = cell_axis_categories(grid, full_ids)
        self.cat_full = _combined_cat_ids(cats_full, p)
        self.A_mass = _combined_local_matrices(grid, "mass", self.nq)
        self.A_stiff = _combined_local_matrices(grid, "stiff", self.nq)
        # full-cell quadrature (for f-term and error norms)
        gx, gw = quadrature.gauss(self.nq)
        ref_pts_1d = [gx] * dim
        mesh = np.meshgrid(*ref_pts_1d, indexing="ij")
        # ordering: axis-0-fastest to match nothing in particular; use
        # C-order of meshgrid then flatten consistently everywhere here.
        self.ref_q = np.stack([m.reshape(-1) for m in mesh], axis=-1)  # (Q, dim)
        wmesh = np.meshgrid(*([gw] * dim), indexing="ij")
        self.w_q = np.multiply.reduce([m.reshape(-1) for m in wmesh]) * np.prod(
            grid.h
        )  # (Q,) physical
        self.V_full_cat = np.stack(
            [
                basis_at_points(
                    grid,
                    np.array([_cat_tuple(c, p, dim)] ),
                    self.ref_q[None, :, :],
                )[0]
                for c in range(max(p, 1) ** dim)
            ]
        )  # (ncat^dim, Q, m)
        self.full_phys_q = self._phys_points(full_ids, self.ref_q)

        # ---- intersected cells -------------------------------------------
        cut_ids = geo.cut_cells
        self.cut_ids = cut_ids
        m = (p + 1) ** dim
        if len(cut_ids) == 0:
            self.w_cut = np.zeros((0, m), dtype=np.int32)
            self.vol_pts = np.zeros((0, 1, dim))
            self.vol_w = np.zeros((0, 1))
            self.V_cut = np.zeros((0, 1, m))
            self.G_cut = np.zeros((0, 1, dim, m))
            self.cut_phys_q = np.zeros((0, 1, dim))
            self.surf_pts = np.zeros((0, 1, dim))
            self.surf_w = np.zeros((0, 1))
            self.surf_n = np.zeros((0, 1, dim))
            self.V_surf = np.zeros((0, 1, m))
            self.G_surf = np.zeros((0, 1, dim, m))
            self.surf_phys_q = np.zeros((0, 1, dim))
            self.nvol = np.zeros(0, dtype=np.int64)
            self.nsurf = np.zeros(0, dtype=np.int64)
            self._build_gp(geo.ghost_penalty_faces(location))
            active = np.zeros(grid.n_nodes, dtype=bool)
            if len(self.w_full):
                active[self.w_full.reshape(-1)] = True
            self.inactive = ~active
            self._build_boundary_faces(loc_flat, inverse)
            return
        self.w_cut = windows_c_order(grid, cut_ids)
        cats_cut = cell_axis_categories(grid, cut_ids)
        side_attr = "inside" if location == INSIDE else "outside"
        vol_pts, self.nvol = _pad2([getattr(q, side_attr + "_pts") for q in geo.cut_quads])
        vol_w, _ = _pad2([getattr(q, side_attr + "_w") for q in geo.cut_quads])
        if vol_pts.ndim == 2:  # empty
            vol_pts = np.zeros((len(cut_ids), 1, dim))
            vol_w = np.zeros((len(cut_ids), 1))
        self.vol_pts = vol_pts
        self.vol_w = vol_w * np.prod(grid.h)  # physical JxW
        self.V_cut = basis_at_points(grid, cats_cut, vol_pts)
        self.G_cut = gradients_at_points(grid, cats_cut, vol_pts)
        self.cut_phys_q = self._phys_points(cut_ids, vol_pts, per_cell=True)

        surf_pts, self.nsurf = _pad2([q.surface_pts for q in geo.cut_quads])
        surf_w, _ = _pad2([q.surface_w for q in geo.cut_quads])
        surf_n, _ = _pad2([q.surface_normals for q in geo.cut_quads])
        if surf_pts.ndim == 2:
            surf_pts = np.zeros((len(cut_ids), 1, dim))
            surf_w = np.zeros((len(cut_ids), 1))
            surf_n = np.zeros((len(cut_ids), 1, dim))
        sign = 1.0 if location == INSIDE else -1.0
        self.surf_pts = surf_pts
        self.surf_w = surf_w
        self.surf_n = surf_n * sign  # outward from this location's region
        self.V_surf = basis_at_points(grid, cats_cut, surf_pts)
        self.G_surf = gradients_at_points(grid, cats_cut, surf_pts)
        self.surf_phys_q = self._phys_points(cut_ids, surf_pts, per_cell=True)

        # ---- ghost-penalty faces -----------------------------------------
        faces = geo.ghost_penalty_faces(location)
        self._build_gp(faces)

        # ---- active/inactive dofs ----------------------------------------
        active = np.zeros(grid.n_nodes, dtype=bool)
        for w in (self.w_full, self.w_cut):
            if len(w):
                active[w.reshape(-1)] = True
        self.inactive = ~active  # C-order node mask

        # ---- domain-boundary faces (for domain_dbc Nitsche) --------------
        self._build_boundary_faces(loc_flat, inverse)


    # ------------------------------------------------------------------
    def _phys_points(self, flat_ids, ref_pts, per_cell=False):
        grid = self.grid
        idx = cell_axis_indices(grid, flat_ids)  # (n, dim)
        lo = np.stack(
            [grid.lower[d] + idx[:, d] * grid.h[d] for d in range(grid.dim)],
            axis=-1,
        )  # (n, dim)
        if per_cell:
            return lo[:, None, :] + ref_pts * np.asarray(grid.h)[None, None, :]
        return lo[:, None, :] + ref_pts[None, :, :] * np.asarray(grid.h)[None, None, :]

    def _build_gp(self, faces):
        """Precompute per-face jump tables: J (nF, Qf, 2m) with
        J = n . [grad phi] at full-face tensor Gauss points."""
        grid = self.grid
        p = grid.degree
        dim = grid.dim
        m = (p + 1) ** dim
        gx, gw = quadrature.gauss(self.nq)
        Js, Ws, Wins = [], [], []
        for (axis, cm, cp) in faces:
            cat_m = cell_axis_categories(grid, np.array([cm]))
            cat_p = cell_axis_categories(grid, np.array([cp]))
            # face quadrature points in each cell's reference coords
            tang = [d for d in range(dim) if d != axis]
            if tang:
                meshes = np.meshgrid(*([gx] * len(tang)), indexing="ij")
                tp = np.stack([mm.reshape(-1) for mm in meshes], axis=-1)
                wmesh = np.meshgrid(*([gw] * len(tang)), indexing="ij")
                tw = np.multiply.reduce([mm.reshape(-1) for mm in wmesh])
                tw = tw * np.prod([grid.h[d] for d in tang])
            else:
                tp = np.zeros((1, 0))
                tw = np.ones(1)
            Qf = len(tp)
            pts_m = np.zeros((Qf, dim))
            pts_p = np.zeros((Qf, dim))
            pts_m[:, axis] = 1.0  # right face of cell-minus
            pts_p[:, axis] = 0.0
            for i, d in enumerate(tang):
                pts_m[:, d] = tp[:, i]
                pts_p[:, d] = tp[:, i]
            dmask = tuple(1 if e == axis else 0 for e in range(dim))
            Gm = basis_at_points(grid, cat_m, pts_m[None], dmask)[0]
            Gp = basis_at_points(grid, cat_p, pts_p[None], dmask)[0]
            J = np.concatenate([Gm, -Gp], axis=-1)  # (Qf, 2m) = n.[grad]
            Js.append(J)
            Ws.append(tw)
            wm = windows_c_order(grid, np.array([cm], dtype=np.int64))[0]
            wp = windows_c_order(grid, np.array([cp], dtype=np.int64))[0]
            Wins.append(np.concatenate([wm, wp]))
        if Js:
            self.gp_J = np.stack(Js)  # (nF, Qf, 2m)
            self.gp_w = np.stack(Ws)  # (nF, Qf)
            self.gp_win = np.stack(Wins).astype(np.int32)  # (nF, 2m)
            # face matrices (without gamma*h scaling)
            self.gp_mat = np.einsum("fqa,fqb,fq->fab", self.gp_J, self.gp_J, self.gp_w)
        else:
            self.gp_J = np.zeros((0, 1, 2 * m))
            self.gp_w = np.zeros((0, 1))
            self.gp_win = np.zeros((0, 2 * m), dtype=np.int32)
            self.gp_mat = np.zeros((0, 2 * m, 2 * m))

    def _build_boundary_faces(self, loc_flat, inverse):
        """Cut quadrature on domain-boundary faces of non-inverse cells.

        1D: the boundary point (weight 1) if the interpolated level set
        puts it on this location's side.  2D: 1D cut quadrature along the
        face via the same root-finding machinery.  3D: 2D Saye-style
        dimension reduction on the face restriction of the level-set
        polynomial (_face_quad_3d) — the reference's boundary-face loop
        is dim-generic (wave/stiffness.h:261-330).
        """
        grid = self.grid
        geo = self.geo
        dim = grid.dim
        p = grid.degree
        m = (p + 1) ** dim
        gx, gw = quadrature.gauss(self.nq)
        items = []  # (cell_flat, V (Qb,m), G (Qb,dim,m), w (Qb,), normal(dim,), phys (Qb,dim))
        want_neg = self.location == INSIDE
        from .geometry import QuadratureGenerator, _flatten

        qg = QuadratureGenerator(geo.ls, self.nq)
        Vinv_ls = np.linalg.inv(
            np.vander(np.asarray(geo.ls.nodes), geo.ls.q, increasing=True))
        for d in range(dim):
            for side in (0, 1):
                # enumerate only the cells on this boundary plane
                other_ranges = [range(grid.cells[e]) if e != d else
                                [0 if side == 0 else grid.cells[d] - 1]
                                for e in range(dim)]
                import itertools as _it

                for idx in _it.product(*other_ranges):
                    flat = _flatten(list(idx), grid.cells)
                    if loc_flat[flat] == inverse:
                        continue
                    face_coord = 0.0 if side == 0 else 1.0
                    # build face quadrature restricted to the location side
                    if dim == 1:
                        pt = np.array([[face_coord]])
                        val = geo.ls.eval_cell(idx, pt)[0]
                        if (val < 0) != want_neg:
                            continue
                        pts_ref = pt
                        w = np.array([1.0])
                    elif dim == 3:
                        pts_ref, w = _face_quad_3d(
                            qg, idx, d, face_coord, want_neg, gx, gw, grid)
                        if len(w) == 0:
                            continue
                    else:
                        tang = [e for e in range(dim) if e != d][0]
                        # polynomial along the face
                        nodal = geo.ls.line_nodal(idx, tang, {d: face_coord})
                        coeffs = Vinv_ls @ nodal
                        roots = qg._roots_in(coeffs, 0.0, 1.0)
                        breaks = np.concatenate([[0.0], roots, [1.0]])
                        ppts, ww = [], []
                        for a, b in zip(breaks[:-1], breaks[1:]):
                            if b - a < 1e-11:
                                continue
                            mid = 0.5 * (a + b)
                            v = np.polyval(coeffs[::-1], mid)
                            if (v < 0) == want_neg:
                                ppts.extend(a + gx * (b - a))
                                ww.extend(gw * (b - a) * grid.h[tang])
                        if not ppts:
                            continue
                        pts_ref = np.zeros((len(ppts), dim))
                        pts_ref[:, d] = face_coord
                        pts_ref[:, tang] = ppts
                        w = np.asarray(ww)
                    cats = cell_axis_categories(grid, np.array([flat]))
                    V = basis_at_points(grid, cats, pts_ref[None])[0]
                    G = gradients_at_points(grid, cats, pts_ref[None])[0]
                    normal = np.zeros(dim)
                    normal[d] = -1.0 if side == 0 else 1.0
                    phys = self._phys_points(np.array([flat]), pts_ref[None],
                                             per_cell=True)[0]
                    normal_q = np.broadcast_to(normal, (len(w), dim))
                    items.append((flat, V, G, w, normal, phys, normal_q))
        self.bdry = items
        if items:
            V, _ = _pad2([it[1] for it in items])
            G, _ = _pad2([it[2] for it in items])
            w, _ = _pad2([it[3] for it in items])
            phys, _ = _pad2([it[5] for it in items])
            self.b_V, self.b_G, self.b_w, self.b_phys = V, G, w, phys
            self.b_normal = np.stack([it[4] for it in items])
            self.b_normal_q, _ = _pad2([it[6] for it in items])
            self.b_win = windows_c_order(
                grid, np.array([it[0] for it in items], dtype=np.int64)
            )
        else:
            self.b_V = np.zeros((0, 1, m))
            self.b_G = np.zeros((0, 1, dim, m))
            self.b_w = np.zeros((0, 1))
            self.b_phys = np.zeros((0, 1, dim))
            self.b_normal = np.zeros((0, dim))
            self.b_normal_q = np.zeros((0, 1, dim))
            self.b_win = np.zeros((0, m), dtype=np.int32)

    # ------------------------------------------------------------------
    # device-side applies: u is the C-order flat node vector (N,); the
    # host tables come from ``table``, cached per (device, dtype)
    # ------------------------------------------------------------------
    def _host_table(self, name: str) -> np.ndarray:
        if name == "A_mass_full":
            return self.A_mass[self.cat_full]
        if name == "A_stiff_full":
            return self.A_stiff[self.cat_full]
        if name == "V_full":
            return self.V_full_cat[self.cat_full]
        return getattr(self, name)

    def table(self, name: str, u: torch.Tensor) -> torch.Tensor:
        """Host table ``name`` on u's device: int64 for an index table,
        bool for the inactive mask, else in u's dtype.  Moved there on
        the first request and cached, so the app's RHS (four calls a
        step) moves no host table after its first stage.  Besides the
        constructor's tables, ``"A_mass_full"``, ``"A_stiff_full"`` and
        ``"V_full"`` are the full cells' gathered local matrices and
        basis values."""
        if name in _INDEX_TABLES:
            dtype = torch.int64
        elif name in _MASK_TABLES:
            dtype = torch.bool
        else:
            dtype = u.dtype
        key = (name, u.device, dtype)
        t = self._tables.get(key)
        if t is None:
            t = _to_device(self._host_table(name), u.device, dtype)
            self._tables[key] = t
        return t

    @staticmethod
    def _scatter(y, win, vals):
        # in place: y is the accumulator its caller allocated
        return y.index_add_(0, win.reshape(-1), vals.reshape(-1))

    def cell_matvec(self, u, windows, mats):
        """Per-cell local products mats[n] @ u[windows[n]] (n, m)."""
        return torch.einsum("nij,nj->ni", mats, u[windows])

    def mass_apply(self, u, gamma_M: float, gp_power: int = 3):
        """y = M_cut u (cell mass over the subdomain + ghost penalty +
        inactive identity)."""
        y = torch.zeros_like(u)
        if len(self.full_ids):
            win = self.table("w_full", u)
            y = self._scatter(y, win, self.cell_matvec(
                u, win, self.table("A_mass_full", u)))
        if len(self.cut_ids):
            V = self.table("V_cut", u)
            win = self.table("w_cut", u)
            uq = torch.einsum("nqi,ni->nq", V, u[win])
            y = self._scatter(y, win, torch.einsum(
                "nqi,nq,nq->ni", V, uq, self.table("vol_w", u)))
        y = self._gp_apply(y, u, gamma_M * self.h_min**gp_power)
        return y + torch.where(self.table("inactive", u), u, 0.0)

    def _gp_apply(self, y, u, scale):
        if len(self.gp_win) == 0 or scale == 0.0:
            return y
        win = self.table("gp_win", u)
        vw = scale * torch.einsum("fab,fb->fa", self.table("gp_mat", u),
                                  u[win])
        return self._scatter(y, win, vw)

    def stiffness_matrix_apply(self, u, gamma_A, nitsche_gamma,
                               with_nitsche=True, gp_power: int = 3):
        """y = S_cut u: cell Laplace + Nitsche (interface) + GP h^3 +
        inactive identity."""
        y = torch.zeros_like(u)
        if len(self.full_ids):
            win = self.table("w_full", u)
            y = self._scatter(y, win, self.cell_matvec(
                u, win, self.table("A_stiff_full", u)))
        if len(self.cut_ids):
            G = self.table("G_cut", u)
            win = self.table("w_cut", u)
            gq = torch.einsum("nqdi,ni->nqd", G, u[win])
            y = self._scatter(y, win, torch.einsum(
                "nqdi,nqd,nq->ni", G, gq, self.table("vol_w", u)))
            if with_nitsche:
                y = self._nitsche_matrix_apply(y, u, nitsche_gamma)
        y = self._gp_apply(y, u, gamma_A * self.h_min**gp_power)
        return y + torch.where(self.table("inactive", u), u, 0.0)

    def _nitsche_matrix_apply(self, y, u, gamma):
        """The symmetric interface Nitsche terms of the stiffness:
        -<d_n v, u> - <v, d_n u> + (gamma/h) <v, u>."""
        V = self.table("V_surf", u)
        w = self.table("surf_w", u)
        win = self.table("w_cut", u)
        Gn = torch.einsum("nqdi,nqd->nqi", self.table("G_surf", u),
                          self.table("surf_n", u))
        uw = u[win]
        uq = torch.einsum("nqi,ni->nq", V, uw)
        dnuq = torch.einsum("nqi,ni->nq", Gn, uw)
        t1 = -torch.einsum("nqi,nq,nq->ni", Gn, uq, w)
        t2 = -torch.einsum("nqi,nq,nq->ni", V, dnuq, w)
        t3 = (gamma / self.h_min) * torch.einsum("nqi,nq,nq->ni", V, uq, w)
        return self._scatter(y, win, t1 + t2 + t3)

    def compute_rhs(self, u, t, impl: bool, rhs_fn=None, interface_dbc=None,
                    domain_dbc=None, gamma_A=0.0, nitsche_gamma=0.0):
        """Reference compute_rhs_internal (wave stiffness.h:42-407).

        Returns the assembled RHS vector (a tensor like ``u``).
        Functions are called as fn(phys_points_numpy, t) and may return
        numpy arrays or tensors.
        """
        y = torch.zeros_like(u)
        # (I) cell integrals
        if impl:
            # -(grad v, grad u) on full + cut cells
            if len(self.full_ids):
                win = self.table("w_full", u)
                y = self._scatter(y, win, -self.cell_matvec(
                    u, win, self.table("A_stiff_full", u)))
            if len(self.cut_ids):
                G = self.table("G_cut", u)
                w = self.table("vol_w", u)
                win = self.table("w_cut", u)
                gq = torch.einsum("nqdi,ni->nqd", G, u[win])
                y = self._scatter(
                    y, win, -torch.einsum("nqdi,nqd,nq->ni", G, gq, w))
        if rhs_fn is not None:
            if len(self.full_ids):
                f = _like(rhs_fn(self.full_phys_q, t), u)  # (nf, Q)
                vw = torch.einsum("nqi,nq,q->ni", self.table("V_full", u), f,
                                  self.table("w_q", u))
                y = self._scatter(y, self.table("w_full", u), vw)
            if len(self.cut_ids):
                f = _like(rhs_fn(self.cut_phys_q, t), u)
                vw = torch.einsum("nqi,nq,nq->ni", self.table("V_cut", u), f,
                                  self.table("vol_w", u))
                y = self._scatter(y, self.table("w_cut", u), vw)
        # (II) interface Nitsche
        if interface_dbc is not None and len(self.cut_ids):
            y = self._nitsche_rhs(
                y, u, t, impl, interface_dbc, nitsche_gamma, "V_surf",
                "G_surf", "surf_n", "surf_w", "w_cut", self.surf_phys_q)
        # (IV) domain-boundary Nitsche
        if domain_dbc is not None and len(self.b_win):
            y = self._nitsche_rhs(
                y, u, t, impl, domain_dbc, nitsche_gamma, "b_V", "b_G",
                "b_normal_q", "b_w", "b_win", self.b_phys)
        # (V) ghost-penalty action: note h^1 scaling on the explicit path
        if impl:
            y = self._gp_apply(y, u, -gamma_A * self.h_min)
        return y

    def _nitsche_rhs(self, y, u, t, impl, dbc, nitsche_gamma, V, G, nrm, w,
                     win, phys):
        """Nitsche terms of one surface family (interface or domain
        boundary), its tables named: the symmetric lhs action when
        ``impl`` and the g-weighted forcing ((gamma/h) v - d_n v, g)."""
        V = self.table(V, u)
        w = self.table(w, u)
        win = self.table(win, u)
        Gn = torch.einsum("nqdi,nqd->nqi", self.table(G, u),
                          self.table(nrm, u))
        if impl:
            uw = u[win]
            uq = torch.einsum("nqi,ni->nq", V, uw)
            dnuq = torch.einsum("nqi,ni->nq", Gn, uw)
            lhs = (-torch.einsum("nqi,nq,nq->ni", Gn, uq, w)
                   - torch.einsum("nqi,nq,nq->ni", V, dnuq, w)
                   + (nitsche_gamma / self.h_min)
                   * torch.einsum("nqi,nq,nq->ni", V, uq, w))
            y = self._scatter(y, win, -lhs)
        g = _like(dbc(phys, t), u)  # (n, Qs)
        rhsv = torch.einsum(
            "nqi,nq,nq->ni", (nitsche_gamma / self.h_min) * V - Gn, g, w)
        return self._scatter(y, win, rhsv)

    # -- error norms over the subdomain ---------------------------------
    def error_norms(self, u, exact_fn, t):
        """(L2, L1, Linf) of u - exact over this location's region, as
        Python floats (one read back to the host).

        Reference: WaveProblem::postprocess (problem.h:552-607)."""
        l2 = l1 = linf = u.new_zeros(())
        if len(self.full_ids):
            if self.w_q_cell is None:
                Vc = self.table("V_full", u)
                wq = self.table("w_q", u)[None, :]
            else:
                Vc = self.table("V_full_cat", u)
                wq = self.table("w_q_cell", u)
            uq = torch.einsum("nqi,ni->nq", Vc, u[self.table("w_full", u)])
            d = uq - _like(exact_fn(self.full_phys_q, t), u)
            l2 = l2 + torch.sum(d * d * wq)
            l1 = l1 + torch.sum(d.abs() * wq)
            linf = torch.maximum(linf, d.abs().max())
        if len(self.cut_ids):
            V = self.table("V_cut", u)
            w = self.table("vol_w", u)
            uq = torch.einsum("nqi,ni->nq", V, u[self.table("w_cut", u)])
            d = uq - _like(exact_fn(self.cut_phys_q, t), u)
            l2 = l2 + torch.sum(d * d * w)
            l1 = l1 + torch.sum(d.abs() * w)
            # only count real (non-padded) quadrature points for Linf
            linf = torch.maximum(
                linf, torch.where(w > 0, d.abs(), 0.0).max())
        l2, l1, linf = torch.stack([l2, l1, linf]).tolist()
        return math.sqrt(l2), l1, linf

    def stiffness_diagonal(self, gamma_A: float, nitsche_gamma: float,
                           with_nitsche: bool = True,
                           gp_power: int = 3) -> np.ndarray:
        """Host-side diagonal of the cut stiffness matrix (Jacobi)."""
        N = self.grid.n_nodes
        diag = np.zeros(N)
        if len(self.full_ids):
            mats = self.A_stiff[self.cat_full]
            np.add.at(diag, self.w_full.reshape(-1),
                      np.einsum("nii->ni", mats).reshape(-1))
        if len(self.cut_ids):
            d = np.einsum("nqdi,nqdi,nq->ni", self.G_cut, self.G_cut,
                          self.vol_w)
            np.add.at(diag, self.w_cut.reshape(-1), d.reshape(-1))
            if with_nitsche:
                Gn = np.einsum("nqdi,nqd->nqi", self.G_surf, self.surf_n)
                d = np.einsum(
                    "nqi,nqi,nq->ni",
                    (nitsche_gamma / self.h_min) * self.V_surf - 2 * Gn,
                    self.V_surf, self.surf_w)
                np.add.at(diag, self.w_cut.reshape(-1), d.reshape(-1))
        if len(self.gp_win):
            scale = gamma_A * self.h_min**gp_power
            d = scale * np.einsum("faa->fa", self.gp_mat)
            np.add.at(diag, self.gp_win.reshape(-1), d.reshape(-1))
        diag[self.inactive] += 1.0
        # guard: Nitsche sign structure can make near-degenerate cut-cell
        # diagonals non-positive
        diag[diag <= 0] = 1.0
        return diag

    def mass_diagonal(self, gamma_M: float, gp_power: int = 3) -> np.ndarray:
        """Host-side diagonal of the cut mass matrix (Jacobi precond)."""
        N = self.grid.n_nodes
        diag = np.zeros(N)
        if len(self.full_ids):
            mats = self.A_mass[self.cat_full]
            np.add.at(diag, self.w_full.reshape(-1),
                      np.einsum("nii->ni", mats).reshape(-1))
        if len(self.cut_ids):
            d = np.einsum("nqi,nqi,nq->ni", self.V_cut, self.V_cut, self.vol_w)
            np.add.at(diag, self.w_cut.reshape(-1), d.reshape(-1))
        if len(self.gp_win):
            scale = gamma_M * self.h_min**gp_power
            d = scale * np.einsum("faa->fa", self.gp_mat)
            np.add.at(diag, self.gp_win.reshape(-1), d.reshape(-1))
        diag[self.inactive] += 1.0
        return diag


def _face_quad_3d(qg, idx, d, face_coord, want_neg, gx, gw, grid,
                  lo=(0.0, 0.0), hi=(1.0, 1.0), depth=0):
    """Cut quadrature of the want-side region of the 2D face
    {x_d = face_coord} of cell ``idx``.

    Saye-style dimension reduction on the FACE RESTRICTION of the
    per-cell level-set polynomial (one dimension below
    geometry.QuadratureGenerator._box): pick a sign-definite height axis
    among the two tangential axes, partition the base axis at the roots
    of the two edge restrictions, Gauss + root-find per base point;
    bisect the face square on tangency.  Returns (pts_ref (Q, 3),
    w (Q,)) with PHYSICAL face-measure weights (matching the 2D path's
    h[tang]-scaled weights).
    """
    from .geometry import (INSIDE, INTERSECTED, _ROOT_TOL,
                           _classify_values)

    ls = qg.ls
    tang = [e for e in range(3) if e != d]
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    area = grid.h[tang[0]] * grid.h[tang[1]]

    def face_pts(c1, c2):
        c1 = np.asarray(c1, float).reshape(-1)
        c2 = np.asarray(c2, float).reshape(-1)
        pts = np.empty((len(c1), 3))
        pts[:, d] = face_coord
        pts[:, tang[0]] = c1
        pts[:, tang[1]] = c2
        return pts

    def bisect():
        parts = []
        mid = 0.5 * (lo + hi)
        for c1 in range(2):
            for c2 in range(2):
                nlo = np.array([lo[0] if c1 == 0 else mid[0],
                                lo[1] if c2 == 0 else mid[1]])
                nhi = np.array([mid[0] if c1 == 0 else hi[0],
                                mid[1] if c2 == 0 else hi[1]])
                parts.append(_face_quad_3d(
                    qg, idx, d, face_coord, want_neg, gx, gw, grid,
                    nlo, nhi, depth + 1))
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def fallback(n=8):
        m1 = lo[0] + (np.arange(n) + 0.5) / n * (hi[0] - lo[0])
        m2 = lo[1] + (np.arange(n) + 0.5) / n * (hi[1] - lo[1])
        M1, M2 = np.meshgrid(m1, m2, indexing="ij")
        pts = face_pts(M1, M2)
        vals = ls.eval_cell(idx, pts)
        keep = (vals < 0) == want_neg
        w = np.full(keep.sum(),
                    area * (hi[0] - lo[0]) * (hi[1] - lo[1]) / n**2)
        return pts[keep], w

    # classify the face box by dense sampling of the polynomial
    s1 = np.linspace(lo[0], hi[0], 7)
    s2 = np.linspace(lo[1], hi[1], 7)
    M1, M2 = np.meshgrid(s1, s2, indexing="ij")
    spts = face_pts(M1, M2)
    vals = ls.eval_cell(idx, spts)
    loc = _classify_values(vals)
    if loc != INTERSECTED:
        if (loc == INSIDE) != want_neg:
            return np.zeros((0, 3)), np.zeros(0)
        p1 = lo[0] + gx * (hi[0] - lo[0])
        p2 = lo[1] + gx * (hi[1] - lo[1])
        P1, P2 = np.meshgrid(p1, p2, indexing="ij")
        W = np.outer(gw * (hi[0] - lo[0]),
                     gw * (hi[1] - lo[1])).reshape(-1) * area
        return face_pts(P1, P2), W

    # sign-definite height axis among the tangential axes (face-local)
    g = np.empty((2, len(spts)))
    for i, ax in enumerate(tang):
        deriv = tuple(1 if e == ax else 0 for e in range(3))
        g[i] = ls.eval_cell(idx, spts, deriv)
    best_k, best_min = -1, 0.0
    for i in range(2):
        gd = g[i] / (hi[i] - lo[i] + 1e-300)
        if np.all(gd > 0) or np.all(gd < 0):
            m = np.abs(gd).min()
            if m > best_min:
                best_k, best_min = i, m
    gmax = np.abs(g).max() + 1e-300
    if best_k < 0 or best_min < 1e-3 * gmax:
        if depth < qg.max_depth:
            return bisect()
        return fallback()

    hk = best_k          # face-local height index
    bl = 1 - hk          # face-local base index
    gk, gb = tang[hk], tang[bl]

    # partition the base axis at the roots of the two edge restrictions
    cuts = [lo[bl], hi[bl]]
    for c in (lo[hk], hi[hk]):
        cpoly = qg._poly_on_line(idx, gb, {d: face_coord, gk: c})
        cuts.extend(qg._roots_in(cpoly, lo[bl], hi[bl]).tolist())
    cuts = np.unique(np.asarray(cuts))
    base_pts, base_ws = [], []
    for a_, b_ in zip(cuts[:-1], cuts[1:]):
        if b_ - a_ < _ROOT_TOL:
            continue
        base_pts.extend(a_ + gx * (b_ - a_))
        base_ws.extend(gw * (b_ - a_))

    # phase 1: root-find every height line, tangency guard BEFORE
    # accumulating (a bisect restarts the whole face)
    lines = []
    for cb, wb in zip(base_pts, base_ws):
        cpoly = qg._poly_on_line(idx, gk, {d: face_coord, gb: cb})
        roots = qg._roots_in(cpoly, lo[hk], hi[hk])
        if len(roots):
            rpts = np.empty((len(roots), 3))
            rpts[:, d] = face_coord
            rpts[:, gk] = roots
            rpts[:, gb] = cb
            gkv = ls.eval_cell(
                idx, rpts, tuple(1 if e == gk else 0 for e in range(3)))
            gbv = ls.eval_cell(
                idx, rpts, tuple(1 if e == gb else 0 for e in range(3)))
            if np.any(np.abs(gkv) < 1e-8 * np.hypot(gkv, gbv)):
                if depth < qg.max_depth:
                    return bisect()
                return fallback()
        lines.append((cb, wb, cpoly, roots))

    # phase 2: accumulate want-side sub-intervals
    pts_out, w_out = [], []
    for cb, wb, cpoly, roots in lines:
        breaks = np.concatenate([[lo[hk]], roots, [hi[hk]]])
        for ia, ib in zip(breaks[:-1], breaks[1:]):
            if ib - ia < _ROOT_TOL:
                continue
            mid = 0.5 * (ia + ib)
            if (np.polyval(cpoly[::-1], mid) < 0) != want_neg:
                continue
            for sx, sw in zip(ia + gx * (ib - ia), gw * (ib - ia)):
                pt = np.empty(3)
                pt[d] = face_coord
                pt[gk] = sx
                pt[gb] = cb
                pts_out.append(pt)
                w_out.append(wb * sw * area)
    if not pts_out:
        return np.zeros((0, 3)), np.zeros(0)
    return np.asarray(pts_out), np.asarray(w_out)


def _cat_tuple(flat, p, dim):
    ncat = max(p, 1)
    out = []
    for _ in range(dim):
        out.append(flat % ncat)
        flat //= ncat
    return tuple(out)
