"""Plain cut-cell finite-element assembly for the reference.

A region (the inside or the outside of the level set) is described by
quadrature tables built from the frozen geometry code: the uncut cells'
tensor Gauss points, the cut cells' volume and interface points, the
faces that carry the ghost penalty and the cut domain-boundary faces.
Every operator is then assembled in float64 with plain torch, cell by
cell, as sum_cells P^T (V^T W V) P: no band layout, no stencil, no
Kronecker factors.  The formulas follow the reference applications
(the wave app's mass.h and stiffness.h, the advection app's
stiffness.h); each face with a ghost penalty is counted once.
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

from .frozen import quadrature
from .frozen.geometry import INSIDE, OUTSIDE, CutGeometry, QuadratureGenerator
from .frozen.grid import Grid
from .frozen.tables import (basis_at_points, cell_axis_categories,
                            cell_axis_indices, gradients_at_points,
                            windows_c_order)


def _pad(arrs):
    """Stack variable-length arrays along a new axis 0, zero-padded along
    their axis 0; zero weights make the padding inert."""
    mx = max([len(a) for a in arrs] + [1])
    out = np.zeros((len(arrs), mx) + arrs[0].shape[1:])
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out


class Region:
    """The quadrature tables of one region of a cut 2D grid."""

    def __init__(self, geo: CutGeometry, location: int):
        grid = geo.grid
        self.grid = grid
        self.location = location
        p, dim = grid.degree, grid.dim
        if dim != 2:
            raise ValueError("the reference assembles 2D grids only")
        self.m = (p + 1) ** dim
        self.nq = p + 1
        self.h = min(grid.h)
        loc = geo.locations_flat
        inverse = OUTSIDE if location == INSIDE else INSIDE
        gx, gw = quadrature.gauss(self.nq)

        # uncut cells of this side: tensor Gauss rule in every cell
        full = np.where(loc == location)[0]
        self.full_win = windows_c_order(grid, full).astype(np.int64)
        cats = cell_axis_categories(grid, full)
        mesh = np.meshgrid(*([gx] * dim), indexing="ij")
        ref_q = np.stack([a.reshape(-1) for a in mesh], axis=-1)
        wq = np.multiply.reduce(
            [a.reshape(-1) for a in np.meshgrid(*([gw] * dim),
                                                indexing="ij")])
        self.full_w = wq * np.prod(grid.h)
        # the basis tables depend on the cell only through its per-axis
        # categories: one table a category pair, indexed per cell
        keys, self.full_cat = np.unique(cats, axis=0, return_inverse=True)
        self.full_cat = self.full_cat.reshape(-1)
        pts = np.broadcast_to(ref_q, (len(keys),) + ref_q.shape)
        self.full_V = basis_at_points(grid, keys, pts)         # (k, Q, m)
        self.full_G = gradients_at_points(grid, keys, pts)     # (k, Q, d, m)
        self.full_x = self._phys(full, np.broadcast_to(
            ref_q, (len(full),) + ref_q.shape))

        # cut cells: this side's volume points and the interface
        cut = geo.cut_cells
        self.cut_win = windows_c_order(grid, cut).astype(np.int64)
        ccats = cell_axis_categories(grid, cut)
        side = "inside" if location == INSIDE else "outside"
        vp = _pad([getattr(q, side + "_pts") for q in geo.cut_quads])
        self.vol_w = _pad([getattr(q, side + "_w") for q in geo.cut_quads]
                          ) * np.prod(grid.h)
        self.vol_V = basis_at_points(grid, ccats, vp)
        self.vol_G = gradients_at_points(grid, ccats, vp)
        self.vol_x = self._phys(cut, vp)
        sp_ = _pad([q.surface_pts for q in geo.cut_quads])
        self.surf_w = _pad([q.surface_w for q in geo.cut_quads])
        sign = 1.0 if location == INSIDE else -1.0
        self.surf_n = sign * _pad([q.surface_normals for q in geo.cut_quads])
        self.surf_V = basis_at_points(grid, ccats, sp_)
        self.surf_G = gradients_at_points(grid, ccats, sp_)
        self.surf_x = self._phys(cut, sp_)

        self._ghost_faces(geo, location, gx, gw)
        self._boundary_faces(geo, loc, inverse, gx, gw)
        active = np.zeros(grid.n_nodes, dtype=bool)
        active[self.full_win.reshape(-1)] = True
        active[self.cut_win.reshape(-1)] = True
        self.active = active

    def _phys(self, ids, ref):
        grid = self.grid
        idx = cell_axis_indices(grid, ids)
        lo = np.stack([grid.lower[d] + idx[:, d] * grid.h[d]
                       for d in range(grid.dim)], axis=-1)
        return lo[:, None, :] + ref * np.asarray(grid.h)[None, None, :]

    def _ghost_faces(self, geo, location, gx, gw):
        """Faces between a cut cell and a cell of this side (or two cut
        cells): n . [grad phi] at the face's Gauss points over both cells'
        windows (minus side first)."""
        grid = self.grid
        J, W, win = [], [], []
        for axis, cm, cp in geo.ghost_penalty_faces(location):
            t = 1 - axis
            pm = np.zeros((len(gx), 2))
            pm[:, axis] = 1.0
            pm[:, t] = gx
            pp = pm.copy()
            pp[:, axis] = 0.0
            d = tuple(1 if e == axis else 0 for e in range(2))
            gm = basis_at_points(grid, cell_axis_categories(
                grid, np.array([cm])), pm[None], d)[0]
            gp = basis_at_points(grid, cell_axis_categories(
                grid, np.array([cp])), pp[None], d)[0]
            J.append(np.concatenate([gm, -gp], axis=-1))
            W.append(gw * grid.h[t])
            win.append(np.concatenate(
                [windows_c_order(grid, np.array([cm]))[0],
                 windows_c_order(grid, np.array([cp]))[0]]))
        self.gp_J = np.array(J).reshape(-1, len(gx), 2 * self.m)
        self.gp_w = np.array(W).reshape(-1, len(gx))
        self.gp_win = np.array(win, dtype=np.int64).reshape(-1, 2 * self.m)

    def _boundary_faces(self, geo, loc, inverse, gx, gw):
        """This side's part of the faces on the box's boundary: a 1D cut
        Gauss rule along each face of a cell that is not of the other
        side, with the face's outward normal."""
        grid = self.grid
        qg = QuadratureGenerator(geo.ls, self.nq)
        vinv = np.linalg.inv(np.vander(np.asarray(geo.ls.nodes), geo.ls.q,
                                       increasing=True))
        want_neg = self.location == INSIDE
        V, G, W, N, X, win = [], [], [], [], [], []
        for d, s in itertools.product(range(2), (0, 1)):
            t = 1 - d
            for it in range(grid.cells[t]):
                idx = [0, 0]
                idx[d] = 0 if s == 0 else grid.cells[d] - 1
                idx[t] = it
                flat = idx[0] + idx[1] * grid.cells[0]
                if loc[flat] == inverse:
                    continue
                coeffs = vinv @ geo.ls.line_nodal(tuple(idx), t,
                                                  {d: float(s)})
                br = np.concatenate([[0.0], qg._roots_in(coeffs, 0.0, 1.0),
                                     [1.0]])
                pts, ws = [], []
                for a, b in zip(br[:-1], br[1:]):
                    if b - a < 1e-11:
                        continue
                    if (np.polyval(coeffs[::-1], 0.5 * (a + b)) < 0) \
                            != want_neg:
                        continue
                    pts.extend(a + gx * (b - a))
                    ws.extend(gw * (b - a) * grid.h[t])
                if not pts:
                    continue
                ref = np.zeros((len(pts), 2))
                ref[:, d] = float(s)
                ref[:, t] = pts
                c = cell_axis_categories(grid, np.array([flat]))
                V.append(basis_at_points(grid, c, ref[None])[0])
                G.append(gradients_at_points(grid, c, ref[None])[0])
                W.append(np.asarray(ws))
                n = np.zeros(2)
                n[d] = -1.0 if s == 0 else 1.0
                N.append(n)
                X.append(self._phys(np.array([flat]), ref[None])[0])
                win.append(windows_c_order(grid, np.array([flat]))[0])
        self.b_V = _pad(V) if V else np.zeros((0, 1, self.m))
        self.b_G = _pad(G) if G else np.zeros((0, 1, 2, self.m))
        self.b_w = _pad(W) if W else np.zeros((0, 1))
        self.b_n = np.array(N).reshape(-1, 2)
        self.b_x = _pad(X) if X else np.zeros((0, 1, 2))
        self.b_win = np.array(win, dtype=np.int64).reshape(-1, self.m)

    # -- assembly (torch, float64, on the reference's device) -------------
    def full_blocks(self, local, device):
        """The uncut cells' (rows, cols, mats) with ``local`` (k, m, m)
        the matrix of each category pair, gathered on ``device``."""
        win = torch.as_tensor(self.full_win, device=device)
        cat = torch.as_tensor(self.full_cat, device=device)
        return (win, win, torch.as_tensor(local, dtype=torch.float64,
                                          device=device)[cat])

    def mass_blocks(self, device):
        """(u, v) over this side of every cell."""
        fm = np.einsum("kqa,kqb,q->kab", self.full_V, self.full_V,
                       self.full_w)
        cm = np.einsum("kqa,kqb,kq->kab", self.vol_V, self.vol_V, self.vol_w)
        return [self.full_blocks(fm, device),
                (self.cut_win, self.cut_win, cm)]

    def ghost_blocks(self, scale):
        """scale * <[d_n v], [d_n u]> over the ghost-penalty faces."""
        g = scale * np.einsum("fqa,fqb,fq->fab", self.gp_J, self.gp_J,
                              self.gp_w)
        return [(self.gp_win, self.gp_win, g)]

    def tables(self, device):
        """The tables of ``error_norms`` on ``device``, float64."""
        f = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return {"fV": f(self.full_V)[f(self.full_cat)], "fw": f(self.full_w),
                "fwin": f(self.full_win), "fx": self.full_x,
                "vV": f(self.vol_V), "vw": f(self.vol_w),
                "cwin": f(self.cut_win), "vx": self.vol_x,
                "sV": f(self.surf_V), "sw": f(self.surf_w),
                "sx": self.surf_x}


def sparse(blocks, shape, device, index=None, dense=False):
    """The sum over (rows, cols, mats) blocks of P_r^T mats P_c as a
    float64 tensor of ``shape`` on ``device``: rows (k, a) and cols (k, b)
    indices, mats (k, a, b).  ``index`` renumbers rows and columns (a
    node's position among the kept nodes); ``dense`` gives a dense
    matrix, else a sparse CSR one."""
    r, c, v = [], [], []
    for rows, cols, mats in blocks:
        rows = torch.as_tensor(rows, device=device)
        cols = torch.as_tensor(cols, device=device)
        mats = torch.as_tensor(mats, dtype=torch.float64, device=device)
        if not len(rows):
            continue
        r.append(rows[:, :, None].expand(mats.shape).reshape(-1))
        c.append(cols[:, None, :].expand(mats.shape).reshape(-1))
        v.append(mats.reshape(-1))
    r, c, v = torch.cat(r), torch.cat(c), torch.cat(v)
    if index is not None:
        ix = torch.as_tensor(index, device=device)
        r, c = ix[r], ix[c]
    if dense:
        out = torch.zeros(shape, dtype=torch.float64, device=device)
        return out.index_put_((r, c), v, accumulate=True)
    coo = torch.sparse_coo_tensor(torch.stack([r, c]), v, shape,
                                  check_invariants=False).coalesce()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # CSR is "beta"
        return coo.to_sparse_csr()


def exact_at(tab, exact, t, device):
    """The exact solution at a region's quadrature points (``tables``),
    as float64 tensors on ``device``."""
    return {k: torch.as_tensor(exact(tab[k + "x"], t), device=device)
            for k in ("f", "v", "s")}


def error_norms(tab, u, ex):
    """(L2, L1, Linf) of u - exact over a region and on its interface,
    as a (6,) float64 tensor; ``tab`` from ``Region.tables``, ``ex`` from
    ``exact_at``, u a node vector."""
    u = u.double()
    df = torch.einsum("nqa,na->nq", tab["fV"], u[tab["fwin"]]) - ex["f"]
    dc = torch.einsum("nqa,na->nq", tab["vV"], u[tab["cwin"]]) - ex["v"]
    ds = torch.einsum("nqa,na->nq", tab["sV"], u[tab["cwin"]]) - ex["s"]
    fw, vw, sw = tab["fw"][None, :], tab["vw"], tab["sw"]
    zero = u.new_zeros(())
    l2 = torch.sqrt((df * df * fw).sum() + (dc * dc * vw).sum())
    l1 = (df.abs() * fw).sum() + (dc.abs() * vw).sum()
    linf = torch.maximum(df.abs().max() if df.numel() else zero,
                         torch.where(vw > 0, dc.abs(), 0.0).max()
                         if dc.numel() else zero)
    if ds.numel():
        s = [torch.sqrt((ds * ds * sw).sum()), (ds.abs() * sw).sum(),
             torch.where(sw > 0, ds.abs(), 0.0).max()]
    else:
        s = [zero, zero, zero]
    return torch.stack([l2, l1, linf] + s)


def build(level_set, degree, cells, lower, upper, level_set_degree):
    """(grid, geometry) of a 2D cut problem."""
    grid = Grid(degree, (cells,) * 2, (lower,) * 2, (upper,) * 2)
    return grid, CutGeometry.build(grid, level_set, level_set_degree)


def plane(point, normal):
    """The signed distance to a plane, on a list of coordinate arrays."""
    n = np.asarray(normal, float) / np.linalg.norm(normal)

    def fn(mesh):
        return sum((np.asarray(m) - point[d]) * n[d]
                   for d, m in enumerate(mesh))

    return fn


def circle(mesh):
    """The signed distance to the unit circle."""
    return np.sqrt(sum(np.asarray(m) ** 2 for m in mesh)) - 1.0


def schedule(start, end, step):
    """The time steps (t, dt) of a fixed desired step, the last one
    shortened to land on ``end`` (deal.II's DiscreteTime)."""
    out, t, eps = [], float(start), 1e-12 * max(1.0, abs(end))
    while not t >= end - eps:
        dt = min(step, end - t)
        if end - (t + dt) < eps:
            dt = end - t
        out.append((t, dt))
        t = t + dt
        if abs(t - end) < eps:
            t = end
    return out


def nodes_xy(grid):
    """(n_nodes, 2) coordinates of the nodes in C order."""
    mesh = grid.node_coords_mesh()
    return np.stack([np.asarray(m).reshape(-1) for m in mesh], axis=-1)
