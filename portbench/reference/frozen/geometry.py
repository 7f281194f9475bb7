"""Cell classification and cut-cell quadrature generation.

TPU-native replacement for deal.II's NonMatching::MeshClassifier and
NonMatching::QuadratureGenerator (used throughout the reference's wave /
advection applications and cut prototypes).  All geometry work happens
host-side in numpy at setup time; the result is a set of padded arrays
(quadrature points/weights/normals per intersected cell) consumed by the
device-side operators.

Algorithm (Saye-style dimension reduction on the per-cell *polynomial*
level set, cf. R. Saye, "High-order quadrature methods for implicitly
defined surfaces and volumes in hyperrectangles", SISC 2015):

* pick a height axis along which d(psi)/dx_k is sign-definite on the box;
* place Gauss points in the base directions; along each height line find
  the roots of the 1D polynomial restriction; the sub-intervals between
  roots are fully inside/outside and get scaled 1D Gauss rules; each root
  contributes a surface point with co-area weight |grad psi|/|d_k psi|;
* if no sign-definite axis exists, bisect the box and recurse.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from . import quadrature
from .grid import Grid
from .levelset import LevelSetInterpolant

INSIDE, INTERSECTED, OUTSIDE = -1, 0, 1

_ROOT_TOL = 1e-11


def _classify_values(vals: np.ndarray, tol: float = 1e-14) -> int:
    mn, mx = vals.min(), vals.max()
    if mn > -tol and mx > tol:
        return OUTSIDE
    if mx < tol and mn < -tol:
        return INSIDE
    if mn > -tol and mx < tol:
        # identically ~zero; treat as intersected (degenerate)
        return INTERSECTED
    return INTERSECTED


def classify_cells(ls: LevelSetInterpolant, n_samples: int = 21) -> np.ndarray:
    """Per-cell location relative to the zero contour of the interpolant.

    Equivalent of NonMatching::MeshClassifier::location_to_level_set.
    Returns int8 array of shape grid.cells (INSIDE/-1, INTERSECTED/0,
    OUTSIDE/+1), sampling the *polynomial* interpolant densely per cell.
    """
    grid = ls.grid
    dim = grid.dim
    tol = 1e-14
    # stage 1: screen with per-cell GLL NODAL min/max (values on the
    # polynomial itself).  A nodal sign change proves intersection; a
    # same-sign cell can only be intersected if the polynomial wiggles
    # below its sampled range, bounded by ~the nodal span.
    nod = np.transpose(
        ls.nodal, tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
    ).reshape(grid.cells + (-1,))
    mn = nod.min(axis=-1)
    mx = nod.max(axis=-1)
    span = mx - mn
    out = np.full(grid.cells, INTERSECTED, dtype=np.int8)
    out[mn > tol] = OUTSIDE
    out[mx < -tol] = INSIDE
    # candidates for dense refinement: same-sign cells whose distance to
    # zero is within the certified inter-node overshoot.  A polynomial
    # interpolating values in [mn, mx] is bounded by the Lebesgue
    # constant: |poly| <= Lambda * max|nodal|, so its dip below the nodal
    # min is at most (Lambda_tensor - 1) * span with Lambda_tensor =
    # Lambda_1D(GLL, q)^dim (upper bounds below; Lambda grows ~log q).
    _LEB_GLL = {1: 1.0, 2: 1.25, 3: 1.67, 4: 1.80, 5: 1.99, 6: 2.10,
                7: 2.27, 8: 2.40, 9: 2.50}
    lam = _LEB_GLL.get(min(ls.degree, 9), 2.5) ** dim
    C = max(1.0, lam - 1.0)
    candidate = ((out == OUTSIDE) & (mn <= C * span)) | (
        (out == INSIDE) & (-mx <= C * span)
    )
    idx = np.argwhere(candidate)
    if len(idx):
        s = np.linspace(0.0, 1.0, n_samples)
        E = ls.eval_matrix(tuple(s), 0)  # (S, q)
        v = _gather_cells(ls.nodal, idx, dim)  # (nc, q, ..., q)
        for d in range(dim):
            v = np.moveaxis(np.tensordot(v, E, axes=(1, 1)), -1, dim - d)
        v = v.reshape(len(idx), -1)
        mnc = v.min(axis=-1)
        mxc = v.max(axis=-1)
        loc = np.full(len(idx), INTERSECTED, dtype=np.int8)
        loc[mnc > tol] = OUTSIDE
        loc[mxc < -tol] = INSIDE
        out[tuple(idx.T)] = loc
    return out


def _gather_cells(nodal, idx, dim):
    """nodal (n0, q, n1, q, ...) -> (n_sel, q, q, ...) for selected cells."""
    # advanced-index the cell axes one at a time, keeping them leading
    out = nodal[idx[:, 0]]  # (nc, q, n1, q, ...)
    for d in range(1, dim):
        # after d-1 squeezes, cell axis d sits at position d+1
        out = np.take_along_axis(
            out,
            idx[:, d].reshape((-1,) + (1,) * (out.ndim - 1)),
            axis=d + 1,
        ).squeeze(axis=d + 1)
    return out


@dataclasses.dataclass
class CellQuadrature:
    """Cut quadrature of one intersected cell, in cell reference coords.

    Weights: volume weights are reference-measure (sum == ref volume of the
    region); surface weights are PHYSICAL measure; normals are physical
    unit vectors pointing from {psi<0} to {psi>0}.
    """

    inside_pts: np.ndarray  # (Qi, dim)
    inside_w: np.ndarray
    outside_pts: np.ndarray  # (Qo, dim)
    outside_w: np.ndarray
    surface_pts: np.ndarray  # (Qs, dim)
    surface_w: np.ndarray  # physical ds weights
    surface_normals: np.ndarray  # (Qs, dim) physical unit


class QuadratureGenerator:
    def __init__(self, ls: LevelSetInterpolant, nq: int, max_depth: int = 6):
        self.ls = ls
        self.grid = ls.grid
        self.nq = nq
        self.max_depth = max_depth
        self.gx, self.gw = quadrature.gauss(nq)
        # monomial conversion for the height-line polynomials
        V = np.vander(np.asarray(ls.nodes), ls.q, increasing=True)
        self.Vinv = np.linalg.inv(V)

    # -- helpers ---------------------------------------------------------
    def _poly_on_line(self, cell_idx, height_axis, base_coords):
        """Monomial (ascending) coefficients of psi restricted to a height
        line at fixed base reference coords (dict axis->coord)."""
        nodal = self.ls.line_nodal(cell_idx, height_axis, base_coords)
        return self.Vinv @ nodal

    def _roots_in(self, coeffs_asc, lo, hi):
        c = np.trim_zeros(coeffs_asc[::-1], "f")
        if len(c) <= 1:
            return np.empty(0)
        r = np.roots(c)
        r = r[np.abs(r.imag) < 1e-9].real
        r = r[(r > lo + _ROOT_TOL) & (r < hi - _ROOT_TOL)]
        return np.sort(r)

    def _grad_samples(self, cell_idx, lo, hi, n=5):
        """Sample reference-coordinate gradient over the box; (dim, n^dim)."""
        dim = self.grid.dim
        axes = [np.linspace(lo[d], hi[d], n) for d in range(dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([m.reshape(-1) for m in mesh], axis=-1)
        g = np.empty((dim, len(pts)))
        for d in range(dim):
            deriv = tuple(1 if e == d else 0 for e in range(dim))
            g[d] = self.ls.eval_cell(cell_idx, pts, deriv)
        return g

    # -- main entry ------------------------------------------------------
    def cell_quadrature(self, cell_idx) -> CellQuadrature:
        acc = {k: [] for k in ("ip", "iw", "op", "ow", "sp", "sw", "sn")}
        dim = self.grid.dim
        self._box(cell_idx, np.zeros(dim), np.ones(dim), 0, acc)
        return CellQuadrature(
            np.array(acc["ip"]).reshape(-1, dim),
            np.array(acc["iw"]).reshape(-1),
            np.array(acc["op"]).reshape(-1, dim),
            np.array(acc["ow"]).reshape(-1),
            np.array(acc["sp"]).reshape(-1, dim),
            np.array(acc["sw"]).reshape(-1),
            np.array(acc["sn"]).reshape(-1, dim),
        )

    def _bulk(self, lo, hi, side, acc):
        """Full tensor Gauss rule on a (sub-)box, assigned to one side."""
        dim = self.grid.dim
        axes_p = [lo[d] + self.gx * (hi[d] - lo[d]) for d in range(dim)]
        axes_w = [self.gw * (hi[d] - lo[d]) for d in range(dim)]
        mesh = np.meshgrid(*axes_p, indexing="ij")
        pts = np.stack([m.reshape(-1) for m in mesh], axis=-1)
        wm = np.meshgrid(*axes_w, indexing="ij")
        w = np.multiply.reduce([m.reshape(-1) for m in wm])
        key = "i" if side == INSIDE else "o"
        acc[key + "p"].extend(pts)
        acc[key + "w"].extend(w)

    def _box(self, cell_idx, lo, hi, depth, acc):
        dim = self.grid.dim
        # classify the box by sampling
        axes = [np.linspace(lo[d], hi[d], 7) for d in range(dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([m.reshape(-1) for m in mesh], axis=-1)
        vals = self.ls.eval_cell(cell_idx, pts)
        loc = _classify_values(vals)
        if loc != INTERSECTED:
            self._bulk(lo, hi, loc, acc)
            return

        if dim == 1:
            self._box_1d(cell_idx, lo, hi, acc)
            return

        # choose sign-definite height axis with largest |d psi|
        g = self._grad_samples(cell_idx, lo, hi)
        best_axis, best_min = -1, 0.0
        for d in range(dim):
            gd = g[d] / (hi[d] - lo[d] + 1e-300)  # favor well-resolved axes
            if np.all(gd > 0) or np.all(gd < 0):
                m = np.abs(gd).min()
                if m > best_min:
                    best_axis, best_min = d, m
        gmax = np.abs(g).max() + 1e-300
        if best_axis < 0 or best_min < 1e-3 * gmax:
            if depth < self.max_depth:
                self._bisect(cell_idx, lo, hi, depth, acc)
                return
            # fallback: low-order sampling (should not happen for the
            # reference geometries; keeps the generator total)
            self._fallback(cell_idx, lo, hi, acc)
            return

        k = best_axis
        base_axes = [d for d in range(dim) if d != k]
        if dim == 3:
            self._box_3d(cell_idx, lo, hi, depth, acc, k, base_axes)
            return
        assert dim == 2
        b = base_axes[0]
        # Saye dimension reduction: partition the base interval at the
        # roots of psi restricted to the bottom/top faces of the box, so
        # the per-line root count (and hence the integrand) is smooth on
        # every sub-interval.
        cuts = [lo[b], hi[b]]
        for face_coord in (lo[k], hi[k]):
            cpoly = self._poly_on_line(cell_idx, b, {k: face_coord})
            cuts.extend(self._roots_in(cpoly, lo[b], hi[b]).tolist())
        cuts = np.unique(np.asarray(cuts))
        base_pts, base_ws = [], []
        for a_, b_ in zip(cuts[:-1], cuts[1:]):
            if b_ - a_ < _ROOT_TOL:
                continue
            base_pts.extend(a_ + self.gx * (b_ - a_))
            base_ws.extend(self.gw * (b_ - a_))
        # ---- phase 1: root-find all lines and check the tangency guard
        # BEFORE accumulating anything, so a bisect can restart the whole
        # box without double-counting already-emitted points.
        lines = []  # (coord_b, wq, cpoly, roots, grads_ref (nroots, dim))
        tangent = False
        for coord_b, wq in zip(base_pts, base_ws):
            cpoly = self._poly_on_line(cell_idx, k, {b: coord_b})
            roots = self._roots_in(cpoly, lo[k], hi[k])
            grads_ref = np.zeros((len(roots), dim))
            if len(roots):
                pt_list = np.empty((len(roots), dim))
                pt_list[:, k] = roots
                pt_list[:, b] = coord_b
                grads_ref = np.stack(
                    [
                        self.ls.eval_cell(
                            cell_idx, pt_list,
                            tuple(1 if e == d else 0 for e in range(dim)),
                        )
                        for d in range(dim)
                    ],
                    axis=-1,
                )
                if np.any(
                    np.abs(grads_ref[:, k])
                    < 1e-8 * np.linalg.norm(grads_ref, axis=1)
                ):
                    tangent = True
            lines.append((coord_b, wq, cpoly, roots, grads_ref))
        if tangent and depth < self.max_depth:
            self._bisect(cell_idx, lo, hi, depth, acc)
            return

        # ---- phase 2: accumulate volume and surface contributions
        h = np.asarray(self.grid.h)
        w_base_fac = np.prod([h[d] for d in base_axes])
        for coord_b, wq, cpoly, roots, grads_ref in lines:
            breaks = np.concatenate([[lo[k]], roots, [hi[k]]])
            for ia, ib in zip(breaks[:-1], breaks[1:]):
                if ib - ia < _ROOT_TOL:
                    continue
                mid = 0.5 * (ia + ib)
                side = INSIDE if np.polyval(cpoly[::-1], mid) < 0 else OUTSIDE
                sub_pts = ia + self.gx * (ib - ia)
                for sx, sw in zip(sub_pts, self.gw * (ib - ia)):
                    pt = np.empty(dim)
                    pt[k] = sx
                    pt[b] = coord_b
                    key = "i" if side == INSIDE else "o"
                    acc[key + "p"].append(pt)
                    acc[key + "w"].append(wq * sw)
            for r, gref in zip(roots, grads_ref):
                gphys = gref / h
                norm = np.linalg.norm(gphys)
                if abs(gphys[k]) < 1e-8 * norm:
                    # near-tangent root at max recursion depth: dropping it
                    # loses a (tiny-base-measure) sliver of surface instead
                    # of injecting an unbounded 1/|d_k psi| weight.
                    continue
                pt = np.empty(dim)
                pt[k] = r
                pt[b] = coord_b
                acc["sp"].append(pt)
                acc["sw"].append(wq * w_base_fac * norm / abs(gphys[k]))
                acc["sn"].append(gphys / norm)

    def _box_3d(self, cell_idx, lo, hi, depth, acc, k, base_axes):
        """3D dimension reduction with a sign-definite height axis k.

        Because psi is monotone along the height direction on this box,
        every height line has 0 or 1 root, and the root count changes
        across the base exactly where the bottom/top face restrictions
        psi(.,.,lo_k) / psi(.,.,hi_k) change sign.  Partitioning each base
        line at the roots of those two constraint restrictions therefore
        makes all integrands piecewise-smooth, and tensor Gauss rules on
        the base sub-segments converge spectrally (Saye's argument, one
        recursion level spelled out for dim 3)."""
        b1, b2 = base_axes
        dim = 3

        def roots_of_line(height_axis, fixed):
            cpoly = self._poly_on_line(cell_idx, height_axis, fixed)
            return self._roots_in(cpoly, lo[height_axis], hi[height_axis])

        # partition b1 at the roots of the 4 edge restrictions
        cuts1 = [lo[b1], hi[b1]]
        for fk in (lo[k], hi[k]):
            for f2 in (lo[b2], hi[b2]):
                cuts1.extend(roots_of_line(b1, {k: fk, b2: f2}).tolist())
        cuts1 = np.unique(np.asarray(cuts1))

        # phase 1: enumerate all height lines; bisect the whole box on any
        # tangency before accumulating anything
        lines = []  # (c1, c2, w12, cpoly_k, roots, grads at roots)
        for a1, e1 in zip(cuts1[:-1], cuts1[1:]):
            if e1 - a1 < _ROOT_TOL:
                continue
            for g1, w1 in zip(a1 + self.gx * (e1 - a1), self.gw * (e1 - a1)):
                cuts2 = [lo[b2], hi[b2]]
                for fk in (lo[k], hi[k]):
                    cuts2.extend(
                        roots_of_line(b2, {k: fk, b1: g1}).tolist())
                cuts2 = np.unique(np.asarray(cuts2))
                for a2, e2 in zip(cuts2[:-1], cuts2[1:]):
                    if e2 - a2 < _ROOT_TOL:
                        continue
                    for g2, w2 in zip(a2 + self.gx * (e2 - a2),
                                      self.gw * (e2 - a2)):
                        cpoly = self._poly_on_line(
                            cell_idx, k, {b1: g1, b2: g2})
                        roots = self._roots_in(cpoly, lo[k], hi[k])
                        grads = np.zeros((len(roots), dim))
                        if len(roots):
                            pts = np.empty((len(roots), dim))
                            pts[:, k] = roots
                            pts[:, b1] = g1
                            pts[:, b2] = g2
                            grads = np.stack(
                                [
                                    self.ls.eval_cell(
                                        cell_idx, pts,
                                        tuple(1 if e == d else 0
                                              for e in range(dim)),
                                    )
                                    for d in range(dim)
                                ],
                                axis=-1,
                            )
                            if np.any(
                                np.abs(grads[:, k])
                                < 1e-8 * np.linalg.norm(grads, axis=1)
                            ):
                                if depth < self.max_depth:
                                    self._bisect(cell_idx, lo, hi, depth, acc)
                                else:
                                    self._fallback(cell_idx, lo, hi, acc)
                                return
                        lines.append((g1, g2, w1 * w2, cpoly, roots, grads))

        # phase 2: accumulate
        h = np.asarray(self.grid.h)
        w_base_fac = h[b1] * h[b2]
        for g1, g2, w12, cpoly, roots, grads in lines:
            breaks = np.concatenate([[lo[k]], roots, [hi[k]]])
            for ia, ib in zip(breaks[:-1], breaks[1:]):
                if ib - ia < _ROOT_TOL:
                    continue
                mid = 0.5 * (ia + ib)
                side = INSIDE if np.polyval(cpoly[::-1], mid) < 0 else OUTSIDE
                for sx, sw in zip(ia + self.gx * (ib - ia),
                                  self.gw * (ib - ia)):
                    pt = np.empty(dim)
                    pt[k] = sx
                    pt[b1] = g1
                    pt[b2] = g2
                    key = "i" if side == INSIDE else "o"
                    acc[key + "p"].append(pt)
                    acc[key + "w"].append(w12 * sw)
            for r, gref in zip(roots, grads):
                gphys = gref / h
                norm = np.linalg.norm(gphys)
                if abs(gphys[k]) < 1e-8 * norm:
                    continue
                pt = np.empty(dim)
                pt[k] = r
                pt[b1] = g1
                pt[b2] = g2
                acc["sp"].append(pt)
                acc["sw"].append(w12 * w_base_fac * norm / abs(gphys[k]))
                acc["sn"].append(gphys / norm)

    def _box_1d(self, cell_idx, lo, hi, acc):
        coeffs = self.Vinv @ self.ls.cell_nodal(cell_idx)
        roots = self._roots_in(coeffs, lo[0], hi[0])
        breaks = np.concatenate([[lo[0]], roots, [hi[0]]])
        for a, b in zip(breaks[:-1], breaks[1:]):
            if b - a < _ROOT_TOL:
                continue
            mid = 0.5 * (a + b)
            side = INSIDE if np.polyval(coeffs[::-1], mid) < 0 else OUTSIDE
            key = "i" if side == INSIDE else "o"
            for sx, sw in zip(a + self.gx * (b - a), self.gw * (b - a)):
                acc[key + "p"].append(np.array([sx]))
                acc[key + "w"].append(sw)
        dpoly = coeffs[1:] * np.arange(1, len(coeffs))
        for r in roots:
            d = np.polyval(dpoly[::-1], r) / self.grid.h[0]
            acc["sp"].append(np.array([r]))
            acc["sw"].append(1.0)
            acc["sn"].append(np.array([np.sign(d)]))

    def _bisect(self, cell_idx, lo, hi, depth, acc):
        dim = self.grid.dim
        mid = 0.5 * (lo + hi)
        for corner in itertools.product(*[range(2)] * dim):
            nlo = np.where(np.array(corner) == 0, lo, mid)
            nhi = np.where(np.array(corner) == 0, mid, hi)
            self._box(cell_idx, nlo, nhi, depth + 1, acc)

    def _fallback(self, cell_idx, lo, hi, acc, n=8):
        """Midpoint sampling volume rule (no surface contribution)."""
        dim = self.grid.dim
        axes = [lo[d] + (np.arange(n) + 0.5) / n * (hi[d] - lo[d]) for d in range(dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([m.reshape(-1) for m in mesh], axis=-1)
        vals = self.ls.eval_cell(cell_idx, pts)
        w = np.prod((hi - lo) / n)
        for pt, v in zip(pts, vals):
            key = "i" if v < 0 else "o"
            acc[key + "p"].append(pt)
            acc[key + "w"].append(w)


@dataclasses.dataclass
class CutGeometry:
    """All host-precomputed geometry for one (grid, level set) pair."""

    grid: Grid
    ls: LevelSetInterpolant
    locations: np.ndarray  # int8, shape grid.cells
    cut_cells: np.ndarray  # (n_cut,) flat cell ids (axis-0-fastest order)
    cut_quads: list  # list[CellQuadrature], aligned with cut_cells

    @staticmethod
    def build(grid: Grid, level_set_fn, level_set_degree: int = None,
              nq: int = None) -> "CutGeometry":
        p = grid.degree
        deg = level_set_degree if level_set_degree is not None else p
        nq = nq if nq is not None else p + 1
        ls = LevelSetInterpolant(grid, level_set_fn, deg)
        locations = classify_cells(ls)
        gen = QuadratureGenerator(ls, nq)
        # flat ids axis-0-fastest (reference cell enumeration)
        loc_flat = np.transpose(
            locations, list(range(grid.dim - 1, -1, -1))
        ).reshape(-1)
        cut_ids = np.where(loc_flat == INTERSECTED)[0].astype(np.int32)
        quads = []
        for cid in cut_ids:
            idx = _unflatten(cid, grid.cells)
            quads.append(gen.cell_quadrature(idx))
        return CutGeometry(grid, ls, locations, cut_ids, quads)

    @property
    def locations_flat(self) -> np.ndarray:
        return np.transpose(
            self.locations, list(range(self.grid.dim - 1, -1, -1))
        ).reshape(-1)

    def ghost_penalty_faces(self, location: int):
        """Interior faces needing ghost penalty for the given location
        (INSIDE or OUTSIDE block), as (axis, cell_minus_flat, cell_plus_flat)
        arrays.  Reference predicate: applications/wave/include/gdm/wave/
        mass.h:86-106 — face between K and N is penalized iff
        (K intersected and N != inverse) or (N intersected and K != inverse).
        Each face is counted ONCE here (the reference visits it twice with
        a 0.5 factor)."""
        inverse = OUTSIDE if location == INSIDE else INSIDE
        loc = self.locations
        grid = self.grid
        faces = []
        for d in range(grid.dim):
            slm = [slice(None)] * grid.dim
            slp = [slice(None)] * grid.dim
            slm[d] = slice(0, grid.cells[d] - 1)
            slp[d] = slice(1, grid.cells[d])
            a = loc[tuple(slm)]
            b = loc[tuple(slp)]
            pen = ((a == INTERSECTED) & (b != inverse)) | (
                (b == INTERSECTED) & (a != inverse)
            )
            idx = np.argwhere(pen)
            for row in idx:
                cm = list(row)
                cp = list(row)
                cp[d] += 1
                faces.append((d, _flatten(cm, grid.cells), _flatten(cp, grid.cells)))
        return faces


def _unflatten(flat, cells):
    idx = []
    for n in cells:
        idx.append(flat % n)
        flat //= n
    return tuple(idx)


def _flatten(idx, cells):
    out = 0
    stride = 1
    for i, n in zip(idx, cells):
        out += int(i) * stride
        stride *= n
    return out
