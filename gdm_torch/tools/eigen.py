"""Spectral analysis tooling (capability parity with
applications/wave/wave-ev.cc): condition numbers of the cut mass /
stiffness matrices, generalized max eigenvalue of S w.r.t. M (CFL
estimation), and matrix dumps — how the reference derived its
ghost-penalty/CFL constants.

Port of gdm/tools/eigen.py.  Matrices are materialized densely by
applying the operators to the unit vectors on the device asked for (the
card unless ``device="cpu"``; the grids used for spectral analysis are
small), one column a call; the eigen solves are host numpy and scipy."""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..cut.geometry import INSIDE, CutGeometry
from ..cut.operators import CutOperators
from ..grid import Grid


def densify(apply_fn, n: int, device="cuda",
            dtype=torch.float64) -> np.ndarray:
    """The (n, n) matrix of ``apply_fn`` as a float64 host array: column
    j is apply_fn(e_j), e_j the j-th unit vector on ``device`` in
    ``dtype`` (gdm maps the apply over the identity's columns)."""
    eye = torch.eye(n, dtype=_device.resolve_dtype(dtype),
                    device=_device.resolve(device))
    cols = torch.stack([apply_fn(eye[:, j]) for j in range(n)], dim=1)
    return cols.detach().cpu().double().numpy()


def condition_number(M: np.ndarray, rescale: bool = False,
                     drop_ones: bool = True):
    """Reference compute_condition_number (wave-ev.cc:13-56)."""
    A = M.copy()
    if rescale:
        d = np.diag(A).copy()
        dinv = np.where(d == 0.0, 0.0, 1.0 / d)
        A = dinv[:, None] * A
    ev = np.sort(np.linalg.eigvals(A).real)
    if drop_ones:
        ev = ev[~np.isclose(ev, 1.0, rtol=0, atol=1e-12)]
    return ev[-1] / ev[0], ev


def max_generalized_eigenvalue(S: np.ndarray, M: np.ndarray):
    """max ev of S x = lambda M x (wave-ev.cc:60-89)."""
    import scipy.linalg

    ev = np.sort(scipy.linalg.eigh(S, M, eigvals_only=True))
    return ev[-1], ev


def write_matrix(M: np.ndarray, file_name: str, binary: bool = True,
                 tol: float = 0.0):
    """Triplet dump (row, col, value), ascii or binary (uint32, uint32,
    float64 records), matching wave-ev.cc:93-127."""
    rows, cols = np.nonzero(np.abs(M) > tol)
    if binary:
        with open(file_name, "wb") as f:
            for r, c in zip(rows, cols):
                f.write(np.uint32(r).tobytes())
                f.write(np.uint32(c).tobytes())
                f.write(np.float64(M[r, c]).tobytes())
    else:
        with open(file_name, "w") as f:
            for r, c in zip(rows, cols):
                f.write(f"{r} {c} {M[r, c]}\n")


def build_ev_operators(fe_degree: int = 5, n_subdivisions_1D: int = 100,
                       radius: float = 1.0, alpha: float = -1.0,
                       align: bool = False, gp_scale: float = 1.0,
                       dim: int = 1, mapping_fn=None,
                       mapping_cut: bool = False,
                       mapping_geometry: str = "q1", device="cuda",
                       dtype=torch.float64):
    """Replicates wave-ev's parameter derivation (wave-ev.cc:146-297):
    --alpha places the interface at fraction alpha inside its cell by
    adjusting the radius; --alpha with --align additionally deforms the
    mesh so the interface coincides with the outermost mesh node.  The
    reference does this with a clamping ``mapping_q_cache_function``
    (|x| <- min(|x|, radius), wave-ev.cc:252-259) + level-set radius 2.0
    (nothing cut); since the domain is truncated to the cells covered by
    the radius, the clamp compresses exactly the two outermost cells by
    the factor (1 - alpha) and leaves every interior cell untouched —
    implemented here as per-cell-Jacobian 1D assembly
    (ops1d.assemble_1d(jac=...)), dim=1 like the reference tool
    (wave-ev.cc:306).  The operators are densified on ``device`` in
    ``dtype`` (a deformed band through ``cut.stencil.routed_apply``: K1
    on a CUDA tensor of a 2D grid)."""
    dense = dict(device=device, dtype=dtype)
    h = 1.21 / (n_subdivisions_1D / 2)
    if mapping_fn is not None and not mapping_cut:
        # general mapping_q_cache_function (wave parameters.h): arbitrary
        # vertex deformation, any dim, uncut spectra — assembled through
        # the per-cell Q1 chart exactly like the reference's
        # MappingQCache(1) (gdm_torch/deform.py)
        assert alpha < 0.0 and not align, "mapping_fn replaces --alpha/--align"
        from .. import deform
        from ..cut.stencil import routed_apply

        left = -1.21 / n_subdivisions_1D * n_subdivisions_1D
        right = -left
        grid = Grid(fe_degree, (n_subdivisions_1D,) * dim,
                    (left,) * dim, (right,) * dim)
        M = densify(routed_apply(deform.mass_band(grid, mapping_fn)),
                    grid.n_nodes, **dense)
        S = densify(routed_apply(deform.laplace_band(grid, mapping_fn)),
                    grid.n_nodes, **dense)
        return grid, None, M, S
    if (alpha >= 0.0) and align:
        assert dim == 1, "--align is a 1D study (wave-ev.cc:306)"
        n_rel = int(2 * np.floor(radius / h))
        radius_snap = h * (n_rel / 2 - alpha)
        left = -1.21 / n_subdivisions_1D * n_rel
        right = +1.21 / n_subdivisions_1D * n_rel
        grid = Grid(fe_degree, (n_rel,), (left,), (right,))
        # clamped mapping: outer cells end at +-radius_snap
        jac = np.full(n_rel, grid.h[0])
        jac[0] = jac[-1] = grid.h[0] * (1.0 - alpha)
        from ..ops1d import assemble_1d

        # nothing is intersected (level-set radius 2.0 > |domain|), so
        # the cut mass/stiffness reduce to the mapped uncut integrals:
        # no ghost-penalty faces, no Nitsche terms, no inactive dofs
        M = assemble_1d(fe_degree, n_rel, grid.h[0], 0, 0, jac=jac).full()
        S = assemble_1d(fe_degree, n_rel, grid.h[0], 1, 1, jac=jac).full()
        return grid, None, M, S
    elif alpha >= 0.0:
        n_rel = int(2 * np.floor(radius / h))
        radius = h * (n_rel / 2 - alpha)
        n_rel = n_subdivisions_1D
    else:
        n_rel = n_subdivisions_1D
    left = -1.21 / n_subdivisions_1D * n_rel
    right = +1.21 / n_subdivisions_1D * n_rel
    grid = Grid(fe_degree, (n_rel,) * dim, (left,) * dim, (right,) * dim)
    geo = CutGeometry.build(
        grid,
        lambda m: np.sqrt(sum(np.asarray(x) ** 2 for x in m)) - radius,
        fe_degree,
    )
    # mapping_cut=True composes the deformation with the cut machinery
    # (reference discretization.h:57-74 feeds the MappingQCache into
    # every NonMatching::FEValues): the cut is generated undeformed, the
    # quadrature tables are re-metriced in CutOperators — an any-dim
    # deformed-cut spectral study (e.g. wave-ev --alpha/--align in 2D).
    op = CutOperators(geo, INSIDE, mapping_fn=mapping_fn,
                      geometry=mapping_geometry)
    gm = gp_scale * 0.25 * np.sqrt(3.0)
    ga = gp_scale * 0.50 * np.sqrt(3.0)
    N = grid.n_nodes
    M = densify(lambda v: op.mass_apply(v, gm), N, **dense)
    S = densify(
        lambda v: op.stiffness_matrix_apply(v, ga, 5.0 * fe_degree,
                                            with_nitsche=False), N, **dense)
    return grid, op, M, S
