"""Assembled 1D GD operators (banded), the building blocks of all uncut
tensor-product operators.

On a structured grid the global GD mass/stiffness/advection matrices are
Kronecker products of assembled 1D matrices (e.g. the 2D mass matrix is
M_x (x) M_y, the 2D Laplacian is S_x (x) M_y + M_x (x) S_y).  The 1D
matrices are banded with half-bandwidth p; only O(p) rows near each end
deviate from the constant interior stencil.

The reference builds these implicitly through deal.II sparse-matrix
assembly (e.g. tests/poisson_01_gdm.cc:123-161); here they are tiny
host-side numpy arrays and the *apply* is a width-(2p+1) stencil op on the
node lattice — the TPU-native formulation.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import basis, quadrature
from .grid import categories_1d, offsets_1d


@functools.lru_cache(maxsize=None)
def local_matrices_1d(p: int, di: int, dj: int, nq: int = None):
    """Per-category local 1D matrices on the reference cell.

    A[c, a, b] = sum_q  phi_a^(di)(xi_q; c) phi_b^(dj)(xi_q; c) w_q

    (no h scaling -- caller multiplies by h^(1 - di - dj)).
    """
    nq = nq if nq is not None else p + 1
    x, w = quadrature.gauss(nq)
    Ti = basis.shape_table(p, x, di)  # (ncat, q, m)
    Tj = basis.shape_table(p, x, dj)
    return np.einsum("cqa,cqb,q->cab", Ti, Tj, w)


@dataclasses.dataclass(frozen=True)
class Banded1D:
    """Banded (half-bandwidth p) 1D assembled GD matrix.

    band[a, k] stores entry (a, a + k - p); out-of-range entries are 0.
    """

    band: np.ndarray  # (N, 2p+1) float64
    p: int

    @property
    def n(self) -> int:
        return self.band.shape[0]

    def full(self) -> np.ndarray:
        N, W = self.band.shape
        A = np.zeros((N, N))
        for k in range(W):
            d = k - self.p
            idx = np.arange(max(0, -d), min(N, N - d))
            A[idx, idx + d] = self.band[idx, k]
        return A

    def apply_np(self, u: np.ndarray) -> np.ndarray:
        return self.full() @ u

    def scaled(self, alpha: float) -> "Banded1D":
        return Banded1D(self.band * alpha, self.p)

    def __add__(self, other: "Banded1D") -> "Banded1D":
        assert self.p == other.p and self.n == other.n
        return Banded1D(self.band + other.band, self.p)

    def transpose(self) -> "Banded1D":
        N, W = self.band.shape
        out = np.zeros_like(self.band)
        for k in range(W):
            d = k - self.p
            idx = np.arange(max(0, -d), min(N, N - d))
            out[idx + d, self.p - d] = self.band[idx, k]
        return Banded1D(out, self.p)


def identity_banded(n_nodes: int, p: int) -> Banded1D:
    band = np.zeros((n_nodes, 2 * p + 1))
    band[:, p] = 1.0
    return Banded1D(band, p)


def assemble_1d(
    p: int, n_cells: int, h: float, di: int, dj: int, nq: int = None,
    jac=None,
) -> Banded1D:
    """Assemble the 1D GD matrix  sum_cells J_c^(1-di-dj) * local(cat(cell)).

    di/dj are the derivative orders on test/trial functions:
    (0,0)=mass, (1,1)=stiffness, (0,1)=advection (v, u').

    ``jac`` (optional, (n_cells,)): per-cell physical cell widths dx/dxi
    of a piecewise-linear mesh deformation — the semantics of the
    reference's vertex-evaluated ``MappingQCache(1)`` mapping
    (applications/wave/include/gdm/wave/discretization.h:57-74).  The GD
    basis lives on the reference index grid; the mapping enters the
    integrals only through the Jacobian.  Defaults to the uniform ``h``.
    """
    A = local_matrices_1d(p, di, dj, nq)
    pw = 1 - di - dj
    scale = (np.full(n_cells, float(h)) if jac is None
             else np.asarray(jac, float)) ** pw
    off = offsets_1d(n_cells, p)
    cat = categories_1d(n_cells, p)
    m = p + 1
    N = n_cells + 1
    band = np.zeros((N, 2 * p + 1))
    Il, Jl = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    rows = off[:, None, None] + Il[None]  # (n, m, m)
    cols_rel = (Jl - Il + p)[None].repeat(n_cells, axis=0)
    np.add.at(band, (rows, cols_rel), A[cat] * scale[:, None, None])
    return Banded1D(band, p)


@functools.lru_cache(maxsize=None)
def mass_1d(p: int, n_cells: int, h: float, nq: int = None) -> Banded1D:
    return assemble_1d(p, n_cells, h, 0, 0, nq)


@functools.lru_cache(maxsize=None)
def stiffness_1d(p: int, n_cells: int, h: float, nq: int = None) -> Banded1D:
    return assemble_1d(p, n_cells, h, 1, 1, nq)


@functools.lru_cache(maxsize=None)
def advection_1d(p: int, n_cells: int, h: float, nq: int = None) -> Banded1D:
    """(v, u') matrix."""
    return assemble_1d(p, n_cells, h, 0, 1, nq)
