"""Quadrature rules (host-side, numpy float64).

Gauss-Legendre on [0,1] (the reference uses dealii::QGauss(p+1) everywhere,
e.g. tests/poisson_01_gdm.cc:88, applications/wave/.../discretization.h:101)
and Gauss-Lobatto points (support points of dealii FE_Q, used for the
level-set interpolant).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss(n: int):
    """n-point Gauss-Legendre rule on [0, 1] -> (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


@functools.lru_cache(maxsize=None)
def gauss_lobatto_points(n: int) -> np.ndarray:
    """n Gauss-Lobatto points on [0, 1] (includes endpoints), n >= 2.

    These are the roots of (1-x^2) P'_{n-1}(x) mapped to [0,1] — the
    support points of dealii's FE_Q elements.
    """
    if n == 2:
        return np.array([0.0, 1.0])
    # interior points: roots of P'_{n-1}
    legc = np.zeros(n)
    legc[n - 1] = 1.0
    dleg = np.polynomial.legendre.legder(legc)
    interior = np.polynomial.legendre.legroots(dleg)
    pts = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    return (pts + 1.0) / 2.0


@functools.lru_cache(maxsize=None)
def _lagrange_coeff_matrix(nodes: tuple, deriv: int) -> np.ndarray:
    """Monomial coefficients C[k, i] of the (differentiated) cardinals on
    `nodes` (cached; nodes sets are few, evaluation points are many)."""
    nodes_a = np.asarray(nodes)
    n = len(nodes_a)
    V = np.vander(nodes_a, n, increasing=True)
    C = np.linalg.inv(V)  # C[k, i]: coeff of x^k for cardinal i
    for _ in range(deriv):
        C = C[1:] * np.arange(1, C.shape[0])[:, None]
    return C


def lagrange_eval_matrix(nodes: tuple, pts, deriv: int = 0) -> np.ndarray:
    """Evaluation matrix E[q, i] = L_i^(deriv)(pts[q]) for the Lagrange basis
    on `nodes` (a tuple of floats on [0,1]); pts: any 1D sequence."""
    C = _lagrange_coeff_matrix(tuple(nodes), deriv)
    pts_a = np.asarray(pts, dtype=np.float64)
    n = len(nodes)
    if C.shape[0] == 0:
        return np.zeros((len(pts_a), n))
    E = np.zeros((len(pts_a), n))
    for k in range(C.shape[0] - 1, -1, -1):
        E = E * pts_a[:, None] + C[k][None, :]
    return E
