"""Galerkin Difference (GD) 1D basis.

The GD finite-element space on a structured grid assigns one degree of
freedom to every grid node.  On a cell whose per-axis *category* is ``c``
(0 .. p-1, see :mod:`gdm.grid`), the p+1 local shape functions are the
Lagrange cardinal polynomials on the equispaced stencil nodes
``{0, 1, ..., p}`` evaluated at ``c + xi`` where ``xi`` is the reference
cell coordinate in [0, 1].

This closed form reproduces the hard-coded rational coefficient tables of
the reference implementation (reference: include/gdm/fe.h:55-336, generated
by scripts/create_coefficients.py); we verified the p=1 and p=3 blocks
symbolically and all degrees are covered by unit tests against golden
values.  Coefficients are computed with exact rational arithmetic
(fractions.Fraction) and converted to float64 once at the end.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

#: degrees supported by the reference tables (odd degrees)
SUPPORTED_DEGREES = (1, 3, 5, 7, 9)


@functools.lru_cache(maxsize=None)
def cardinal_coefficients(p: int):
    """Exact monomial coefficients of the Lagrange cardinals on {0..p}.

    Returns a (p+1, p+1) tuple-of-tuples of Fractions: ``C[m][k]`` is the
    coefficient of x^k in L_m, where L_m(j) = delta_{mj} for j in 0..p.
    """
    n = p + 1
    coeffs = []
    for m in range(n):
        # numerator polynomial prod_{j != m} (x - j), denominator prod (m - j)
        poly = [Fraction(1)]  # coefficients, ascending powers
        denom = Fraction(1)
        for j in range(n):
            if j == m:
                continue
            denom *= m - j
            # multiply poly by (x - j)
            new = [Fraction(0)] * (len(poly) + 1)
            for k, a in enumerate(poly):
                new[k + 1] += a
                new[k] -= a * j
            poly = new
        coeffs.append(tuple(a / denom for a in poly))
    return tuple(coeffs)


@functools.lru_cache(maxsize=None)
def category_coefficients_exact(p: int, category: int):
    """Exact-rational ascending coefficients of the p+1 shape functions of
    a category, as polynomials in xi (tuple of tuples of Fractions)."""
    C = cardinal_coefficients(p)
    n = p + 1
    c = category
    out = []
    for m in range(n):
        shifted = [Fraction(0)] * n
        for k in range(n):
            a = C[m][k]
            if a == 0:
                continue
            binom = Fraction(1)
            ck = Fraction(1)
            for i in range(k + 1):
                shifted[k - i] += a * binom * ck
                binom = binom * (k - i) / (i + 1)
                ck *= c
        out.append(tuple(shifted))
    return tuple(out)


def category_coefficients(p: int, category: int) -> np.ndarray:
    """Monomial (ascending) float64 coefficients of the p+1 shape functions
    of a cell with the given per-axis category, as polynomials in the
    reference coordinate xi in [0,1].

    Matches reference include/gdm/fe.h tables (which store descending
    coefficients); shape function m here equals table row m.
    """
    exact = category_coefficients_exact(p, category)
    return np.array([[float(x) for x in row] for row in exact])


def _poly_eval(coeffs: np.ndarray, pts: np.ndarray, deriv: int) -> np.ndarray:
    """Evaluate polynomials (rows of ascending `coeffs`) at `pts`.

    Returns array of shape (n_polys, n_pts).
    """
    n = coeffs.shape[1]
    # differentiate `deriv` times
    c = coeffs.copy()
    for _ in range(deriv):
        c = c[:, 1:] * np.arange(1, c.shape[1])[None, :]
        if c.shape[1] == 0:
            return np.zeros((coeffs.shape[0], len(pts)))
    # Horner, highest power first
    val = np.zeros((c.shape[0], len(pts)))
    for k in range(c.shape[1] - 1, -1, -1):
        val = val * pts[None, :] + c[:, k : k + 1]
    return val


def _cardinal_eval(p: int, x: np.ndarray, deriv: int) -> np.ndarray:
    """Stable product-form evaluation of the Lagrange cardinals on {0..p}.

    Returns (p+1, n_pts): value of d^deriv/dx^deriv L_m at x.  Avoids the
    catastrophic cancellation of expanded monomial coefficients at high
    degree: maintains h[d] = g^{(d)}/d! through the factor recurrence
    g_k = g_{k-1} * (x - r_k)  =>  h_k[d] = h_{k-1}[d]*(x-r_k) + h_{k-1}[d-1].
    """
    import math

    x = np.asarray(x, dtype=np.float64)
    npts = x.shape[0]
    out = np.zeros((p + 1, npts))
    dmax = deriv

    for m in range(p + 1):
        denom = 1.0
        h = np.zeros((dmax + 1, npts))
        h[0] = 1.0
        for j in range(p + 1):
            if j == m:
                continue
            denom *= m - j
            xm = x - j
            for d in range(min(dmax, p), 0, -1):
                h[d] = h[d] * xm + h[d - 1]
            h[0] = h[0] * xm
        out[m] = h[dmax] * (math.factorial(dmax) / denom)
    return out


def shape_table(p: int, pts: np.ndarray, deriv: int = 0) -> np.ndarray:
    """Tabulate the GD shape functions for every category.

    Parameters
    ----------
    p : polynomial degree (odd).
    pts : reference-cell points in [0, 1], shape (n_q,).
    deriv : derivative order (w.r.t. the reference coordinate).

    Returns
    -------
    Array of shape (p, n_q, p+1): ``T[c, q, m]`` is the value of the
    m-th shape function of category c at point q (d^deriv/dxi^deriv).
    Note gradients in physical coordinates require an extra 1/h**deriv.
    """
    pts = np.asarray(pts, dtype=np.float64)
    ncat = max(p, 1)
    out = np.zeros((ncat, len(pts), p + 1))
    for c in range(ncat):
        out[c] = _cardinal_eval(p, pts + c, deriv).T
    return out


def shape_at(p: int, category: int, pts: np.ndarray, deriv: int = 0) -> np.ndarray:
    """Shape values of one category at points: shape (n_q, p+1)."""
    pts = np.asarray(pts, dtype=np.float64)
    return _cardinal_eval(p, pts + category, deriv).T
