"""ctypes bindings for the native C++ geometry core (native/gdm_native.cpp).

The source is shared with gdm; the shared library is built on first use
(g++ -O3) into this package's own build directory, written under a
temporary name and renamed into place, so concurrent test workers never
load a half-written file.  Every entry point has a pure-numpy fallback
for machines without a C++ compiler.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

from . import profiling

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "gdm_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_LIB = os.path.join(BUILD_DIR, "libgdm_native.so")


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def _load():
    """The library, built if missing or older than its source (span
    ``setup.kernels``); None where it cannot be built or loaded."""
    with profiling.span("setup.kernels"):
        return _build_and_load()


def _build_and_load():
    try:
        if (not os.path.exists(_LIB)) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _build()
        lib = ctypes.CDLL(_LIB)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.gdm_batched_real_roots.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gdm_batched_real_roots.restype = None
    lib.gdm_cut_quadrature_2d.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gdm_cut_quadrature_2d.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def batched_real_roots(coeffs: np.ndarray, lo: float, hi: float,
                       root_tol: float = 1e-11):
    """Real roots in (lo, hi) of many polynomials.

    coeffs: (n, degree+1) ascending.  Returns (roots (n, degree) NaN-padded
    sorted, counts (n,)).
    """
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float64)
    n, d1 = coeffs.shape
    degree = d1 - 1
    lib = _load()
    if lib is None:
        roots = np.full((n, degree), np.nan)
        counts = np.zeros(n, dtype=np.int32)
        for i in range(n):
            c = np.trim_zeros(coeffs[i][::-1], "f")
            if len(c) <= 1:
                continue
            r = np.roots(c)
            r = r[np.abs(r.imag) < 1e-9].real
            r = np.sort(r[(r > lo + root_tol) & (r < hi - root_tol)])
            roots[i, : len(r)] = r
            counts[i] = len(r)
        return roots, counts
    roots = np.full((n, degree), np.nan)
    counts = np.zeros(n, dtype=np.int32)
    lib.gdm_batched_real_roots(
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n), ctypes.c_int(degree),
        ctypes.c_double(lo), ctypes.c_double(hi), ctypes.c_double(root_tol),
        roots.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return roots, counts


def cut_quadrature_2d(monos: np.ndarray, gx, gw, hx: float, hy: float,
                      maxv: int = None, maxs: int = None):
    """Batched 2D cut-cell quadrature from per-cell monomial level-set
    coefficients.  Returns dict of padded arrays + per-cell counts and
    status (status=1: cell needs the python bisection fallback).
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    monos = np.ascontiguousarray(monos, dtype=np.float64)
    nc, q, _ = monos.shape
    gx = np.ascontiguousarray(gx, dtype=np.float64)
    gw = np.ascontiguousarray(gw, dtype=np.float64)
    nq = len(gx)
    deg = q - 1
    if maxv is None:
        maxv = (2 * deg + 3) * nq * (deg + 1) * nq
    if maxs is None:
        maxs = (2 * deg + 3) * nq * deg

    def dbuf(shape):
        return np.zeros(shape, dtype=np.float64)

    in_pts = dbuf((nc, maxv, 2)); in_w = dbuf((nc, maxv))
    out_pts = dbuf((nc, maxv, 2)); out_w = dbuf((nc, maxv))
    s_pts = dbuf((nc, maxs, 2)); s_w = dbuf((nc, maxs))
    s_n = dbuf((nc, maxs, 2))
    n_in = np.zeros(nc, np.int32); n_out = np.zeros(nc, np.int32)
    n_s = np.zeros(nc, np.int32); status = np.zeros(nc, np.int32)

    P = ctypes.POINTER(ctypes.c_double)
    I = ctypes.POINTER(ctypes.c_int32)
    lib.gdm_cut_quadrature_2d(
        monos.ctypes.data_as(P), ctypes.c_int64(nc), ctypes.c_int(q),
        gx.ctypes.data_as(P), gw.ctypes.data_as(P), ctypes.c_int(nq),
        ctypes.c_double(hx), ctypes.c_double(hy),
        ctypes.c_int(maxv), ctypes.c_int(maxs),
        in_pts.ctypes.data_as(P), in_w.ctypes.data_as(P),
        n_in.ctypes.data_as(I),
        out_pts.ctypes.data_as(P), out_w.ctypes.data_as(P),
        n_out.ctypes.data_as(I),
        s_pts.ctypes.data_as(P), s_w.ctypes.data_as(P),
        s_n.ctypes.data_as(P), n_s.ctypes.data_as(I),
        status.ctypes.data_as(I),
    )
    return {
        "in_pts": in_pts, "in_w": in_w, "n_in": n_in,
        "out_pts": out_pts, "out_w": out_w, "n_out": n_out,
        "s_pts": s_pts, "s_w": s_w, "s_n": s_n, "n_s": n_s,
        "status": status,
    }
