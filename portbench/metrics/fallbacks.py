"""Solves the verified mass solvers sent to their fallback over the run
(``VerifiedSolver.fallback_count``, the device counter folded in)."""


def read(t):
    return t.fallbacks
