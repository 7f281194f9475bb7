"""Krylov solvers on torch tensors.

Port of gdm/solvers.py.  The stopping rule replicates deal.II's
ReductionControl semantics exactly as gdm does: success when
||r|| <= max(abs_tol, rel_tol * ||r0||), capped at max_iter.

gdm's CG is a ``lax.while_loop`` that stops on the device.  Here the
loop runs on the host and reads ||r|| back once per iteration
(``.item()``), which costs one host-device synchronization per CG
iteration on a GPU; PERF.md records that cost.  Tensors may have any
shape (the padded kernel layout included): dot products run over all
elements.
"""

from __future__ import annotations

import math

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.dot(a.reshape(-1), b.reshape(-1)).item()


def cg(
    apply_fn,
    b: torch.Tensor,
    x0: torch.Tensor = None,
    precond=None,
    max_iter: int = 1000,
    abs_tol: float = 1e-20,
    rel_tol: float = 1e-14,
):
    """Preconditioned conjugate gradients.

    Returns (x, info) with info = dict(iterations, residual) as Python
    numbers.  `apply_fn` must be linear and symmetric positive definite
    on the subspace containing b.  No guards on p^T A p or r^T z (as in
    gdm.solvers.cg; the one-launch kernel in gdm_torch.ops.resident has
    them).
    """
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    if precond is None:
        precond = lambda r: r  # noqa: E731

    r = b - apply_fn(x)
    z = precond(r)
    norm_r0 = math.sqrt(_dot(r, r))
    tol = max(abs_tol, rel_tol * norm_r0)
    p = z.clone()
    rz = _dot(r, z)
    norm_r = norm_r0
    i = 0
    while norm_r > tol and i < max_iter:
        Ap = apply_fn(p)
        alpha = rz / _dot(p, Ap)
        # in place: x, r and p are this solve's own buffers
        x.add_(p, alpha=alpha)
        r.sub_(Ap, alpha=alpha)
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p.mul_(beta).add_(z)
        norm_r = math.sqrt(_dot(r, r))
        rz = rz_new
        i += 1
    return x, {"iterations": i, "residual": norm_r}


def jacobi_preconditioner(diag: torch.Tensor):
    """diag: tensor; zeros are treated as 1."""
    inv = torch.where(diag == 0, torch.ones_like(diag), 1.0 / diag)
    return lambda r: inv * r
