"""The arithmetic the reference computes in.

``F64`` is the reference itself: float64 state, operators and solves,
the mass solved by a dense inverse on the region's nodes and refined
once against the sparse matrix.  ``TF32`` is the control: float32 state
where every product with an operator reads the operator and the vector
rounded to TF32 (a 10-bit mantissa, round to nearest even), as a tensor
core multiplies, and sums in float32; the mass solved as the program
solves it, by CG from zero to the configuration's tolerances, with the
additive Schwarz preconditioner of the cut cells' windows (their blocks
inverted with the program's float32 ridge of 1e-7 of the block's largest
diagonal, point Jacobi elsewhere, applied in float64).  An exact solve
will not do for a control: with the mass inverted exactly, any
perturbation at float32's level or above excites the p = 5 cut masses'
near-null modes, and the DoD run blows up within a few steps (inf); a
CG with the ridged preconditioner leaves those modes alone, as the
program's does.
A comparison that cannot tell the control from the program cannot tell
a lower precision from the configuration's float32.
"""

from __future__ import annotations

import torch

from . import cutfem


def inverse(m: torch.Tensor) -> torch.Tensor:
    """The inverse of a symmetric positive definite float64 matrix, by
    Cholesky where it factors, else by LU."""
    chol, info = torch.linalg.cholesky_ex(m)
    if int(info) == 0:
        return torch.cholesky_inverse(chol)
    return torch.linalg.inv(m)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (round to nearest even), as
    float32."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class F64:
    def matrix(self, a):
        return a

    def vec(self, x):
        return x.double()

    def mv(self, a, x):
        return a @ x

    def mass(self, blocks, n, index, device, settings, windows):
        """The solve of the mass over ``n`` indexed nodes."""
        inv = inverse(cutfem.sparse(blocks, (n, n), device, index,
                                    dense=True))
        m = cutfem.sparse(blocks, (n, n), device, index)

        def solve(x):
            y = inv @ x
            return y + inv @ (x - m @ y)

        return solve


class TF32:
    def matrix(self, a):
        return torch.sparse_csr_tensor(a.crow_indices(), a.col_indices(),
                                       tf32(a.values()), a.shape)

    def vec(self, x):
        return x.float()

    def mv(self, a, x):
        return a @ tf32(x)

    def mass(self, blocks, n, index, device, settings, windows):
        m = cutfem.sparse(blocks, (n, n), device, index)
        pre = schwarz(m, torch.as_tensor(index, device=device)[
            torch.as_tensor(windows, device=device)], n)
        m = self.matrix(m)
        rel, max_iter, abs_tol = settings

        def solve(b):
            return cg(lambda v: m @ tf32(v), b.float(), pre, rel, abs_tol,
                      max_iter)

        return solve


def schwarz(m, windows, n):
    """z = P r, P the sum over the windows of their blocks' exact inverses
    plus point Jacobi on the rows no window covers, in float64."""
    coo = m.to_sparse_coo().coalesce()
    ij, v = coo.indices(), coo.values()
    diag = torch.zeros(n, dtype=torch.float64, device=m.device)
    on = ij[0] == ij[1]
    diag[ij[0][on]] = v[on]
    covered = torch.zeros(n, dtype=torch.bool, device=m.device)
    covered[windows.reshape(-1)] = True
    jac = torch.where(covered, 0.0, 1.0 / diag)
    # the (k, w, w) blocks, gathered from the sparse matrix
    k, w = windows.shape
    blocks = torch.zeros((k, w, w), dtype=torch.float64, device=m.device)
    pos = torch.full((n,), -1, dtype=torch.int64, device=m.device)
    for c in range(k):
        pos[windows[c]] = torch.arange(w, device=m.device)
        keep = (pos[ij[0]] >= 0) & (pos[ij[1]] >= 0)
        blocks[c, pos[ij[0][keep]], pos[ij[1][keep]]] = v[keep]
        pos[windows[c]] = -1
    # the program's float32 ridge: 1e-7 of each block's largest diagonal
    d = torch.diagonal(blocks, dim1=1, dim2=2)
    blocks = blocks + 1e-7 * d.max(dim=1).values[:, None, None] * \
        torch.eye(w, dtype=blocks.dtype, device=blocks.device)
    inv = torch.linalg.inv(blocks)

    def apply(r):
        r = r.double()
        z = jac * r
        zl = torch.einsum("kij,kj->ki", inv, r[windows])
        return z.index_add_(0, windows.reshape(-1), zl.reshape(-1)).float()

    return apply


def cg(apply, b, pre, rel, abs_tol, max_iter, check=8):
    """Preconditioned CG from zero to ||r|| <= max(abs_tol, rel ||b||) or
    ``max_iter`` iterations, the residual read every ``check``
    iterations."""
    x = torch.zeros_like(b)
    tol = max(abs_tol, rel * float(torch.linalg.vector_norm(b)))
    if float(torch.linalg.vector_norm(b)) <= tol:
        return x
    r = b.clone()
    z = pre(r)
    p = z.clone()
    rz = r @ z
    for it in range(max_iter):
        q = apply(p)
        alpha = rz / (p @ q)
        x = x + alpha * p
        r = r - alpha * q
        if (it + 1) % check == 0:
            rn = float(torch.linalg.vector_norm(r))
            if rn <= tol or rn != rn:       # converged, or NaN
                break
        z = pre(r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def by_name(name: str):
    return {"float64": F64, "tf32": TF32}[name]()
