"""Scalar Laplace and mass applies, and the Laplace dispatch of the
uncut Poisson and multigrid solves.

Port of gdm/ops/fast.py.  ``laplace_apply_fn`` acts on bare
(N0, ..., N_{dim-1}) fields: in 2D and 3D it is K3 or K4
(gdm_torch/ops/stencil2.py, stencil3.py), whose wrappers launch the
CUDA kernel for a CUDA tensor and the plain torch twin for a CPU
tensor; in 1D it is the separable band sweep.

gdm rode its Pallas kernels only on a TPU and only above
``min_dofs=200_000`` nodes, because of the TPU's 128-lane padding.  The
card has no such padding, so every 2D/3D CUDA apply takes the kernel and
there is no ``use_pallas`` option.  gdm's TPU-only ``use_mxu_3d`` and
``laplace_3d_mxu_fn`` (dense-factor matmuls for the TPU's matrix unit)
have no caller on the card and are not ported (ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from .. import operators
from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from .stencil2 import make_padded_laplace2
from .stencil3 import make_padded_laplace3
from .tensor import apply_banded


def _bands(grid: Grid, device, dtype):
    bs, bm = [], []
    for d in range(grid.dim):
        p, n, h = grid.degree, grid.cells[d], grid.h[d]
        bs.append(torch.as_tensor(stiffness_1d(p, n, h).band, dtype=dtype,
                                  device=device))
        bm.append(torch.as_tensor(mass_1d(p, n, h).band, dtype=dtype,
                                  device=device))
    return bs, bm


def laplace_apply_fn(grid: Grid, device="cpu", dtype=torch.float32):
    """The Laplace apply on bare (N0, ..., N_{dim-1}) fields: K3 in 2D,
    K4 in 3D, the separable sweep in 1D."""
    if grid.dim in (2, 3):
        make = make_padded_laplace2 if grid.dim == 2 else make_padded_laplace3
        apply_padded, pad, unpad, _ = make(grid, device, dtype)

        def apply(u):
            return unpad(apply_padded(pad(u)))

        return apply

    bs, bm = _bands(grid, device, dtype)
    dim = grid.dim

    def apply(u):
        out = None
        for d in range(dim):
            v = u
            for e in range(dim):
                v = apply_banded(v, bs[e] if e == d else bm[e], e)
            out = v if out is None else out + v
        return out

    return apply


def mass_apply_fn(grid: Grid, device="cpu", dtype=torch.float32):
    _, bm = _bands(grid, device, dtype)

    def apply(u):
        v = u
        for d in range(grid.dim):
            v = apply_banded(v, bm[d], d)
        return v

    return apply


def best_field_laplace(grid: Grid, device="cpu", dtype=torch.float32):
    """(field-shaped Laplace apply, rode_kernel: bool): the dispatch of
    the uncut Poisson and multigrid solves, on fields of shape
    grid.nodes + (1,).

    In 2D and 3D it is K3 or K4 on ``u[..., 0]`` (a contiguous view of a
    contiguous field, so no copy) on every device: the wrappers launch
    the kernel for a CUDA tensor and run the plain twin for a CPU tensor,
    so ``rode_kernel`` is whether the device is a CUDA card.  In 1D, and
    for fields of several components, it is the exact SeparableOperator
    apply, ``operators.laplace``.
    """
    device = torch.device(device)
    if grid.dim in (2, 3) and grid.n_components == 1:
        fn = laplace_apply_fn(grid, device, dtype)

        def apply(u):
            return fn(u[..., 0])[..., None]

        return apply, device.type == "cuda"
    return operators.laplace(grid, device=device, dtype=dtype).apply, False
