"""Scalar Laplace and mass applies, and the Laplace dispatch of the
uncut Poisson and multigrid solves.

Port of gdm/ops/fast.py.  ``laplace_apply_fn`` acts on bare
(N0, ..., N_{dim-1}) fields: in 2D and 3D it is the kernel that
``best_padded_laplace`` picks, the port of gdm's dispatch of the same
name (gdm/ops/pallas_stencil2.py): in 2D K3 with the row stage that
``rows=`` names (gdm_torch/ops/stencil2.py), in 3D K5 while
N0 + 2p <= 512 and K4 above (stencil3.py).  Their wrappers launch the
CUDA kernel for a CUDA tensor and the plain torch twin for a CPU
tensor.  In 1D it is the separable band sweep.  Every entry point here
defaults to the card (``device="cuda"``).

The 2D default differs from gdm's.  gdm returns ``rows or "mxu3p"``, its
bf16x3 row products (about 1e-6 relative), a choice its docstring
grounds in v5e timing, with a tile rule (96/128/160 rows) swept on the
v5e too.  Neither carries over: with ``rows=None`` the card runs K3's
float32-exact ``"vpu"`` row stage, the one the uncut solves use; any row
mode gdm accepts runs its own kernel when it is asked for, at the card's
tile (``stencil2.tc_options``).

gdm rode its Pallas kernels only on a TPU and only above
``min_dofs=200_000`` nodes, because of the TPU's 128-lane padding.  The
card has no such padding, so every 2D/3D CUDA apply takes the kernel.
gdm's ``use_pallas``, ``interpret`` and ``min_dofs`` are taken in gdm's
positions and change nothing (``use_pallas="never"`` raises, see
``device.take_use_pallas``), and ``dtype`` stands where gdm puts it,
``device`` by keyword after gdm's parameters.  The 3D threshold
N0 + 2p <= 512 is gdm's, copied as it is (gdm's K5 holds the planes on
128-wide lanes); the card's own crossover is not measured yet.
gdm's TPU-only ``use_mxu_3d`` and ``laplace_3d_mxu_fn`` (dense-factor
matmuls for the TPU's matrix unit) have no caller on the card and are
not ported.
"""

from __future__ import annotations

import torch

from .. import device as _device
from .. import operators
from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from .stencil2 import make_padded_laplace2
from .stencil3 import make_padded_laplace3, make_padded_laplace3_mxu
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


def best_padded_laplace(grid: Grid, dtype=torch.float32, interpret=False,
                        rows=None, *, device="cuda"):
    """(apply, pad, unpad, shape) of the 2D/3D Laplace kernel: in 2D K3
    with the row stage ``rows`` ("vpu", K3 itself, when None; "mxu",
    "mxu3" or "mxu3p", that mode's kernel), in 3D, as in gdm, K5 when
    N0 + 2p <= 512, else K4 (``rows`` is the 2D row stage and must be
    None there).  ``interpret`` is taken and has no effect."""
    if grid.dim == 3:
        if rows is not None:
            raise ValueError(f"rows={rows!r} is the 2D row stage; the 3D "
                             f"kernels take none")
        if grid.nodes[0] + 2 * grid.degree <= 512:
            return make_padded_laplace3_mxu(grid, dtype, device=device)
        return make_padded_laplace3(grid, dtype, device=device)
    if grid.dim == 2:
        return make_padded_laplace2(grid, dtype,
                                    rows="vpu" if rows is None else rows,
                                    device=device)
    raise ValueError(f"no padded Laplace kernel for a {grid.dim}D grid")


def laplace_apply_fn(grid: Grid, dtype=torch.float32, use_pallas=None, *,
                     device="cuda"):
    """The Laplace apply on bare (N0, ..., N_{dim-1}) fields: the kernel
    of ``best_padded_laplace`` in 2D and 3D, the separable sweep in 1D.
    ``use_pallas`` as in ``device.take_use_pallas``."""
    dtype = _device.resolve_dtype(dtype)
    _device.take_use_pallas(use_pallas)
    device = _device.resolve(device)
    if grid.dim in (2, 3):
        apply_padded, pad, unpad, _ = best_padded_laplace(grid, dtype,
                                                          device=device)

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


def mass_apply_fn(grid: Grid, dtype=torch.float32, *, device="cuda"):
    _, bm = _bands(grid, _device.resolve(device),
                   _device.resolve_dtype(dtype))

    def apply(u):
        v = u
        for d in range(grid.dim):
            v = apply_banded(v, bm[d], d)
        return v

    return apply


def best_field_laplace(grid: Grid, use_pallas=None, min_dofs=200_000, *,
                       device="cuda", dtype=torch.float32):
    """(field-shaped Laplace apply, rode_kernel: bool): the dispatch of
    the uncut Poisson and multigrid solves, on fields of shape
    grid.nodes + (1,).

    In 2D and 3D it is the kernel of ``best_padded_laplace`` on
    ``u[..., 0]`` (a contiguous view of a contiguous field, so no copy)
    on every device: the wrappers launch the kernel for a CUDA tensor and
    run the plain twin for a CPU tensor, so ``rode_kernel`` is whether
    the device is a CUDA card.  In 1D, and for fields of several
    components, it is the exact SeparableOperator apply,
    ``operators.laplace``.

    gdm's ``use_pallas`` is taken as in ``device.take_use_pallas``, and
    its ``min_dofs`` (the TPU's lane-padding threshold) has no effect.
    gdm has no ``dtype`` here; ``device`` and ``dtype`` go by keyword.
    """
    _device.take_use_pallas(use_pallas)
    device = _device.resolve(device)
    dtype = _device.resolve_dtype(dtype)
    if grid.dim in (2, 3) and grid.n_components == 1:
        fn = laplace_apply_fn(grid, dtype, device=device)

        def apply(u):
            return fn(u[..., 0])[..., None]

        return apply, device.type == "cuda"
    return operators.laplace(grid, device=device, dtype=dtype).apply, False
