"""K0: gdm's v1 2D Laplace apply, rows first.

Port of gdm/ops/pallas_stencil.py: ``make_padded_laplace`` (K0, gdm's
first fused 2D Laplace kernel, which runs the row sweeps as one dense
banded product per tile on the matrix unit and the column sweeps second)
and ``laplace_2d_pallas_fn``, here ``laplace_2d_fn``.  Nothing in gdm
calls either beyond its builder; K3 (gdm_torch/ops/stencil2.py) computes
the same operator columns first.  The CUDA kernel is
gdm_torch/csrc/laplace2_v1.cu: the row stage as window products on the
tensor cores (3xTF32 wgmma in float32, as gdm's HIGHEST; DMMA in
float64) from window tables built once per band tables and row units
(``ops.tc_tables``), the column stage on the FMA units, persistent
blocks launched as ``stencil2.tc_plan`` says.  ``laplace_v1_apply``
launches it for a CUDA tensor and runs its plain twin for a CPU tensor;
there is no other switch.

K0 is the Laplace only (gdm's builder takes no ``bands=``), for odd
p <= 7 (gdm's row halo is 8 rows).  The node array is the contiguous
(N0, N1) field: ``pad`` and ``unpad`` are reshapes.
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..grid import Grid
from ._padded import padded_apply
from .stencil2 import Bands2, laplace2_bands, tc_apply, tc_options
from .tensor import apply_banded

MAX_DEGREE = 7


def laplace_v1_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K0, in its order: the row stage
    ts = A0 U, tm = B0 U, then the columns y = ts A1^T + tm B1^T."""
    ts = apply_banded(u, bt.a0, 0)
    tm = apply_banded(u, bt.b0, 0)
    return apply_banded(ts, bt.a1, 1) + apply_banded(tm, bt.b1, 1)


def laplace_v1_apply(u: torch.Tensor, bt: Bands2,
                     tile_r=None) -> torch.Tensor:
    """y = A0 U A1^T + B0 U B1^T through the CUDA kernel K0 for a CUDA
    tensor, the plain version for a CPU tensor; odd p <= 7."""
    if bt.p > MAX_DEGREE:
        raise ValueError(f"K0 takes odd degrees p <= {MAX_DEGREE}, not "
                         f"{bt.p}")
    return tc_apply(u, bt, "v1", laplace_v1_apply,
                    laplace_v1_apply_plain, tile_r)


laplace_v1_apply.launches = 0


def make_padded_laplace(grid: Grid, dtype=torch.float32, tile_r=None,
                        interpret=False, *, device="cuda"):
    """(apply, pad, unpad, shape) of K0 for the GD Laplace, odd p <= 7.

    tile_r: the card's tile, as ``stencil2.tc_options`` resolves it
    (gdm's default 128 was the TPU's); the resolved tile is
    ``apply.options``.  The "padded" array is the (N0, N1) node array
    itself.  ``interpret`` (gdm's TPU interpreter) is taken and has no
    effect.
    """
    dtype = _device.resolve_dtype(dtype)
    if grid.degree > MAX_DEGREE:
        raise ValueError(f"K0 takes odd degrees p <= {MAX_DEGREE}, not "
                         f"{grid.degree}: gdm's row halo is 8 rows")
    bt = laplace2_bands(grid, device, dtype)
    return padded_apply(bt, laplace_v1_apply, laplace_v1_apply_plain,
                        **tc_options("v1", bt, tile_r))


def laplace_2d_fn(grid: Grid, dtype=torch.float32, *, device="cuda"):
    """The (N0, N1) -> (N0, N1) Laplace apply through K0 (gdm's
    ``laplace_2d_pallas_fn(grid, dtype)``)."""
    apply_padded, pad, unpad, _ = make_padded_laplace(grid, dtype,
                                                      device=device)

    def apply(u):
        return unpad(apply_padded(pad(u)))

    return apply
