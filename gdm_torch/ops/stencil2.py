"""K3 and K3s: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T.

Port of gdm/ops/pallas_stencil2.py: ``make_padded_laplace2`` (K3, the
TPU kernel that gdm/ops/fast.py::best_field_laplace routes the uncut
Poisson CG operator and every multigrid level through) and
``make_padded_laplace2_stream`` (K3s, the same operator streamed down
the rows; no solve dispatch routes to it, in gdm or here).  The CUDA
kernels are gdm_torch/csrc/laplace2.cu and laplace2_stream.cu; their
source notes say what bounds them on the card.  ``laplace2_apply`` and
``laplace2_stream_apply`` launch their kernel for a CUDA tensor and run
the plain torch version for a CPU tensor; there is no other switch.

Both compute what gdm's f32-exact ``rows="vpu"`` kernel computes, not
the bf16x3 row products of gdm's TPU default.  The node array is the
contiguous (N0, N1) field itself: gdm's guard rows and 128-lane padding
existed for aligned TPU DMAs, so here ``pad`` and ``unpad`` are
reshapes and cost no copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from ._padded import launch, padded_apply
from .tensor import apply_banded

MAX_DEGREE = 15


@dataclasses.dataclass(frozen=True)
class Bands2:
    """The four (N_d, 2p+1) band tables of y = A0 U A1^T + B0 U B1^T
    on one device in one dtype (row-major, band[a, k] = entry
    (a, a+k-p))."""
    a0: torch.Tensor
    a1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    p: int

    @property
    def shape(self) -> tuple:
        return (self.a0.shape[0], self.a1.shape[0])


def laplace2_bands(grid: Grid, device="cpu", dtype=torch.float32,
                   bands=None) -> Bands2:
    """The band tables for ``grid``: ``bands=(A0, A1, B0, B1)`` numpy
    arrays, or by default the GD Laplace (S0, M1, M0, S1)."""
    if grid.dim != 2:
        raise ValueError(f"K3 and K3s are the 2D apply; the grid is "
                         f"{grid.dim}D")
    p = grid.degree
    if p > MAX_DEGREE:
        raise ValueError(f"K3 and K3s take odd degrees p <= {MAX_DEGREE}, "
                         f"not {p}")
    if bands is None:
        bands = (stiffness_1d(p, grid.cells[0], grid.h[0]).band,
                 mass_1d(p, grid.cells[1], grid.h[1]).band,
                 mass_1d(p, grid.cells[0], grid.h[0]).band,
                 stiffness_1d(p, grid.cells[1], grid.h[1]).band)
    n0, n1 = grid.nodes
    want = ((n0, 2 * p + 1), (n1, 2 * p + 1), (n0, 2 * p + 1),
            (n1, 2 * p + 1))
    tabs = []
    for name, b, shape in zip(("A0", "A1", "B0", "B1"), bands, want):
        b = np.asarray(b, np.float64)
        if b.shape != shape:
            raise ValueError(f"band {name} has shape {b.shape}, expected "
                             f"{shape}")
        tabs.append(torch.as_tensor(b, dtype=dtype, device=device)
                    .contiguous())
    return Bands2(*tabs, p)


def _check(u: torch.Tensor, bt: Bands2):
    if tuple(u.shape) != bt.shape:
        raise ValueError(f"expected shape {bt.shape}, got {tuple(u.shape)}")
    if u.dtype != bt.a0.dtype or u.device != bt.a0.device:
        raise ValueError(f"u is {u.dtype} on {u.device}, the bands are "
                         f"{bt.a0.dtype} on {bt.a0.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def laplace2_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3: the column stage V = U A1^T,
    W = U B1^T, then the row stage y = A0 V + B0 W."""
    v = apply_banded(u, bt.a1, 1)
    w = apply_banded(u, bt.b1, 1)
    return apply_banded(v, bt.a0, 0) + apply_banded(w, bt.b0, 0)


def _launch(u: torch.Tensor, bt: Bands2, fn: str, what: str):
    return launch(u, fn, what, (bt.a0, bt.a1, bt.b0, bt.b1), bt.p, bt.shape)


def laplace2_apply(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """y = A0 U A1^T + B0 U B1^T: the CUDA kernel K3 for a CUDA tensor,
    the plain version for a CPU tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace2_apply_plain(u, bt)
    y = _launch(u, bt, "laplace2_apply", "K3")
    laplace2_apply.launches += 1
    return y


laplace2_apply.launches = 0


def laplace2_stream_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3s: K3's operator, so K3's twin."""
    return laplace2_apply_plain(u, bt)


def laplace2_stream_apply(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """K3's operator through the streaming kernel K3s (persistent blocks
    and an asynchronous-copy ring) for a CUDA tensor, the plain version
    for a CPU tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace2_stream_apply_plain(u, bt)
    y = _launch(u, bt, "laplace2_stream_apply", "K3s")
    laplace2_stream_apply.launches += 1
    return y


laplace2_stream_apply.launches = 0


def make_padded_laplace2(grid: Grid, device="cuda", dtype=torch.float32,
                         bands=None):
    """(apply, pad, unpad, shape) of K3 as in gdm, for any odd p <= 15.

    bands: optional (A0, A1, B0, B1) numpy band matrices ((N_d, 2p+1)
    each, the Banded1D.band layout) generalizing the operator to
    y = A0 U A1^T + B0 U B1^T.  Default: the Laplace (S0, M1, M0, S1).
    The "padded" array is the (N0, N1) node array itself.
    """
    bt = laplace2_bands(grid, _device.resolve(device), dtype, bands)
    return padded_apply(bt, laplace2_apply, laplace2_apply_plain)


def make_padded_laplace2_stream(grid: Grid, device="cuda",
                                dtype=torch.float32, bands=None):
    """(apply, pad, unpad, shape) of K3s, the streamed K3: the same
    operator, band tables and node array as ``make_padded_laplace2``."""
    bt = laplace2_bands(grid, _device.resolve(device), dtype, bands)
    return padded_apply(bt, laplace2_stream_apply,
                        laplace2_stream_apply_plain)
