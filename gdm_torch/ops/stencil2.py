"""K3: the 2D separable band apply  y = A0 U A1^T + B0 U B1^T.

Port of gdm/ops/pallas_stencil2.py (``make_padded_laplace2``, the TPU
kernel that gdm/ops/fast.py::best_field_laplace routes the uncut
Poisson CG operator and every multigrid level through).  The CUDA
kernel is gdm_torch/csrc/laplace2.cu; its source note says what bounds
it on the card.  ``laplace2_apply`` launches it for a CUDA tensor and
runs the plain torch version ``laplace2_apply_plain`` for a CPU tensor;
there is no other switch.

It computes what gdm's f32-exact ``rows="vpu"`` kernel computes, not
the bf16x3 row products of gdm's TPU default.  The node array is the
contiguous (N0, N1) field itself: gdm's guard rows and 128-lane padding
existed for aligned TPU DMAs, so here ``pad`` and ``unpad`` are
reshapes and cost no copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from . import _build
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
        raise ValueError(f"K3 is the 2D apply; the grid is {grid.dim}D")
    p = grid.degree
    if p > MAX_DEGREE:
        raise ValueError(f"K3 takes odd degrees p <= {MAX_DEGREE}, not {p}")
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


def laplace2_apply(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """y = A0 U A1^T + B0 U B1^T: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace2_apply_plain(u, bt)
    if u.device.type != "cuda":
        raise ValueError(f"no K3 apply for device {u.device}")
    fns = {torch.float32: "gdm_laplace2_apply_f32",
           torch.float64: "gdm_laplace2_apply_f64"}
    if u.dtype not in fns:
        raise ValueError(f"the CUDA K3 apply takes float32 or float64, "
                         f"not {u.dtype}")
    kl = _build.kernels()
    y = torch.empty_like(u)
    n0, n1 = bt.shape
    with torch.cuda.device(u.device):
        err = getattr(kl.lib, fns[u.dtype])(
            u.data_ptr(), bt.a0.data_ptr(), bt.a1.data_ptr(),
            bt.b0.data_ptr(), bt.b1.data_ptr(), y.data_ptr(), bt.p, n0, n1,
            _build.stream_handle(u.device))
    _build.check(kl, err, "K3 laplace2 launch")
    laplace2_apply.launches += 1
    return y


laplace2_apply.launches = 0


def make_padded_laplace2(grid: Grid, device="cpu", dtype=torch.float32,
                         bands=None):
    """(apply, pad, unpad, shape) as in gdm, for any odd p <= 15.

    bands: optional (A0, A1, B0, B1) numpy band matrices ((N_d, 2p+1)
    each, the Banded1D.band layout) generalizing the operator to
    y = A0 U A1^T + B0 U B1^T.  Default: the Laplace (S0, M1, M0, S1).
    The "padded" array is the (N0, N1) node array itself.
    """
    bt = laplace2_bands(grid, device, dtype, bands)
    shape = bt.shape

    def apply(u):
        return laplace2_apply(u, bt)

    def pad(u):
        return u.reshape(shape)

    def unpad(u):
        return u

    return apply, pad, unpad, shape
