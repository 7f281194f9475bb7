"""K4: the 3D GD Laplace apply
y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2.

Port of gdm/ops/pallas_stencil2.py (``make_padded_laplace3``).  The CUDA
kernel is gdm_torch/csrc/laplace3.cu; it runs gdm's three banded stages
(A = U M2^T, B = U S2^T; P = M1 A, T = S1 A + M1 B; y = S0 P + M0 T)
with the intermediates in shared memory.  ``laplace3_apply`` launches it
for a CUDA tensor and runs the plain torch version
``laplace3_apply_plain`` (the same stages as band sweeps) for a CPU
tensor; there is no other switch.  The node array is the contiguous
(N0, N1, N2) field: ``pad`` and ``unpad`` are reshapes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from . import _build
from .tensor import apply_banded

MAX_DEGREE = 7


@dataclasses.dataclass(frozen=True)
class Bands3:
    """Stiffness and mass band tables per axis, (N_d, 2p+1) row-major."""
    s: tuple   # (S0, S1, S2)
    m: tuple   # (M0, M1, M2)
    p: int

    @property
    def shape(self) -> tuple:
        return tuple(b.shape[0] for b in self.s)


def laplace3_bands(grid: Grid, device="cpu", dtype=torch.float32) -> Bands3:
    if grid.dim != 3:
        raise ValueError(f"K4 is the 3D apply; the grid is {grid.dim}D")
    p = grid.degree
    if p > MAX_DEGREE:
        raise ValueError(
            f"K4 takes odd degrees p <= {MAX_DEGREE}, not {p}: its shared-"
            f"memory plane ring holds 2p+1 planes of 16 x 32 nodes, which "
            f"fits one H100 block up to p = {MAX_DEGREE}")

    def tab(band):
        return torch.as_tensor(band, dtype=dtype, device=device).contiguous()

    s = tuple(tab(stiffness_1d(p, grid.cells[d], grid.h[d]).band)
              for d in range(3))
    m = tuple(tab(mass_1d(p, grid.cells[d], grid.h[d]).band)
              for d in range(3))
    return Bands3(s, m, p)


def _check(u: torch.Tensor, bt: Bands3):
    if tuple(u.shape) != bt.shape:
        raise ValueError(f"expected shape {bt.shape}, got {tuple(u.shape)}")
    ref = bt.s[0]
    if u.dtype != ref.dtype or u.device != ref.device:
        raise ValueError(f"u is {u.dtype} on {u.device}, the bands are "
                         f"{ref.dtype} on {ref.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def laplace3_apply_plain(u: torch.Tensor, bt: Bands3) -> torch.Tensor:
    """The plain torch version of K4: the three staged band sweeps."""
    (s0, s1, s2), (m0, m1, m2) = bt.s, bt.m
    a = apply_banded(u, m2, 2)
    b = apply_banded(u, s2, 2)
    p_ = apply_banded(a, m1, 1)
    t_ = apply_banded(a, s1, 1) + apply_banded(b, m1, 1)
    return apply_banded(p_, s0, 0) + apply_banded(t_, m0, 0)


def laplace3_apply(u: torch.Tensor, bt: Bands3) -> torch.Tensor:
    """The 3D Laplace apply: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace3_apply_plain(u, bt)
    if u.device.type != "cuda":
        raise ValueError(f"no K4 apply for device {u.device}")
    fns = {torch.float32: "gdm_laplace3_apply_f32",
           torch.float64: "gdm_laplace3_apply_f64"}
    if u.dtype not in fns:
        raise ValueError(f"the CUDA K4 apply takes float32 or float64, "
                         f"not {u.dtype}")
    kl = _build.kernels()
    y = torch.empty_like(u)
    (s0, s1, s2), (m0, m1, m2) = bt.s, bt.m
    with torch.cuda.device(u.device):
        err = getattr(kl.lib, fns[u.dtype])(
            u.data_ptr(), s0.data_ptr(), m0.data_ptr(), s1.data_ptr(),
            m1.data_ptr(), s2.data_ptr(), m2.data_ptr(), y.data_ptr(), bt.p,
            *bt.shape, _build.stream_handle(u.device))
    _build.check(kl, err, "K4 laplace3 launch")
    laplace3_apply.launches += 1
    return y


laplace3_apply.launches = 0


def make_padded_laplace3(grid: Grid, device="cpu", dtype=torch.float32):
    """(apply, pad, unpad, shape) for the 3D Laplace, odd p <= 7.  The
    "padded" array is the (N0, N1, N2) node array itself."""
    bt = laplace3_bands(grid, device, dtype)
    shape = bt.shape

    def apply(u):
        return laplace3_apply(u, bt)

    def pad(u):
        return u.reshape(shape)

    def unpad(u):
        return u

    return apply, pad, unpad, shape
