"""K2: the whole preconditioned CG of a 2D band system in one launch.

Port of gdm/ops/pallas_resident.py (``make_resident_cg``).  The CUDA
kernel is gdm_torch/csrc/resident.cu, a cooperative persistent kernel;
its source note says what bounds it on the card and why gdm's VMEM
budget gate has no counterpart here.  ``resident_cg`` launches it for
CUDA tensors and runs the plain torch version ``resident_cg_plain`` for
CPU tensors; there is no other switch.

Both compute exactly what the TPU kernel computes: the ReductionControl
stop ``it < max_iter and ||r|| > max(abs_tol, rel_tol * ||r0||)`` with
early exit, alpha = 0 when p^T A p <= 0 and beta = 0 when r^T z <= 0,
and one fresh apply after the loop for the TRUE residual.  The solve
returns (x, stats) with stats a float32 tensor of three entries, named
by ``STATS``: the true ||b - A x||, the iteration count and ||r0||.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import device as _device
from ..solvers import _dot
from . import _build
from .cutband import (BandPlanes, PaddedLayout, band_apply_plain, band_planes,
                      layout_for)

STATS = ("residual", "iterations", "r0")


def read_stats(stats: torch.Tensor) -> dict:
    """The stats tensor as a dict of Python numbers (one host sync)."""
    vals = dict(zip(STATS, stats.tolist()))
    vals["iterations"] = int(vals["iterations"])
    return vals


def resident_cg_plain(b, x0, A: BandPlanes, G: BandPlanes = None,
                      GT: BandPlanes = None, max_iter: int = 50,
                      rel_tol: float = 1e-5, abs_tol: float = 1e-12):
    """The plain torch version of K2: a host while-loop over band
    applies with the kernel's guards and stats."""
    def B(v):
        return v if G is None else band_apply_plain(band_apply_plain(v, G), GT)

    x = x0.clone()
    r = b - band_apply_plain(x, A)
    z = B(r)
    rz = _dot(r, z)
    nr0 = math.sqrt(_dot(r, r))
    tol = max(abs_tol, rel_tol * nr0)
    p = z.clone()
    nr = nr0
    it = 0
    while it < max_iter and nr > tol:
        Ap = band_apply_plain(p, A)
        pAp = _dot(p, Ap)
        alpha = 0.0 if pAp <= 0.0 else rz / pAp
        # in place: x, r and p are this solve's own buffers
        x.add_(p, alpha=alpha)
        r.sub_(Ap, alpha=alpha)
        z = B(r)
        rz_new = _dot(r, z)
        beta = 0.0 if rz <= 0.0 else rz_new / rz
        p.mul_(beta).add_(z)
        nr = math.sqrt(_dot(r, r))
        rz = rz_new
        it += 1
    rt = b - band_apply_plain(x, A)
    stats = torch.tensor([math.sqrt(_dot(rt, rt)), it, nr0],
                         dtype=torch.float32, device=b.device)
    return x, stats


def resident_cg(b, x0, A: BandPlanes, G: BandPlanes = None,
                GT: BandPlanes = None, max_iter: int = 50,
                rel_tol: float = 1e-5, abs_tol: float = 1e-12):
    """One CG solve of A x = b preconditioned by G^T G (plain CG when G
    is None), on the padded layout: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    ops = [A] if G is None else [A, G, GT]
    if (G is None) != (GT is None):
        raise ValueError("give both FSAI factors or neither")
    layout = A.layout
    for name, v in (("b", b), ("x0", x0)):
        if v.shape != layout.shape or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {layout.shape} "
                             f"array, got {tuple(v.shape)}")
        if v.dtype != A.planes.dtype or v.device != A.planes.device:
            raise ValueError(f"{name} is {v.dtype} on {v.device}, the "
                             f"planes are {A.planes.dtype} on "
                             f"{A.planes.device}")
    for op in ops[1:]:
        if op.layout != layout or op.planes.dtype != A.planes.dtype \
                or op.planes.device != A.planes.device:
            raise ValueError("A, G and GT must share layout, dtype and device")
    if b.device.type == "cpu":
        return resident_cg_plain(b, x0, A, G, GT, max_iter, rel_tol, abs_tol)
    if b.device.type != "cuda":
        raise ValueError(f"no resident CG for device {b.device}")
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(b.dtype)
    if suffix is None:
        raise ValueError(f"the CUDA resident CG takes float32 or float64, "
                         f"not {b.dtype}")
    kl = _build.kernels()
    cells = layout.rows * layout.pitch
    n_taps = sum(len(op.taps) for op in ops)
    Gp = G if G is not None else A  # any valid pointers when unused
    GTp = GT if GT is not None else A
    with torch.cuda.device(b.device):
        nblocks = ctypes.c_int(0)
        _build.check(kl, getattr(kl.lib, f"gdm_resident_cg_blocks_{suffix}")(
            cells, n_taps, ctypes.byref(nblocks)),
            "resident CG: cooperative grid sizing")
        x = x0.clone()
        work = torch.empty((5,) + layout.shape, dtype=b.dtype, device=b.device)
        partials = torch.empty(3 * nblocks.value, dtype=torch.float64,
                               device=b.device)
        stats = torch.empty(3, dtype=torch.float32, device=b.device)
        err = getattr(kl.lib, f"gdm_resident_cg_{suffix}")(
            b.data_ptr(), x.data_ptr(),
            A.planes.data_ptr(), A.offsets.data_ptr(), len(A.taps),
            Gp.planes.data_ptr(), Gp.offsets.data_ptr(),
            len(G.taps) if G is not None else 0,
            GTp.planes.data_ptr(), GTp.offsets.data_ptr(),
            len(GT.taps) if GT is not None else 0,
            int(G is not None), work.data_ptr(), partials.data_ptr(),
            nblocks.value, stats.data_ptr(), layout.rows, layout.pitch,
            layout.n0, layout.n1, layout.r, int(max_iter), float(rel_tol),
            float(abs_tol), _build.stream_handle(b.device))
    _build.check(kl, err, "resident CG cooperative launch")
    resident_cg.launches += 1
    return x, stats


resident_cg.launches = 0


def make_resident_cg(stA, stG=None, stGT=None, max_iter: int = 50,
                     rel_tol: float = 1e-5, abs_tol: float = 1e-12,
                     device="cuda", dtype=torch.float32,
                     layout: PaddedLayout = None):
    """One-launch CG solve of ``stA x = b`` preconditioned by
    B = stGT o stG (or unpreconditioned when both are None).

    Returns (solve_padded, pad, unpad, shape) as gdm does, on ``layout``
    (default: the largest radius of the three operators).
    solve_padded(b_pad, x0_pad=None) -> (x_pad, stats).
    """
    if (stG is None) != (stGT is None):
        raise ValueError("give both FSAI factors or neither")
    device = _device.resolve(device)
    if layout is None:
        r = max([stA.radius] + [s.radius for s in (stG, stGT)
                                if s is not None])
        layout = layout_for(stA.grid, r)
    A = band_planes(stA, layout, device, dtype)
    G = GT = None
    if stG is not None:
        G = band_planes(stG, layout, device, dtype)
        GT = band_planes(stGT, layout, device, dtype)

    def solve_padded(b_pad, x0_pad=None):
        if x0_pad is None:
            x0_pad = torch.zeros_like(b_pad)
        return resident_cg(b_pad, x0_pad, A, G, GT, max_iter, rel_tol,
                           abs_tol)

    return solve_padded, layout.pad, layout.unpad, layout.shape
