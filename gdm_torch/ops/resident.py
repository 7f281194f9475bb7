"""K2: the whole preconditioned CG of a 2D band system in one launch.

Port of gdm/ops/pallas_resident.py (``make_resident_cg``).  The CUDA
kernel is gdm_torch/csrc/resident.cu, a cooperative persistent kernel
with one block per SM; its source note says what bounds it on the card
and what its design does about it.  ``resident_cg`` launches it for CUDA
tensors and runs the plain torch version ``resident_cg_plain`` for CPU
tensors; there is no other switch.

The kernel has two bodies, one launch each: ``"shared"`` keeps every
block's slice of the A, G and G^T planes in shared memory for the whole
solve (gdm's VMEM residency), ``"device"`` reads them from device memory
where they do not fit.  ``resident_plan`` picks the body from the bytes
and lays out the shared memory; the launcher takes its plan, and a CUDA
tensor launches one body or raises.  There is no size above which the
solve refuses: the device body stages as few cells at a time as it must.

Both compute exactly what the TPU kernel computes: the ReductionControl
stop ``it < max_iter and ||r|| > max(abs_tol, rel_tol * ||r0||)`` with
early exit, alpha = 0 when p^T A p <= 0 and beta = 0 when r^T z <= 0,
and one fresh apply after the loop for the TRUE residual.  The solve
returns (x, stats) with stats a float32 tensor of three entries, named
by ``STATS``: the true ||b - A x||, the iteration count and ||r0||.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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


BODIES = ("shared", "device")
NT = 512                        # threads per block of csrc/resident.cu
SCRATCH_BYTES = 8 * (NT // 32 + 8)   # its reduction scratch, in doubles
H100_SMS = 132
H100_SMEM = 232448              # shared memory an H100 block may opt in to


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """How csrc/resident.cu runs one solve: ``blocks`` blocks (one per
    SM), block b owning cells [b cells / blocks, (b + 1) cells / blocks)
    of the flat padded array and staging ``chunk`` of them at a time (its
    whole range in the ``"shared"`` body) in a window of 2r + 1 rows of
    stride ``sw``; ``smem`` bytes of dynamic shared memory."""
    body: str
    blocks: int
    chunk: int
    sw: int
    smem: int


def _layout_bytes(layout: PaddedLayout, n_taps: int, itemsize: int,
                  chunk: int, planes: bool):
    """(shared bytes, sw) of a block staging ``chunk`` cells, as
    csrc/resident.cu lays them out: the scratch, with ``planes`` the
    planes' slices, then the window, with ``planes`` the block's own p, r
    and x, and the taps' window offsets."""
    r = layout.r
    sw = min(layout.pitch, chunk + 2 * r)
    window = 2 * r * sw + chunk + 2 * r
    values = window + ((n_taps + 3) * chunk if planes else 0)
    return SCRATCH_BYTES + itemsize * values + 4 * n_taps, sw


@functools.lru_cache(maxsize=None)
def resident_plan(layout: PaddedLayout, n_taps: int, itemsize: int,
                  sms: int = H100_SMS, smem_max: int = H100_SMEM,
                  body: str = None) -> ResidentPlan:
    """The body K2 runs for ``n_taps`` planes (A, G and G^T together) of
    ``itemsize`` bytes on ``layout``, on a card of ``sms`` SMs whose
    blocks may take ``smem_max`` bytes of shared memory: ``"shared"``
    when every block's slice of the planes fits beside its window,
    ``"device"`` otherwise, with the largest chunk whose window fits.
    ``body`` forces one; a forced ``"shared"`` that does not fit raises
    ValueError."""
    if body not in (None,) + BODIES:
        raise ValueError(f"body must be None or one of {BODIES}, not "
                         f"{body!r}")
    cells = layout.rows * layout.pitch
    own = -(-cells // sms)
    smem, sw = _layout_bytes(layout, n_taps, itemsize, own, True)
    if body == "shared" or (body is None and smem <= smem_max):
        if smem > smem_max:
            raise ValueError(
                f"the shared body needs {smem} bytes of shared memory a "
                f"block for {n_taps} planes over {own} cells; the card "
                f"gives {smem_max}")
        return ResidentPlan("shared", sms, own, sw, smem)
    lo, hi = 1, own     # the window of one cell always fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _layout_bytes(layout, n_taps, itemsize, mid, False)[0] <= smem_max:
            lo = mid
        else:
            hi = mid - 1
    smem, sw = _layout_bytes(layout, n_taps, itemsize, lo, False)
    return ResidentPlan("device", sms, lo, sw, smem)


@functools.lru_cache(maxsize=None)
def card_limits(index: int) -> tuple:
    """(SMs, shared bytes a block may opt in to) of CUDA card ``index``;
    raises where it has no cooperative launch."""
    kl = _build.kernels()
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(kl, kl.lib.gdm_resident_cg_limits(
            ctypes.byref(sms), ctypes.byref(smem)), "resident CG: the card")
    return sms.value, smem.value


def resident_cg(b, x0, A: BandPlanes, G: BandPlanes = None,
                GT: BandPlanes = None, max_iter: int = 50,
                rel_tol: float = 1e-5, abs_tol: float = 1e-12, *,
                body: str = None):
    """One CG solve of A x = b preconditioned by G^T G (plain CG when G
    is None), on the padded layout: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``body`` ("shared" or "device")
    forces the kernel's body, for tests and measurements; by default
    ``resident_plan`` picks it.  ``resident_cg.launches`` counts every
    launch, ``resident_cg.body_launches`` each body's."""
    ops = [A] if G is None else [A, G, GT]
    if (G is None) != (GT is None):
        raise ValueError("give both FSAI factors or neither")
    if body not in (None,) + BODIES:
        raise ValueError(f"body must be None or one of {BODIES}, not "
                         f"{body!r}")
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
    n_taps = sum(len(op.taps) for op in ops)
    plan = resident_plan(layout, n_taps, b.element_size(),
                         *card_limits(b.device.index
                                      if b.device.index is not None
                                      else torch.cuda.current_device()),
                         body=body)
    Gp = G if G is not None else A  # any valid pointers when unused
    GTp = GT if GT is not None else A
    with torch.cuda.device(b.device):
        x = x0.clone()
        work = torch.empty((7,) + layout.shape, dtype=b.dtype, device=b.device)
        partials = torch.empty(3 * plan.blocks, dtype=torch.float64,
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
            stats.data_ptr(), layout.rows, layout.pitch, layout.n0,
            layout.n1, layout.r, int(max_iter), float(rel_tol),
            float(abs_tol), int(plan.body == "shared"), plan.blocks,
            plan.chunk, plan.sw, plan.smem,
            _build.stream_handle(b.device))
    _build.check(kl, err, f"resident CG ({plan.body} body) cooperative "
                 f"launch")
    resident_cg.launches += 1
    resident_cg.body_launches[plan.body] += 1
    return x, stats


resident_cg.launches = 0
resident_cg.body_launches = dict.fromkeys(BODIES, 0)


def make_resident_cg(stA, stG=None, stGT=None, max_iter: int = 50,
                     rel_tol: float = 1e-5, abs_tol: float = 1e-12,
                     dtype=torch.float32, interpret: bool = False,
                     vmem_budget: int = None, *, device="cuda",
                     layout: PaddedLayout = None):
    """One-launch CG solve of ``stA x = b`` preconditioned by
    B = stGT o stG (or unpreconditioned when both are None).

    Returns (solve_padded, pad, unpad, shape) as gdm does, on ``layout``
    (default: the largest radius of the three operators).
    solve_padded(b_pad, x0_pad=None) -> (x_pad, stats).  The parameters
    stand in gdm's positional order, ``device`` and ``layout`` by
    keyword after them.  ``interpret`` (gdm's TPU interpreter) and
    ``vmem_budget`` (gdm's gate on the TPU's VMEM) are taken and have no
    effect: ``resident_plan`` keeps the planes in shared memory where
    they fit and in device memory where they do not.
    """
    dtype = _device.resolve_dtype(dtype)
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
