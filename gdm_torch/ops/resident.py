"""K2: the whole preconditioned CG of a 2D band system in one launch.

Port of gdm/ops/pallas_resident.py (``make_resident_cg``).  The CUDA
kernel is gdm_torch/csrc/resident.cu, a cooperative persistent kernel
with one block per SM; its source note says what bounds it on the card
and what its design does about it.  ``resident_cg`` launches it for CUDA
tensors and runs the plain torch version ``resident_cg_plain`` for CPU
tensors; there is no other switch.

Three preconditioner modes (``MODES``): none, gdm's FSAI z = G^T (G r),
and one band z = P r (``P=``), which runs the streamed route's assembled
Schwarz band (gdm's ``lax.while_loop`` CG over its band kernel) and a
Jacobi preconditioner as a one-tap band (``jacobi_band``).  A ``Gate``
(``gate=``) makes a launch solve only when an earlier solve's stats fail
gdm's check (gdm's ``lax.cond`` fallback, gdm/cut/fsai.py:336-356),
decided on the card: a closed gate leaves x at x0 and writes a stats
vector whose ``ran`` is 0.

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
returns (x, stats) with stats a float32 tensor of four entries, named
by ``STATS``: the true ||b - A x||, the iteration count, ||r0|| and
whether the launch solved (1) or its gate closed (0).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .. import device as _device
from ..solvers import _dot
from . import _build
from .cutband import (BandPlanes, PaddedLayout, band_apply_plain, band_planes,
                      layout_for)

STATS = ("residual", "iterations", "r0", "ran")
MODES = ("none", "fsai", "band")   # csrc/resident.cu's MODE_NONE, _FSAI, _BAND


def read_stats(stats: torch.Tensor) -> dict:
    """The stats tensor as a dict of Python numbers (one host sync)."""
    vals = dict(zip(STATS, stats.tolist()))
    vals["iterations"] = int(vals["iterations"])
    vals["ran"] = bool(vals["ran"])
    return vals


@dataclasses.dataclass(frozen=True)
class Gate:
    """gdm's check on the stats of an earlier solve: that solve failed,
    and a gated launch solves, when its true residual > slack *
    max(abs_tol, rel_tol * ||r0||).  ``stats`` is the earlier solve's
    float32 stats tensor, on the device of the gated solve."""
    stats: torch.Tensor
    slack: float
    rel_tol: float
    abs_tol: float

    def opened(self) -> bool:
        """The check on the host (one read): the plain twin's gate."""
        res, _, r0 = self.stats.tolist()[:3]
        return res > self.slack * max(self.abs_tol, self.rel_tol * r0)


def jacobi_band(diag, grid, device, dtype, layout: PaddedLayout
                ) -> BandPlanes:
    """Jacobi's 1 / diag (zeros taken as 1, as
    ``solvers.jacobi_preconditioner``) as a one-tap band on ``layout``,
    for K2's one-band mode.  ``diag`` is a host array of the grid's
    node values (C order)."""
    from ..cut.stencil import StencilOperator

    d = np.asarray(diag, np.float64).reshape(grid.nodes)
    inv = np.where(d == 0.0, 1.0, 1.0 / np.where(d == 0.0, 1.0, d))
    return band_planes(StencilOperator(grid, inv[..., None, None], 0),
                       layout, device, dtype)


def resident_cg_plain(b, x0, A: BandPlanes, G: BandPlanes = None,
                      GT: BandPlanes = None, max_iter: int = 50,
                      rel_tol: float = 1e-5, abs_tol: float = 1e-12, *,
                      P: BandPlanes = None, gate: Gate = None):
    """The plain torch version of K2: a host while-loop over band
    applies with the kernel's guards, modes, gate and stats."""
    if gate is not None and not gate.opened():
        return x0.clone(), torch.zeros(len(STATS), dtype=torch.float32,
                                       device=x0.device)

    def B(v):
        if P is not None:
            return band_apply_plain(v, P)
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
    stats = torch.tensor([math.sqrt(_dot(rt, rt)), it, nr0, 1.0],
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


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the C entries' argument list (csrc/resident.cu's GDM_RESIDENT_ENTRY),
# in the order ``entry_args`` gives the values
ENTRY_ARGTYPES = ([_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P]
                  + [_I] * 6 + [_D, _D, _P, _D, _D, _D] + [_I] * 5 + [_P])


def entry_args(b, x, A: BandPlanes, slots, mode: str, work, partials,
               stats, max_iter, rel_tol, abs_tol, gate: Gate,
               plan: ResidentPlan, stream) -> tuple:
    """The values of one C entry call (``ENTRY_ARGTYPES``): ``slots`` the
    two preconditioner bands (G, G^T; P, None; or None, None), ``mode``
    one of ``MODES``, ``gate`` None or a Gate."""
    lay = A.layout
    pl = [s if s is not None else A for s in slots]  # valid when unused
    n = [len(s.taps) if s is not None else 0 for s in slots]
    return (b.data_ptr(), x.data_ptr(), A.planes.data_ptr(),
            A.offsets.data_ptr(), len(A.taps),
            pl[0].planes.data_ptr(), pl[0].offsets.data_ptr(), n[0],
            pl[1].planes.data_ptr(), pl[1].offsets.data_ptr(), n[1],
            MODES.index(mode), work.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), lay.rows, lay.pitch, lay.n0, lay.n1, lay.r,
            int(max_iter), float(rel_tol), float(abs_tol),
            gate.stats.data_ptr() if gate is not None else None,
            *((float(gate.slack), float(gate.rel_tol), float(gate.abs_tol))
              if gate is not None else (0.0, 0.0, 0.0)),
            int(plan.body == "shared"), plan.blocks, plan.chunk, plan.sw,
            plan.smem, stream)


def resident_cg(b, x0, A: BandPlanes, G: BandPlanes = None,
                GT: BandPlanes = None, max_iter: int = 50,
                rel_tol: float = 1e-5, abs_tol: float = 1e-12, *,
                P: BandPlanes = None, gate: Gate = None, body: str = None):
    """One CG solve of A x = b preconditioned by G^T G, by the one band
    ``P`` (z = P r), or by nothing, on the padded layout: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.  ``gate`` makes
    the solve depend on an earlier solve's stats, decided on the device.
    ``body`` ("shared" or "device") forces the kernel's body, for tests
    and measurements; by default ``resident_plan`` picks it.
    ``resident_cg.launches`` counts every launch,
    ``resident_cg.body_launches`` each body's, ``mode_launches`` each
    mode's and ``gated_launches`` those with a gate (open or closed: the
    host does not read which)."""
    if (G is None) != (GT is None):
        raise ValueError("give both FSAI factors or neither")
    if P is not None and G is not None:
        raise ValueError("give the FSAI factors or the one band P, not both")
    mode = "band" if P is not None else "fsai" if G is not None else "none"
    slots = (P, None) if P is not None else (G, GT)
    ops = [A] + [s for s in slots if s is not None]
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
            raise ValueError("A and its preconditioner bands must share "
                             "layout, dtype and device")
    if gate is not None and (
            gate.stats.shape != (len(STATS),)
            or gate.stats.dtype != torch.float32
            or gate.stats.device != b.device):
        raise ValueError(f"the gate's stats must be a float32 "
                         f"({len(STATS)},) tensor on {b.device}")
    if b.device.type == "cpu":
        return resident_cg_plain(b, x0, A, G, GT, max_iter, rel_tol,
                                 abs_tol, P=P, gate=gate)
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
    with torch.cuda.device(b.device):
        x = x0.clone()
        work = torch.empty((7,) + layout.shape, dtype=b.dtype, device=b.device)
        partials = torch.empty(3 * plan.blocks, dtype=torch.float64,
                               device=b.device)
        stats = torch.empty(len(STATS), dtype=torch.float32, device=b.device)
        err = getattr(kl.lib, f"gdm_resident_cg_{suffix}")(*entry_args(
            b, x, A, slots, mode, work, partials, stats, max_iter, rel_tol,
            abs_tol, gate, plan, _build.stream_handle(b.device)))
    _build.check(kl, err, f"resident CG ({plan.body} body) cooperative "
                 f"launch")
    resident_cg.launches += 1
    resident_cg.body_launches[plan.body] += 1
    resident_cg.mode_launches[mode] += 1
    resident_cg.gated_launches += gate is not None
    return x, stats


resident_cg.launches = 0
resident_cg.body_launches = dict.fromkeys(BODIES, 0)
resident_cg.mode_launches = dict.fromkeys(MODES, 0)
resident_cg.gated_launches = 0


def make_resident_cg(stA, stG=None, stGT=None, max_iter: int = 50,
                     rel_tol: float = 1e-5, abs_tol: float = 1e-12,
                     dtype=torch.float32, interpret: bool = False,
                     vmem_budget: int = None, *, device="cuda",
                     layout: PaddedLayout = None, P=None):
    """One-launch CG solve of ``stA x = b`` preconditioned by
    B = stGT o stG, by the one band ``P`` (a StencilOperator, K2's
    one-band mode), or unpreconditioned when all are None.

    Returns (solve_padded, pad, unpad, shape) as gdm does, on ``layout``
    (default: the largest radius of the operators).
    solve_padded(b_pad, x0_pad=None, *, gate=None) -> (x_pad, stats),
    ``gate`` a ``Gate`` on an earlier solve's stats.  The parameters
    stand in gdm's positional order, ``device``, ``layout`` and ``P`` by
    keyword after them.  ``interpret`` (gdm's TPU interpreter) and
    ``vmem_budget`` (gdm's gate on the TPU's VMEM) are taken and have no
    effect: ``resident_plan`` keeps the planes in shared memory where
    they fit and in device memory where they do not.
    """
    dtype = _device.resolve_dtype(dtype)
    if (stG is None) != (stGT is None):
        raise ValueError("give both FSAI factors or neither")
    if P is not None and stG is not None:
        raise ValueError("give the FSAI factors or the one band P, not both")
    device = _device.resolve(device)
    if layout is None:
        r = max([stA.radius] + [s.radius for s in (stG, stGT, P)
                                if s is not None])
        layout = layout_for(stA.grid, r)
    A = band_planes(stA, layout, device, dtype)
    G = GT = Pp = None
    if stG is not None:
        G = band_planes(stG, layout, device, dtype)
        GT = band_planes(stGT, layout, device, dtype)
    if P is not None:
        Pp = band_planes(P, layout, device, dtype)

    def solve_padded(b_pad, x0_pad=None, *, gate=None):
        if x0_pad is None:
            x0_pad = torch.zeros_like(b_pad)
        return resident_cg(b_pad, x0_pad, A, G, GT, max_iter, rel_tol,
                           abs_tol, P=Pp, gate=gate)

    return solve_padded, layout.pad, layout.unpad, layout.shape
