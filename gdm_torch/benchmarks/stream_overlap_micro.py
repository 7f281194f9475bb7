"""M3, M4 and M5, gdm's stream-overlap micro-benchmarks, on the card.

Port of gdm's benchmarks/stream_overlap_micro.py: can the copies of the
next tiles hide under the FMA work of this one?  ``make_micro`` (M3)
streams tiles of tile_r rows through a ring of ``nb`` shared-memory
slots, each tile copied as ``nsplit`` row chunks of their own, in gdm's
modes ``"compute"`` (no traffic),
``"dma"`` (copies, no stencil), ``"both"`` (copies and a K-tap
separable stencil), ``"dma_in"`` and ``"dma_out"``;
``make_auto_micro`` (M4) streams the same array, gdm's automatic
BlockSpec pipeline, in units of whole rows through a ring of bulk
copies (``auto_ring``);
``make_sepbuf_micro`` (M5) is a two-slot ring with one buffer per slot
and static slot indices.  ``main`` prints gdm's rows and the overlap
fraction, (t_compute + t_dma - t_both) / (t_compute + t_dma -
max(t_compute, t_dma)): 1 when the copies hide under the compute
completely, 0 when the two run one after the other.

The kernels are gdm_torch/csrc/micro_stream.cu; its source note says
what each mode computes, what gdm leaves undefined (the guard rows, and
all of y in "compute", "dma_in" and "dma_out") and what the port writes
there.  Each wrapper (``stream_micro_apply``, ``auto_micro_apply``,
``sepbuf_micro_apply``) launches its kernel for a CUDA tensor, counted
on its ``launches``, and runs its plain torch twin for a CPU tensor.
"compute" and "dma_in" return a sink, one float per (tile, column
strip), instead of y.  M3 launches from a plan picked from the layout
(``m3_plan``: the column strip, the blocks; ``m3_plans`` and the private
``_launch_m3_plan`` run every plan).  Run on a card:

    python -m gdm_torch.benchmarks.stream_overlap_micro [N0 N1 tile_r nb nsplit [modes...]]

with the modes of M3, or ``auto_dma``, ``auto_both`` (M4), ``sep_dma``,
``sep_dma_in`` (M5).
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np
import torch

from .. import device as _device
from . import _kernel
from .timing import device_ms

MODES = ("compute", "dma", "both", "dma_in", "dma_out")
AUTO_MODES = ("dma", "both")
SEPBUF_MODES = ("dma", "dma_in")
SINK_MODES = ("compute", "dma_in")
H = 8                        # gdm's guard rows
SMEM_MAX = 232448            # shared memory an H100 block may use
SMEM_SM = 233472             # shared memory of an H100 SM
SMEM_TWO = 113 * 1024        # M5: at most this per block for two on an SM
STRIPS = (64, 32)            # M5's column strips, widest first
SMS = 132                    # an H100 SXM's SMs


def _rnd(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class StreamGeom:
    """gdm's layout: W2 = rnd(N1 + 2p, 128) columns, Rp = rnd(N0, tile_r)
    rows in n_tiles tiles, R_ext = Rp + 2H; T_ext = tile_r + 2H rows
    of gdm's tile; sw, the column strip of M3's ring (``m3_plan``) or
    M5's (``strip_width``), None for M4, whose units are whole rows."""
    n0: int
    n1: int
    tile_r: int
    k: int
    sw: int = None

    @property
    def p(self) -> int:
        return (self.k - 1) // 2

    @property
    def w2(self) -> int:
        return _rnd(self.n1 + 2 * self.p, 128)

    @property
    def n_tiles(self) -> int:
        return -(-self.n0 // self.tile_r)

    @property
    def rp(self) -> int:
        return self.n_tiles * self.tile_r

    @property
    def t_ext(self) -> int:
        return self.tile_r + 2 * H

    @property
    def r_ext(self) -> int:
        return self.rp + 2 * H

    @property
    def n_strips(self) -> int:
        return self.w2 // self.sw

    @property
    def n_dof(self) -> int:
        return self.n0 * self.n1


def ring_bytes(tile_r: int, k: int, sw: int, slots: int):
    """Shared memory of one M5 block as csrc/micro_stream.cu lays it
    out: the ring's slots (T_ext rows of sw + 2 rnd(p, 4) columns,
    plus the rows' column-0 values), the stencil's V rows and a
    reduction scratch."""
    p = (k - 1) // 2
    rows = tile_r + 2 * H
    slot = rows * (sw + 2 * _rnd(p, 4)) + _rnd(rows, 4)
    return 4 * (16 + _rnd((tile_r + 2 * p) * sw, 4) + slots * slot)


def strip_width(tile_r: int, k: int, slots: int):
    """M5's column strip: the widest of 64 and 32 columns whose
    block fits twice on an SM, else the widest that fits once; a ring
    that does not fit raises ValueError."""
    for limit in (SMEM_TWO, SMEM_MAX):
        for sw in STRIPS:
            if ring_bytes(tile_r, k, sw, slots) <= limit:
                return sw
    raise ValueError(
        f"a ring of {slots} slots of {tile_r} rows needs "
        f"{ring_bytes(tile_r, k, STRIPS[-1], slots)} bytes of shared "
        f"memory at the narrowest strip; an H100 block has {SMEM_MAX}: "
        f"take a smaller tile_r or fewer slots")


def _geometry(n0, n1, tile_r, k, slots=None, sw=None) -> StreamGeom:
    """gdm's layout, with M5's strip for a ring of ``slots`` slots, the
    strip ``sw`` (M3), or none (M4)."""
    for name, v in (("N0", n0), ("N1", n1), ("tile_r", tile_r)):
        if int(v) != v or v < 1:
            raise ValueError(f"{name} must be a positive integer, not {v}")
    if k not in (3, 5, 7):
        raise ValueError(f"the card's micro kernels take K = 3, 5 or 7 "
                         f"taps, not {k}")
    if slots is not None:
        sw = strip_width(int(tile_r), k, slots)
    return StreamGeom(int(n0), int(n1), int(tile_r), k, sw)


def stream_coef(g: StreamGeom, device) -> torch.Tensor:
    """gdm's coefficients: default_rng(0) standard normals (K, W2) in
    float32."""
    return torch.as_tensor(
        np.random.default_rng(0).standard_normal((g.k, g.w2)),
        dtype=torch.float32, device=device)


def _col_stage(u: torch.Tensor, coef: torch.Tensor, p: int) -> torch.Tensor:
    """V = sum_l coef[l] roll(u, p - l): V[q][j] = sum_l coef[l][j]
    u[q][(j + l - p) mod W2], summed from zero in gdm's order."""
    v = torch.zeros_like(u)
    for l in range(coef.shape[0]):
        v = v + coef[l] * torch.roll(u, (p - l) % u.shape[1], dims=1)
    return v


def _row_stage(v: torch.Tensor, coef: torch.Tensor, rows: int,
               first: int) -> torch.Tensor:
    """acc[r] = sum_k coef[k][0] v[first + k + r], r < rows."""
    acc = torch.zeros((rows, v.shape[1]), dtype=v.dtype, device=v.device)
    for k in range(coef.shape[0]):
        acc = acc + coef[k, 0] * v[first + k:first + k + rows]
    return acc


def stream_term_scale(u: torch.Tensor, coef: torch.Tensor) -> float:
    """A bound on the sum of |terms| of one output of the stencil,
    max|u| times the largest column sum of |coef| times sum_k
    |coef[k][0]|: the scale of the float32 rounding of "both"."""
    return (u.abs().max() * coef.abs().sum(dim=0).max()
            * coef[:, 0].abs().sum()).item()


def synth_tile(g: StreamGeom, device) -> torch.Tensor:
    """The fixed tile of "compute" and "dma_out" (csrc/micro_stream.cu's
    ``synth``): F[q][j] = ((31 q + 17 j) mod 64) / 64 - 1/2 over T_ext
    rows and strip 0's columns -p .. sw + p, wrapped mod W2."""
    q = torch.arange(g.t_ext, device=device)[:, None]
    j = (torch.arange(-g.p, g.sw + g.p, device=device) % g.w2)[None, :]
    return ((31 * q + 17 * j) % 64).to(torch.float32) / 64 - 0.5


def stream_micro_plain(u: torch.Tensor, coef: torch.Tensor, g: StreamGeom,
                       mode: str) -> torch.Tensor:
    """The plain torch version of M3: y (R_ext, W2), zero in the guard
    rows, for "both", "dma" and "dma_out"; the sink (n_tiles, n_strips)
    for "compute" and "dma_in" (see csrc/micro_stream.cu).  "compute" and
    "dma_out" read no u: they run on the fixed tile ``synth_tile``."""
    p, sw = g.p, g.sw
    if mode == "compute":
        # the fixed tile under every strip's coefficients
        u0 = synth_tile(g, u.device)
        cs = coef.reshape(g.k, g.n_strips, sw)
        v = torch.zeros((g.n_strips, g.t_ext, sw), dtype=u.dtype,
                        device=u.device)
        for l in range(g.k):
            v = v + cs[l][:, None, :] * u0[None, :, l:l + sw]
        acc = torch.zeros((g.n_strips, g.tile_r, sw), dtype=u.dtype,
                          device=u.device)
        for k in range(g.k):
            acc = acc + coef[k, 0] * v[:, H - p + k:H - p + k + g.tile_r]
        return acc.sum(dim=(1, 2))[None, :].expand(g.n_tiles, -1).contiguous()
    if mode == "dma_in":
        c0 = u[:g.rp, 0].reshape(g.n_tiles, g.tile_r).sum(dim=1)
        return (sw * c0)[:, None].expand(-1, g.n_strips).contiguous()
    y = torch.zeros((g.r_ext, g.w2), dtype=u.dtype, device=u.device)
    if mode == "both":
        v = _col_stage(u, coef, p)
        y[H:H + g.rp] = _row_stage(v, coef, g.rp, H - p)
    elif mode == "dma":
        y[H:H + g.rp] = u[:g.rp, :1]
    else:   # dma_out: the fixed tile's column 0 in every tile
        y[H:H + g.rp] = synth_tile(g, u.device)[:g.tile_r, p:p + 1].repeat(
            g.n_tiles, 1)
    return y


def _check_coef(coef, u, g):
    if tuple(coef.shape) != (g.k, g.w2) or coef.dtype != torch.float32 or (
            coef.device != u.device or not coef.is_contiguous()):
        raise ValueError(f"coef must be contiguous float32 ({g.k}, {g.w2}) "
                         f"on {u.device}")


# ---- M3's launch plan ------------------------------------------------------

M3_STRIPS = (128, 64, 32)    # M3's column strips, widest first
M3_GROUPS = (2, 4, 1)        # consumer row groups a block, preferred first
M3_HALO = 4                  # halo columns a side: p <= 3, 16 bytes
M3_MAX_NB = 8                # slots a ring
M3_MAX_NSPLIT = 8            # copies (mbarriers) a unit


@dataclasses.dataclass(frozen=True)
class M3Plan:
    """M3's launch (csrc/micro_stream.cu, ``m3_kernel``): column strips
    of ``sw`` columns, ``units`` = n_tiles x n_strips (tile, strip)
    units, ``blocks`` blocks of ``threads`` = sw groups + 32 threads
    (``groups`` row groups of a consumer thread a column, each over an
    even run of the unit's tile_r output rows, and a producer warp),
    ``smem`` bytes a block: nb slots of ``nbox`` boxes of ``box_rows``
    rows (a multiple of 4, so every box starts 128-byte aligned) at a
    pitch of sw + 8, which cover the ``rows`` = tile_r + 2p rows of a
    unit, copied in nsplit chunks of boxes.  In "dma", "both" and "dma_in" the blocks draw the units from
    the plan's ticket counter (``_m3_tickets``); in "compute" and
    "dma_out" block b takes [b U // G, (b + 1) U // G), strip-major."""
    sw: int
    groups: int
    n_strips: int
    units: int
    blocks: int
    threads: int
    rows: int
    box_rows: int
    nbox: int
    nb: int
    nsplit: int
    smem: int


def m3_smem(nb: int, nsplit: int, slot_rows: int, sw: int) -> int:
    """An M3 block's shared memory as m3_kernel lays it out: nb x nsplit
    `full`, nb `empty` and nb `halo` mbarriers, a 2 x 16-float scratch
    and the slots' units (8 ints), rounded to 128 bytes, then nb slots
    of ``slot_rows`` rows of sw + 8 floats, each rounded to 128 bytes."""
    bars = _rnd(8 * nb * (nsplit + 2) + 128 + 32, 128)
    return bars + nb * _rnd(4 * slot_rows * (sw + 2 * M3_HALO), 128)


def m3_boxes(rows: int, nsplit: int):
    """(box_rows, nbox): the boxes of a unit's ``rows`` rows, nsplit
    chunks of at least one box each: boxes of ceil(rows / nsplit) rows
    rounded up to 4, or, where that leaves fewer boxes than chunks,
    rounded down; at most 256 rows (a tensor map's box).  None when
    nsplit asks for more chunks than the unit has 4-row boxes."""
    per = -(-rows // nsplit)
    box = min(256, _rnd(per, 4))
    if -(-rows // box) < nsplit:
        box = per // 4 * 4
    if box < 4:
        return None
    return box, -(-rows // box)


def _m3_plan(g: StreamGeom, nb: int, nsplit: int, sw: int, groups: int,
             sms: int):
    """The plan of strip ``sw``: as many blocks as the SMs hold at once
    (by shared memory and threads), at most one a unit; None when a
    block's ring does not fit."""
    rows = g.tile_r + 2 * g.p
    box_rows, nbox = m3_boxes(rows, nsplit)
    smem = m3_smem(nb, nsplit, box_rows * nbox, sw)
    if smem > SMEM_MAX:
        return None
    threads = sw * groups + 32
    per_sm = min(SMEM_SM // (smem + 1024), 2048 // threads)
    units = g.n_tiles * (g.w2 // sw)
    return M3Plan(sw, groups, g.w2 // sw, units, min(units, sms * per_sm),
                  threads, rows, box_rows, nbox, nb, nsplit, smem)


def m3_plan_cost(plan: M3Plan, sms: int = SMS) -> float:
    """The plan's modelled time, in units of an even, halo-free stream
    over the whole card: the strip's halo columns, (sw + 8) / sw, times
    the most units a block takes over the mean (a unit is the grain of
    the balance), times the card's share of idle SMs when there are
    fewer blocks than SMs."""
    mean = plan.units / plan.blocks
    return ((plan.sw + 2 * M3_HALO) / plan.sw * -(-plan.units // plan.blocks)
            / mean * max(1.0, sms / plan.blocks))


def m3_plans(n0: int, n1: int, tile_r: int, k: int, nb: int = 2,
             nsplit: int = 1, sms: int = SMS) -> list:
    """Every plan M3 can launch for the layout: one a strip of M3_STRIPS
    whose ring fits a block and row groups of M3_GROUPS (no more than
    tile_r)."""
    _check_ring(nb, nsplit)
    g = _geometry(n0, n1, tile_r, k)
    if m3_boxes(g.tile_r + 2 * g.p, nsplit) is None:
        raise ValueError(f"nsplit = {nsplit} copies a unit of "
                         f"{g.tile_r + 2 * g.p} rows: at most one a 4-row "
                         f"box")
    plans = [pl for sw in M3_STRIPS for groups in M3_GROUPS
             if groups <= g.tile_r
             and (pl := _m3_plan(g, nb, nsplit, sw, groups, sms)) is not None]
    if not plans:
        raise ValueError(
            f"a ring of {nb} slots of {g.tile_r + 2 * g.p} rows needs "
            f"{m3_smem(nb, nsplit, g.tile_r + 2 * g.p, M3_STRIPS[-1])} "
            f"bytes of shared memory at the narrowest strip; an H100 "
            f"block has {SMEM_MAX}: take a smaller tile_r or fewer slots")
    return plans


def m3_plan(n0: int, n1: int, tile_r: int, k: int, nb: int = 2,
            nsplit: int = 1, sms: int = SMS) -> M3Plan:
    """M3's plan for gdm's (N0, N1, tile_r, K, nb, nsplit): the plan of
    ``m3_plans`` of least ``m3_plan_cost``, on a tie the widest strip and
    the first row groups of M3_GROUPS."""
    plans = m3_plans(n0, n1, tile_r, k, nb, nsplit, sms)
    return min(plans, key=lambda pl: (m3_plan_cost(pl, sms), -pl.sw,
                                      M3_GROUPS.index(pl.groups)))


# the ticket counter of each (device, plan), and its launches that drew
# tickets: a launch of "dma", "both" or "dma_in" draws units + blocks
_M3_TICKETS = {}


def _m3_tickets(device, plan: M3Plan, mode: str):
    """(counter, base) for a launch of ``plan`` in ``mode``: the plan's
    8-byte ticket counter on ``device`` (made at its first launch) and
    the count it stands at when this launch starts."""
    key = (device, plan)
    if key not in _M3_TICKETS:
        _M3_TICKETS[key] = [torch.zeros(1, dtype=torch.int64, device=device),
                            0]
    entry = _M3_TICKETS[key]
    base = entry[1] * (plan.units + plan.blocks)
    if mode in ("dma", "both", "dma_in"):
        entry[1] += 1
    return entry[0], base


def _launch_m3_plan(u, coef, g, mode, plan: M3Plan):
    """M3 in ``mode`` on the CUDA tensor u with ``plan`` (g's strip must
    be the plan's); y, or the sink in "compute" and "dma_in".  Counts
    nothing (``stream_micro_apply`` does)."""
    if g.sw != plan.sw:
        raise ValueError(f"M3: the layout's strip of {g.sw} columns is not "
                         f"the plan's {plan.sw}")
    if u.data_ptr() % 16:
        raise ValueError("M3: u must be 16-byte aligned")
    # y, or the sink in its place: the kernel writes one of the two
    out = (torch.empty((g.n_tiles, g.n_strips), dtype=torch.float32,
                       device=u.device) if mode in SINK_MODES
           else torch.empty_like(u))
    tickets, base = _m3_tickets(u.device, plan, mode)
    _kernel.run("gdm_micro_stream_f32", f"M3 {mode}", u.device,
                u.data_ptr(), coef.data_ptr(), out.data_ptr(), out.data_ptr(),
                MODES.index(mode), g.p, g.tile_r, g.n_tiles, g.w2, plan.sw,
                plan.nb, plan.nsplit, plan.box_rows, plan.nbox, plan.groups,
                plan.blocks, plan.threads, plan.smem, tickets.data_ptr(),
                base)
    return out


def stream_micro_apply(u: torch.Tensor, coef: torch.Tensor, g: StreamGeom,
                       mode: str, nb: int = 2, nsplit: int = 1):
    """M3 in mode ``mode``: the CUDA kernel (csrc/micro_stream.cu,
    launched from ``m3_plan``) for a CUDA tensor, the plain version for a
    CPU tensor; y, or the sink in "compute" and "dma_in".  ``g`` is
    ``make_micro``'s layout, with the plan's strip."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    _check_ring(nb, nsplit)
    _kernel.check_input(u, "M3", (g.r_ext, g.w2), (torch.float32,))
    _check_coef(coef, u, g)
    if u.device.type == "cpu":
        return stream_micro_plain(u, coef, g, mode)
    plan = m3_plan(g.n0, g.n1, g.tile_r, g.k, nb, nsplit,
                   torch.cuda.get_device_properties(
                       u.device).multi_processor_count)
    out = _launch_m3_plan(u, coef, g, mode, plan)
    stream_micro_apply.blocks = plan.blocks
    stream_micro_apply.launches += 1
    return out


stream_micro_apply.launches = 0
stream_micro_apply.blocks = None


def _check_ring(nb, nsplit):
    for name, v in (("nb", nb), ("nsplit", nsplit)):
        if int(v) != v or v < 1:
            raise ValueError(f"{name} must be a positive integer, not {v}")
    if not 2 <= nb <= M3_MAX_NB or nsplit > M3_MAX_NSPLIT:
        raise ValueError(f"the ring takes 2 to {M3_MAX_NB} slots of at most "
                         f"{M3_MAX_NSPLIT} copies a unit; not nb = {nb}, "
                         f"nsplit = {nsplit}")


def make_micro(mode: str, N0: int = 4096, N1: int = 4096, tile_r: int = 96,
               K: int = 7, nb: int = 2, nsplit: int = 1, device="cuda"):
    """(apply_fn, (R_ext, W2), n_dof) of M3, as gdm's make_micro; the
    card unless ``device="cpu"`` is asked for.  ``apply_fn.geom`` is the
    layout (with the plan's column strip), ``apply_fn.plan`` the launch
    plan (``m3_plan`` at an H100's 132 SMs) and ``apply_fn.coef`` gdm's
    coefficients."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    device = _device.resolve(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else SMS)
    plan = m3_plan(N0, N1, tile_r, K, nb, nsplit, sms)
    g = _geometry(N0, N1, tile_r, K, sw=plan.sw)
    coef = stream_coef(g, device)

    def apply_fn(u_pad):
        return stream_micro_apply(u_pad, coef, g, mode, nb, nsplit)

    apply_fn.geom, apply_fn.coef, apply_fn.plan = g, coef, plan
    return apply_fn, (g.r_ext, g.w2), g.n_dof


# ---- M4: whole-row units through a ring of bulk copies -----------------

# gdm's factor 1.0000001 as a float32 value: a float32 tensor times it
# rounds the exact product once, on any device, as the kernel does
AUTO_SCALE = float(np.float32(1.0000001))

# M4's ring by mode: (bytes of u a stage aims to hold, stages, threads a
# block), the fastest of scripts/torch_sweep_auto_micro.py on an H100:
# "dma" streams, "both" needs two rows a unit to reuse each column's
# coefficients and all its threads to hide the loads of them
AUTO_RING = {"dma": (16 * 1024, 4, 256), "both": (32 * 1024, 3, 1024)}


@dataclasses.dataclass(frozen=True)
class AutoRing:
    """M4's ring on the card (csrc/micro_stream.cu, ``auto_kernel``):
    units of ``unit_rows`` whole rows of the (Rp, W2) array, contiguous
    bytes (the last unit shorter where unit_rows does not divide Rp),
    through ``stages`` stages, each one unit of u and, in "both", one of
    y; ``smem`` bytes of shared memory a block (128 for the mbarriers),
    ``threads`` threads a block."""
    unit_rows: int
    n_units: int
    stages: int
    buffers: int
    smem: int
    threads: int


def auto_ring(g: StreamGeom, mode: str) -> AutoRing:
    """M4's ring for layout ``g`` in ``mode``: as many whole rows a unit
    as come nearest the mode's stage bytes, at least one.  A row too
    wide for the ring raises ValueError."""
    target, stages, threads = AUTO_RING[mode]
    row_bytes = 4 * g.w2
    unit_rows = max(1, min(g.rp, round(target / row_bytes)))
    buffers = 2 if mode == "both" else 1
    smem = 128 + stages * buffers * unit_rows * row_bytes
    if smem > SMEM_MAX:
        raise ValueError(
            f"M4's ring of {stages} stages of one {g.w2}-column row "
            f"needs {smem} bytes of shared memory; an H100 block has "
            f"{SMEM_MAX}")
    return AutoRing(unit_rows, -(-g.rp // unit_rows), stages, buffers, smem,
                    threads)


def auto_micro_plain(u: torch.Tensor, coef: torch.Tensor, g: StreamGeom,
                     mode: str) -> torch.Tensor:
    """The plain torch version of M4 on the (Rp, W2) array: "dma"
    y = u 1.0000001 (a float32 product), "both" y = sum_k coef[k][0] V."""
    if mode == "dma":
        return u * AUTO_SCALE
    v = _col_stage(u, coef, g.p)
    acc = torch.zeros_like(u)
    for k in range(g.k):
        acc = acc + coef[k, 0] * v
    return acc


def auto_micro_apply(u: torch.Tensor, coef: torch.Tensor, g: StreamGeom,
                     mode: str) -> torch.Tensor:
    """M4 in mode ``mode``: the CUDA kernel (csrc/micro_stream.cu) for a
    CUDA tensor, the plain version for a CPU tensor."""
    if mode not in AUTO_MODES:
        raise ValueError(f"mode must be one of {AUTO_MODES}, not {mode!r}")
    _kernel.check_input(u, "M4", (g.rp, g.w2), (torch.float32,))
    _check_coef(coef, u, g)
    if u.device.type == "cpu":
        return auto_micro_plain(u, coef, g, mode)
    if u.data_ptr() % 16:
        raise ValueError("M4: u must be 16-byte aligned")
    ring = auto_ring(g, mode)
    y = torch.empty_like(u)
    blocks = ctypes.c_int()
    _kernel.run("gdm_micro_auto_f32", f"M4 {mode}", u.device, u.data_ptr(),
                coef.data_ptr(), y.data_ptr(), AUTO_MODES.index(mode) + 1,
                g.p, g.rp, g.w2, ring.unit_rows, ring.stages, ring.threads,
                ctypes.byref(blocks))
    auto_micro_apply.blocks = blocks.value
    auto_micro_apply.launches += 1
    return y


auto_micro_apply.launches = 0
auto_micro_apply.blocks = None


def make_auto_micro(mode: str, N0: int = 4096, N1: int = 4096,
                    tile_r: int = 96, K: int = 7, device="cuda"):
    """(apply, (Rp, W2), n_dof) of M4, as gdm's make_auto_micro: disjoint
    tile_r-row blocks, no halo rows (gdm's automatic pipeline), streamed
    on the card in units of whole rows (``auto_ring``, ``apply.ring``)."""
    if mode not in AUTO_MODES:
        raise ValueError(f"mode must be one of {AUTO_MODES}, not {mode!r}")
    device = _device.resolve(device)
    g = _geometry(N0, N1, tile_r, K)
    ring = auto_ring(g, mode)
    coef = stream_coef(g, device)

    def apply(u_pad):
        return auto_micro_apply(u_pad, coef, g, mode)

    apply.geom, apply.coef, apply.ring = g, coef, ring
    return apply, (g.rp, g.w2), g.n_dof


# ---- M5: M3's two-slot ring, one buffer per slot ------------------------

def sepbuf_micro_plain(u: torch.Tensor, g: StreamGeom,
                       mode: str) -> torch.Tensor:
    """The plain torch version of M5: "dma" y[H + t tile_r + r] =
    u[t tile_r][0] (gdm's buf[0, :1]), zero in the guard rows; "dma_in"
    the sink u[t tile_r][strip's first column]."""
    firsts = u[0:g.rp:g.tile_r]
    if mode == "dma_in":
        return firsts[:, 0:g.w2:g.sw].contiguous()
    y = torch.zeros((g.r_ext, g.w2), dtype=u.dtype, device=u.device)
    y[H:H + g.rp] = firsts[:, :1].repeat_interleave(g.tile_r, dim=0)
    return y


def sepbuf_micro_apply(u: torch.Tensor, coef: torch.Tensor, g: StreamGeom,
                       mode: str):
    """M5 in mode ``mode``: the CUDA kernel (csrc/micro_stream.cu) for a
    CUDA tensor, the plain version for a CPU tensor."""
    if mode not in SEPBUF_MODES:
        raise ValueError(f"mode must be one of {SEPBUF_MODES}, not {mode!r}")
    _kernel.check_input(u, "M5", (g.r_ext, g.w2), (torch.float32,))
    _check_coef(coef, u, g)
    if u.device.type == "cpu":
        return sepbuf_micro_plain(u, g, mode)
    if u.data_ptr() % 16:
        raise ValueError("M5: u must be 16-byte aligned")
    # y, or the sink in its place: the kernel writes one of the two
    out = (torch.empty((g.n_tiles, g.n_strips), dtype=torch.float32,
                       device=u.device) if mode in SINK_MODES
           else torch.empty_like(u))
    blocks = ctypes.c_int()
    _kernel.run("gdm_micro_sepbuf_f32", f"M5 {mode}", u.device, u.data_ptr(),
                out.data_ptr(), out.data_ptr(), MODES.index(mode), g.p, H,
                g.tile_r, g.n_tiles, g.w2, g.sw, ctypes.byref(blocks))
    sepbuf_micro_apply.launches += 1
    return out


sepbuf_micro_apply.launches = 0


def make_sepbuf_micro(mode: str, N0: int = 4096, N1: int = 4096,
                      tile_r: int = 96, K: int = 7, device="cuda"):
    """(apply, (R_ext, W2), n_dof) of M5, as gdm's make_sepbuf_micro."""
    if mode not in SEPBUF_MODES:
        raise ValueError(f"mode must be one of {SEPBUF_MODES}, not {mode!r}")
    device = _device.resolve(device)
    g = _geometry(N0, N1, tile_r, K, 2)
    coef = stream_coef(g, device)

    def apply(u_pad):
        return sepbuf_micro_apply(u_pad, coef, g, mode)

    apply.geom, apply.coef = g, coef
    return apply, (g.r_ext, g.w2), g.n_dof


def overlap_fraction(t_compute: float, t_dma: float, t_both: float) -> float:
    """gdm's overlap fraction: 1 when the copies hide under the compute
    completely, 0 when the two are serialized."""
    lo, hi = max(t_compute, t_dma), t_compute + t_dma
    return (hi - t_both) / max(hi - lo, 1e-12)


def build(mode: str, n0: int, n1: int, tile_r: int, nb: int, nsplit: int,
          device="cuda"):
    """gdm's main() dispatch: ``auto_``, ``sep_`` or an M3 mode."""
    if mode.startswith("auto_"):
        return make_auto_micro(mode[5:], n0, n1, tile_r, device=device)
    if mode.startswith("sep_"):
        return make_sepbuf_micro(mode[4:], n0, n1, tile_r, device=device)
    return make_micro(mode, n0, n1, tile_r, nb=nb, nsplit=nsplit,
                      device=device)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = _device.resolve("cuda")
    args = [a for a in argv if not a.startswith("--")]
    if args:
        n0, n1, tile_r, nb, nsplit = (int(a) for a in args[:5])
        cases = [(n0, n1, tile_r, nb, nsplit,
                  args[5:] or ["compute", "dma", "both"])]
    else:
        cases = [(1024, 1024, 96, 2, 1, ["compute", "dma", "both"]),
                 (4096, 4096, 96, 2, 1, ["compute", "dma", "both"])]
    print("platform: gpu,", torch.cuda.get_device_name(device))
    for n0, n1, tile_r, nb, nsplit, modes in cases:
        us_per_mdof = {}
        for mode in modes:
            apply_fn, shape, n_dof = build(mode, n0, n1, tile_r, nb, nsplit,
                                           device)
            u = torch.ones(shape, dtype=torch.float32, device=device)
            dt = device_ms(lambda: apply_fn(u)) * 1e-3
            us_per_mdof[mode] = dt / n_dof * 1e12
            print(f"N0={n0} N1={n1} tile_r={tile_r} nb={nb} "
                  f"nsplit={nsplit} mode={mode}: {dt * 1e6:.1f} us/apply, "
                  f"{us_per_mdof[mode]:.2f} us/MDoF", flush=True)
        if {"compute", "dma", "both"} <= set(us_per_mdof):
            overlap = overlap_fraction(us_per_mdof["compute"],
                                       us_per_mdof["dma"],
                                       us_per_mdof["both"])
            print(f"N0={n0}: overlap fraction = {overlap:.2f} "
                  f"(1 = perfect, 0 = fully serialized)", flush=True)


if __name__ == "__main__":
    main()
