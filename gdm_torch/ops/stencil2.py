"""K3 and its schedules: the 2D separable band apply
y = A0 U A1^T + B0 U B1^T.

Port of gdm/ops/pallas_stencil2.py: ``make_padded_laplace2`` (K3, the
TPU kernel that gdm/ops/fast.py::best_field_laplace routes the uncut
Poisson CG operator and every multigrid level through, with gdm's four
row stages behind its ``rows=`` keyword: ``"vpu"``, K3's FMA row stage;
``"mxu"``, K3/mxu, the row stage as a window product on the tensor cores
at float32 fidelity; ``"mxu3"``, K3/mxu3, the same product as bf16x3;
``"mxu3p"``, K3/mxu3p, that product with one unit's products under the
next unit's column stage) and five other
schedules of the same operator that no solve dispatch routes to, in gdm
or here: ``make_padded_laplace2_stream`` (K3s, streamed down the rows),
``make_padded_laplace2_mxucol`` (K3c, the column stage on the tensor
cores), ``make_padded_laplace2_fullmxu`` (K3f, both stages on the
tensor cores), ``make_padded_laplace2_hybrid`` (K3h, the column stage
split by rows between the FMA units and the tensor cores) and
``make_padded_laplace2_hybp`` (K3p, K3h pipelined across tiles).  The
CUDA kernels are gdm_torch/csrc/laplace2*.cu (the tensor-core ones share
the stages of csrc/tc_stage.cuh and csrc/tc_strip.cuh); their source
notes say what bounds them on the card.  Each wrapper (``laplace2_apply``, ``laplace2_stream_apply``,
``laplace2_mxucol_apply``, ...) launches its kernel for a CUDA tensor
and runs its plain torch twin for a CPU tensor; there is no other
switch.  Every twin is K3's plain column-then-row computation.
``k3_plan`` picks K3's launch from the shape (its tiles and the output
rows a thread keeps in registers), ``k3s_plan`` K3s's (its strip width
and its strips and segments); tests/test_torch_plans.py holds both on
the CPU.  ``tc_plan`` picks every tensor-core schedule's (row units, or
whole tiles of a strip, times column blocks over persistent blocks), whose
tables ``ops.tc_tables`` builds once per band tables and row units;
tests/test_torch_tc_tables.py holds both.

K3 and K3s compute what gdm's f32-exact ``rows="vpu"`` kernel computes;
the tensor-core schedules run their products as 3xTF32 in float32 and on
the DMMA units in float64, except the bf16x3 row products of K3/mxu3 and
K3/mxu3p in float32 (about 16 bits of each operand: within 1e-5 of
max|y| on the card; in float64 they are DMMA products too).  The node
array is the contiguous (N0, N1) field itself:
gdm's guard rows and 128-lane padding existed for aligned TPU DMAs, so
here ``pad`` and ``unpad`` are reshapes and cost no copy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import device as _device
from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from . import _build, tc_tables
from ._padded import launch, padded_apply, positive_int
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
    # the tables of the tensor-core schedules (tc_tables.KERNELS), built at
    # first use (tc_tables.tables);
    # not an argument, so every new Bands2 (replace() too) starts empty
    tables: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False)

    @property
    def shape(self) -> tuple:
        return (self.a0.shape[0], self.a1.shape[0])


def laplace2_bands(grid: Grid, device="cuda", dtype=torch.float32,
                   bands=None) -> Bands2:
    """The band tables for ``grid`` on ``device`` (the card unless
    ``device="cpu"`` is asked for): ``bands=(A0, A1, B0, B1)`` numpy
    arrays, or by default the GD Laplace (S0, M1, M0, S1)."""
    device = _device.resolve(device)
    if grid.dim != 2:
        raise ValueError(f"K3 and its schedules are the 2D apply; the "
                         f"grid is {grid.dim}D")
    p = grid.degree
    if p > MAX_DEGREE:
        raise ValueError(f"K3 and its schedules take odd degrees "
                         f"p <= {MAX_DEGREE}, not {p}")
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


def _launch(u: torch.Tensor, bt: Bands2, fn: str, what: str, extra=()):
    return launch(u, fn, what, (bt.a0, bt.a1, bt.b0, bt.b1), bt.p, bt.shape,
                  extra)


# ---- K3's launch plan (csrc/laplace2.cu) ----

SM_COUNT = 132           # SMs of an H100 SXM
K3_COLS = 32             # the most columns of a tile: one warp's lanes
K3_WARPS = 4             # warps of a block, each a row segment of the tile
K3_ROWS = (8, 4, 2)      # output rows a thread (rs), most first
K3_MAX_RS_P = 7          # above this p only rs = 2 (registers)
K3_THREADS = 32768       # the most rows a thread while the grid keeps this
                         # many threads busy
K3_BLOCKS_PER_SM = 9     # float32, p <= 3: __launch_bounds__(128, 9)


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """How K3 cuts the (n0, n1) nodes into tiles, one block of K3_WARPS
    warps each: ``tiles`` = (along rows, along columns), each axis split
    evenly (a tile holds the floor or the ceiling of n / tiles), so the
    largest tile is ``rows`` x ``cols``; a thread owns one column of
    ``rs`` consecutive output rows; ``smem`` bytes of shared memory per
    block."""
    rows: int
    cols: int
    tiles: tuple
    rs: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles[0] * self.tiles[1]


def k3_smem(p: int, itemsize: int, rs: int) -> int:
    """Bytes of shared memory of one K3 block, as laplace2.cu's Geom lays
    it out: the u tile (4 rs + 2p rows, pitch 32 + 2p), the tile rows'
    A0 and B0 bands (pitch 2p + 1 rounded up to 4, for 16-byte loads)
    and above p = 7 the lane columns' A1 and B1."""
    k, ty = 2 * p + 1, K3_WARPS * rs
    coef = 0 if p <= K3_MAX_RS_P else 2 * k * K3_COLS
    return itemsize * ((ty + 2 * p) * (K3_COLS + 2 * p) +
                       2 * ty * _rnd(k, 4) + coef)


def _even(n: int, most: int):
    """(parts, largest part) of an even split of n into parts of at most
    ``most``."""
    parts = -(-n // most)
    return parts, -(-n // parts)


def _k3_plan(nodes, p, itemsize, rs) -> K3Plan:
    n0, n1 = nodes
    ntr, r = _even(n0, K3_WARPS * rs)
    ntc, c = _even(n1, K3_COLS)
    return K3Plan(r, c, (ntr, ntc), rs, k3_smem(p, itemsize, rs))


def k3_plans(nodes, p: int, dtype) -> list:
    """Every plan K3 can launch for ``nodes``: each rs of K3_ROWS (only
    2 above p = 7)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return [_k3_plan(tuple(nodes), p, itemsize, rs) for rs in K3_ROWS
            if rs == 2 or p <= K3_MAX_RS_P]


def k3_plan(nodes, p: int, dtype) -> K3Plan:
    """K3's launch plan for the (n0, n1) nodes: the most output rows a
    thread (rs of K3_ROWS) that still puts K3_THREADS threads to work,
    the fewest where none does (more, shorter tiles: at 257^2 and below
    tiles of 8 rows), and rs = 2 above p = 7."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nodes = tuple(nodes)
    for rs in K3_ROWS:
        plan = _k3_plan(nodes, p, itemsize, rs)
        threads = -(-nodes[0] // rs) * plan.tiles[1] * K3_COLS
        if p > K3_MAX_RS_P or threads >= K3_THREADS:
            break
    if p > K3_MAX_RS_P:
        plan = _k3_plan(nodes, p, itemsize, 2)
    return plan


def _launch_plan(u: torch.Tensor, bt: Bands2, plan) -> torch.Tensor:
    """K3 (a K3Plan) or K3s (a K3sPlan) on the CUDA tensor ``u`` with the
    launch plan ``plan``; counts nothing (the wrappers do)."""
    if isinstance(plan, K3sPlan):
        return _launch(u, bt, "laplace2_stream_apply", "K3s", plan.args)
    return _launch(u, bt, "laplace2_apply", "K3", (*plan.tiles, plan.rs))


def k3_occupancy(rs: int, dtype) -> int:
    """Blocks of K3 one SM of the card holds at p = 3 (the solves'
    degree) with rs output rows a thread, as the CUDA runtime's
    occupancy calculator reports them for the built kernel (its
    registers and shared memory)."""
    kl = _build.kernels()
    out = ctypes.c_int(0)
    err = kl.lib.gdm_laplace2_occupancy(
        rs, int(dtype == torch.float64), ctypes.byref(out))
    _build.check(kl, err, "K3 occupancy")
    return out.value


def laplace2_apply(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """y = A0 U A1^T + B0 U B1^T: the CUDA kernel K3, launched as
    ``k3_plan`` says, for a CUDA tensor, the plain version for a CPU
    tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace2_apply_plain(u, bt)
    y = _launch_plan(u, bt, k3_plan(bt.shape, bt.p, u.dtype))
    laplace2_apply.launches += 1
    return y


laplace2_apply.launches = 0


def laplace2_stream_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3s: K3's operator, so K3's twin."""
    return laplace2_apply_plain(u, bt)


# ---- K3s's launch plan (csrc/laplace2_stream.cu) ----

K3S_COLS = (256, 128, 64)  # strip widths: consumer threads of a block
K3S_BAR_BYTES = 128        # the ring's mbarriers, before the slots
K3S_PER_SM = (2, 4, 6, 8)  # blocks a plan aims to put on each SM
K3S_WAVE = 4               # ... and the one k3s_plan picks: one wave at
                           # __launch_bounds__(160, 4) (float32, p <= 3)
K3S_MIN_SEG = 8            # the fewest output rows of a segment (its 2p
                           # halo rows are streamed twice)


def k3s_slots(p: int) -> int:
    """Slots of K3s's copy ring, each of 2p + 1 u rows."""
    return 4 if p <= 7 else 2


@dataclasses.dataclass(frozen=True)
class K3sPlan:
    """How K3s cuts the (n0, n1) nodes: strips of at most ``cols``
    columns (a consumer thread each, a producer warp beside them) and
    segments of rows, one block a (segment, strip), ``tiles`` = (along
    rows, along columns), each axis split evenly, so the largest block
    is ``rows`` x ``width`` nodes; ``smem`` bytes of shared memory per
    block."""
    cols: int
    width: int
    rows: int
    tiles: tuple
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles[0] * self.tiles[1]

    @property
    def args(self) -> tuple:
        """The plan's integer launch arguments, in the kernel's order."""
        return (self.cols, *self.tiles)


def k3s_smem(p: int, itemsize: int, cols: int, rows: int) -> int:
    """Bytes of shared memory of one K3s block with strips of ``cols``
    and segments of ``rows`` rows, as laplace2_stream.cu's Geom lays it
    out: the mbarriers; ``k3s_slots(p)`` slots of 2p + 1 u rows and one
    zero row, each cols + 2p elements rounded out to 16 bytes at both
    ends; the segment's A0 and B0 band rows as copied (rounded out the
    same way) and again at a pitch of 2p + 1 rounded up to 16 bytes."""
    vec, k = 16 // itemsize, 2 * p + 1
    up = _rnd(cols + 2 * p + 2 * vec - 2, vec)
    raw = _rnd(rows * k + 2 * vec - 2, vec)
    return K3S_BAR_BYTES + itemsize * ((k3s_slots(p) * k + 1) * up +
                                       2 * raw + 2 * rows * _rnd(k, vec))


def _k3s_plan(nodes, p, itemsize, cols, per_sm) -> K3sPlan:
    """The even split for strips of ``cols`` and ``per_sm`` blocks an
    SM: segments of K3S_MIN_SEG rows at the least, more segments where
    a segment's band rows would not fit a block."""
    n0, n1 = nodes
    ntc, width = _even(n1, cols)
    ntr = max(1, min(SM_COUNT * per_sm // ntc, n0 // K3S_MIN_SEG))
    while k3s_smem(p, itemsize, cols, -(-n0 // ntr)) > SMEM_MAX:
        ntr += 1
    rows = -(-n0 // ntr)
    return K3sPlan(cols, width, rows, (ntr, ntc),
                   k3s_smem(p, itemsize, cols, rows))


def k3s_plans(nodes, p: int, dtype) -> list:
    """Every plan K3s can launch for ``nodes``: each strip width of
    K3S_COLS with the segments of each wave of K3S_PER_SM (duplicates
    dropped)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plans = []
    for cols in K3S_COLS:
        for per_sm in K3S_PER_SM:
            plan = _k3s_plan(tuple(nodes), p, itemsize, cols, per_sm)
            if plan not in plans:
                plans.append(plan)
    return plans


@functools.lru_cache(maxsize=None)
def _k3s_plan_cached(nodes: tuple, p: int, dtype) -> K3sPlan:
    itemsize = torch.empty((), dtype=dtype).element_size()
    n1 = nodes[1]
    cols = 256 if n1 >= 2048 else 128 if n1 >= 512 else 64
    return _k3s_plan(nodes, p, itemsize, cols, K3S_WAVE)


def k3s_plan(nodes, p: int, dtype) -> K3sPlan:
    """K3s's launch plan for the (n0, n1) nodes: strips of 256 columns
    from 2048 columns up, 128 from 512, else 64, and as many segments as
    put K3S_WAVE blocks on each SM (never below K3S_MIN_SEG rows).
    Cached: the wrapper asks on every launch."""
    return _k3s_plan_cached(tuple(nodes), p, dtype)


def laplace2_stream_apply(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """K3's operator through the streaming kernel K3s (a producer warp
    feeding an mbarrier ring of u rows, consumer threads with V and W
    in registers), launched as ``k3s_plan`` says, for a CUDA tensor,
    the plain version for a CPU tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace2_stream_apply_plain(u, bt)
    y = _launch_plan(u, bt, k3s_plan(bt.shape, bt.p, u.dtype))
    laplace2_stream_apply.launches += 1
    return y


laplace2_stream_apply.launches = 0


def make_padded_laplace2_stream(grid: Grid, dtype=torch.float32,
                                tile_r=None, interpret=False, bands=None,
                                *, device="cuda"):
    """(apply, pad, unpad, shape) of K3s, the streamed K3: the same
    operator, band tables and node array as ``make_padded_laplace2``.

    ``tile_r``, gdm's row tile (sized to the TPU's VMEM), is taken and has
    no effect: K3s's strips and segments come from ``k3s_plan``, and the
    tile does not change the function.  A value that is not a positive
    integer raises ValueError.  ``interpret`` (gdm's TPU interpreter) is
    taken and has no effect."""
    dtype = _device.resolve_dtype(dtype)
    positive_int("tile_r", tile_r)
    bt = laplace2_bands(grid, device, dtype, bands)
    return padded_apply(bt, laplace2_stream_apply,
                        laplace2_stream_apply_plain)


# ---- K3c, K3f, K3h, K3p: the tensor-core schedules of K3's operator ----

SMEM_MAX = 232448               # bytes of shared memory an H100 block may use
TILE_CANDIDATES = (64, 48, 32, 16)
# K3c's default tile has tile_r + 2p = 64 extended rows: one wgmma M, so
# one product chain a tile and no padded chain
MXUCOL_ROWS = 64


def _rnd(n: int, m: int) -> int:
    return -(-n // m) * m


def tc_smem_bytes(kernel: str, p: int, tile_r: int, itemsize: int) -> int:
    """Shared memory of one block of the tensor-core kernel ``kernel``
    ("mxucol", "fullmxu", "hybrid", "hybp", "mxu", "mxu3", "mxu3p" or
    "v1") at degree p with tile_r output rows, as the kernels lay it out
    (tc_tables.smem_bytes): K3f ("fullmxu"), K0 ("v1"), K3/mxu ("mxu"),
    K3/mxu3 ("mxu3") and K3/mxu3p ("mxu3p") walk row units of 32 rows
    whatever the tile (the split window and operands, landing slots of u
    rows in float32); the units of K3p ("hybp"), K3c ("mxucol") and K3h
    ("hybrid") are whole tiles: their [V | W] slots and slots of u rows
    and band rows grow with the tile (tc_tables.strip_layout)."""
    if kernel not in tc_tables.KERNELS:
        raise ValueError(f"no tensor-core kernel {kernel!r}")
    return tc_tables.smem_bytes(kernel, p, itemsize, tile_r)


def tc_options(kernel: str, bt: Bands2, tile_r=None, vpu_rows=None) -> dict:
    """The card's tile of a tensor-core kernel: {"tile_r": ..} and, for
    "hybrid" and "hybp", {"vpu_rows": ..}.

    tile_r, the block's output rows: by default the largest of 64, 48,
    32, 16 whose tile fits one H100 block at this degree and dtype (see
    ``tc_smem_bytes``; 64 for K3h at every p <= 15 in both dtypes and for
    K3f, K0, K3/mxu, K3/mxu3 and K3/mxu3p always, whose shared memory does
    not grow with the tile; for K3p 64 in float32 at every p <= 15 and
    smaller in float64 from p = 9), and for K3c 64 - 2p, so that a tile's
    extended rows fill one product chain (wgmma's M of 64 rows).  As in
    gdm, every kernel but K3f clamps it to N0 rounded up to 8.  A tile
    that does not fit raises.

    vpu_rows, the rows of the extended tile (tile_r + 2p rows) whose
    column stage runs on the FMA units, the rest on the tensor cores:
    by default two thirds of the extended tile rounded up to 8 (gdm's
    K3p default; per row the FMA units cost about 2.3x less than the
    3xTF32 window product at the card's peak rates), clamped to the
    extended tile as gdm clamps it; 0 means all tensor cores and any
    value >= tile_r + 2p all FMAs.  The unit of K3p and K3h is one tile
    of a 32-column strip, so its extended rows [0, vpu_rows) run on the
    FMA units and the rest on the tensor cores as the value says; the
    ragged last tile (rows + 2p extended rows) keeps the same first
    vpu_rows rows on the FMA units (``tc_tables.hybp_rows``).
    """
    p, n0 = bt.p, bt.shape[0]
    itemsize = bt.a0.element_size()
    if tile_r is None and kernel == "mxucol":
        tile_r = MXUCOL_ROWS - 2 * p
    if tile_r is None:
        tile_r = next((t for t in TILE_CANDIDATES
                       if tc_smem_bytes(kernel, p, t, itemsize) <= SMEM_MAX),
                      None)
        if tile_r is None:
            raise ValueError(f"no tile of K3 {kernel} fits an H100 block at "
                             f"p = {p}, {itemsize}-byte values")
    if int(tile_r) != tile_r or tile_r < 1:
        raise ValueError(f"tile_r must be a positive integer, not {tile_r}")
    tile_r = int(tile_r)
    if kernel != "fullmxu":
        tile_r = min(tile_r, _rnd(n0, 8))
    need = tc_smem_bytes(kernel, p, tile_r, itemsize)
    if need > SMEM_MAX:
        raise ValueError(
            f"a K3 {kernel} tile of {tile_r} rows at p = {p} with "
            f"{itemsize}-byte values needs {need} bytes of shared memory; "
            f"an H100 block has {SMEM_MAX}: take a smaller tile_r")
    if kernel not in ("hybrid", "hybp"):
        return {"tile_r": tile_r}
    t_ext = tile_r + 2 * p
    if vpu_rows is None:
        vpu_rows = tc_tables.default_vpu_rows(tile_r, p)
    if int(vpu_rows) != vpu_rows or vpu_rows < 0:
        raise ValueError(f"vpu_rows must be an integer >= 0, not {vpu_rows}")
    return {"tile_r": tile_r, "vpu_rows": min(int(vpu_rows), t_ext)}


@functools.lru_cache(maxsize=None)
def tc_occupancy(kernel: str, p: int, dtype, tile_r=None) -> int:
    """Blocks of K3f ("fullmxu"), K0 ("v1"), K3/mxu ("mxu"), K3/mxu3
    ("mxu3"), K3/mxu3p ("mxu3p"), K3p ("hybp"), K3c ("mxucol") or K3h
    ("hybrid"; the strip kernels with tiles of tile_r rows) one SM of the
    card holds at degree p, as the CUDA runtime's occupancy calculator
    reports them for the built kernel."""
    kl = _build.kernels()
    out = ctypes.c_int(0)
    fn = getattr(kl.lib, f"gdm_laplace2_{kernel}_occupancy")
    f64 = int(dtype == torch.float64)
    if kernel in tc_tables.COLS:
        err = fn(p, f64, tc_tables.cols_of(kernel), ctypes.byref(out))
    elif kernel in tc_tables.TILE_KERNELS:
        err = fn(p, f64, int(tile_r), ctypes.byref(out))
    else:
        err = fn(p, f64, ctypes.byref(out))
    _build.check(kl, err, f"{kernel} occupancy")
    return out.value


@functools.lru_cache(maxsize=None)
def tc_plan(kernel: str, nodes, p: int, dtype,
            tile_r: int) -> tc_tables.TcPlan:
    """The launch plan of K3f ("fullmxu"), K0 ("v1"), K3/mxu ("mxu"),
    K3/mxu3 ("mxu3"), K3/mxu3p ("mxu3p"), K3p ("hybp"), K3c ("mxucol") or
    K3h ("hybrid") for the (n0, n1) nodes with tiles of tile_r rows: row
    units of at most 32 rows (the strip kernels: whole tiles) times
    blocks of the kernel's columns (tc_tables.COLS),
    walked by one wave of persistent blocks, as many an SM as the
    runtime's occupancy of the built kernel (which needs the card).
    Cached: the wrappers ask on every launch."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    occ = tc_occupancy(kernel, p, dtype, int(tile_r)
                       if kernel in tc_tables.TILE_KERNELS else None)
    return tc_tables.plan(kernel, tuple(nodes), p, itemsize, int(tile_r),
                          occ, SM_COUNT)


# the strip kernels' names in errors
STRIP_NAMES = {"hybp": "K3p", "mxucol": "K3c", "hybrid": "K3h"}


def _launch_tc_plan(u: torch.Tensor, bt: Bands2, plan: tc_tables.TcPlan,
                    vpu_rows=None) -> torch.Tensor:
    """K3f, K0, K3/mxu, K3/mxu3, K3/mxu3p, K3c or K3p and K3h (with
    ``vpu_rows``) on the CUDA tensor ``u`` with the plan ``plan``, from
    the tables of ``bt`` (built at first use); counts nothing."""
    tab = tc_tables.tables(bt, plan.kernel, plan.tile_r)
    if plan.kernel in tc_tables.TILE_KERNELS:
        tabs, split = (tab["ct"], tab["rb"]), ()
        if plan.kernel != "mxucol":   # K3p and K3h split rows at vpu_rows
            tabs, split = (bt.a1, bt.b1) + tabs, (vpu_rows,)
        return launch(u, f"laplace2_{plan.kernel}_apply",
                      STRIP_NAMES[plan.kernel], tabs, bt.p, bt.shape,
                      (plan.tile_r, *split, len(plan.row_units), plan.segs,
                       plan.blocks))
    if plan.kernel == "fullmxu":
        tabs = (tab["win"], tab["ct"], tab["ru"])
    else:
        tabs = (bt.a1, bt.b1, tab["win"], tab["ru"])
    extra = (tc_tables.TRB, len(plan.row_units), plan.blocks)
    if plan.kernel in tc_tables.COLS:
        extra = (tc_tables.TRB, plan.cols) + extra[1:]
    return launch(u, f"laplace2_{plan.kernel}_apply", plan.kernel, tabs,
                  bt.p, bt.shape, extra)


def tc_apply(u, bt, kernel, wrapper, plain, tile_r, vpu_rows=None):
    """The wrapper of tensor-core kernel ``kernel``: its plain twin for a
    CPU tensor, else the kernel, launched as ``tc_plan`` says and counted
    on ``wrapper.launches``."""
    _check(u, bt)
    opts = tc_options(kernel, bt, tile_r, vpu_rows)
    if u.device.type == "cpu":
        return plain(u, bt)
    y = _launch_tc_plan(u, bt, tc_plan(kernel, bt.shape, bt.p, u.dtype,
                                       opts["tile_r"]), opts.get("vpu_rows"))
    wrapper.launches += 1
    return y


def laplace2_mxucol_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3c: K3's operator, so K3's twin."""
    return laplace2_apply_plain(u, bt)


def laplace2_mxucol_apply(u: torch.Tensor, bt: Bands2,
                          tile_r=None) -> torch.Tensor:
    """K3's operator through K3c (the column stage pipelined across the
    tiles of a column strip: persistent blocks of a tensor warpgroup, the
    copies and the whole tile's column stage as 3xTF32 window products
    with u in registers against the cached C^T, and an FMA warpgroup, the
    row stage of the tile before, joined by mbarriers; DMMA in float64)
    for a CUDA tensor, the plain version for a CPU tensor."""
    return tc_apply(u, bt, "mxucol", laplace2_mxucol_apply,
                    laplace2_mxucol_apply_plain, tile_r)


laplace2_mxucol_apply.launches = 0


def laplace2_fullmxu_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3f: K3's operator, so K3's twin."""
    return laplace2_apply_plain(u, bt)


def laplace2_fullmxu_apply(u: torch.Tensor, bt: Bands2,
                           tile_r=None) -> torch.Tensor:
    """K3's operator through K3f (both stages as window products on the
    tensor cores) for a CUDA tensor, the plain version for a CPU
    tensor."""
    return tc_apply(u, bt, "fullmxu", laplace2_fullmxu_apply,
                    laplace2_fullmxu_apply_plain, tile_r)


laplace2_fullmxu_apply.launches = 0


def laplace2_hybrid_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3h: K3's operator, so K3's twin."""
    return laplace2_apply_plain(u, bt)


def laplace2_hybrid_apply(u: torch.Tensor, bt: Bands2, tile_r=None,
                          vpu_rows=None) -> torch.Tensor:
    """K3's operator through K3h (the column stage split by rows: persistent
    blocks over the tiles of a column strip, an FMA warpgroup on rows
    [0, vpu_rows) and a tensor warpgroup on the rest, as 3xTF32 window
    products with u in registers against the cached C^T, both on one tile
    at a time, then the row stage on all eight warps; DMMA in float64)
    for a CUDA tensor, the plain version for a CPU tensor."""
    return tc_apply(u, bt, "hybrid", laplace2_hybrid_apply,
                    laplace2_hybrid_apply_plain, tile_r, vpu_rows)


laplace2_hybrid_apply.launches = 0


def laplace2_hybp_apply_plain(u: torch.Tensor, bt: Bands2) -> torch.Tensor:
    """The plain torch version of K3p: K3's operator, so K3's twin."""
    return laplace2_apply_plain(u, bt)


def laplace2_hybp_apply(u: torch.Tensor, bt: Bands2, tile_r=None,
                        vpu_rows=None) -> torch.Tensor:
    """K3's operator through K3p (K3h's split column stage pipelined
    across the tiles of a column strip: persistent blocks of a tensor
    warpgroup, the copies and the 3xTF32 column rows from K3f's cached
    C^T, and an FMA warpgroup, the FMA column rows and the row stage,
    joined by mbarriers; DMMA in float64) for a CUDA tensor, the plain
    version for a CPU tensor."""
    return tc_apply(u, bt, "hybp", laplace2_hybp_apply,
                    laplace2_hybp_apply_plain, tile_r, vpu_rows)


laplace2_hybp_apply.launches = 0


# ---- K3/mxu, K3/mxu3, K3/mxu3p: K3's tensor-core row modes ----------

def laplace2_mxu_apply(u: torch.Tensor, bt: Bands2,
                       tile_r=None) -> torch.Tensor:
    """K3's operator through K3/mxu (K3's FMA column stage, the row stage
    as a 3xTF32 window product on the tensor cores from the cached window
    tables; DMMA in float64) for a CUDA tensor, the plain version for a
    CPU tensor."""
    return tc_apply(u, bt, "mxu", laplace2_mxu_apply,
                    laplace2_apply_plain, tile_r)


laplace2_mxu_apply.launches = 0


def laplace2_mxu3_apply(u: torch.Tensor, bt: Bands2,
                        tile_r=None) -> torch.Tensor:
    """K3's operator through K3/mxu3 (K3/mxu's kernel with the row
    product as bf16x3 in float32 from the cached bf16 window tables,
    within about 1e-5 of max|y|; DMMA in float64) for a CUDA tensor, the
    plain version for a CPU tensor."""
    return tc_apply(u, bt, "mxu3", laplace2_mxu3_apply,
                    laplace2_apply_plain, tile_r)


laplace2_mxu3_apply.launches = 0


def laplace2_mxu3p_apply(u: torch.Tensor, bt: Bands2,
                         tile_r=None) -> torch.Tensor:
    """K3's operator through K3/mxu3p (K3/mxu's design with the row
    product as bf16x3 from cached bf16 window tables, on a warpgroup of
    its own that runs one unit's products under the next unit's column
    stage; DMMA in float64) for a CUDA tensor, the plain version for a
    CPU tensor."""
    return tc_apply(u, bt, "mxu3p", laplace2_mxu3p_apply,
                    laplace2_apply_plain, tile_r)


laplace2_mxu3p_apply.launches = 0

# rows= of make_padded_laplace2: (wrapper, plain twin, tensor-core kernel)
ROWS = {"vpu": (laplace2_apply, laplace2_apply_plain, None),
        "mxu": (laplace2_mxu_apply, laplace2_apply_plain, "mxu"),
        "mxu3": (laplace2_mxu3_apply, laplace2_apply_plain, "mxu3"),
        "mxu3p": (laplace2_mxu3p_apply, laplace2_apply_plain, "mxu3p")}


def _check_gdm_schedule(mxu_precision, pipeline_interleave, static_parity):
    """gdm's ``make_padded_laplace2`` schedule keywords, as the card takes
    them (see ``make_padded_laplace2``); raises ValueError for a value
    the card kernels do not satisfy."""
    if mxu_precision is not None:
        name = str(getattr(mxu_precision, "name", mxu_precision)).lower()
        if name not in ("highest", "float32"):
            raise ValueError(
                f"mxu_precision={mxu_precision!r}: the card's rows='mxu' "
                f"product runs as 3xTF32 (float32 fidelity, gdm's HIGHEST) "
                f"and has no cheaper pass count; for bf16x3 products take "
                f"rows='mxu3'")
    for name, value in (("pipeline_interleave", pipeline_interleave),
                        ("static_parity", static_parity)):
        if value is not None and not isinstance(value, bool):
            raise ValueError(f"{name} must be None, True or False, not "
                             f"{value!r}")


def make_padded_laplace2(grid: Grid, dtype=torch.float32, tile_r=None,
                         interpret=False, rows="vpu", mxu_precision=None,
                         bands=None, pipeline_interleave=None,
                         static_parity=True, *, device="cuda"):
    """(apply, pad, unpad, shape) of K3 as in gdm, for any odd p <= 15.

    rows: gdm's row stage, one of ``ROWS``: "vpu" (K3, the FMA row
    stage, float32-exact), "mxu" (K3/mxu, the row stage as a window
    product on the tensor cores, 3xTF32: float32 fidelity, gdm's
    HIGHEST), "mxu3" (K3/mxu3, that product as bf16x3, within about 1e-5
    of max|y| in float32) or "mxu3p" (K3/mxu3p, the bf16x3 products of
    one unit under the next unit's column stage).  In float64 every mode is exact to float64 (DMMA products).
    Any other value raises; gdm takes "vpu" for any unknown string.
    tile_r: the card's tile of the row modes, as in ``tc_options``
    (gdm's TPU tile rules do not carry over); K3's "vpu" tile is fixed
    at 32 x 32, so there it must be None.  The resolved tile is
    ``apply.options``.

    gdm's schedule keywords: ``mxu_precision`` (the pass count of gdm's
    rows="mxu" product) is taken when None or gdm's HIGHEST, recognised
    by name ("HIGHEST" or jax's alias "float32"), which K3/mxu's 3xTF32
    product matches in every mode; any other precision raises ValueError.
    ``pipeline_interleave`` (where gdm's mxu3p issues the previous tile's
    products in its roll loop) and ``static_parity`` (literal slot
    indices for the TPU compiler) take None, True or False and have no
    effect: both values produce the same function, and K3/mxu3p always
    overlaps one unit's products with the next unit's column stage on
    separate warpgroups.  Anything else raises ValueError.

    bands: optional (A0, A1, B0, B1) numpy band matrices ((N_d, 2p+1)
    each, the Banded1D.band layout) generalizing the operator to
    y = A0 U A1^T + B0 U B1^T.  Default: the Laplace (S0, M1, M0, S1).
    The "padded" array is the (N0, N1) node array itself.

    The parameters stand in gdm's positional order, ``device`` by
    keyword after them; ``interpret`` (gdm's TPU interpreter) is taken
    and has no effect.
    """
    dtype = _device.resolve_dtype(dtype)
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {sorted(ROWS)}, not {rows!r}")
    _check_gdm_schedule(mxu_precision, pipeline_interleave, static_parity)
    kernel, plain, tc = ROWS[rows]
    if tc is None and tile_r is not None:
        raise ValueError(f"K3's rows='vpu' tile is fixed at 32 x 32 on the "
                         f"card; tile_r={tile_r} is for the tensor-core row "
                         f"modes")
    bt = laplace2_bands(grid, device, dtype, bands)
    options = {} if tc is None else tc_options(tc, bt, tile_r)
    return padded_apply(bt, kernel, plain, **options)


def make_padded_laplace2_mxucol(grid: Grid, dtype=torch.float32,
                                tile_r=None, interpret=False, *,
                                device="cuda"):
    """(apply, pad, unpad, shape) of K3c, odd p <= 15: K3's operator,
    band tables and node array.  ``tile_r`` as in ``tc_options``; the
    resolved tile is ``apply.options``.  ``interpret`` is taken and has
    no effect."""
    bt = laplace2_bands(grid, device, _device.resolve_dtype(dtype))
    return padded_apply(bt, laplace2_mxucol_apply,
                        laplace2_mxucol_apply_plain,
                        **tc_options("mxucol", bt, tile_r))


def make_padded_laplace2_fullmxu(grid: Grid, dtype=torch.float32,
                                 tile_r=None, interpret=False, *,
                                 device="cuda"):
    """(apply, pad, unpad, shape) of K3f, odd p <= 15: K3's operator,
    band tables and node array.  ``tile_r`` as in ``tc_options`` (not
    clamped to N0, as in gdm).  ``interpret`` is taken and has no
    effect."""
    bt = laplace2_bands(grid, device, _device.resolve_dtype(dtype))
    return padded_apply(bt, laplace2_fullmxu_apply,
                        laplace2_fullmxu_apply_plain,
                        **tc_options("fullmxu", bt, tile_r))


def make_padded_laplace2_hybrid(grid: Grid, dtype=torch.float32,
                                tile_r=None, vpu_rows=None, interpret=False,
                                *, device="cuda"):
    """(apply, pad, unpad, shape) of K3h, odd p <= 15: K3's operator,
    band tables and node array.  ``tile_r`` and ``vpu_rows`` as in
    ``tc_options`` (gdm's defaults, 376 and 136, were the TPU's).
    ``interpret`` is taken and has no effect."""
    bt = laplace2_bands(grid, device, _device.resolve_dtype(dtype))
    return padded_apply(bt, laplace2_hybrid_apply,
                        laplace2_hybrid_apply_plain,
                        **tc_options("hybrid", bt, tile_r, vpu_rows))


def make_padded_laplace2_hybp(grid: Grid, dtype=torch.float32, tile_r=None,
                              vpu_rows=None, interpret=False, *,
                              device="cuda"):
    """(apply, pad, unpad, shape) of K3p, odd p <= 15: K3's operator,
    band tables and node array.  ``tile_r`` and ``vpu_rows`` as in
    ``tc_options``.  ``interpret`` is taken and has no effect."""
    bt = laplace2_bands(grid, device, _device.resolve_dtype(dtype))
    return padded_apply(bt, laplace2_hybp_apply, laplace2_hybp_apply_plain,
                        **tc_options("hybp", bt, tile_r, vpu_rows))
