"""K4 and K5: the 3D GD Laplace apply
y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2.

Port of gdm/ops/pallas_stencil2.py: ``make_padded_laplace3`` (K4) and
``make_padded_laplace3_mxu`` (K5), two schedules of one operator, which
gdm's dispatch ``best_padded_laplace`` (gdm_torch/ops/fast.py here)
picks between by the plane count.  Both run gdm's stages
(A = U M2^T, B = U S2^T; P = M1 A, T = S1 A + M1 B; y = S0 P + M0 T).
K4 (gdm_torch/csrc/laplace3.cu) does all three as band sums with the
intermediates in registers; K5 (laplace3_mxu.cu) keeps them in shared
memory and does the plane coupling, stage 3, as a dense product
y = [S0 | M0] [P ; T] on the tensor cores.  ``laplace3_apply`` and ``laplace3_mxu_apply`` launch
their kernel for a CUDA tensor and run the plain torch version for a
CPU tensor; there is no other switch.  ``k4_plan`` picks K4's launch
from the shape (its chunk of planes; strips, runs of rows and the rows a
thread follow from the shape), ``k5_plan`` K5's (its boxes of output
planes, rows and columns, and the u slots a warp);
tests/test_torch_plans.py holds both on the CPU.  The node array is the
contiguous (N0, N1, N2) field: ``pad`` and ``unpad`` are reshapes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import device as _device
from ..grid import Grid
from ..ops1d import mass_1d, stiffness_1d
from . import _build
from ._padded import launch, padded_apply, positive_int
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


def laplace3_bands(grid: Grid, device="cuda", dtype=torch.float32) -> Bands3:
    """The band tables for ``grid`` on ``device`` (the card unless
    ``device="cpu"`` is asked for)."""
    device = _device.resolve(device)
    if grid.dim != 3:
        raise ValueError(f"K4 and K5 are the 3D apply; the grid is "
                         f"{grid.dim}D")
    p = grid.degree
    if p > MAX_DEGREE:
        raise ValueError(
            f"K4 and K5 take odd degrees p <= {MAX_DEGREE}, not {p}: they "
            f"are built for those (K4's register ring of 2p+1 output "
            f"planes, K5's shared-memory window of 16+2p planes of 8 x 32 "
            f"nodes, which fits one H100 block up to p = {MAX_DEGREE})")

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


def _launch(u: torch.Tensor, bt: Bands3, fn: str, what: str, extra=()):
    (s0, s1, s2), (m0, m1, m2) = bt.s, bt.m
    return launch(u, fn, what, (s0, m0, s1, m1, s2, m2), bt.p, bt.shape,
                  extra)


def laplace3_apply(u: torch.Tensor, bt: Bands3,
                   tile_planes=None) -> torch.Tensor:
    """The 3D Laplace apply through K4: the CUDA kernel, launched as
    ``k4_plan`` says, for a CUDA tensor, the plain version for a CPU
    tensor.  ``tile_planes``: the most planes of axis 0 one block
    marches over (gdm's tile of planes); by default the plan's chunk."""
    _check(u, bt)
    tile_planes = positive_int("tile_planes", tile_planes)
    if u.device.type == "cpu":
        return laplace3_apply_plain(u, bt)
    y = _launch_plan(u, bt, k4_plan(bt.shape, bt.p, u.dtype, tile_planes))
    laplace3_apply.launches += 1
    return y


laplace3_apply.launches = 0


def band_matrix(band: torch.Tensor) -> torch.Tensor:
    """The (N, N) matrix of an (N, 2p+1) band table."""
    n, w = band.shape
    p = (w - 1) // 2
    full = band.new_zeros((n, n + 2 * p))
    rows = torch.arange(n, device=band.device)
    for k in range(w):
        # entry (a, a+k-p) sits at column a+k of the p-padded matrix;
        # the band is zero where a+k-p falls outside [0, N)
        full[rows, rows + k] = band[:, k]
    return full[:, p:n + p]


def laplace3_mxu_apply_plain(u: torch.Tensor, bt: Bands3) -> torch.Tensor:
    """The plain torch version of K5: stages 1-2 as K4's band sweeps,
    stage 3 as the dense product y = [S0 | M0] [P ; T] of shape
    (N0 x 2N0)(2N0 x N1 N2), with torch.matmul in the working dtype."""
    (s0, s1, s2), (m0, m1, m2) = bt.s, bt.m
    a = apply_banded(u, m2, 2)
    b = apply_banded(u, s2, 2)
    p_ = apply_banded(a, m1, 1)
    t_ = apply_banded(a, s1, 1) + apply_banded(b, m1, 1)
    n0 = u.shape[0]
    c = torch.cat([band_matrix(s0), band_matrix(m0)], dim=1)
    pt = torch.cat([p_.reshape(n0, -1), t_.reshape(n0, -1)], dim=0)
    return torch.matmul(c, pt).reshape(u.shape)


# ---- K5's launch plan (csrc/laplace3_mxu.cu) ----

SM_COUNT = 132         # SMs of an H100 SXM
SMEM_SM = 233472       # bytes of shared memory of one SM
SMEM_BLOCK = 232448    # bytes one block may take
K5_BOX = (16, 8, 32)   # the most planes, rows and columns a K5 block owns
# (planes, rows) of a box, largest first; a box takes up to 32 columns
K5_BOXES = ((16, 8), (8, 8), (8, 4), (4, 4), (4, 2), (2, 2))
K5_SLOTS = (1, 2, 3)   # u slots per warp the kernel is built for


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """How K5 cuts the (n0, n1, n2) nodes into blocks: ``grid`` boxes
    along axes 0, 1, 2, each axis split evenly (a box holds the floor or
    the ceiling of n / boxes), so the largest box is ``chunk`` output
    planes by ``tile`` = (rows, columns); ``slots`` u tiles in shared
    memory per warp; ``smem`` bytes of shared memory per block; ``box``
    the (planes, rows) entry of K5_BOXES the plan was cut to."""
    tile: tuple
    chunk: int
    grid: tuple
    smem: int
    slots: int
    box: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def boxes(self, nodes):
        """Per axis, the (start, size) of every box, as the kernel cuts
        them."""
        return tuple(even_boxes(n, nt) for n, nt in zip(nodes, self.grid))


def even_boxes(n: int, nt: int) -> list:
    """(start, size) of the nt boxes of an even split of n nodes: the
    first n mod nt boxes one node larger (csrc/laplace3_mxu.cu's box)."""
    base, rem = divmod(n, nt)
    return [(b * base + min(b, rem), base + (b < rem)) for b in range(nt)]


def _rnd(n: int, m: int = 32) -> int:
    return -(-n // m) * m


def k5_smem(p: int, itemsize: int, slots: int) -> int:
    """Bytes of shared memory of one K5 block, as laplace3_mxu.cu's Geom
    lays it out: [P ; T] (depth 2(16 + 2p) rounded to 8, pitch 264), the
    C slice, the warps' u slots (later the y stage) and the stage-2
    band rows (pitch 2p + 1 rounded up to 4, for 16-byte loads), each
    array on 32 elements."""
    t0, ty, tx = K5_BOX
    k, w = 2 * p + 1, t0 + 2 * p
    kd = _rnd(2 * w, 8)
    ldp = ty * tx + 8
    slot = _rnd((ty + 2 * p) * (tx + 2 * p))
    elems = (_rnd(kd * ldp) + _rnd(t0 * (kd + 8)) +
             _rnd(max(8 * slots * slot, t0 * ldp)) + 2 * _rnd(ty * _rnd(k, 4)))
    return itemsize * elems


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes one H100 SM holds (1 KB reserved each)."""
    return SMEM_SM // (smem + 1024)


def _split(n: int, most: int, least: int = 1):
    """(boxes, largest box) of an even split of n nodes into boxes of at
    most ``most`` and, where n allows, at least ``least`` nodes."""
    nt = -(-n // most)
    if n >= least:
        nt = max(1, min(nt, n // least))
    return nt, -(-n // nt)


def _k5_plan(nodes, p, itemsize, planes, rows, slots) -> K5Plan:
    n0, n1, n2 = nodes
    # axis 0 never hands a block a single output plane (it would walk 2p
    # halo planes for it)
    nt0, t0 = _split(n0, planes, 2)
    nt1, t1 = _split(n1, rows)
    nt2, t2 = _split(n2, K5_BOX[2])
    return K5Plan((t1, t2), t0, (nt0, nt1, nt2), k5_smem(p, itemsize, slots),
                  slots, (planes, rows))


def k5_plans(nodes, p: int, dtype) -> list:
    """Every plan K5 can launch for ``nodes``: each box of K5_BOXES with
    one or (where it fits a block) two u slots per warp."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return [_k5_plan(tuple(nodes), p, itemsize, planes, rows, slots)
            for planes, rows in K5_BOXES for slots in K5_SLOTS
            if k5_smem(p, itemsize, slots) <= SMEM_BLOCK]


def k5_plan(nodes, p: int, dtype) -> K5Plan:
    """K5's launch plan for the (n0, n1, n2) nodes: the largest box of
    K5_BOXES that still launches a block for every SM (the smallest box
    where none does), and the most u slots per warp (the next planes'
    copies in flight) that fit a block while every block of the grid is
    resident at once, else one (more blocks on an SM: three at p = 3 in
    float32)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nodes = tuple(nodes)
    for planes, rows in K5_BOXES:
        plan = _k5_plan(nodes, p, itemsize, planes, rows, 1)
        if plan.blocks >= SM_COUNT:
            break
    for slots in K5_SLOTS[:0:-1]:
        smem = k5_smem(p, itemsize, slots)
        if smem <= SMEM_BLOCK and (
                plan.blocks <= SM_COUNT * blocks_per_sm(smem)):
            return dataclasses.replace(plan, smem=smem, slots=slots)
    return plan


def k5_occupancy(slots: int, dtype) -> int:
    """Blocks of K5 one SM of the card holds at p = 3 (the solves'
    degree) with ``slots`` u slots a warp, as the CUDA runtime's
    occupancy calculator reports them for the built kernel (its
    registers and shared memory)."""
    kl = _build.kernels()
    out = ctypes.c_int(0)
    err = kl.lib.gdm_laplace3_mxu_occupancy(
        slots, int(dtype == torch.float64), ctypes.byref(out))
    _build.check(kl, err, "K5 occupancy")
    return out.value


def _launch_plan(u: torch.Tensor, bt: Bands3, plan) -> torch.Tensor:
    """K4 (a K4Plan) or K5 (a K5Plan) on the CUDA tensor ``u`` with the
    launch plan ``plan``; counts nothing (the wrappers do)."""
    if isinstance(plan, K4Plan):
        return _launch(u, bt, "laplace3_apply", "K4",
                       (plan.strips, *plan.grid, plan.smem))
    return _launch(u, bt, "laplace3_mxu_apply", "K5",
                   (*plan.grid, plan.slots))


def laplace3_mxu_apply(u: torch.Tensor, bt: Bands3) -> torch.Tensor:
    """The 3D Laplace apply through K5 (plane coupling on the tensor
    cores): the CUDA kernel, launched as ``k5_plan`` says, for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check(u, bt)
    if u.device.type == "cpu":
        return laplace3_mxu_apply_plain(u, bt)
    y = _launch_plan(u, bt, k5_plan(bt.shape, bt.p, u.dtype))
    laplace3_mxu_apply.launches += 1
    return y


laplace3_mxu_apply.launches = 0


# ---- K4's launch plan (csrc/laplace3.cu) ----

K4_SEG_STRIPS = 6   # strips (consumer warps) of a block's segment
K4_SLOTS = 4        # planes in the copy ring
K4_LANES = 32       # the widest strip of columns: one a lane
K4_BAR_BYTES = 128  # the ring's mbarriers, before the ring
# rows a thread owns, by (degree, float64), from the registers a thread
# takes (laplace3.cu's k4_rows)
K4_ROWS = {(1, False): 8, (3, False): 4, (5, False): 4, (7, False): 2,
           (1, True): 4, (3, True): 2, (5, True): 2, (7, True): 2}
K4_MIN_CHUNK = 8    # the fewest output planes of a default chunk (each
                    # chunk streams 2p halo planes)


def k4_rows(p: int, itemsize: int) -> int:
    """Output rows a K4 thread owns at degree p (laplace3.cu's
    k4_rows)."""
    return K4_ROWS[(p, itemsize == 8)]


def k4_smem(p: int, itemsize: int, n2: int, strips: int, segments: int,
            chunk: int) -> int:
    """Bytes of shared memory of one K4 block, as laplace3.cu's Geom lays
    it out: the mbarriers; K4_SLOTS ring slots, each the R + 2p rows of
    the tile as one span of the node array (R + 2p) n2 + 2p elements
    when one segment spans the width, else R + 2p rows at a pitch of the
    widest segment + 2p elements (with 32 more for the lanes past a
    strip, and 16 bytes at each end); the run's R rows of [M1 | S1] and
    the chunk's chunk + 2p rows of [S0 | M0] entries, each half at a
    pitch of 2p + 1 rounded up to 16 bytes.  The launcher refuses a plan
    whose bytes differ from its own count."""
    vec, k = 16 // itemsize, 2 * p + 1
    r, kp = k4_rows(p, itemsize), _rnd(k, vec)
    if segments == 1:
        slot = _rnd((r + 2 * p) * n2 + 2 * p + K4_LANES + 2 * vec, vec)
    else:
        width = -(-strips // segments) * -(-n2 // strips)
        slot = (r + 2 * p) * _rnd(width + 2 * p + K4_LANES + 2 * vec, vec)
    return K4_BAR_BYTES + itemsize * (K4_SLOTS * slot + 2 * r * kp +
                                      2 * (chunk + 2 * p) * kp)


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """How K4 cuts the (n0, n1, n2) nodes: the n2 columns into ``strips``
    strips of at most K4_LANES (one consumer warp each, a thread one
    column), the n1 rows into ``runs`` runs of at most ``rows`` rows (a
    thread's rows), ``grid`` = (segments of at most K4_SEG_STRIPS strips,
    runs, chunks of at most ``chunk`` output planes), every split even
    (its parts differ by at most one); ``smem`` bytes of shared memory a
    block; ``p`` the degree."""
    rows: int
    runs: int
    strips: int
    grid: tuple
    chunk: int
    smem: int
    p: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def warps(self) -> int:
        """Consumer warps of the widest segment (a block has one more,
        the producer)."""
        return -(-self.strips // self.grid[0])

    def boxes(self, nodes):
        """(start, size) of every chunk of planes, run of rows and strip
        of columns, as the kernel cuts them, and the strips of each
        segment as (first strip, strips)."""
        n0, n1, n2 = nodes
        return (even_boxes(n0, self.grid[2]), even_boxes(n1, self.runs),
                even_boxes(n2, self.strips),
                even_boxes(self.strips, self.grid[0]))

    @property
    def recompute(self) -> float:
        """Planes stages 1-2 run on per output plane at the largest
        chunk: (chunk + 2p) / chunk."""
        return (self.chunk + 2 * self.p) / self.chunk


def _k4_plan(nodes, p, itemsize, chunk) -> K4Plan:
    n0, n1, n2 = nodes
    r = k4_rows(p, itemsize)
    strips = -(-n2 // K4_LANES)
    segments = -(-strips // K4_SEG_STRIPS)
    nt0 = -(-n0 // chunk)
    chunk = -(-n0 // nt0)
    return K4Plan(r, -(-n1 // r), strips, (segments, -(-n1 // r), nt0),
                  chunk, k4_smem(p, itemsize, n2, strips, segments, chunk), p)


def _k4_cost(nodes, p, dtype, itemsize, nt0, occupancy) -> tuple:
    """The time model of a K4 launch with nt0 chunks: the waves of blocks
    (at occupancy(p, dtype, warps, smem) an SM) times the planes a block
    streams (its chunk + 2p), then the planes streamed in all."""
    plan = _k4_plan(nodes, p, itemsize, -(-nodes[0] // nt0))
    slots = SM_COUNT * occupancy(p, dtype, plan.warps, plan.smem)
    planes = plan.chunk + 2 * p
    return -(-plan.blocks // slots) * planes, plan.grid[2] * planes


def _k4_chunk(nodes, p, dtype, itemsize, occupancy) -> int:
    """The chunk of the least modelled time (_k4_cost) among chunks of
    K4_MIN_CHUNK planes and more (of the whole axis where it has fewer)
    that fit a block's shared memory."""
    n0 = nodes[0]
    best = None
    for nt0 in range(1, max(1, n0 // K4_MIN_CHUNK) + 1):
        chunk = -(-n0 // nt0)
        if _k4_plan(nodes, p, itemsize, chunk).smem > SMEM_BLOCK:
            continue
        cost = _k4_cost(nodes, p, dtype, itemsize, nt0, occupancy)
        if best is None or cost < best[0]:
            best = (cost, chunk)
    if best is None:   # no chunk of K4_MIN_CHUNK fits: the longest that does
        chunk = K4_MIN_CHUNK
        while chunk > 1 and _k4_plan(nodes, p, itemsize,
                                     chunk).smem > SMEM_BLOCK:
            chunk -= 1
        return chunk
    return best[1]


@functools.lru_cache(maxsize=None)
def _k4_plan_cached(nodes: tuple, p: int, dtype, planes,
                    occupancy) -> K4Plan:
    itemsize = torch.empty((), dtype=dtype).element_size()
    if planes is None:
        chunk = _k4_chunk(nodes, p, dtype, itemsize, occupancy)
    else:
        chunk = min(planes, nodes[0])
        while chunk > 1 and _k4_plan(nodes, p, itemsize,
                                     chunk).smem > SMEM_BLOCK:
            chunk -= 1
    return _k4_plan(nodes, p, itemsize, chunk)


@functools.lru_cache(maxsize=None)
def k4_occupancy(p: int, dtype, warps: int, smem: int) -> int:
    """Blocks of K4 one SM of the card holds with ``warps`` consumer
    warps and ``smem`` bytes of shared memory, as the CUDA runtime's
    occupancy calculator reports them for the built kernel (cached)."""
    kl = _build.kernels()
    out = ctypes.c_int(0)
    err = kl.lib.gdm_laplace3_occupancy(p, int(dtype == torch.float64),
                                        warps, smem, ctypes.byref(out))
    _build.check(kl, err, "K4 occupancy")
    return out.value


def k4_plan(nodes, p: int, dtype, planes=None,
            occupancy=k4_occupancy) -> K4Plan:
    """K4's launch plan for the (n0, n1, n2) nodes: chunks of at most
    ``planes`` output planes (gdm's tile_planes) where given, else the
    chunk of K4_MIN_CHUNK planes or more (where the grid has them) whose
    waves of blocks times planes a block streams is least, at
    ``occupancy(p, dtype, warps, smem)`` blocks an SM (by default the
    built kernel's, which needs the card; the CPU tests pass a model of
    their own); a chunk too long for a block's shared memory is cut.
    Cached: the wrapper asks on every launch."""
    return _k4_plan_cached(tuple(nodes), p, dtype, planes, occupancy)


def k4_plans(nodes, p: int, dtype, occupancy=k4_occupancy) -> list:
    """Every plan the sweeps time for ``nodes``: k4_plan's own and the
    chunks of 1, 2, 3, 4, 6 and 8 chunks along axis 0 (duplicates and
    chunks below two planes dropped)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nodes = tuple(nodes)
    plans = [k4_plan(nodes, p, dtype, occupancy=occupancy)]
    for nt0 in (1, 2, 3, 4, 6, 8):
        chunk = -(-nodes[0] // nt0)
        plan = _k4_plan(nodes, p, itemsize, chunk)
        if chunk >= 2 and plan.smem <= SMEM_BLOCK and plan not in plans:
            plans.append(plan)
    return plans


def make_padded_laplace3(grid: Grid, dtype=torch.float32, tile_planes=None,
                         interpret=False, *, device="cuda"):
    """(apply, pad, unpad, shape) of K4, odd p <= 7.  The "padded" array
    is the (N0, N1, N2) node array itself.  ``tile_planes`` (gdm's tile
    of axis-0 planes) is K4's chunk of planes per block, as in
    ``laplace3_apply``, kept in ``apply.options``; a value that is not a
    positive integer raises ValueError.  ``interpret`` (gdm's TPU
    interpreter) is taken and has no effect."""
    dtype = _device.resolve_dtype(dtype)
    tile_planes = positive_int("tile_planes", tile_planes)
    bt = laplace3_bands(grid, device, dtype)
    options = {} if tile_planes is None else {"tile_planes": tile_planes}
    return padded_apply(bt, laplace3_apply, laplace3_apply_plain, **options)


def make_padded_laplace3_mxu(grid: Grid, dtype=torch.float32,
                             tile_planes1=None, interpret=False, chunk=None,
                             pipelined=True, *, device="cuda"):
    """(apply, pad, unpad, shape) of K5, odd p <= 7: K4's band tables and
    node array, the plane coupling as a tensor-core product.

    gdm's schedule keywords, none of which changes the function:
    ``tile_planes1`` (gdm's tile of axis-1 planes, sized to the TPU's
    VMEM) and ``chunk`` (the row chunk of gdm's in-kernel loops, sized to
    the TPU's vector registers) are taken and have no effect: K5's boxes
    come from ``k5_plan``.  ``pipelined=True`` (gdm's dispatch passes it)
    is what K5 always does: its warps copy their planes' tiles with
    cp.async while the other warps compute.  ``pipelined=False`` asks
    for a schedule the card kernel does not have and raises ValueError,
    as does a tile or chunk that is not a positive integer.
    ``interpret`` (gdm's TPU interpreter) is taken and has no effect.
    """
    dtype = _device.resolve_dtype(dtype)
    positive_int("tile_planes1", tile_planes1)
    positive_int("chunk", chunk)
    if pipelined is not True:
        raise ValueError(
            f"pipelined={pipelined!r}: K5 always overlaps its warps' plane "
            f"copies (cp.async) with the other warps' compute; it has no "
            f"unpipelined schedule, so only pipelined=True is taken")
    bt = laplace3_bands(grid, device, dtype)
    return padded_apply(bt, laplace3_mxu_apply, laplace3_mxu_apply_plain)
