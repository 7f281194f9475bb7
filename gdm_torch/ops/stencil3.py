"""K4 and K5: the 3D GD Laplace apply
y = S0 (x) M1 (x) M2 + M0 (x) S1 (x) M2 + M0 (x) M1 (x) S2.

Port of gdm/ops/pallas_stencil2.py: ``make_padded_laplace3`` (K4) and
``make_padded_laplace3_mxu`` (K5), two schedules of one operator, which
gdm's dispatch ``best_padded_laplace`` (gdm_torch/ops/fast.py here)
picks between by the plane count.  Both run gdm's stages
(A = U M2^T, B = U S2^T; P = M1 A, T = S1 A + M1 B; y = S0 P + M0 T)
with the intermediates in shared memory.  K4 (gdm_torch/csrc/
laplace3.cu) does all three as band sums; K5 (laplace3_mxu.cu) does the
plane coupling, stage 3, as a dense product y = [S0 | M0] [P ; T] on the
tensor cores.  ``laplace3_apply`` and ``laplace3_mxu_apply`` launch
their kernel for a CUDA tensor and run the plain torch version for a
CPU tensor; there is no other switch.  ``k5_plan`` picks K5's launch
from the shape (its boxes of output planes, rows and columns, and the u
slots a warp); tests/test_torch_plans.py holds it on the CPU.  The node array is the contiguous
(N0, N1, N2) field: ``pad`` and ``unpad`` are reshapes.
"""

from __future__ import annotations

import ctypes
import dataclasses

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
            f"K4 and K5 take odd degrees p <= {MAX_DEGREE}, not {p}: their "
            f"shared-memory plane windows (K4 2p+1 planes of 16 x 32 nodes, "
            f"K5 16+2p planes of 8 x 32) fit one H100 block up to "
            f"p = {MAX_DEGREE}")

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
    """The 3D Laplace apply through K4: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``tile_planes``: the
    planes of axis 0 one block marches over (gdm's tile of planes); by
    default the launcher's choice, the longest of 64, 32, 16, 8 that
    keeps about four blocks per SM."""
    _check(u, bt)
    tile_planes = positive_int("tile_planes", tile_planes)
    if u.device.type == "cpu":
        return laplace3_apply_plain(u, bt)
    y = _launch(u, bt, "laplace3_apply", "K4", (tile_planes or 0,))
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


def _launch_plan(u: torch.Tensor, bt: Bands3, plan: K5Plan) -> torch.Tensor:
    """K5 on the CUDA tensor ``u`` with the launch plan ``plan``; counts
    nothing (``laplace3_mxu_apply`` does)."""
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


def make_padded_laplace3(grid: Grid, device="cuda", dtype=torch.float32,
                         tile_planes=None):
    """(apply, pad, unpad, shape) of K4, odd p <= 7.  The "padded" array
    is the (N0, N1, N2) node array itself.  ``tile_planes`` (gdm's tile
    of axis-0 planes) is K4's chunk of planes per block, as in
    ``laplace3_apply``, kept in ``apply.options``; a value that is not a
    positive integer raises ValueError."""
    tile_planes = positive_int("tile_planes", tile_planes)
    bt = laplace3_bands(grid, device, dtype)
    options = {} if tile_planes is None else {"tile_planes": tile_planes}
    return padded_apply(bt, laplace3_apply, laplace3_apply_plain, **options)


def make_padded_laplace3_mxu(grid: Grid, device="cuda", dtype=torch.float32,
                             tile_planes1=None, chunk=None, pipelined=True):
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
    """
    positive_int("tile_planes1", tile_planes1)
    positive_int("chunk", chunk)
    if pipelined is not True:
        raise ValueError(
            f"pipelined={pipelined!r}: K5 always overlaps its warps' plane "
            f"copies (cp.async) with the other warps' compute; it has no "
            f"unpipelined schedule, so only pipelined=True is taken")
    bt = laplace3_bands(grid, device, dtype)
    return padded_apply(bt, laplace3_mxu_apply, laplace3_mxu_apply_plain)
