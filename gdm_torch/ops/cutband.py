"""K1: the 2D stencil-band apply on the padded layout.

Port of gdm/ops/pallas_cutband.py (``make_padded_stencil2``, the TPU
kernel under gdm/cut/fastapply.py::fast_stencil_bundle).  The CUDA
kernel is gdm_torch/csrc/cutband.cu; its source note says what bounds it
on the card.  ``band_apply`` launches it, as ``k1_plan`` picks from the
layout, the tap count and the dtype, for a CUDA tensor and runs the
plain torch version ``band_apply_plain`` for a CPU tensor; there is no
other switch.  tests/test_torch_plans.py holds the plan on the CPU.

The padded layout (``PaddedLayout``) is the one layout of the flagship
path: K1, K2 (gdm_torch/ops/resident.py) and the RK state all use it.
A (rows, pitch) array holds the nodes at [r, r + n0) x [r, r + n1) and
zeros in a guard frame at least r wide; the pitch is a multiple of 4
elements (16-byte rows in float32).  Every band apply writes zeros to
the guard cells, so the layout is closed under the apply and a CG can
run inside it without re-padding.  (gdm rounds rows to the Pallas tile
and lanes to 128, and its two kernels disagree on the row rounding; the
port needs neither.)

Tap order: the operator's taps with any nonzero coefficient, in (dy, dx)
row-major order over StencilOperator.band[..., dy, dx], as signed
offsets — the order of gdm/ops/pallas_resident.py::_planes.  Planes are
tap-major, (T, rows, pitch), zero outside the node block.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import device as _device
from . import _build
from ._padded import positive_int


@dataclasses.dataclass(frozen=True)
class PaddedLayout:
    n0: int
    n1: int
    r: int

    @property
    def rows(self) -> int:
        return self.n0 + 2 * self.r

    @property
    def pitch(self) -> int:
        return (self.n1 + 2 * self.r + 3) // 4 * 4

    @property
    def shape(self) -> tuple:
        return (self.rows, self.pitch)

    def interior(self, u_pad: torch.Tensor) -> torch.Tensor:
        """The (n0, n1) node block of a padded array (a view)."""
        r = self.r
        return u_pad[r : r + self.n0, r : r + self.n1]

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat (or (n0, n1)) node vector -> padded array, zero guards."""
        out = u.new_zeros(self.shape)
        self.interior(out).copy_(u.reshape(self.n0, self.n1))
        return out

    def unpad(self, u_pad: torch.Tensor) -> torch.Tensor:
        """Padded array -> flat node vector (a copy)."""
        return self.interior(u_pad).reshape(-1)


def layout_for(grid, r: int) -> PaddedLayout:
    """The padded layout of a 2D grid for band radii up to ``r``."""
    if grid.dim != 2:
        raise NotImplementedError(
            "the padded band kernels are 2D; the 3D cut problems are not "
            "ported yet")
    n0, n1 = grid.nodes
    return PaddedLayout(n0, n1, r)


@dataclasses.dataclass(frozen=True)
class BandPlanes:
    """A StencilOperator's nonzero taps on a padded layout."""
    taps: tuple            # ((dy, dx), ...) signed offsets
    planes: torch.Tensor   # (T, rows, pitch), zero outside the nodes
    offsets: torch.Tensor  # (T, 2) int32 copy of taps, on planes.device
    layout: PaddedLayout


def band_planes(st, layout: PaddedLayout, device, dtype) -> BandPlanes:
    grid = st.grid
    n0, n1 = grid.nodes
    r_op = st.radius
    if (n0, n1) != (layout.n0, layout.n1) or r_op > layout.r:
        raise ValueError(f"operator on {grid.nodes} with radius {r_op} "
                         f"does not fit {layout}")
    K = 2 * r_op + 1
    band = np.asarray(st.band_host, np.float64).reshape(n0, n1, K, K)
    nonzero = np.any(band != 0.0, axis=(0, 1))
    taps = tuple((dy - r_op, dx - r_op)
                 for dy in range(K) for dx in range(K) if nonzero[dy, dx])
    planes = np.zeros((len(taps),) + layout.shape)
    r = layout.r
    for t, (dy, dx) in enumerate(taps):
        planes[t, r : r + n0, r : r + n1] = band[:, :, dy + r_op, dx + r_op]
    return BandPlanes(
        taps,
        torch.as_tensor(planes, dtype=dtype, device=device),
        torch.as_tensor(np.asarray(taps, np.int32).reshape(-1, 2),
                        device=device),
        layout)


def _check(u: torch.Tensor, bp: BandPlanes):
    if u.shape != bp.layout.shape:
        raise ValueError(f"expected shape {bp.layout.shape}, got "
                         f"{tuple(u.shape)}")
    if u.dtype != bp.planes.dtype or u.device != bp.planes.device:
        raise ValueError(
            f"u is {u.dtype} on {u.device}, the planes are "
            f"{bp.planes.dtype} on {bp.planes.device}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def band_apply_plain(u: torch.Tensor, bp: BandPlanes) -> torch.Tensor:
    """The plain torch version of K1: one sliced multiply-add per tap."""
    lay = bp.layout
    r, n0, n1 = lay.r, lay.n0, lay.n1
    y = torch.zeros_like(u)
    yi = lay.interior(y)
    for t, (dy, dx) in enumerate(bp.taps):
        # in place into this call's own output
        yi += (bp.planes[t, r : r + n0, r : r + n1]
               * u[r + dy : r + dy + n0, r + dx : r + dx + n1])
    return y


# ---- K1's launch plan (csrc/cutband.cu) ----

SMEM_MAX = 232448       # bytes of shared memory an H100 block may use
K1_THREADS = 256        # threads of a block
K1_WIDTH = 32           # cells across a tile
K1_GROUPS = (1, 2, 4, 8)  # tap groups a cell's taps split into
K1_INFLIGHT = (12, 24)  # taps a thread loads at once (the kernel's MAXT)


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """How K1 cuts the (rows, pitch) layout: a thread owns ``vec``
    adjacent cells of a row (16 bytes) and one of ``groups`` tap groups
    (the taps split evenly), and loads ``inflight`` of its taps at once;
    a block of K1_THREADS threads holds a tile of at most ``tile_rows``
    rows by K1_WIDTH cells once for each group.  ``tiles`` = (along
    rows, along vectors), each axis split evenly, so the largest tile is
    ``rows`` x ``cols`` cells; ``smem`` bytes of shared memory a
    block."""
    groups: int
    inflight: int
    vec: int
    tile_rows: int
    rows: int
    cols: int
    tiles: tuple
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles[0] * self.tiles[1]

    @property
    def args(self) -> tuple:
        """The plan's integer launch arguments, in the kernel's order."""
        return (self.groups, *self.tiles, self.inflight)


def _even(n: int, most: int):
    """(parts, largest part) of an even split of n into parts of at most
    ``most``."""
    parts = -(-n // most)
    return parts, -(-n // parts)


def k1_tile_pitch(r: int) -> int:
    """The u tile's pitch in cells: K1_WIDTH + 2r rounded up to 1 mod 32
    (a float32 warp's four rows then hit 32 distinct banks)."""
    return (K1_WIDTH + 2 * r + 30) // 32 * 32 + 1


def k1_smem(itemsize: int, r: int, groups: int, taps: int) -> int:
    """Bytes of shared memory of one K1 block, as cutband.cu lays it
    out: with more than one group every thread's partial sums (a 16-byte
    vector), the u tile with its r-wide halo and the taps' flat offsets
    (int32)."""
    vec = 16 // itemsize
    tile_rows = K1_THREADS * vec // (K1_WIDTH * groups)
    red = K1_THREADS * 16 if groups > 1 else 0
    return (red + itemsize * (tile_rows + 2 * r) * k1_tile_pitch(r)
            + 4 * taps)


def _k1_plan(rows, pitch, taps, itemsize, r, groups) -> K1Plan:
    vec = 16 // itemsize
    tile_rows = K1_THREADS * vec // (K1_WIDTH * groups)
    ntr, th = _even(rows, tile_rows)
    ntc, tq = _even(pitch // vec, K1_WIDTH // vec)
    per_group = -(-taps // groups)
    inflight = next((m for m in K1_INFLIGHT if per_group <= m),
                    K1_INFLIGHT[-1])
    return K1Plan(groups, inflight, vec, tile_rows, th, tq * vec,
                  (ntr, ntc), k1_smem(itemsize, r, groups, taps))


def k1_plans(rows: int, pitch: int, taps: int, dtype, r: int) -> list:
    """Every plan K1 can launch on a (rows, pitch) layout of guard width
    r with ``taps`` taps: one for each tap-group count of K1_GROUPS up
    to the taps, whose block fits the card's shared memory."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if pitch % 4:
        raise ValueError(f"K1 needs a pitch that is a multiple of 4, not "
                         f"{pitch}")
    plans = [_k1_plan(rows, pitch, taps, itemsize, r, g) for g in K1_GROUPS
             if g == 1 or g <= taps]
    return [pl for pl in plans if pl.smem <= SMEM_MAX]


@functools.lru_cache(maxsize=None)
def k1_plan(rows: int, pitch: int, taps: int, dtype, r: int) -> K1Plan:
    """K1's launch plan: the most tap groups (at the flagship's 77 taps
    eight groups of 9-10, each thread's taps all in flight at once),
    the fastest plan of every sweep at 128^2 and 512^2; raises
    ValueError when no plan fits a block.  Cached: the wrapper asks on
    every launch."""
    plans = k1_plans(rows, pitch, taps, dtype, r)
    if not plans:
        raise ValueError(f"no K1 plan fits an H100 block: {taps} taps, "
                         f"guard width {r}, {dtype}")
    return plans[-1]


def _launch_plan(u: torch.Tensor, bp: BandPlanes,
                 plan: K1Plan) -> torch.Tensor:
    """K1 on the CUDA tensor ``u`` with the launch plan ``plan``; counts
    nothing (``band_apply`` does)."""
    if u.device.type != "cuda":
        raise ValueError(f"no band apply for device {u.device}")
    fns = {torch.float32: "gdm_cutband_apply_f32",
           torch.float64: "gdm_cutband_apply_f64"}
    if u.dtype not in fns:
        raise ValueError(f"the CUDA band apply takes float32 or float64, "
                         f"not {u.dtype}")
    kl = _build.kernels()
    lay = bp.layout
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        err = getattr(kl.lib, fns[u.dtype])(
            u.data_ptr(), bp.planes.data_ptr(), bp.offsets.data_ptr(),
            y.data_ptr(), len(bp.taps), lay.rows, lay.pitch, lay.n0, lay.n1,
            lay.r, *plan.args, _build.stream_handle(u.device))
    _build.check(kl, err, "cutband apply launch")
    return y


def band_apply(u: torch.Tensor, bp: BandPlanes) -> torch.Tensor:
    """y = band * u on the padded layout: the CUDA kernel, launched as
    ``k1_plan`` says, for a CUDA tensor, the plain version for a CPU
    tensor."""
    _check(u, bp)
    if u.device.type == "cpu":
        return band_apply_plain(u, bp)
    lay = bp.layout
    y = _launch_plan(u, bp, k1_plan(lay.rows, lay.pitch, len(bp.taps),
                                    u.dtype, lay.r))
    band_apply.launches += 1
    return y


band_apply.launches = 0


def make_padded_stencil2(st, dtype=torch.float32, tile_r=None,
                         interpret=False, *, device="cuda",
                         layout: PaddedLayout = None):
    """(apply_padded, pad, unpad, shape) for a 2D StencilOperator, as in
    gdm, with gdm's parameters in gdm's order; ``layout`` defaults to the
    operator's own radius.  ``tile_r``, gdm's row tile (sized to the
    TPU's VMEM), is taken and has no effect: K1's tile comes from
    ``k1_plan`` (at most 32 cells across), and the tile does not change
    the function.  A value that is not a positive integer raises
    ValueError.  ``interpret`` (gdm's TPU interpreter) is taken and has
    no effect."""
    dtype = _device.resolve_dtype(dtype)
    positive_int("tile_r", tile_r)
    if layout is None:
        layout = layout_for(st.grid, st.radius)
    bp = band_planes(st, layout, _device.resolve(device), dtype)

    def apply_padded(u_pad):
        return band_apply(u_pad, bp)

    return apply_padded, layout.pad, layout.unpad, layout.shape
