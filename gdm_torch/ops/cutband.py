"""K1: the 2D stencil-band apply on the padded layout.

Port of gdm/ops/pallas_cutband.py (``make_padded_stencil2``, the TPU
kernel under gdm/cut/fastapply.py::fast_stencil_bundle).  The CUDA
kernel is gdm_torch/csrc/cutband.cu; its source note says what bounds it
on the card.  ``band_apply`` launches it for a CUDA tensor and runs the
plain torch version ``band_apply_plain`` for a CPU tensor; there is no
other switch.

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
            "the padded band kernels are 2D; 3D is ROADMAP Queue 1, item 11")
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


def band_apply(u: torch.Tensor, bp: BandPlanes) -> torch.Tensor:
    """y = band * u on the padded layout: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    _check(u, bp)
    if u.device.type == "cpu":
        return band_apply_plain(u, bp)
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
            lay.r, _build.stream_handle(u.device))
    _build.check(kl, err, "cutband apply launch")
    band_apply.launches += 1
    return y


band_apply.launches = 0


def make_padded_stencil2(st, device="cuda", dtype=torch.float32,
                         layout: PaddedLayout = None, tile_r=None):
    """(apply_padded, pad, unpad, shape) for a 2D StencilOperator, as in
    gdm; ``layout`` defaults to the operator's own radius.  ``tile_r``,
    gdm's row tile (sized to the TPU's VMEM), is taken and has no effect:
    K1 has no row tile (one thread per node, 32 x 8 nodes per block), and
    the tile does not change the function.  A value that is not a
    positive integer raises ValueError."""
    positive_int("tile_r", tile_r)
    if layout is None:
        layout = layout_for(st.grid, st.radius)
    bp = band_planes(st, layout, _device.resolve(device), dtype)

    def apply_padded(u_pad):
        return band_apply(u_pad, bp)

    return apply_padded, layout.pad, layout.unpad, layout.shape
