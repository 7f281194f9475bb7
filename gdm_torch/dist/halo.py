"""Halo exchange between the shards of a mesh axis.

Port of gdm/dist/halo.py.  The banded GD operator touches p rows on
each side of a shard boundary; the exchange ships exactly those node
planes, as the reference's update_ghost_values/compress pair
(applications/wave/include/gdm/wave/stiffness.h:149, 406).  gdm does it
with two ``ppermute``s inside ``shard_map``; the port's one controller
copies the planes between the slots' tensors (a peer copy where two
slots lie on different cards, none where they share one).  The global
ends receive zeros, the banded matrix's out-of-range convention.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, check_mesh


def halo_fill(pads: list, width: int) -> list:
    """Fill, in place, the ``width`` guard planes at each end of every
    halo-padded block (leading length N_i + 2 width, N_i >= width) with
    its neighbours' edge planes: the left guard from the left
    neighbour's last interior planes, the right guard from the right
    neighbour's first.  The global ends are left as they are.  Returns
    ``pads``."""
    w = width
    for i, pad in enumerate(pads):
        if i > 0:
            pad[:w].copy_(pads[i - 1][-2 * w:-w])
        if i < len(pads) - 1:
            pad[-w:].copy_(pads[i + 1][w:2 * w])
    return pads


def halo_pad(blocks: list, width: int, axis_name: str = "x") -> list:
    """Each shard's block with ``width`` planes from each neighbour
    along axis 0 (leading length N_local + 2 width), zeros at the ends
    of the global domain; the blocks are a slot's each, in slot order,
    each on its slot's device.  ``axis_name`` is gdm's and names the
    one mesh axis."""
    return halo_fill([torch.nn.functional.pad(
        b, (0, 0) * (b.ndim - 1) + (width, width)) for b in blocks], width)


def banded_apply_sharded(u: torch.Tensor, band: torch.Tensor, mesh: Mesh,
                         axis: str = "x") -> torch.Tensor:
    """y = Band @ u along the leading axis, computed shard by shard over
    ``mesh`` with a halo exchange of p planes; u, band and y whole on
    u's device (the controller's view, as gdm's global arrays).  A shard
    narrower than p raises gdm's ValueError."""
    p = (band.shape[1] - 1) // 2
    n_shards = check_mesh(mesh).shape[axis]
    if u.shape[0] < n_shards * p:
        raise ValueError(
            f"shard width {u.shape[0]}/{n_shards} < halo width {p}: the "
            f"single-hop ppermute halo needs >= {p} rows per device "
            f"(use fewer devices or a larger grid)"
        )
    blocks = torch.tensor_split(u, n_shards, dim=0)
    bands = torch.tensor_split(band, n_shards, dim=0)
    ups = halo_pad([b.to(d) for b, d in zip(blocks, mesh.devices)], p, axis)
    ys = []
    for up, bb, d in zip(ups, bands, mesh.devices):
        bb = bb.to(d)
        N = bb.shape[0]
        bshape = (N,) + (1,) * (up.ndim - 1)
        y = up.new_zeros((N,) + tuple(up.shape[1:]))
        for k in range(2 * p + 1):
            # in place into this shard's own output
            y.addcmul_(bb[:, k].reshape(bshape), up[k:k + N])
        ys.append(y.to(u.device))
    return torch.cat(ys, dim=0)
