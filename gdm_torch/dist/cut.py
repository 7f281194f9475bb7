"""Sharded execution of the cut operators (stencil-band form).

Port of gdm/dist/cut.py.  The reference runs the cut wave and advection
applications under MPI: a ghost exchange around every matrix-free apply
(applications/wave/include/gdm/wave/stiffness.h:149, 406) and the slab
partition of include/gdm/system.h:703-761.  gdm shards the assembled
stencil band (``cut.stencil.StencilOperator``) along grid axis 0 of a
1-D mesh and exchanges halos with ``shard_map`` + ``ppermute``; the cut
tables themselves stay on the host as in the serial build, so a
sharded apply equals the serial one in exact arithmetic.

The node count along axis 0 need not divide by the slot count: the
operator is padded with identity rows (band = e_center, u = 0), which
leaves every CG iterate on the data rows unchanged.

Inside a shard the port sweeps as the tensor's device allows: on a
CUDA shard of a 2D grid, K1 (``ops.cutband.band_apply``) on the shard's
own padded layout, ``PaddedLayout(loc, N1, r)``, whose guard rows along
axis 0 hold the halo planes received from the neighbours (its guard
columns stay zero); its planes are the global band's rows of that
shard, over the whole band's taps, built once per slot and dtype.
Elsewhere (the CPU, 1D, 3D) gdm's ``_sweep``, the plain tap loop.  gdm
sweeps with XLA inside each shard, on every platform.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..cut.stencil import StencilOperator
from ..ops import cutband
from .halo import halo_fill
from .mesh import Mesh, check_mesh


def _tap_order(radius: int, dim: int) -> list:
    """gdm's tap order: flat offset k, axis 0's index fastest."""
    K = 2 * radius + 1
    return [idx[::-1] for idx in itertools.product(range(K), repeat=dim)]


def _sweep(up, taps, out_shape):
    """gdm's ``_sweep``: y[i] = sum_off band[i, off] * up[i + off] on
    halo-padded blocks (padded by the radius on every axis; a leading
    batch axis of shards sharing a device), over ``taps``, the pairs
    (band[..., off], offset slices) in gdm's tap order."""
    y = up.new_zeros(out_shape)
    for b, sl in taps:
        # in place into these shards' own output
        y.addcmul_(b, up[sl])
    return y


def sharded_stencil_apply(op: StencilOperator, mesh: Mesh, axis: str = "x"):
    """Return ``apply(u_flat) -> y_flat`` equal to ``op.apply`` but
    executed with axis-0 domain decomposition over ``mesh``: a halo
    exchange of ``radius`` node planes per apply.  u and y are whole on
    u's device (gdm's single controller sees global arrays; a CG over
    this apply keeps its vectors there); each shard computes on its
    slot's device.  ``apply.loc`` is a shard's node planes along axis 0."""
    grid = op.grid
    r = op.radius
    dim = grid.dim
    n = check_mesh(mesh).shape[axis]
    nodes = grid.nodes
    N0 = nodes[0]
    # pad axis 0 so shards are equal and at least r wide
    loc = max(-(-N0 // n), r)
    L = n * loc
    K = 2 * r + 1
    band = np.zeros((L,) + nodes[1:] + (K,) * dim)
    band[:N0] = np.asarray(op.band_host)
    band[N0:][(Ellipsis,) + (r,) * dim] = 1.0  # identity pad rows
    blocks = [band[s * loc:(s + 1) * loc] for s in range(n)]
    taps = cutband.band_taps(band, r) if dim == 2 else None
    layout = cutband.PaddedLayout(loc, nodes[1], r) if dim == 2 else None
    # the shards that sweep share their device's buffers: one batched
    # sweep a device, the slots' blocks along a leading axis
    groups = {}
    for s, d in enumerate(mesh.devices):
        if not (dim == 2 and d.type == "cuda"):
            groups.setdefault(d, []).append(s)
    # a block's node columns in its buffer, past the r-wide guard
    cols = tuple(slice(r, r + n_d) for n_d in nodes[1:])
    cache = {}

    def state(dtype):
        """Each slot's halo-padded input buffer (its node block at rows
        [r, r + loc) and ``cols``; pad rows and guard columns stay zero,
        as each apply writes only the data's rows and the guard rows)
        and the device work: K1's planes a CUDA slot of a 2D grid, the
        tap views of a device's batched band elsewhere; built once per
        dtype."""
        if dtype not in cache:
            bufs, k1 = [None] * n, {}
            for s, d in enumerate(mesh.devices):
                if dim == 2 and d.type == "cuda":
                    k1[s] = cutband.planes_of(blocks[s], r, layout, d, dtype,
                                              taps)
                    bufs[s] = torch.zeros(layout.shape, dtype=dtype,
                                          device=d)
            sweeps = []
            for d, slots in groups.items():
                gbuf = torch.zeros((len(slots), loc + 2 * r)
                                   + tuple(n_d + 2 * r for n_d in nodes[1:]),
                                   dtype=dtype, device=d)
                gband = torch.as_tensor(np.stack([blocks[s] for s in slots]),
                                        dtype=dtype, device=d)
                views = []
                for idx in _tap_order(r, dim):
                    sl = (slice(None),) + tuple(
                        slice(i, i + m)
                        for i, m in zip(idx, (loc,) + nodes[1:]))
                    views.append((gband[(Ellipsis,) + tuple(idx)], sl))
                sweeps.append((slots, gbuf, views))
                for j, s in enumerate(slots):
                    bufs[s] = gbuf[j]
            cache[dtype] = (bufs, k1, sweeps)
        return cache[dtype]

    def apply_fn(u_flat: torch.Tensor) -> torch.Tensor:
        u = u_flat.reshape(nodes)
        bufs, k1, sweeps = state(u.dtype)
        for s, buf in enumerate(bufs):
            lo, hi = s * loc, min((s + 1) * loc, N0)
            if hi > lo:
                buf[(slice(r, r + hi - lo),) + cols].copy_(u[lo:hi])
        halo_fill(bufs, r)
        ys = [None] * n
        for s, planes in k1.items():
            ys[s] = layout.interior(cutband.band_apply(bufs[s], planes))
        for slots, gbuf, views in sweeps:
            y = _sweep(gbuf, views, (len(slots), loc) + nodes[1:])
            for j, s in enumerate(slots):
                ys[s] = y[j]
        return torch.cat([y.to(u.device) for y in ys],
                         dim=0)[:N0].reshape(-1)

    apply_fn.loc = loc
    return apply_fn
