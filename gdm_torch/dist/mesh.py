"""Device mesh and sharding helpers.

Port of gdm/dist/mesh.py, gdm's replacement for the reference's MPI
slab decomposition (include/gdm/system.h:703-761: a 1-D partition of
the structured grid with a ghost layer).  As in gdm, one controller
drives every shard: a ``Mesh`` is one named axis over a list of shard
slots, each a ``torch.device``, and node fields are split along grid
axis 0 into one block a slot.  There is no ``torch.distributed``
process group: gdm's callers pass one mesh object to
``WaveProblem(mesh=...)`` from one process, and so do the port's.

Slot i lives on ``cuda:(i % torch.cuda.device_count())``, so a mesh may
hold more slots than the machine has cards and several shards then
share a card (gdm's mesh has one device a shard).  ``Mesh.n_cards``
says how many cards a mesh spans; reports give it beside the slot
count.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as _device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One named mesh axis over shard slots, each a ``torch.device``."""
    axis: str
    devices: tuple

    @property
    def shape(self) -> dict:
        """{axis: slots}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """The distinct devices the slots lie on."""
        return len(set(self.devices))


def device_mesh(n_devices: int = None, axis: str = "x",
                device="cuda") -> Mesh:
    """A mesh of ``n_devices`` slots (default: one a card) along
    ``axis``: slot i on ``cuda:(i % cards)``, or on the CPU for
    ``device="cpu"``.  Without a card a CUDA mesh raises, as every
    entry point of the port does."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n = cards if n_devices is None else int(n_devices)
        slots = tuple(torch.device("cuda", i % cards) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        slots = (dev,) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, not {n}")
    return Mesh(axis, slots)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself when it is a port ``Mesh``; anything else (gdm's
    ``jax.sharding.Mesh`` among them) raises TypeError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a gdm_torch.dist.mesh.Mesh (device_mesh(n)), "
            f"not {type(mesh).__name__}")
    return mesh


def shard_field(u: torch.Tensor, mesh: Mesh, axis: str = "x") -> list:
    """A node field split along grid axis 0 into one block a slot, each
    on its slot's device (blocks differ in length by at most one)."""
    n = check_mesh(mesh).shape[axis]
    return [b.to(d) for b, d in zip(torch.tensor_split(u, n, dim=0),
                                    mesh.devices)]


def replicate(u: torch.Tensor, mesh: Mesh) -> list:
    """One copy of ``u`` a slot, each on its slot's device."""
    return [u.to(d) for d in check_mesh(mesh).devices]
