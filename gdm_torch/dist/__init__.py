from .mesh import Mesh, device_mesh, shard_field, replicate  # noqa: F401
from .halo import banded_apply_sharded, halo_pad  # noqa: F401
