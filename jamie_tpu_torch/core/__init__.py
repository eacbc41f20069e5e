"""Host helpers, dtype/device policy, the device mesh and timing."""

from .mesh import create_mesh, data_sharding, replicated_sharding, shard_rows
from .dtypes import resolve_dtype
from .timing import TimeLogger

__all__ = [
    'create_mesh', 'data_sharding', 'replicated_sharding', 'shard_rows',
    'resolve_dtype', 'TimeLogger',
]
