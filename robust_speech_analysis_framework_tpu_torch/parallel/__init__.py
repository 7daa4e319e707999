"""Multi-device runs: the (dp, mp) device grid, the parameter and batch
rules over it, and the multi-host helpers."""

from .mesh import DeviceGrid, auto_mesh, in_threads, make_mesh, mesh_axes, resolve_mesh
from .sharding import (
    DEFAULT_PARAM_RULES,
    batch_sharding,
    gather,
    place_params,
    replicate,
    shard_params,
    split_dim,
)

__all__ = [
    "DeviceGrid",
    "auto_mesh",
    "in_threads",
    "make_mesh",
    "mesh_axes",
    "resolve_mesh",
    "DEFAULT_PARAM_RULES",
    "batch_sharding",
    "gather",
    "place_params",
    "replicate",
    "shard_params",
    "split_dim",
]
