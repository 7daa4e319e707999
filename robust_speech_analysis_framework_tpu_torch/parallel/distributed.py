"""Multi-host initialisation and cross-host helpers.

Counterpart of ``robust_speech_analysis_framework_tpu/parallel/distributed.py``.
Inside one host a :class:`.mesh.DeviceGrid` drives every device from one
process; across hosts, one process a host joins a ``torch.distributed``
process group. :func:`initialize_distributed` reads torchrun's contract
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) where the JAX
package reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``, and picks NCCL for the card and gloo for the CPU.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> bool:
    """Join the process group when running multi-host; no-op otherwise.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``;
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).
    A world of one (or none given) returns False and initialises nothing.
    The backend is NCCL for ``device="cuda"`` (which raises on a host
    without a card) and gloo for ``device="cpu"``. Returns True when a
    process group was initialised.
    """
    world_size = world_size or _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if not world_size or world_size <= 1:
        return False
    dev = resolve_device(device)
    if init_method is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT") if not os.environ.get(v)]
        if missing:
            raise ValueError(f"WORLD_SIZE={world_size} but {' and '.join(missing)} not set")
        init_method = "env://"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank or 0)
    return True


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def shard_file_list(paths: Sequence[str]) -> list:
    """This process's slice of a corpus file list: a contiguous block of an
    even split over the process group's ranks (the whole list outside one).
    The cross-host half of data-parallel extraction; within a host the dp
    rows of a device grid split the files further."""
    n_proc, pid = _world()
    bounds = np.linspace(0, len(paths), n_proc + 1).astype(int)
    return list(paths[bounds[pid] : bounds[pid + 1]])


def all_gather_host_objects(obj: Any) -> List[Any]:
    """A small picklable object from every process, in rank order
    (``torch.distributed.all_gather_object``); ``[obj]`` outside a process
    group."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
