"""The (dp, mp) device grid for multi-device extraction and training.

Counterpart of ``robust_speech_analysis_framework_tpu/parallel/mesh.py``.
The JAX package lays a logical ``(dp, mp)`` mesh over its chips and lets one
controller program them all; here a :class:`DeviceGrid` lays the same axes
over a list of ``torch.device`` s and one process drives every device of it,
each from its own CUDA stream:

* ``dp`` (data): batches of files, chunks, sequences or trial lanes split
  over the rows of the grid;
* ``mp`` (model): the rule-matched parameters of a model
  (:mod:`.sharding`) split over the devices of a row.

A device may appear more than once in the list (``[cuda:0, cuda:0]`` on a
one-card machine, ``[cpu] * n`` in the tests): every multi-device path then
runs its split over the same device, which checks the split's arithmetic
and measures its overhead but not a speed-up. ``torch.distributed`` is used
only by the multi-host helpers (:mod:`.distributed`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..device import DeviceLike, fp32_convs, resolve_device


def mesh_axes() -> Tuple[str, str]:
    return ("dp", "mp")


class DeviceGrid:
    """``dp`` rows of ``mp`` devices. ``rows[r][c]`` is the device at
    (dp index r, mp index c); ``shape`` is ``{"dp": dp, "mp": mp}`` as a JAX
    mesh's is."""

    axis_names = mesh_axes()

    def __init__(self, devices: Sequence[DeviceLike], mp: int = 1):
        devs = [_indexed(torch.device(d)) for d in devices]
        n = len(devs)
        if mp < 1 or n % mp != 0:
            raise ValueError(f"mp={mp} does not divide device count {n}")
        if n == 0:
            raise ValueError("a device grid needs at least one device")
        self.rows: List[List[torch.device]] = [devs[r * mp : (r + 1) * mp]
                                               for r in range(n // mp)]

    @property
    def dp(self) -> int:
        return len(self.rows)

    @property
    def mp(self) -> int:
        return len(self.rows[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the grid, row by row (repeats kept)."""
        return [d for row in self.rows for d in row]

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def lead(self) -> torch.device:
        """The device at (0, 0): where a multi-device result is gathered."""
        return self.rows[0][0]

    def row_leads(self) -> List[torch.device]:
        """The first device of each dp row."""
        return [row[0] for row in self.rows]

    def __repr__(self) -> str:
        return f"DeviceGrid(dp={self.dp}, mp={self.mp}, devices={[str(d) for d in self.devices]})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device (``cuda:k``), so that devices of a
    grid compare equal to the devices their tensors report."""
    return resolve_device(dev) if dev.type == "cuda" and dev.index is None else dev


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() without devices= lays the grid over the CUDA devices, and "
            "torch.cuda.is_available() is False; pass devices=[torch.device('cpu')] * n "
            "to run the multi-device paths on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    mp: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> DeviceGrid:
    """A (dp, mp) grid over ``n_devices`` of ``devices`` (default: every CUDA
    device; raises without a card). ``mp`` must divide the device count;
    ``dp = n_devices / mp``. Asking for more devices than the list holds
    raises."""
    devs = list(devices) if devices is not None else _cuda_devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices, {len(devs)} available")
        devs = devs[:n_devices]
    return DeviceGrid(devs, mp)


def auto_mesh(n_devices: Optional[int] = None, mp: int = 1) -> Optional[DeviceGrid]:
    """A grid over the CUDA devices when there are at least two, else None:
    on one card (or none) every ``mesh=`` argument stays None and the
    single-device paths run unchanged."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if n_devices is None else min(n_devices, avail)
    if n <= 1:
        return None
    return make_mesh(n_devices=n, mp=mp)


MeshLike = Union[str, DeviceGrid, None]


def resolve_mesh(mesh: MeshLike, device: DeviceLike = "cuda") -> Optional[DeviceGrid]:
    """``mesh="auto"`` → :func:`auto_mesh` when ``device`` is the card, None
    on the CPU (a CPU grid is asked for explicitly); a grid or None passes
    through."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', a DeviceGrid, or None; got {mesh!r}")
        return auto_mesh() if resolve_device(device).type == "cuda" else None
    if mesh is not None and not isinstance(mesh, DeviceGrid):
        raise TypeError(f"mesh must be 'auto', a DeviceGrid, or None; got {type(mesh).__name__}")
    return mesh


def in_threads(fn: Callable[[int], Any], n: int) -> List[Any]:
    """``[fn(0), ..., fn(n - 1)]``, each call from its own host thread (one
    alone runs in the caller's): how one process drives several devices at
    once. Convolutions stay IEEE float32 throughout: the flag that
    :func:`..device.fp32_convs` sets is process-wide, so it is held here
    around every thread's nested use. The first error propagates."""
    if n == 1:
        return [fn(0)]
    import concurrent.futures

    with fp32_convs(), concurrent.futures.ThreadPoolExecutor(max_workers=n) as pool:
        return list(pool.map(fn, range(n)))
