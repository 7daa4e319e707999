"""Results left on the device until the caller asks for them.

Counterpart of ``Deferred`` and ``collect`` in
``robust_speech_analysis_framework_tpu/ops/framing.py`` (the corpus buffer
and the frame gathers of that module come with the MSHDS extractor). A
``Deferred`` holds device tensors whose kernels are already queued, and a
finalizer that turns their host copies into the operation's return value.
:func:`collect` copies a whole list of them to the host behind ONE
synchronisation, so a CV engine that has queued every fold's eval pass
waits for the card once, not once per fold.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``tree`` (a tensor, or lists/tuples of them, nested) with ``fn``
    applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(node, fn) for node in tree)
    return tree


def _to_host(tree: Any) -> Any:
    """``tree`` with every tensor as a numpy array. CUDA tensors are copied
    into pinned buffers without blocking, then the device is synchronised
    once for all of them."""
    on_card = []

    def stage(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type != "cuda":
            return t
        on_card.append(t)
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)

    staged = _map_tensors(tree, stage)
    if on_card:
        torch.cuda.synchronize()
    return _map_tensors(staged, torch.Tensor.numpy)


class Deferred:
    """A queued-but-unfetched result: ``arrays`` holds the tensors still on
    the device, ``finalize`` turns their host copies (numpy arrays in the
    same nesting) into the operation's normal return value."""

    __slots__ = ("arrays", "finalize")

    def __init__(self, arrays: Any, finalize: Callable[[Any], Any]):
        self.arrays = arrays
        self.finalize = finalize

    def result(self):
        return self.finalize(_to_host(self.arrays))

    @staticmethod
    def ready(value) -> "Deferred":
        """A Deferred wrapping an already-final value."""
        return Deferred((), lambda _: value)


def collect(deferreds: List[Deferred]) -> List[Any]:
    """Every Deferred's result, in order: all their tensors are copied to
    the host behind one synchronisation, then each finalizer runs."""
    host = _to_host([d.arrays for d in deferreds])
    return [d.finalize(h) for d, h in zip(deferreds, host)]

