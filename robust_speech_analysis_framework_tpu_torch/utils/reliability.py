"""Determinism checks and batch downshift on device memory exhaustion.

Counterpart of ``robust_speech_analysis_framework_tpu/utils/reliability.py``:

* :func:`deterministic_check`: the same call twice gives the same bits;
* :func:`with_oom_downshift`: a batched call retried on halves when the
  card runs out of memory (``torch.cuda.OutOfMemoryError``), the output
  order kept.

``retry_transient`` is not carried: a card error propagates.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np
import torch


def _leaves(tree: Any) -> List[np.ndarray]:
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [np.asarray(tree)]


def deterministic_check(fn: Callable, *args, runs: int = 2) -> bool:
    """True iff ``fn(*args)`` gives bitwise-identical results (tensors,
    arrays, or lists/tuples/dicts of them; NaNs equal) on every run."""
    first = _leaves(fn(*args))
    for _ in range(runs - 1):
        other = _leaves(fn(*args))
        if len(other) != len(first):
            return False
        for a, b in zip(first, other):
            if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=True):
                return False
    return True


def with_oom_downshift(
    fn: Callable[[Sequence], List],
    items: Sequence,
    min_batch: int = 1,
) -> List:
    """``fn`` over ``items`` as one batch; when it raises
    ``torch.cuda.OutOfMemoryError``, over each half in turn, recursively,
    down to ``min_batch`` items. ``fn`` takes a list and returns one result
    an item, in order. Every other error propagates."""
    items = list(items)
    if not items:
        return []
    try:
        return list(fn(items))
    except torch.cuda.OutOfMemoryError:
        if len(items) <= min_batch:
            raise
    mid = len(items) // 2
    return with_oom_downshift(fn, items[:mid], min_batch) + with_oom_downshift(
        fn, items[mid:], min_batch)
