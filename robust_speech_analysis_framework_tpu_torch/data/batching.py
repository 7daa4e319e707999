"""Ragged-sequence batching with bucketed padding (numpy).

Copy of ``robust_speech_analysis_framework_tpu/data/batching.py``: padded
lengths are rounded up a geometric bucket ladder, so a server sees a
bounded set of shapes; training batches are shuffled by
``np.random.RandomState(seed)``, in the JAX package's order.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def bucket_length(t: int, min_bucket: int = 64, growth: float = 2.0) -> int:
    """Smallest ladder value ≥ t: min_bucket * growth^k."""
    if t <= min_bucket:
        return min_bucket
    k = math.ceil(math.log(t / min_bucket) / math.log(growth))
    return int(round(min_bucket * growth**k))


def pad_batch(
    sequences: Sequence[np.ndarray],
    min_bucket: int = 64,
    growth: float = 2.0,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a list of (T_i, D) arrays to a shared bucketed length.

    Returns ``(batch, lengths)`` with batch (B, T_bucket, D) float32 and
    lengths (B,) int32. Sequences longer than ``max_len`` are truncated.
    """
    lens = [len(s) for s in sequences]
    t_cap = max(lens)
    if max_len is not None:
        t_cap = min(t_cap, max_len)
    t_pad = bucket_length(t_cap, min_bucket, growth)
    d = sequences[0].shape[1]
    out = np.zeros((len(sequences), t_pad, d), dtype=np.float32)
    lengths = np.zeros(len(sequences), dtype=np.int32)
    for i, s in enumerate(sequences):
        # Truncate to the cap (not the bucket round-up): lengths must never
        # exceed max_len even when the bucket ladder overshoots it.
        t = min(len(s), t_cap)
        out[i, :t] = s[:t]
        lengths[i] = t
    return out, lengths


def batch_iterator(
    sequences: Sequence[np.ndarray],
    labels: Sequence[int],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    min_bucket: int = 64,
    growth: float = 2.0,
    max_len: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (padded_batch, lengths, labels) minibatches.

    With ``shuffle``, order is drawn from ``np.random.RandomState(seed)``
    so epochs are reproducible.
    """
    n = len(sequences)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    labels = np.asarray(labels)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        batch, lengths = pad_batch(
            [sequences[i] for i in idx], min_bucket, growth, max_len
        )
        yield batch, lengths, labels[idx]


def length_sorted_batches(
    sequences: Sequence[np.ndarray], batch_size: int
) -> List[np.ndarray]:
    """Index batches grouping similar lengths together (inference-time
    throughput: minimizes padding waste and compile count)."""
    order = np.argsort([len(s) for s in sequences], kind="stable")
    return [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
