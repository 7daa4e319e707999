"""Length bucketing for the openSMILE extractor (numpy).

Files are grouped by a geometric ladder of padded lengths, so a corpus of
variable-length files runs as a few stacked batches. The buckets are the
JAX package's exactly: the pitch path finder runs over the padded frames,
so a different bucket would give it a different tail.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_MIN_BUCKET = 64
_GROWTH = 1.5


def bucket_size(n: int, min_bucket: int = _MIN_BUCKET, growth: float = _GROWTH) -> int:
    """The smallest rung of ``min_bucket · growth^k`` (k ≥ 0, rounded up) ≥ n."""
    if n <= min_bucket:
        return min_bucket
    k = math.ceil(math.log(n / min_bucket) / math.log(growth))
    return int(math.ceil(min_bucket * growth**k))


def pad_frames(frames: np.ndarray, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad ``frames`` along ``axis`` to its bucket size by edge replication.

    Returns (padded, true_count); unchanged when already on a rung.
    """
    n = frames.shape[axis]
    target = bucket_size(n)
    if target == n:
        return frames, n
    pad_widths = [(0, 0)] * frames.ndim
    pad_widths[axis] = (0, target - n)
    return np.pad(frames, pad_widths, mode="edge"), n
