"""The Conformer's work, counted from shapes at real (unpadded) lengths: the
model FLOPs of a chunk and of a batch's position rows, and the least time of
the relative-position score stage.

FLOPs count the products, 2 operations a multiply-add: the seven convs, the
feature projection, q/k/v/out, the two T × T products (scores and context),
the position term at the chunk's real pairs (one 64-term dot product a pair
and head), both FFNs, the conv module's two pointwise products and its
depthwise taps; and, once a batch, ``pos`` over the batch's 2T − 1 rows.
Norms, activations, the softmax and the BatchNorm are left out, so a share
of the peak is a floor.

The score stage (``conformer_relpos_softmax_kernel`` on the card) must read
each real (query, key) pair's score and write its probability, 8 bytes a
pair, head and layer, at the published HBM rate (``peaks.PEAK_HBM_BYTES``),
and take its position dot product, 2 · head size operations, at the fp32
peak (``peaks.PEAK_FP32_FLOPS``): its least time is the larger of the two,
whatever implements the stage.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

from .peaks import PEAK_FP32_FLOPS, PEAK_HBM_BYTES
from .wavlm_counts import BYTES_PER_PAIR, frames  # noqa: F401  the same conv stack and score pass


def chunk_flops(cfg: Mapping, n_samples: int) -> float:
    """Forward FLOPs of the Conformer encoder over one chunk of ``n_samples``,
    without the batch's position rows (:func:`batch_flops`)."""
    t, in_dim, total = int(n_samples), 1, 0.0
    for dim, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
        total += 2 * t * dim * in_dim * k
        in_dim = dim
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    total += 2 * t * in_dim * d  # feature projection
    per_layer = (4 * 2 * t * d * d  # q, k, v, out
                 + 2 * 2 * t * t * d  # scores and context
                 + 2 * t * t * d  # the position term: a 64-term dot product a pair and head
                 + 2 * 2 * 2 * t * d * ff  # the two FFNs
                 + 2 * t * d * 2 * d + 2 * t * d * d  # the two pointwise products
                 + 2 * t * d * cfg["conv_depthwise_kernel_size"])  # the depthwise taps
    return total + cfg["num_layers"] * per_layer


def batch_flops(cfg: Mapping, t_pad: int) -> float:
    """FLOPs of ``pos`` over a batch's 2T − 1 position rows, every layer."""
    d = cfg["hidden_size"]
    return cfg["num_layers"] * 2 * (2 * t_pad - 1) * d * d


def relpos_score_bound(cfg: Mapping, chunk_frames: Sequence[int]) -> Tuple[float, str]:
    """Least time (ms) of the score stage over chunks of ``chunk_frames``
    real frames, every layer and head: the larger of their real pairs' bytes
    at the HBM rate and their position dot products at the fp32 peak; and
    which of the two sets it, ``"bytes"`` or ``"operations"``."""
    pairs = sum(int(t) ** 2 for t in chunk_frames) * cfg["num_heads"] * cfg["num_layers"]
    head = cfg["hidden_size"] // cfg["num_heads"]
    by_bytes = BYTES_PER_PAIR * pairs / PEAK_HBM_BYTES * 1e3
    by_ops = 2 * head * pairs / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def relpos_score_bound_ms(cfg: Mapping, chunk_frames: Sequence[int]) -> float:
    """:func:`relpos_score_bound`'s time alone."""
    return relpos_score_bound(cfg, chunk_frames)[0]
