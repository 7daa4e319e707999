"""WavLM's work, counted from shapes at real (unpadded) lengths: the model
FLOPs of a chunk and the least time of the relative-position softmax kernel.

FLOPs count the products, 2 operations a multiply-add: the seven convs, the
feature projection, the positional conv, q/k/v/out, the two T × T products
(scores and context), the FFN and the gate's 64 → 8 product of each head.
Norms, GELU, the softmax and the bias are left out, so a share of the peak
is a floor.

The kernel (``wavlm_relpos_softmax_kernel``) reads each score once and
writes its probability over it: 8 bytes a real (query, key) pair, head and
layer, over the published HBM rate (``peaks.PEAK_HBM_BYTES``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

from .peaks import PEAK_HBM_BYTES

GATE_OUTPUTS = 8
BYTES_PER_PAIR = 8  # a float32 score read, a float32 probability written


def frames(cfg: Mapping, n_samples: int) -> int:
    """Frames the conv stack makes of ``n_samples`` samples."""
    t = int(n_samples)
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
    return t


def chunk_flops(cfg: Mapping, n_samples: int) -> float:
    """Forward FLOPs of the WavLM encoder over one chunk of ``n_samples``."""
    t, in_dim, total = int(n_samples), 1, 0.0
    for dim, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
        total += 2 * t * dim * in_dim * k
        in_dim = dim
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    total += 2 * t * in_dim * d  # feature projection
    total += 2 * t * d * (d // cfg["pos_conv_groups"]) * cfg["pos_conv_kernel"]
    per_layer = (4 * 2 * t * d * d  # q, k, v, out
                 + 2 * 2 * t * t * d  # scores and context
                 + 2 * 2 * t * d * ff  # the FFN
                 + 2 * t * d * GATE_OUTPUTS)  # each head's 64 → 8 gate product
    return total + cfg["num_layers"] * per_layer


def relpos_softmax_bound_ms(cfg: Mapping, chunk_frames: Sequence[int]) -> float:
    """Least time (ms) of the kernel over chunks of ``chunk_frames`` real
    frames, every layer and head: their real pairs' bytes at the HBM rate."""
    pairs = sum(int(t) ** 2 for t in chunk_frames)
    return BYTES_PER_PAIR * pairs * cfg["num_heads"] * cfg["num_layers"] / PEAK_HBM_BYTES * 1e3
