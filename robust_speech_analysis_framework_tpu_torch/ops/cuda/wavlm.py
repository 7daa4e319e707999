"""WavLM's gated relative-position softmax: the hand-written CUDA kernel and
its plain PyTorch version.

For attention scores ``(q · s) · kᵀ`` of shape (B, H, T, T), per-query
gates (B, H, T), the relative-position table (NB, H), the bucket of each of
the 2T − 1 distances j − i (``buckets[j − i + T − 1]``) and the valid keys
of each row (B,), both compute

    x[b, h, i, j] = scores[b, h, i, j] + gates[b, h, i] · table[buckets[j − i + T − 1], h]
    p[b, h, i, :] = softmax of x over the keys j < lengths[b]; 0 at the others

(a row with no valid key is all zeros). The JAX package has no WavLM, so
there is no Pallas kernel behind it.

* :func:`relpos_softmax`: on CUDA one launch of ``csrc/wavlm_relpos.cu``
  that reads each score once and writes its probability over it: the
  scores tensor is returned, now holding the probabilities, and the T × T
  bias is never formed. On CPU tensors it returns the plain version.
* :func:`relpos_softmax_reference`: the plain version, which gathers the
  (H, T, T) bias, multiplies by the gates, adds, masks and takes
  ``torch.softmax``: a new tensor.

Dispatch goes by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. There is no fallback between them.
``relpos_softmax.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from ._build import call as _call

MAX_ROWS = 65_535  # B · H: the launch grid's second dimension


def relpos_softmax_reference(scores: torch.Tensor, gates: torch.Tensor, table: torch.Tensor,
                             buckets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, H, T, T) probabilities, a new float32 tensor."""
    t = scores.shape[-1]
    pos = torch.arange(t, device=scores.device)
    dist = buckets.long()[pos[None, :] - pos[:, None] + t - 1]  # (T, T) buckets
    bias = table[dist].permute(2, 0, 1)  # (H, T, T)
    x = scores + gates[..., None] * bias
    valid = (pos[None, :] < lengths.long().clamp(0, t)[:, None])[:, None, None, :]
    probs = torch.softmax(x.masked_fill(~valid, float("-inf")), dim=-1)
    return torch.where(valid, probs, 0.0)


def _check(scores, gates, table, buckets, lengths) -> None:
    if scores.ndim != 4 or scores.shape[2] != scores.shape[3]:
        raise ValueError(f"expected scores (B, H, T, T), got {tuple(scores.shape)}")
    b, h, t, _ = scores.shape
    if gates.shape != (b, h, t):
        raise ValueError(f"expected gates of {(b, h, t)}, got {tuple(gates.shape)}")
    if table.ndim != 2 or table.shape[1] != h:
        raise ValueError(f"expected table (NB, {h}), got {tuple(table.shape)}")
    if buckets.shape != (max(2 * t - 1, 0),):
        raise ValueError(f"expected buckets of ({2 * t - 1},), got {tuple(buckets.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"expected lengths of ({b},), got {tuple(lengths.shape)}")
    tensors = (scores, gates, table, buckets, lengths)
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"inputs on {[str(x.device) for x in tensors]}")


def relpos_softmax(scores: torch.Tensor, gates: torch.Tensor, table: torch.Tensor,
                   buckets: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The gated relative-position softmax (module docstring). On CUDA the
    probabilities overwrite ``scores``, which is returned; ``buckets`` must
    hold buckets in [0, NB) (the kernel does not check them). Inference
    only: the kernel has no backward."""
    _check(scores, gates, table, buckets, lengths)
    if scores.device.type == "cpu":
        return relpos_softmax_reference(scores, gates, table, buckets, lengths)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    b, h, t, _ = scores.shape
    if b * h > MAX_ROWS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} (batch, head) rows, got {b * h}")
    if not all(x.dtype == torch.float32 for x in (scores, gates, table)):
        raise TypeError(f"expected float32 scores, gates and table, got "
                        f"{[x.dtype for x in (scores, gates, table)]}")
    if buckets.dtype != torch.int32:
        raise TypeError(f"expected int32 buckets, got {buckets.dtype}")
    if not scores.is_contiguous():
        raise ValueError("the kernel writes the probabilities over contiguous scores")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (scores, gates, table)):
        raise RuntimeError("relpos_softmax has no backward on CUDA: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if b * h * t == 0:
        return scores
    _call("wavlm_relpos", "wavlm_relpos_softmax_f32", scores.device, scores,
          gates.contiguous(), table.contiguous(), buckets.contiguous(),
          lengths.to(torch.int32).contiguous(), b, h, t)
    relpos_softmax.launches += 1
    return scores


relpos_softmax.launches = 0
