"""The Conformer's shifted relative-position softmax: the hand-written CUDA
kernel and its plain PyTorch version.

For content scores ``S = ((q + u)/√d)·kᵀ`` of shape (B, H, T, T), the
position queries ``Q = (q + v)/√d`` (B, H, T, D), the layer's projected
position rows ``P`` (2T − 1, H, D) in the published order (row
``T − 1 − (i − j)`` holds distance i − j) and the valid keys of each row
(B,), both compute

    x[b, h, i, j] = S[b, h, i, j] + Q[b, h, i] · P[T − 1 − i + j, h]
    p[b, h, i, :] = softmax of x over the keys j < lengths[b]; 0 at the others

(a row with no valid key is all zeros). The JAX package has no Conformer, so
there is no Pallas kernel behind it.

* :func:`relpos_shift_softmax`: on CUDA one launch of
  ``csrc/conformer_relpos.cu`` that forms each row's position term from the
  2T − 1 rows of ``P`` and writes the probabilities over ``S``: the scores
  tensor is returned, and no (B, H, T, 2T − 1) product, padded or shifted
  copy is formed. A T over :data:`MAX_T` raises (:func:`check_frames`).
* :func:`relpos_shift_softmax_reference`: the plain version, the published
  Transformer-XL shift of ``transformers``' ``Wav2Vec2ConformerSelfAttention``:
  the full (B, H, T, 2T − 1) product, a zero column, a view that shifts each
  row and the first T columns; then the sum, the key mask and
  ``torch.softmax``: a new tensor.

The choice is the port's one rule (``ops/cuda/wav2vec2._uses_kernel``):
float32 on CUDA launches the kernel or raises, a T over :data:`MAX_T`
included; CPU tensors, or another dtype, take the plain version. ``relpos_shift_softmax.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from ._build import call as _call
from .wav2vec2 import _uses_kernel

MAX_T = 1024  # frames (20.485 s chunks): a block's rows of the position term live in shared memory
HEAD_SIZE = 64  # the kernel's D
MAX_ROWS = 65_535  # B · H: the launch grid's second dimension


def relpos_shift_softmax_reference(scores: torch.Tensor, q: torch.Tensor, pos: torch.Tensor,
                                   lengths: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, H, T, T) probabilities, a new tensor."""
    b, h, t, _ = scores.shape
    bd = torch.matmul(q, pos.permute(1, 2, 0))  # (B, H, T, 2T - 1)
    padded = torch.cat([bd.new_zeros(b, h, t, 1), bd], dim=-1).view(b, h, 2 * t, t)
    shifted = padded[:, :, 1:].view(b, h, t, 2 * t - 1)[..., :t]  # row i: P(i - j) at key j
    keys = torch.arange(t, device=scores.device)
    valid = (keys[None, :] < lengths.long().clamp(0, t)[:, None])[:, None, None, :]
    probs = torch.softmax((scores + shifted).masked_fill(~valid, float("-inf")), dim=-1)
    return torch.where(valid, probs, 0.0)


def _check(scores, q, pos, lengths) -> None:
    if scores.ndim != 4 or scores.shape[2] != scores.shape[3]:
        raise ValueError(f"expected scores (B, H, T, T), got {tuple(scores.shape)}")
    b, h, t, _ = scores.shape
    if q.ndim != 4 or q.shape[:3] != (b, h, t):
        raise ValueError(f"expected position queries ({b}, {h}, {t}, D), got {tuple(q.shape)}")
    if pos.shape != (max(2 * t - 1, 0), h, q.shape[3]):
        raise ValueError(f"expected position rows of {(2 * t - 1, h, q.shape[3])}, got "
                         f"{tuple(pos.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"expected lengths of ({b},), got {tuple(lengths.shape)}")
    tensors = (scores, q, pos, lengths)
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"inputs on {[str(x.device) for x in tensors]}")


def check_frames(t: int, device: torch.device) -> None:
    """Raise where the kernel would run (float32 on ``device``) and a chunk's
    ``t`` frames are over its :data:`MAX_T`."""
    if t > MAX_T and _uses_kernel(torch.device(device), torch.float32):
        raise ValueError(f"the Conformer's relative-position kernel takes at most {MAX_T} frames "
                         f"a chunk (20.485 s at 16 kHz), got {t}: give shorter chunks")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous) where it starts on 16 bytes, as the kernel's
    cp.async copies need, else a copy of it."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def relpos_shift_softmax(scores: torch.Tensor, q: torch.Tensor, pos: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The shifted relative-position softmax (module docstring). On CUDA the
    probabilities overwrite ``scores``, which is returned. ``q`` is read in
    the (B, T, H, D) layout the query projection gives: a (B, H, T, D)
    transposed view of it is taken as it is, anything else is copied so.
    Inference only: the kernel has no backward."""
    _check(scores, q, pos, lengths)
    b, h, t, _ = scores.shape
    if not _uses_kernel(scores.device, scores.dtype):
        return relpos_shift_softmax_reference(scores, q, pos, lengths)
    check_frames(t, scores.device)
    if q.shape[3] != HEAD_SIZE:
        raise ValueError(f"the kernel takes heads of {HEAD_SIZE}, got {q.shape[3]}")
    if b * h > MAX_ROWS:
        raise ValueError(f"the kernel takes at most {MAX_ROWS} (batch, head) rows, got {b * h}")
    if not all(x.dtype == torch.float32 for x in (q, pos)):
        raise TypeError(f"expected float32 queries and position rows, got {q.dtype}, {pos.dtype}")
    if not scores.is_contiguous():
        raise ValueError("the kernel writes the probabilities over contiguous scores")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (scores, q, pos)):
        raise RuntimeError("relpos_shift_softmax has no backward on CUDA: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if b * h * t == 0:
        return scores
    _call("conformer_relpos", "conformer_relpos_softmax_f32", scores.device, scores,
          _aligned(q.transpose(1, 2).contiguous()), _aligned(pos.contiguous()),
          lengths.to(torch.int32).contiguous(), b, h, t)
    relpos_shift_softmax.launches += 1
    return scores


relpos_shift_softmax.launches = 0
