"""Wav2Vec2's first feature-encoder block: the hand-written CUDA kernel and
its plain PyTorch version.

The block is conv_0 over the raw waveform (one input channel, C outputs,
10 taps, stride 5, no bias), the norm of each (row, channel) over the row's
valid frames, the ``gn_scale`` / ``gn_bias`` affine and the exact (erf)
GELU. The JAX package leaves it to XLA (``models/wav2vec2.py``: conv_0 and
its masked channel norm); there is no Pallas kernel behind it.

* :func:`conv0_norm_gelu`: → (B, C, T) float32, T = (L − 10) // 5 + 1. On
  CUDA one call is a memset and two launches of ``csrc/feature_conv0.cu``
  in one scratch buffer that the .cu file sizes and lays out: the
  statistics of each row from its patches' moments in float64, then one
  pass that computes the conv, the norm, the affine and the GELU and writes
  the output once. A C whose records do not fit a block's shared memory
  raises the launch's CUDA error.
* :func:`conv0_norm_gelu_reference`: the same block as the encoder ran it
  before the kernel, the conv in the compute dtype (cuDNN's or the CPU's,
  IEEE float32 for float32) and :func:`channel_norm_gelu` over its output.
  The bfloat16 preset runs it on every device; ``ShardedWav2Vec2`` at
  mp > 1 calls :func:`channel_norm_gelu` after gathering its conv's slices.

Dispatch goes by the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. There is no fallback between them.
``conv0_norm_gelu.launches`` counts the kernel's calls (two launches each).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ...device import conv1d
from ._build import call as _call
from ._build import load as _load

TAPS, STRIDE = 10, 5  # the kernel's conv: every Wav2Vec2 config's conv_0


def masked_channel_norm(
    x: torch.Tensor, lengths: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """Per-(sample, channel) normalization over valid time frames.

    ``x`` is (B, C, T). Equivalent to torch GroupNorm(num_groups=C, C) on
    each unpadded sequence; GroupNorm over the padded tensor would count the
    padding.
    """
    if lengths is None:
        mean = x.mean(dim=2, keepdim=True)
        var = x.var(dim=2, unbiased=False, keepdim=True)
    else:
        t = torch.arange(x.shape[2], device=x.device)
        mask = (t[None, None, :] < lengths[:, None, None]).to(x.dtype)
        n = mask.sum(dim=2, keepdim=True).clamp(min=1.0)
        mean = (x * mask).sum(dim=2, keepdim=True) / n
        var = (((x - mean) * mask) ** 2).sum(dim=2, keepdim=True) / n
    return (x - mean) * torch.rsqrt(var + eps)


def channel_norm_gelu(
    h: torch.Tensor, lengths: Optional[torch.Tensor], gn_scale: torch.Tensor,
    gn_bias: torch.Tensor, eps: float,
) -> torch.Tensor:
    """The first block after its conv: ``h`` (B, C, T) → :func:`masked_channel_norm`,
    the ``gn_scale`` / ``gn_bias`` affine and GELU, in float32 whatever
    ``h``'s dtype (a bfloat16 mean and variance over ~16k frames would lose
    the small-variance channels)."""
    h = masked_channel_norm(h.float(), lengths, eps)
    return F.gelu(h * gn_scale[:, None] + gn_bias[:, None])


def conv0_norm_gelu_reference(
    wav: torch.Tensor, weight: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
    lengths: Optional[torch.Tensor], eps: float, stride: int = STRIDE,
    cdt: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain block: ``wav`` (B, L), ``weight`` (C, 1, K), ``lengths`` the
    valid frames of the conv's output (B,) or None (every frame) → (B, C, T)
    float32. The conv runs in ``cdt`` (:func:`..device.conv1d`), the rest in
    float32 (:func:`channel_norm_gelu`)."""
    h = conv1d(wav[:, None, :], weight, None, cdt, stride=stride)
    return channel_norm_gelu(h, lengths, gn_scale, gn_bias, eps)


def _check(wav, weight, gn_scale, gn_bias, lengths, stride) -> None:
    if wav.ndim != 2 or weight.ndim != 3 or weight.shape[1] != 1:
        raise ValueError(f"expected wav (B, L) and weight (C, 1, K), got {tuple(wav.shape)}, "
                         f"{tuple(weight.shape)}")
    c = weight.shape[0]
    if gn_scale.shape != (c,) or gn_bias.shape != (c,):
        raise ValueError(f"expected gn_scale and gn_bias of ({c},), got "
                         f"{tuple(gn_scale.shape)}, {tuple(gn_bias.shape)}")
    if lengths is not None and lengths.shape != (wav.shape[0],):
        raise ValueError(f"expected lengths of ({wav.shape[0]},), got {tuple(lengths.shape)}")
    tensors = [wav, weight, gn_scale, gn_bias] + ([] if lengths is None else [lengths])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}")
    if wav.shape[1] < weight.shape[2]:
        raise ValueError(f"a waveform of {wav.shape[1]} samples is shorter than the "
                         f"conv's {weight.shape[2]} taps")


def conv0_norm_gelu(
    wav: torch.Tensor, weight: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
    lengths: Optional[torch.Tensor], eps: float, stride: int = STRIDE,
) -> torch.Tensor:
    """conv_0 → masked channel norm → affine → GELU: (B, L) → (B, C, T)
    float32, as :func:`conv0_norm_gelu_reference`. Inference only: the
    kernel has no backward."""
    _check(wav, weight, gn_scale, gn_bias, lengths, stride)
    if wav.device.type == "cpu":
        return conv0_norm_gelu_reference(wav, weight, gn_scale, gn_bias, lengths, eps, stride)
    if wav.device.type != "cuda":
        raise ValueError(f"unsupported device {wav.device}")
    b, n = wav.shape
    c, _, k = weight.shape
    if k != TAPS or stride != STRIDE:
        raise ValueError(f"the kernel takes a conv of {TAPS} taps at stride {STRIDE}, "
                         f"got {k} taps at stride {stride}")
    if b > 65_535:
        raise ValueError(f"the kernel takes at most 65535 rows, got {b}")
    tensors = (wav, weight, gn_scale, gn_bias)
    if not all(t.dtype == torch.float32 for t in tensors):
        raise TypeError(f"expected float32, got {[t.dtype for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("conv0_norm_gelu has no backward on CUDA: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    dev = wav.device
    t = (n - k) // stride + 1
    if b == 0:
        return torch.empty((0, c, t), device=dev, dtype=torch.float32)
    fn = _load("feature_conv0").conv0_norm_gelu_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    scratch = torch.empty(fn(b, t, c), device=dev, dtype=torch.uint8)
    out = torch.empty((b, c, t), device=dev, dtype=torch.float32)
    frames = scratch if lengths is None else lengths.to(torch.int32).contiguous()  # not read if None
    _call("feature_conv0", "conv0_norm_gelu_f32", dev, wav.contiguous(), frames,
          weight.contiguous(), gn_scale.contiguous(), gn_bias.contiguous(), scratch, out, b, n,
          t, c, int(lengths is not None), float(eps))
    conv0_norm_gelu.launches += 1
    return out


conv0_norm_gelu.launches = 0
