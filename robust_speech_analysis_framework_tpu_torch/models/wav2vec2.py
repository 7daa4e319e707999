"""Wav2Vec2-base encoder in PyTorch (float32), with HF checkpoint porting.

Counterpart of ``robust_speech_analysis_framework_tpu/models/wav2vec2.py``:
a 7-layer strided conv feature encoder (stride 320 ⇒ ~49.9 frames/s),
feature projection to 768, grouped positional conv embedding and a 12-layer
post-norm transformer encoder. Module names mirror the JAX parameter tree
(``feature_encoder.conv_0``, ``layer_3.q``, ...), so carrying JAX weights
over is transposes only (:mod:`.weights`).

Batched ragged inference is exact, as in the JAX package: the convs are
VALID, the first conv's channel norm runs over valid frames only, padded
frames are zeroed before the positional conv, and padded keys get a -1e30
additive bias. Attention is plain matmul + softmax in float32 (XLA computed
it on the TPU; there is no kernel of the JAX package here).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import fp32_convs


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5

    def output_length(self, n_samples) -> Any:
        """Conv-stack output frames for an input of ``n_samples`` samples."""
        t = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


def _masked_channel_norm(
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


class FeatureEncoder(nn.Module):
    """Strided conv stack over raw waveform: (B, L) → (B, T, conv_dim[-1])."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        in_dim = 1
        for i, (dim, k, s) in enumerate(
            zip(config.conv_dim, config.conv_kernel, config.conv_stride)
        ):
            self.add_module(f"conv_{i}", nn.Conv1d(in_dim, dim, k, stride=s, bias=False))
            in_dim = dim
        self.gn_scale = nn.Parameter(torch.ones(config.conv_dim[0]))
        self.gn_bias = nn.Parameter(torch.zeros(config.conv_dim[0]))

    def forward(
        self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        h = waveform[:, None, :]  # (B, 1, L)
        cur_lengths = lengths
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            with fp32_convs():
                h = getattr(self, f"conv_{i}")(h)
            if cur_lengths is not None:
                cur_lengths = torch.div(cur_lengths - k, s, rounding_mode="floor") + 1
            if i == 0:
                h = _masked_channel_norm(h, cur_lengths, cfg.layer_norm_eps)
                h = h * self.gn_scale[:, None] + self.gn_bias[:, None]
            h = F.gelu(h)
        return h.transpose(1, 2), cur_lengths


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (kernel 128, groups 16)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        k = config.pos_conv_kernel
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.pos_conv_groups,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with fp32_convs():
            h = self.conv(x.transpose(1, 2))
        # Even kernel + symmetric padding yields one extra frame; drop it.
        return F.gelu(h[:, :, : x.shape[1]]).transpose(1, 2)


class EncoderLayer(nn.Module):
    """Post-norm transformer block (wav2vec2-base: do_stable_layer_norm=False)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.attn_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.ff1 = nn.Linear(d, config.intermediate_size)
        self.ff2 = nn.Linear(config.intermediate_size, d)
        self.ff_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape
        heads = self.num_heads
        head_dim = d // heads
        split = lambda y: y.reshape(b, t, heads, head_dim).transpose(1, 2)  # noqa: E731
        q = split(self.q(x) * head_dim**-0.5)
        k = split(self.k(x))
        v = split(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # (B, heads, T, T)
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
        x = self.attn_norm(x + self.out(ctx))
        ff = self.ff2(F.gelu(self.ff1(x)))
        return self.ff_norm(x + ff)


class Wav2Vec2Model(nn.Module):
    """Full encoder: waveform (B, L) [+ lengths] → hidden states (B, T, D).

    Returns ``(hidden, out_lengths)``; frames at index ≥ out_lengths[b] are
    garbage and must be dropped by the caller (the extractor does).
    """

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = config
        self.feature_encoder = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.pos_conv = PositionalConvEmbedding(config)
        self.encoder_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(config))

    def forward(
        self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        feats, out_lengths = self.feature_encoder(waveform, lengths)
        h = self.feature_projection(feats)
        attn_bias = None
        if out_lengths is not None:
            t = torch.arange(h.shape[1], device=h.device)
            valid = t[None, :] < out_lengths[:, None]
            # Zero padded frames before the positional conv: matches unpadded
            # semantics because that conv zero-pads its boundary anyway.
            h = h.masked_fill(~valid[:, :, None], 0.0)
            attn_bias = torch.zeros(valid.shape, dtype=h.dtype, device=h.device)
            attn_bias = attn_bias.masked_fill(~valid, -1e30)[:, None, None, :]
        h = self.encoder_norm(h + self.pos_conv(h))
        for i in range(self.config.num_layers):
            h = getattr(self, f"layer_{i}")(h, attn_bias)
        return h, out_lengths


# ---------------------------------------------------------------------------
# HF checkpoint porting
# ---------------------------------------------------------------------------

def port_hf_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a ``transformers.Wav2Vec2Model`` state dict onto this module.

    Accepts numpy arrays or tensors. Ignores the quantizer / masked-spec-embed
    entries the inference path never uses. Head-model state dicts whose
    backbone keys carry a ``wav2vec2.`` prefix (e.g. ``Wav2Vec2ForCTC``) are
    accepted by stripping the prefix. The weight-normed positional conv is
    folded into a plain weight.
    """
    if any(k.startswith("wav2vec2.") for k in state_dict):
        state_dict = {
            k[len("wav2vec2."):]: v
            for k, v in state_dict.items()
            if k.startswith("wav2vec2.")
        }
    if not any(k.startswith("feature_extractor.conv_layers.") for k in state_dict):
        raise ValueError(
            "state dict does not look like a transformers Wav2Vec2Model: no "
            "'feature_extractor.conv_layers.*' keys found (got e.g. "
            f"{sorted(state_dict)[:3]}...). Pass the bare backbone's "
            "state_dict()."
        )

    def t(name: str) -> np.ndarray:
        v = state_dict[name]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    out: Dict[str, np.ndarray] = {}
    n_convs = 1 + max(
        int(k.split(".")[2]) for k in state_dict if k.startswith("feature_extractor.conv_layers.")
    )
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in state_dict if k.startswith("encoder.layers.")
    )
    for i in range(n_convs):
        out[f"feature_encoder.conv_{i}.weight"] = t(f"feature_extractor.conv_layers.{i}.conv.weight")
    out["feature_encoder.gn_scale"] = t("feature_extractor.conv_layers.0.layer_norm.weight")
    out["feature_encoder.gn_bias"] = t("feature_extractor.conv_layers.0.layer_norm.bias")
    out["feature_projection.norm.weight"] = t("feature_projection.layer_norm.weight")
    out["feature_projection.norm.bias"] = t("feature_projection.layer_norm.bias")
    out["feature_projection.projection.weight"] = t("feature_projection.projection.weight")
    out["feature_projection.projection.bias"] = t("feature_projection.projection.bias")

    # Weight-normed positional conv: weight = g * v / ||v||, the norm taken
    # over (out, in/groups) for each tap (HF's weight_norm dim=2). Newer
    # torch exports use parametrizations.*.original{0,1}.
    if "encoder.pos_conv_embed.conv.weight_g" in state_dict:
        g = t("encoder.pos_conv_embed.conv.weight_g")
        v = t("encoder.pos_conv_embed.conv.weight_v")
    else:
        g = t("encoder.pos_conv_embed.conv.parametrizations.weight.original0")
        v = t("encoder.pos_conv_embed.conv.parametrizations.weight.original1")
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    out["pos_conv.conv.weight"] = g * v / np.maximum(norm, 1e-12)
    out["pos_conv.conv.bias"] = t("encoder.pos_conv_embed.conv.bias")
    out["encoder_norm.weight"] = t("encoder.layer_norm.weight")
    out["encoder_norm.bias"] = t("encoder.layer_norm.bias")

    names = {
        "q": "attention.q_proj", "k": "attention.k_proj",
        "v": "attention.v_proj", "out": "attention.out_proj",
        "attn_norm": "layer_norm", "ff1": "feed_forward.intermediate_dense",
        "ff2": "feed_forward.output_dense", "ff_norm": "final_layer_norm",
    }
    for i in range(n_layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = t(f"encoder.layers.{i}.{theirs}.{leaf}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
