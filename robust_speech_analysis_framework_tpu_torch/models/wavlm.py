"""WavLM-Large encoder in PyTorch (float32), with HF checkpoint porting.

WavLM (Chen et al., arXiv:2110.13900; ``transformers``' ``WavLMModel`` with
``do_stable_layer_norm=True`` and ``feat_extract_norm="layer"``, the Large
layout) beside :class:`..models.wav2vec2.Wav2Vec2Model`, with its contract:
``forward(waveform, lengths)`` → ``(hidden, out_lengths)``. The JAX package
has no WavLM.

* Feature encoder in layer mode: each of the 7 convs (a bias only with
  ``conv_bias``), then a LayerNorm over the channels of each frame (affine,
  eps 1e-5 as ``transformers`` builds it whatever the config's), then GELU,
  on (B, T, C); conv_1 … are Wav2Vec2's :func:`..ops.cuda.wav2vec2.feature_conv`
  with no GELU (a hand-written kernel on the card).
* The feature projection and the positional conv are Wav2Vec2's modules;
  ``h + GELU(posconv(h))`` goes into the layers with no LayerNorm.
* Pre-norm layers: ``x + Attn(LN₁(x))``, then ``x + FFN(LN₂(x))``; one
  LayerNorm after the last layer.
* Gated relative-position attention: one (num_buckets, heads) table
  (``rel_attn_embed``, layer 0's in ``transformers``) gives every layer the
  ungated bias ``table[bucket(j − i), h]``; each layer scales it per query by
  its gate ``g = a (b c_h − 1) + 2``, (a, b) the sigmoids of two sums of
  four outputs of a 64 → 8 product of each head's slice of LN₁(x), and
  c_h its ``gru_rel_pos_const``. The scores ``(q · s) · kᵀ`` come from
  Wav2Vec2's ``_attention``; the gated bias, the key mask and the softmax
  are one pass of :func:`..ops.cuda.wavlm.relpos_softmax` (a hand-written
  kernel on the card, its plain version on the CPU).

Batched ragged inference is exact: the convs are VALID and normalised per
frame, so padding never reaches a valid frame; padded frames are zeroed
before the positional conv; padded keys are masked in the softmax. The
bucket of each of the 2T − 1 distances of a padded length T is computed
once, with the published function on the CPU in float32 (its log on the card
could round a boundary distance the other way), copied to the device and
cached per (T, device): the T × T bias is never formed on the card.

Float32 only: ``compute_dtype="bfloat16"`` raises, and so does a split over
mp > 1 devices (``Wav2Vec2Extractor``'s ``mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import conv1d
from ..ops.cuda.wav2vec2 import feature_conv
from ..ops.cuda.wavlm import relpos_softmax
from ..utils.profiling import span
from .wav2vec2 import (FeatureProjection, PositionalConvEmbedding, Wav2Vec2Config, _attention,
                       _linear, hf_pos_conv_weight)

CONV_NORM_EPS = 1e-5  # the conv stack's LayerNorms: nn.LayerNorm's default in transformers
GATE_OUTPUTS = 8  # gru_rel_pos_linear: head_dim → 8, summed in two groups of 4


@dataclasses.dataclass(frozen=True)
class WavLMConfig(Wav2Vec2Config):
    """WavLM-Large's published widths (``microsoft/wavlm-large``)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_bias: bool = False
    num_buckets: int = 320
    max_bucket_distance: int = 800

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise ValueError(f"WavLM runs in float32 only, not compute_dtype="
                             f"{self.compute_dtype!r}")


def relative_position_buckets(distances: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """The bucket (int64) of each key − query distance, as ``transformers``'
    ``WavLMAttention._relative_positions_bucket`` computes it: half the
    buckets for positive distances; |d| below a quarter of the buckets is
    its own bucket, larger ones log-spaced up to ``max_distance`` and capped."""
    half = num_buckets // 2
    out = (distances > 0).to(torch.long) * half
    d = distances.abs()
    exact = half // 2
    large = torch.log(d.float() / exact) / math.log(max_distance / exact) * (half - exact)
    large = torch.clamp((exact + large).to(torch.long), max=half - 1)
    return out + torch.where(d < exact, d, large)


class LayerNormFeatureEncoder(nn.Module):
    """The conv stack in layer mode: (B, L) → (B, T, conv_dim[-1])."""

    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.config = config
        in_dim = 1
        for i, (dim, k, s) in enumerate(
            zip(config.conv_dim, config.conv_kernel, config.conv_stride)
        ):
            self.add_module(f"conv_{i}", nn.Conv1d(in_dim, dim, k, stride=s,
                                                   bias=config.conv_bias))
            self.add_module(f"norm_{i}", nn.LayerNorm(dim, eps=CONV_NORM_EPS))
            in_dim = dim

    def forward(self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            if lengths is not None:
                lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
            conv, norm = getattr(self, f"conv_{i}"), getattr(self, f"norm_{i}")
            if i > 0:  # (B, T, C) in and out: the kernel on the card, its plain version on the CPU
                h = feature_conv(h, conv.weight, conv.bias, s, False)
            else:  # one input channel: cuDNN's conv, then a (B, T, C) view
                h = conv1d(waveform[:, None, :], conv.weight, conv.bias, torch.float32,
                           stride=s).transpose(1, 2)
            h = F.gelu(F.layer_norm(h, (h.shape[2],), norm.weight, norm.bias, norm.eps))
        return h, lengths


class WavLMLayer(nn.Module):
    """Pre-norm transformer block with the gated relative-position bias."""

    def __init__(self, config: WavLMConfig):
        super().__init__()
        d, heads = config.hidden_size, config.num_heads
        eps = config.layer_norm_eps
        self.num_heads = heads
        self.q_scale = (d // heads) ** -0.5
        self.attn_norm = nn.LayerNorm(d, eps=eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.gru_rel_pos_linear = nn.Linear(d // heads, GATE_OUTPUTS)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(heads))
        self.ff_norm = nn.LayerNorm(d, eps=eps)
        self.ff1 = nn.Linear(d, config.intermediate_size)
        self.ff2 = nn.Linear(config.intermediate_size, d)

    def gates(self, u: torch.Tensor) -> torch.Tensor:
        """The per-query gates (B, heads, T) of LN₁(x) ``u`` (B, T, D)."""
        b, t, _ = u.shape
        heads = self.num_heads
        r = self.gru_rel_pos_linear(u.reshape(b, t, heads, -1))  # (B, T, heads, 8)
        a, g = torch.sigmoid(r.view(b, t, heads, 2, GATE_OUTPUTS // 2).sum(-1)).unbind(-1)
        return (a * (g * self.gru_rel_pos_const - 1.0) + 2.0).transpose(1, 2).contiguous()

    def forward(self, x: torch.Tensor, table: torch.Tensor, buckets: torch.Tensor,
                key_lengths: torch.Tensor) -> torch.Tensor:
        f32 = torch.float32
        u = self.attn_norm(x)
        gates = self.gates(u)
        ctx = _attention(u, (self.q.weight, self.q.bias), (self.k.weight, self.k.bias),
                         (self.v.weight, self.v.bias), self.num_heads, self.q_scale, f32, None,
                         lambda scores: relpos_softmax(scores, gates, table, buckets,
                                                       key_lengths))
        x = x + _linear(ctx, self.out.weight, self.out.bias, f32)
        ff = _linear(F.gelu(_linear(self.ff_norm(x), self.ff1.weight, self.ff1.bias, f32)),
                     self.ff2.weight, self.ff2.bias, f32)
        return x + ff


class WavLMModel(nn.Module):
    """Full encoder: waveform (B, L) [+ lengths] → hidden states (B, T, D).

    Returns ``(hidden, out_lengths)``; frames at index ≥ out_lengths[b] are
    garbage and must be dropped by the caller (the extractor does).
    """

    def __init__(self, config: WavLMConfig = WavLMConfig()):
        super().__init__()
        if not isinstance(config, WavLMConfig):
            raise TypeError(f"WavLMModel takes a WavLMConfig, not {type(config).__name__}")
        self.config = config
        self.feature_encoder = LayerNormFeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.pos_conv = PositionalConvEmbedding(config)
        self.rel_attn_embed = nn.Embedding(config.num_buckets, config.num_heads)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", WavLMLayer(config))
        self.encoder_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def position_buckets(self, t: int, device: torch.device) -> torch.Tensor:
        """(2t − 1,) int32 buckets of the distances −(t − 1) … t − 1 on
        ``device``, built once per (t, device)."""
        key = (int(t), torch.device(device))
        cached = self._buckets.get(key)
        if cached is None:
            with span("wavlm.position_bias"):
                d = torch.arange(-(t - 1), t)
                cfg = self.config
                cached = relative_position_buckets(d, cfg.num_buckets, cfg.max_bucket_distance)
                cached = self._buckets[key] = cached.to(torch.int32).to(device)
        return cached

    def forward(
        self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        feats, out_lengths = self.feature_encoder(waveform, lengths)
        h = self.feature_projection(feats)
        b, t, _ = h.shape
        if out_lengths is None:
            key_lengths = torch.full((b,), t, dtype=torch.int32, device=h.device)
        else:
            valid = torch.arange(t, device=h.device)[None, :] < out_lengths[:, None]
            # zero padded frames before the positional conv: the unpadded
            # semantics, since that conv zero-pads its boundary anyway
            h = h.masked_fill(~valid[:, :, None], 0.0)
            key_lengths = out_lengths.to(torch.int32)  # the kernel's type, cast once
        h = h + self.pos_conv(h)
        table = self.rel_attn_embed.weight
        buckets = self.position_buckets(t, h.device)
        for i in range(self.config.num_layers):
            h = getattr(self, f"layer_{i}")(h, table, buckets, key_lengths)
        return self.encoder_norm(h), out_lengths


# ---------------------------------------------------------------------------
# HF checkpoint porting
# ---------------------------------------------------------------------------


def wavlm_config_from_hf(hf_config: Any) -> WavLMConfig:
    """A :class:`WavLMConfig` from a ``transformers.WavLMConfig``; only the
    Large layout (``do_stable_layer_norm``, ``feat_extract_norm="layer"``,
    GELU) is taken."""
    layout = (getattr(hf_config, "do_stable_layer_norm", False),
              getattr(hf_config, "feat_extract_norm", None),
              getattr(hf_config, "hidden_act", None),
              getattr(hf_config, "feat_extract_activation", None))
    if layout != (True, "layer", "gelu", "gelu"):
        raise ValueError(
            "only WavLM's Large layout is ported (do_stable_layer_norm=True, "
            "feat_extract_norm='layer', GELU activations); the checkpoint has "
            f"do_stable_layer_norm={layout[0]}, feat_extract_norm={layout[1]!r}, "
            f"hidden_act={layout[2]!r}, feat_extract_activation={layout[3]!r}")
    return WavLMConfig(
        hidden_size=hf_config.hidden_size, num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads, intermediate_size=hf_config.intermediate_size,
        conv_dim=tuple(hf_config.conv_dim), conv_kernel=tuple(hf_config.conv_kernel),
        conv_stride=tuple(hf_config.conv_stride),
        pos_conv_kernel=hf_config.num_conv_pos_embeddings,
        pos_conv_groups=hf_config.num_conv_pos_embedding_groups,
        layer_norm_eps=hf_config.layer_norm_eps, conv_bias=bool(hf_config.conv_bias),
        num_buckets=hf_config.num_buckets, max_bucket_distance=hf_config.max_bucket_distance)


def port_hf_wavlm_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a ``transformers.WavLMModel`` state dict (the Large layout) onto
    :class:`WavLMModel`.

    Accepts numpy arrays or tensors. A head model's backbone keys (``wavlm.``
    prefix) are taken with the prefix stripped; the masked-spec embedding and
    any head are ignored. The weight-normed positional conv is folded into a
    plain weight, and layer 0's relative-position table becomes the model's.
    """
    if any(k.startswith("wavlm.") for k in state_dict):
        state_dict = {k[len("wavlm."):]: v for k, v in state_dict.items()
                      if k.startswith("wavlm.")}
    if ("feature_extractor.conv_layers.1.layer_norm.weight" not in state_dict
            or "encoder.layers.0.attention.rel_attn_embed.weight" not in state_dict):
        raise ValueError(
            "state dict does not look like a transformers WavLMModel in the Large layout: "
            "no 'feature_extractor.conv_layers.1.layer_norm.*' or "
            "'encoder.layers.0.attention.rel_attn_embed.weight' keys (got e.g. "
            f"{sorted(state_dict)[:3]}...). Pass the bare backbone's state_dict().")

    def t(name: str) -> np.ndarray:
        v = state_dict[name]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    out: Dict[str, np.ndarray] = {}
    n_convs = 1 + max(int(k.split(".")[2]) for k in state_dict
                      if k.startswith("feature_extractor.conv_layers."))
    n_layers = 1 + max(int(k.split(".")[2]) for k in state_dict if k.startswith("encoder.layers."))
    for i in range(n_convs):
        pre = f"feature_extractor.conv_layers.{i}"
        out[f"feature_encoder.conv_{i}.weight"] = t(f"{pre}.conv.weight")
        if f"{pre}.conv.bias" in state_dict:
            out[f"feature_encoder.conv_{i}.bias"] = t(f"{pre}.conv.bias")
        out[f"feature_encoder.norm_{i}.weight"] = t(f"{pre}.layer_norm.weight")
        out[f"feature_encoder.norm_{i}.bias"] = t(f"{pre}.layer_norm.bias")
    out["feature_projection.norm.weight"] = t("feature_projection.layer_norm.weight")
    out["feature_projection.norm.bias"] = t("feature_projection.layer_norm.bias")
    out["feature_projection.projection.weight"] = t("feature_projection.projection.weight")
    out["feature_projection.projection.bias"] = t("feature_projection.projection.bias")
    out["pos_conv.conv.weight"] = hf_pos_conv_weight(state_dict, t)
    out["pos_conv.conv.bias"] = t("encoder.pos_conv_embed.conv.bias")
    out["rel_attn_embed.weight"] = t("encoder.layers.0.attention.rel_attn_embed.weight")
    out["encoder_norm.weight"] = t("encoder.layer_norm.weight")
    out["encoder_norm.bias"] = t("encoder.layer_norm.bias")
    names = {
        "q": "attention.q_proj", "k": "attention.k_proj", "v": "attention.v_proj",
        "out": "attention.out_proj", "gru_rel_pos_linear": "attention.gru_rel_pos_linear",
        "attn_norm": "layer_norm", "ff1": "feed_forward.intermediate_dense",
        "ff2": "feed_forward.output_dense", "ff_norm": "final_layer_norm",
    }
    for i in range(n_layers):
        pre = f"encoder.layers.{i}"
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = t(f"{pre}.{theirs}.{leaf}")
        out[f"layer_{i}.gru_rel_pos_const"] = t(f"{pre}.attention.gru_rel_pos_const").reshape(-1)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
