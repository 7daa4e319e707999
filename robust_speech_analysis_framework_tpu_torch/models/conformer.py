"""Wav2Vec2-Conformer-Large (relative positions) in PyTorch (float32), with HF
checkpoint porting.

The Conformer encoder of ``facebook/wav2vec2-conformer-rel-pos-large``
(``transformers``' ``Wav2Vec2ConformerModel`` with
``position_embeddings_type="relative"``; Gulati et al., arXiv:2005.08100;
Dai et al., arXiv:1901.02860) beside :class:`..models.wav2vec2.Wav2Vec2Model`,
with its contract: ``forward(waveform, lengths)`` → ``(hidden, out_lengths)``.
The JAX package has no Conformer.

* Feature encoder: WavLM's layer-mode conv stack
  (:class:`..models.wavlm.LayerNormFeatureEncoder`: conv with bias, a
  LayerNorm a frame, GELU; conv_1 … on the hand-written ``feature_conv``),
  then Wav2Vec2's feature projection. ``transformers`` builds a positional
  conv but never calls it: there is none here.
* Block (every LayerNorm affine, eps 1e-5 as ``transformers`` builds them):
  ``x + ½ FFN₁(LN(x))``, ``x + Attn(LN(x))``, ``x + ConvModule(x)``,
  ``x + ½ FFN₂(LN(x))``, then the block's own LayerNorm; FFN(y) =
  W₂ SiLU(W₁ y + b₁) + b₂. One LayerNorm after the last block.
* ConvModule: LN, pointwise 1024 → 2048 (no bias), GLU, a depthwise conv
  of odd kernel K with K // 2 frames of zero padding a side (no bias),
  BatchNorm with its running statistics, SiLU, pointwise 1024 → 1024 (no
  bias). The pointwise products run on cuBLAS as linear maps of (B, T, C).
* Attention: scores ``((q + u_h)·k_j + (q + v_h)·P_h(i − j)) / √64``, with
  ``u``/``v`` the layer's ``pos_bias_u``/``pos_bias_v`` and ``P`` the layer's
  bias-free ``pos`` projection of the sinusoid table ``pe`` of the 2T − 1
  distances T − 1 … −(T − 1). The content scores ``((q + u)/8)·kᵀ`` come from
  Wav2Vec2's ``_attention``; the position term, the key mask and the
  softmax are one pass of :func:`..ops.cuda.conformer.relpos_shift_softmax`
  (a hand-written kernel on the card that reads the 2T − 1 projected rows
  and forms no (T, 2T − 1) product; its plain version on the CPU).

Batched ragged inference is exact: padded frames are zeroed after the
projection, padded keys are masked, and each conv module zeroes its GLU
output on padded frames before the depthwise conv, so the conv's reach of
K // 2 frames past a chunk's end reads zeros, as the unpadded chunk's
boundary padding does. ``transformers``' batched forward skips that last
mask and lets padded frames leak into a chunk's last K // 2 frames; on each
chunk alone the two agree. The table ``pe`` of a padded length T is built
once on the CPU in float32 as published, copied to the device and cached per
(T, device); ``transformers``' ``max_source_positions`` only sizes its first
table, so it does not enter here.

Float32 and relative positions only: ``compute_dtype="bfloat16"`` raises,
a checkpoint with rotary or no position embeddings is refused
(:func:`conformer_config_from_hf`), and so is a split over mp > 1 devices
(``Wav2Vec2Extractor``'s ``mesh``).
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
from ..ops.cuda.conformer import relpos_shift_softmax
from ..utils.profiling import span
from .wav2vec2 import FeatureProjection, Wav2Vec2Config, _attention, _linear
from .wavlm import LayerNormFeatureEncoder

BLOCK_NORM_EPS = 1e-5  # the blocks' and conv modules' LayerNorms: nn.LayerNorm's default
BATCH_NORM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ConformerConfig(Wav2Vec2Config):
    """Wav2Vec2-Conformer-Large's published widths
    (``facebook/wav2vec2-conformer-rel-pos-large``). Positions are relative,
    a constant of the model (:func:`conformer_config_from_hf` refuses other
    checkpoints). The inherited positional-conv widths are unused: the
    published forward has no positional conv."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_bias: bool = True
    conv_depthwise_kernel_size: int = 31

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise ValueError(f"the Conformer runs in float32 only, not compute_dtype="
                             f"{self.compute_dtype!r}")
        if self.conv_depthwise_kernel_size % 2 == 0:
            raise ValueError(f"the depthwise kernel must be odd for 'same' padding, not "
                             f"{self.conv_depthwise_kernel_size}")


def relative_position_table(t: int, d: int) -> torch.Tensor:
    """(2t − 1, d) float32 sinusoids of the distances t − 1 … −(t − 1), row
    by row, as ``transformers``' ``Wav2Vec2ConformerRelPositionalEmbedding``
    computes them: ``[sin(r ω_m), cos(r ω_m)]`` interleaved, ω_m =
    10000^(−2m/d)."""
    position = torch.arange(0, t, dtype=torch.int64).float().unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d, 2, dtype=torch.int64).float()
                         * -(math.log(10000.0) / d))
    positive, negative = torch.zeros(t, d), torch.zeros(t, d)
    positive[:, 0::2] = torch.sin(position * div_term)
    positive[:, 1::2] = torch.cos(position * div_term)
    negative[:, 0::2] = torch.sin(-1 * position * div_term)
    negative[:, 1::2] = torch.cos(-1 * position * div_term)
    return torch.cat([torch.flip(positive, [0]), negative[1:]])


class ConformerLayer(nn.Module):
    """One Conformer block: macaron FFNs, relative-position attention, the
    conv module and the block's LayerNorm."""

    def __init__(self, config: ConformerConfig):
        super().__init__()
        d, heads, ff = config.hidden_size, config.num_heads, config.intermediate_size
        k = config.conv_depthwise_kernel_size
        self.num_heads = heads
        self.q_scale = (d // heads) ** -0.5
        self.ff1_norm = nn.LayerNorm(d, eps=BLOCK_NORM_EPS)
        self.ff1_in = nn.Linear(d, ff)
        self.ff1_out = nn.Linear(ff, d)
        self.attn_norm = nn.LayerNorm(d, eps=BLOCK_NORM_EPS)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.pos = nn.Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads))
        self.conv_norm = nn.LayerNorm(d, eps=BLOCK_NORM_EPS)
        self.pointwise1 = nn.Linear(d, 2 * d, bias=False)
        self.depthwise = nn.Conv1d(d, d, k, padding=k // 2, groups=d, bias=False)
        self.batch_norm = nn.BatchNorm1d(d, eps=BATCH_NORM_EPS)
        self.pointwise2 = nn.Linear(d, d, bias=False)
        self.ff2_norm = nn.LayerNorm(d, eps=BLOCK_NORM_EPS)
        self.ff2_in = nn.Linear(d, ff)
        self.ff2_out = nn.Linear(ff, d)
        self.final_norm = nn.LayerNorm(d, eps=BLOCK_NORM_EPS)

    def attention(self, u: torch.Tensor, pe: torch.Tensor,
                  key_lengths: torch.Tensor) -> torch.Tensor:
        """The attention's output (B, T, D) for LN(x) ``u``."""
        f32 = torch.float32
        b, t, d = u.shape
        q = _linear(u, self.q.weight, self.q.bias, f32)
        q_u = (q + self.pos_bias_u.reshape(-1)) * self.q_scale  # 1/8: exact
        q_v = ((q + self.pos_bias_v.reshape(-1)) * self.q_scale).view(
            b, t, self.num_heads, -1).transpose(1, 2)  # (B, H, T, 64), a view
        pos = _linear(pe, self.pos.weight, None, f32).view(2 * t - 1, self.num_heads, -1)
        ctx = _attention(u, q_u, (self.k.weight, self.k.bias), (self.v.weight, self.v.bias),
                         self.num_heads, 1.0, f32, None,
                         lambda scores: relpos_shift_softmax(scores, q_v, pos, key_lengths))
        return _linear(ctx, self.out.weight, self.out.bias, f32)

    def conv_module(self, x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        """The conv module's output (B, T, D); ``valid`` (B, T) zeroes the
        GLU output on padded frames before the depthwise conv."""
        f32 = torch.float32
        with span("conformer.conv_module"):
            y = F.glu(_linear(self.conv_norm(x), self.pointwise1.weight, None, f32), dim=-1)
            if valid is not None:
                y = y.masked_fill(~valid[:, :, None], 0.0)
            conv, bn = self.depthwise, self.batch_norm
            y = conv1d(y.transpose(1, 2), conv.weight, None, f32, padding=conv.padding,
                       groups=conv.groups)  # (B, D, T), IEEE float32 on cuDNN
            y = F.silu(F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                    False, 0.0, bn.eps))
            return _linear(y.transpose(1, 2), self.pointwise2.weight, None, f32)

    def forward(self, x: torch.Tensor, pe: torch.Tensor, key_lengths: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
        f32 = torch.float32

        def ffn(y, w1, w2):
            return _linear(F.silu(_linear(y, w1.weight, w1.bias, f32)), w2.weight, w2.bias, f32)

        x = x + 0.5 * ffn(self.ff1_norm(x), self.ff1_in, self.ff1_out)
        x = x + self.attention(self.attn_norm(x), pe, key_lengths)
        x = x + self.conv_module(x, valid)
        x = x + 0.5 * ffn(self.ff2_norm(x), self.ff2_in, self.ff2_out)
        return self.final_norm(x)


class ConformerModel(nn.Module):
    """Full encoder: waveform (B, L) [+ lengths] → hidden states (B, T, D).

    Returns ``(hidden, out_lengths)``; frames at index ≥ out_lengths[b] are
    garbage and must be dropped by the caller (the extractor does).
    """

    def __init__(self, config: ConformerConfig = ConformerConfig()):
        super().__init__()
        if not isinstance(config, ConformerConfig):
            raise TypeError(f"ConformerModel takes a ConformerConfig, not {type(config).__name__}")
        self.config = config
        self.feature_encoder = LayerNormFeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", ConformerLayer(config))
        self.encoder_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self._tables: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def position_table(self, t: int, device: torch.device) -> torch.Tensor:
        """The (2t − 1, D) sinusoid table on ``device``, built once per (t, device)."""
        key = (int(t), torch.device(device))
        cached = self._tables.get(key)
        if cached is None:
            with span("conformer.position_table"):
                table = relative_position_table(int(t), self.config.hidden_size)
                cached = self._tables[key] = table.to(device)
        return cached

    def forward(
        self, waveform: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        feats, out_lengths = self.feature_encoder(waveform, lengths)
        h = self.feature_projection(feats)
        b, t, _ = h.shape
        valid = None
        if out_lengths is None:
            key_lengths = torch.full((b,), t, dtype=torch.int32, device=h.device)
        else:
            valid = torch.arange(t, device=h.device)[None, :] < out_lengths[:, None]
            h = h.masked_fill(~valid[:, :, None], 0.0)
            key_lengths = out_lengths.to(torch.int32)  # the kernel's type, cast once
        pe = self.position_table(t, h.device)
        for i in range(self.config.num_layers):
            h = getattr(self, f"layer_{i}")(h, pe, key_lengths, valid)
        return self.encoder_norm(h), out_lengths


# ---------------------------------------------------------------------------
# HF checkpoint porting
# ---------------------------------------------------------------------------


def conformer_config_from_hf(hf_config: Any) -> ConformerConfig:
    """A :class:`ConformerConfig` from a ``transformers.Wav2Vec2ConformerConfig``;
    only the relative-position Large layout (``feat_extract_norm="layer"``,
    GELU convs, SiLU blocks) is taken."""
    layout = (getattr(hf_config, "position_embeddings_type", None),
              getattr(hf_config, "feat_extract_norm", None),
              getattr(hf_config, "feat_extract_activation", None),
              getattr(hf_config, "hidden_act", None))
    if layout[0] != "relative" or layout[1:3] != ("layer", "gelu") or layout[3] not in (
            "swish", "silu"):
        raise ValueError(
            "only the relative-position Conformer with layer-norm convs is ported "
            "(position_embeddings_type='relative', feat_extract_norm='layer', GELU convs, "
            f"SiLU blocks); the checkpoint has position_embeddings_type={layout[0]!r}, "
            f"feat_extract_norm={layout[1]!r}, feat_extract_activation={layout[2]!r}, "
            f"hidden_act={layout[3]!r}")
    return ConformerConfig(
        hidden_size=hf_config.hidden_size, num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads, intermediate_size=hf_config.intermediate_size,
        conv_dim=tuple(hf_config.conv_dim), conv_kernel=tuple(hf_config.conv_kernel),
        conv_stride=tuple(hf_config.conv_stride), layer_norm_eps=hf_config.layer_norm_eps, conv_bias=bool(hf_config.conv_bias),
        conv_depthwise_kernel_size=hf_config.conv_depthwise_kernel_size)


_LAYER_NAMES = {  # ours: transformers' (under encoder.layers.<i>.)
    "ff1_norm": "ffn1_layer_norm", "ff1_in": "ffn1.intermediate_dense",
    "ff1_out": "ffn1.output_dense", "attn_norm": "self_attn_layer_norm",
    "q": "self_attn.linear_q", "k": "self_attn.linear_k", "v": "self_attn.linear_v",
    "out": "self_attn.linear_out", "conv_norm": "conv_module.layer_norm",
    "batch_norm": "conv_module.batch_norm", "ff2_norm": "ffn2_layer_norm",
    "ff2_in": "ffn2.intermediate_dense", "ff2_out": "ffn2.output_dense",
    "final_norm": "final_layer_norm",
}


def port_hf_conformer_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a ``transformers.Wav2Vec2ConformerModel`` state dict (relative
    positions, layer-norm convs) onto :class:`ConformerModel`.

    Accepts numpy arrays or tensors. A head model's backbone keys
    (``wav2vec2_conformer.`` prefix) are taken with the prefix stripped. The
    positional conv (``encoder.pos_conv_embed.*``, which the published
    forward never calls), the masked-spec embedding and any head are
    dropped; the pointwise convs' (out, in, 1) kernels become (out, in)
    matrices. BatchNorm's ``num_batches_tracked`` stays int64 (0 where the
    checkpoint has none)."""
    prefix = "wav2vec2_conformer."
    if any(k.startswith(prefix) for k in state_dict):
        state_dict = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if ("feature_extractor.conv_layers.1.layer_norm.weight" not in state_dict
            or "encoder.layers.0.self_attn.linear_pos.weight" not in state_dict):
        raise ValueError(
            "state dict does not look like a transformers Wav2Vec2ConformerModel with relative "
            "positions and layer-norm convs: no 'feature_extractor.conv_layers.1.layer_norm.*' "
            "or 'encoder.layers.0.self_attn.linear_pos.weight' keys (got e.g. "
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
    for leaf in ("weight", "bias"):
        out[f"feature_projection.norm.{leaf}"] = t(f"feature_projection.layer_norm.{leaf}")
        out[f"feature_projection.projection.{leaf}"] = t(f"feature_projection.projection.{leaf}")
        out[f"encoder_norm.{leaf}"] = t(f"encoder.layer_norm.{leaf}")
    counts: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        pre, ours = f"encoder.layers.{i}", f"layer_{i}"
        for name, theirs in _LAYER_NAMES.items():
            for leaf in ("weight", "bias"):
                out[f"{ours}.{name}.{leaf}"] = t(f"{pre}.{theirs}.{leaf}")
        bn = f"{pre}.conv_module.batch_norm"
        out[f"{ours}.batch_norm.running_mean"] = t(f"{bn}.running_mean")
        out[f"{ours}.batch_norm.running_var"] = t(f"{bn}.running_var")
        tracked = f"{bn}.num_batches_tracked"
        counts[f"{ours}.batch_norm.num_batches_tracked"] = torch.tensor(
            int(t(tracked)) if tracked in state_dict else 0, dtype=torch.int64)
        out[f"{ours}.pos.weight"] = t(f"{pre}.self_attn.linear_pos.weight")
        out[f"{ours}.pos_bias_u"] = t(f"{pre}.self_attn.pos_bias_u")
        out[f"{ours}.pos_bias_v"] = t(f"{pre}.self_attn.pos_bias_v")
        out[f"{ours}.pointwise1.weight"] = t(f"{pre}.conv_module.pointwise_conv1.weight")[..., 0]
        out[f"{ours}.depthwise.weight"] = t(f"{pre}.conv_module.depthwise_conv.weight")
        out[f"{ours}.pointwise2.weight"] = t(f"{pre}.conv_module.pointwise_conv2.weight")[..., 0]
    ported = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
    return {**ported, **counts}
