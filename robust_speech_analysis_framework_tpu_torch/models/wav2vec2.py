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
additive bias. Attention is plain matmul + softmax (XLA computed it on the
TPU; there is no kernel of the JAX package here).

``Wav2Vec2Config.compute_dtype="bfloat16"`` is the JAX package's reduced
precision preset (``models/wav2vec2.py:49-57``): matmuls and convs take
bfloat16 operands and give bfloat16 results, while the channel norm, the
feature encoder's output, the projection and positional-conv outputs, the
attention scores and softmax, the ``out`` and ``ff2`` outputs and every
LayerNorm stay float32 (``:109-118``, ``:129-130``, ``:149-150``,
``:180-194``). Weights are stored in float32 and cast at each product, as
Flax's ``promote_dtype`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import conv1d
from ..ops.cuda import wav2vec2 as w2v_ops
from ..ops.cuda.wav2vec2 import channel_norm_gelu, conv0_norm_gelu, feature_conv, pos_conv_gelu


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
    # "float32" or "bfloat16": the dtype of the matmuls and convs
    compute_dtype: str = "float32"

    @property
    def cdtype(self) -> torch.dtype:
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', not "
                             f"{self.compute_dtype!r}")
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def output_length(self, n_samples) -> Any:
        """Conv-stack output frames for an input of ``n_samples`` samples."""
        t = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


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
        cdt = cfg.cdtype
        cur_lengths = lengths
        # the wrappers pick their kernel or plain version by device and cdt;
        # conv_1 ... take and give (B, T, C)
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            if cur_lengths is not None:
                cur_lengths = torch.div(cur_lengths - k, s, rounding_mode="floor") + 1
            if i > 0:
                conv = getattr(self, f"conv_{i}")
                h = feature_conv(h, conv.weight, conv.bias, s, True, cdt=cdt)
            else:
                h = conv0_norm_gelu(waveform, self.conv_0.weight, self.gn_scale, self.gn_bias,
                                    cur_lengths, cfg.layer_norm_eps, stride=s,
                                    cdt=cdt).transpose(1, 2)
        return h.float(), cur_lengths


def _dense(layer: nn.Linear, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``layer(x)`` with operands and result in ``cdt`` (Flax's ``Dense(dtype=)``)."""
    return F.linear(x.to(cdt), layer.weight.to(cdt), layer.bias.to(cdt))


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.cdtype = config.cdtype
        self.norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(self.projection, self.norm(x), self.cdtype).float()


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (kernel 128, groups 16): hidden
    states (B, T, D) → GELU(conv + bias) (B, T, D) float32, every frame of
    the padded batch; the caller adds it to its input."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        k = config.pos_conv_kernel
        self.cdtype = config.cdtype
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.pos_conv_groups,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv  # the wrapper picks the kernel or its plain version by device and cdt
        return pos_conv_gelu(x, conv.weight, conv.bias, conv.groups, cdt=self.cdtype)


class EncoderLayer(nn.Module):
    """Post-norm transformer block (wav2vec2-base: do_stable_layer_norm=False)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.cdtype = cdt = config.cdtype
        # the query scale rounded to the compute dtype first, as the JAX
        # package multiplies by jnp.asarray(head_dim**-0.5, cdt)
        self.q_scale = float(torch.tensor((d // config.num_heads) ** -0.5, dtype=cdt))
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.attn_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.ff1 = nn.Linear(d, config.intermediate_size)
        self.ff2 = nn.Linear(config.intermediate_size, d)
        self.ff_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
        cdt = self.cdtype
        ctx = _attention(x, (self.q.weight, self.q.bias), (self.k.weight, self.k.bias),
                         (self.v.weight, self.v.bias), self.num_heads, self.q_scale, cdt,
                         attn_bias)
        x = self.attn_norm(x + _dense(self.out, ctx, cdt).float())
        ff = _dense(self.ff2, F.gelu(_dense(self.ff1, x, cdt)), cdt).float()
        return self.ff_norm(x + ff)


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            cdt: torch.dtype) -> torch.Tensor:
    """:func:`_dense` over explicit tensors."""
    return F.linear(x.to(cdt), weight.to(cdt), None if bias is None else bias.to(cdt))


def _attention(x: torch.Tensor, q: tuple, k: tuple, v: tuple, heads: int, q_scale: float,
               cdt: torch.dtype, attn_bias: Optional[torch.Tensor],
               normalize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> torch.Tensor:
    """Multi-head attention's context (B, T, heads · head_dim) in ``cdt``,
    before the output projection; ``q``/``k``/``v`` are (weight, bias) of
    ``heads`` heads (all of a layer's, or an mp slice of them); ``q`` may
    instead be the queries already projected and scaled, (B, T, heads ·
    head_dim) in ``cdt`` (the Conformer's biased queries; ``q_scale`` is then
    unused). ``normalize`` (the scores (B, heads, T, T) → probabilities)
    takes the place of ``attn_bias`` and the softmax (WavLM's and the
    Conformer's biased softmaxes)."""
    b, t, _ = x.shape
    split = lambda y: y.reshape(b, t, heads, -1).transpose(1, 2)  # noqa: E731
    qh = split(q if isinstance(q, torch.Tensor) else _linear(x, *q, cdt) * q_scale)
    kh = split(_linear(x, *k, cdt))
    vh = split(_linear(x, *v, cdt))
    # scores and softmax in float32 whatever the compute dtype
    scores = torch.matmul(qh, kh.transpose(-1, -2)).float()  # (B, heads, T, T)
    if normalize is not None:
        probs = normalize(scores)
    else:
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(cdt), vh).transpose(1, 2).reshape(b, t, -1)


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
# Split over a (dp, mp) device grid
# ---------------------------------------------------------------------------


class ShardedWav2Vec2:
    """A :class:`Wav2Vec2Model` laid over a (dp, mp) grid (the JAX
    extractor's ``mesh=``, ``features/wav2vec2.py:222-257``).

    Every dp row holds the weights, the rule-matched ones
    (``parallel.sharding``) split over its mp devices, the others copied on
    each; a batch splits over the rows (``batch_sharding``). In a row the
    products are Megatron's: the feature encoder's convs, the projection and
    the positional conv compute their output channels' slice on each device
    and gather them; ``q``/``k``/``v``/``ff1`` are column-parallel (a
    device's heads and hidden units, with their bias slices), ``out``/``ff2``
    row-parallel, their partial products summed across the row on its lead
    device, where the norms and the residual adds run. A split that does
    not fall on whole heads or conv groups gathers those weights whole on
    the lead. With mp = 1 each row runs the model whole on its device.
    Called as the model is: ``(wav, lengths)`` on any device → hidden
    states and frame counts on the grid's lead device.
    """

    def __init__(self, model: Wav2Vec2Model, mesh):
        from ..parallel.sharding import place_params, shard_params

        # parameters and buffers (the Conformer's BatchNorm statistics), each
        # row's copy on its own devices
        params = {n: p.detach() for n, p in (*model.named_parameters(), *model.named_buffers())}
        self.model = model
        self.mesh = mesh
        self.config = model.config
        self.spec = shard_params(params, mesh)
        self.slices = place_params(params, mesh)

    def __call__(self, wav: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        from ..parallel.sharding import batch_sharding

        lead = self.mesh.lead
        outs = [self._row(r, wav[rows].to(self.mesh.rows[r][0]),
                          lengths[rows].to(self.mesh.rows[r][0]))
                for r, rows in enumerate(batch_sharding(self.mesh, wav.shape[0]))]
        return (torch.cat([h.to(lead) for h, _ in outs]),
                torch.cat([n.to(lead) for _, n in outs]))

    # --- one dp row ------------------------------------------------------------

    def _whole(self, r: int, name: str) -> torch.Tensor:
        from ..parallel.sharding import gather

        return gather(self.slices[name][r], self.spec[name], self.mesh.rows[r][0])

    def _part(self, r: int, c: int, name: str, dim: int = 0) -> torch.Tensor:
        """Parameter ``name``'s mp slice c along ``dim``: the slice held at
        (r, c), or that share of a replicated copy."""
        t = self.slices[name][r][c]
        return t if self.spec[name] is not None else t.chunk(self.mesh.mp, dim)[c]

    def _columns(self, r: int, x: torch.Tensor, weight: str, bias: Optional[str],
                 fn: Callable, cat_dim: int) -> torch.Tensor:
        """``fn(x, weight, bias)`` with the weight's output channels split
        over row r's devices, gathered on its lead along ``cat_dim``."""
        devs = self.mesh.rows[r]
        if self.spec[weight] is None:
            return fn(x, self._whole(r, weight), None if bias is None else self._whole(r, bias))
        return torch.cat([
            fn(x.to(dev), self._part(r, c, weight),
               None if bias is None else self._part(r, c, bias)).to(devs[0])
            for c, dev in enumerate(devs)], cat_dim)

    def _row(self, r: int, wav: torch.Tensor, lengths: torch.Tensor):
        if self.mesh.mp == 1:  # nothing split: the model whole on the row's device
            params = {n: self._whole(r, n) for n in self.slices}
            return torch.func.functional_call(self.model, params, (wav, lengths))
        cfg = self.config
        cdt = cfg.cdtype
        lead = self.mesh.rows[r][0]
        w = lambda n: self._whole(r, n)  # noqa: E731
        h = wav[:, None, :]
        cur = lengths
        for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
            h = self._columns(r, h, f"feature_encoder.conv_{i}.weight", None,
                              lambda x, wt, _b, s=s: conv1d(x, wt, None, cdt, stride=s), 1)
            cur = torch.div(cur - k, s, rounding_mode="floor") + 1
            h = F.gelu(h) if i > 0 else channel_norm_gelu(
                h, cur, w("feature_encoder.gn_scale"), w("feature_encoder.gn_bias"),
                cfg.layer_norm_eps)
        feats = h.float().transpose(1, 2)
        normed = F.layer_norm(feats, (feats.shape[-1],), w("feature_projection.norm.weight"),
                              w("feature_projection.norm.bias"), cfg.layer_norm_eps)
        h = self._columns(r, normed, "feature_projection.projection.weight",
                          "feature_projection.projection.bias",
                          lambda x, wt, b: _linear(x, wt, b, cdt), 2).float()
        t = torch.arange(h.shape[1], device=lead)
        valid = t[None, :] < cur[:, None]
        h = h.masked_fill(~valid[:, :, None], 0.0)
        attn_bias = torch.zeros(valid.shape, dtype=h.dtype, device=lead)
        attn_bias = attn_bias.masked_fill(~valid, -1e30)[:, None, None, :]
        h = F.layer_norm(h + self._pos_conv(r, h), (h.shape[-1],), w("encoder_norm.weight"),
                         w("encoder_norm.bias"), cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            h = self._layer(r, f"layer_{i}", h, attn_bias)
        return h, cur

    def _pos_conv(self, r: int, x: torch.Tensor) -> torch.Tensor:
        """The positional conv's plain version (cuDNN's per slice), whole or,
        where a device's output channels are whole groups, on each device
        over its channels' inputs only (GELU acts element by element)."""
        cdt, groups, mp = self.config.cdtype, self.config.pos_conv_groups, self.mesh.mp
        if self.spec["pos_conv.conv.weight"] is None or groups % mp:
            return w2v_ops.pos_conv_gelu_reference(
                x, self._whole(r, "pos_conv.conv.weight"), self._whole(r, "pos_conv.conv.bias"),
                groups, cdt)
        devs = self.mesh.rows[r]
        return torch.cat([
            w2v_ops.pos_conv_gelu_reference(
                part.to(dev), self._part(r, c, "pos_conv.conv.weight"),
                self._part(r, c, "pos_conv.conv.bias"), groups // mp, cdt).to(devs[0])
            for c, (part, dev) in enumerate(zip(x.chunk(mp, 2), devs))], 2)

    def _layer(self, r: int, pre: str, x: torch.Tensor,
               attn_bias: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        cdt, heads, mp = cfg.cdtype, cfg.num_heads, self.mesh.mp
        eps = cfg.layer_norm_eps
        devs = self.mesh.rows[r]
        lead = devs[0]
        layer = getattr(self.model, pre)
        w = lambda n: self._whole(r, f"{pre}.{n}")  # noqa: E731
        parallel = lambda *names: all(self.spec[f"{pre}.{n}.weight"] is not None  # noqa: E731
                                      for n in names)

        def reduce(parts: List[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
            out = parts[0].to(lead)
            for p in parts[1:]:
                out = out + p.to(lead)
            return out + bias

        if parallel("q", "k", "v", "out") and heads % mp == 0:
            qkv = lambda c, n: (self._part(r, c, f"{pre}.{n}.weight"),  # noqa: E731
                                self._part(r, c, f"{pre}.{n}.bias"))
            parts = []
            for c, dev in enumerate(devs):
                ctx = _attention(x.to(dev), qkv(c, "q"), qkv(c, "k"), qkv(c, "v"), heads // mp,
                                 layer.q_scale, cdt, attn_bias.to(dev))
                parts.append(_linear(ctx, self._part(r, c, f"{pre}.out.weight", 1), None,
                                     cdt).float())
            attn = reduce(parts, w("out.bias"))
        else:
            ctx = _attention(x, (w("q.weight"), w("q.bias")), (w("k.weight"), w("k.bias")),
                             (w("v.weight"), w("v.bias")), heads, layer.q_scale, cdt, attn_bias)
            attn = _linear(ctx, w("out.weight"), w("out.bias"), cdt).float()
        x = F.layer_norm(x + attn, (x.shape[-1],), w("attn_norm.weight"), w("attn_norm.bias"), eps)
        if parallel("ff1", "ff2"):
            parts = [_linear(F.gelu(_linear(x.to(dev), self._part(r, c, f"{pre}.ff1.weight"),
                                            self._part(r, c, f"{pre}.ff1.bias"), cdt)),
                             self._part(r, c, f"{pre}.ff2.weight", 1), None, cdt).float()
                     for c, dev in enumerate(devs)]
            ff = reduce(parts, w("ff2.bias"))
        else:
            ff = _linear(F.gelu(_linear(x, w("ff1.weight"), w("ff1.bias"), cdt)),
                         w("ff2.weight"), w("ff2.bias"), cdt).float()
        return F.layer_norm(x + ff, (x.shape[-1],), w("ff_norm.weight"), w("ff_norm.bias"), eps)


# ---------------------------------------------------------------------------
# HF checkpoint porting
# ---------------------------------------------------------------------------

def hf_pos_conv_weight(state_dict: Mapping[str, Any], t: Callable[[str], np.ndarray]
                       ) -> np.ndarray:
    """The weight-normed positional conv of a ``transformers`` encoder as a
    plain weight: g * v / ||v||, the norm taken over (out, in/groups) for
    each tap (HF's weight_norm dim=2). Newer torch exports use
    parametrizations.*.original{0,1}. ``t`` reads an entry as an array."""
    if "encoder.pos_conv_embed.conv.weight_g" in state_dict:
        g = t("encoder.pos_conv_embed.conv.weight_g")
        v = t("encoder.pos_conv_embed.conv.weight_v")
    else:
        g = t("encoder.pos_conv_embed.conv.parametrizations.weight.original0")
        v = t("encoder.pos_conv_embed.conv.parametrizations.weight.original1")
    norm = np.sqrt((v**2).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


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

    out["pos_conv.conv.weight"] = hf_pos_conv_weight(state_dict, t)
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
