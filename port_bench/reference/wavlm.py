"""WavLM-Large in plain PyTorch: the yardstick the benchmark holds the
program's WavLM extraction to.

Written from the published architecture (Chen et al., arXiv:2110.13900, and
``microsoft/wavlm-large``'s layout: ``feat_extract_norm="layer"``,
``do_stable_layer_norm=True``): a 7-layer strided conv feature encoder, each
conv (no bias) followed by a LayerNorm over the channels of each frame and
GELU; a LayerNorm and projection to the hidden width; a grouped positional
conv of even kernel whose extra frame is dropped, added after GELU with no
LayerNorm; pre-norm transformer layers ``x + Attn(LN1(x))``,
``x + FFN(LN2(x))``; one LayerNorm after the last layer. Attention adds to
the scores ``(q * d^-1/2) . k^T`` the relative-position bias
``E[bucket(j - i), h]`` of one (num_buckets, heads) table shared by every
layer, scaled per query by the layer's gate ``a (b c_h - 1) + 2``, where
(a, b) are the sigmoids of the sums of the first and last four outputs of a
64 -> 8 product of the head's slice of LN1(x). Chunking is the extractor's
(``reference.wav2vec2.chunk_bounds``), each chunk encoded on its own and the
chunks' frames concatenated, overlap included.

Departures from the published code, none of which changes a value: chunks
are encoded unpadded, chunks of one length together, so no key mask is
needed; the positional conv's weight norm is taken as its folded weight; the
relative-position table is the model's (``rel_attn_embed.weight``) rather
than layer 0's; dropout and layer drop are off (inference). The bias is
formed whole, (heads, T, T), and added to the scores before ``torch.softmax``.

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .wav2vec2 import chunk_bounds

Weights = Mapping[str, torch.Tensor]
GATE_OUTPUTS = 8
CONV_NORM_EPS = 1e-5


def wavlm_spec(cfg: Mapping) -> list:
    """The WavLM encoder's tensors, in the program's names, for
    ``reference.weights.make_weights``: (name, shape, role, fan in)."""
    spec = []
    inp = 1
    for i, (dim, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        spec.append((f"feature_encoder.conv_{i}.weight", (dim, inp, k), "weight", inp * k))
        if cfg.get("conv_bias", False):
            spec.append((f"feature_encoder.conv_{i}.bias", (dim,), "bias", inp * k))
        spec += [(f"feature_encoder.norm_{i}.weight", (dim,), "scale", 1.0),
                 (f"feature_encoder.norm_{i}.bias", (dim,), "shift", 1.0)]
        inp = dim
    d, ff, heads = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_heads"]
    spec += [("feature_projection.norm.weight", (inp,), "scale", 1.0),
             ("feature_projection.norm.bias", (inp,), "shift", 1.0),
             ("feature_projection.projection.weight", (d, inp), "weight", inp),
             ("feature_projection.projection.bias", (d,), "bias", inp)]
    groups, kp = cfg["pos_conv_groups"], cfg["pos_conv_kernel"]
    spec += [("pos_conv.conv.weight", (d, d // groups, kp), "weight", d // groups * kp),
             ("pos_conv.conv.bias", (d,), "bias", d // groups * kp),
             # an nn.Embedding's N(0, 1) initialisation
             ("rel_attn_embed.weight", (cfg["num_buckets"], heads), "weight", 1.0)]
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"
        spec += [(f"{p}.attn_norm.weight", (d,), "scale", 1.0),
                 (f"{p}.attn_norm.bias", (d,), "shift", 1.0)]
        for name in ("q", "k", "v", "out"):
            spec += [(f"{p}.{name}.weight", (d, d), "weight", d), (f"{p}.{name}.bias", (d,), "bias", d)]
        spec += [(f"{p}.gru_rel_pos_linear.weight", (GATE_OUTPUTS, d // heads), "weight", d // heads),
                 (f"{p}.gru_rel_pos_linear.bias", (GATE_OUTPUTS,), "bias", d // heads),
                 (f"{p}.gru_rel_pos_const", (heads,), "scale", 1.0),
                 (f"{p}.ff_norm.weight", (d,), "scale", 1.0), (f"{p}.ff_norm.bias", (d,), "shift", 1.0),
                 (f"{p}.ff1.weight", (ff, d), "weight", d), (f"{p}.ff1.bias", (ff,), "bias", d),
                 (f"{p}.ff2.weight", (d, ff), "weight", ff), (f"{p}.ff2.bias", (d,), "bias", ff)]
    spec += [("encoder_norm.weight", (d,), "scale", 1.0), ("encoder_norm.bias", (d,), "shift", 1.0)]
    return spec


def buckets(t_len: int, cfg: Mapping) -> torch.Tensor:
    """(T, T) int64 bucket of key j - query i, as the published
    ``_relative_positions_bucket`` computes it (on the CPU, in float32)."""
    pos = torch.arange(t_len)
    rel = pos[None, :] - pos[:, None]
    half = cfg["num_buckets"] // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = torch.log(rel.float() / exact) / math.log(cfg["max_bucket_distance"] / exact)
    large = torch.clamp((exact + large * (half - exact)).to(torch.long), max=half - 1)
    return out + torch.where(rel < exact, rel, large)


def encode(w: Weights, wav: torch.Tensor, cfg: Mapping, gate: bool = True,
           pre_norm: bool = True) -> torch.Tensor:
    """Hidden states (N, T, D) of N chunks of one length, ``wav`` (N, L).
    ``gate=False`` (the bias left ungated, g = 1) and ``pre_norm=False``
    (post-norm layers in the pre-norm model's place) are the faults the
    benchmark's tests plant."""
    eps = cfg["layer_norm_eps"]
    h = wav[:, None, :]
    for i, s in enumerate(cfg["conv_stride"]):
        h = F.conv1d(h, w[f"feature_encoder.conv_{i}.weight"], w.get(f"feature_encoder.conv_{i}.bias"),
                     stride=s)
        h = F.layer_norm(h.transpose(1, 2), (h.shape[1],), w[f"feature_encoder.norm_{i}.weight"],
                         w[f"feature_encoder.norm_{i}.bias"], CONV_NORM_EPS)
        h = F.gelu(h).transpose(1, 2)
    h = h.transpose(1, 2)
    h = F.layer_norm(h, h.shape[-1:], w["feature_projection.norm.weight"],
                     w["feature_projection.norm.bias"], eps)
    h = F.linear(h, w["feature_projection.projection.weight"], w["feature_projection.projection.bias"])
    n, t_len, d = h.shape
    kp = cfg["pos_conv_kernel"]
    pos = F.conv1d(h.transpose(1, 2), w["pos_conv.conv.weight"], w["pos_conv.conv.bias"],
                   padding=kp // 2, groups=cfg["pos_conv_groups"])[:, :, :t_len]
    h = h + F.gelu(pos).transpose(1, 2)
    heads = cfg["num_heads"]
    hd = d // heads
    bias = w["rel_attn_embed.weight"][buckets(t_len, cfg).to(h.device)].permute(2, 0, 1)  # (H, T, T)
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"

        def proj(x, name):
            return F.linear(x, w[f"{p}.{name}.weight"], w[f"{p}.{name}.bias"])

        def norm(x, name):
            return F.layer_norm(x, (d,), w[f"{p}.{name}.weight"], w[f"{p}.{name}.bias"], eps)

        def split(y):
            return y.reshape(n, t_len, heads, hd).transpose(1, 2)

        u = norm(h, "attn_norm") if pre_norm else h
        r = proj(split(u), "gru_rel_pos_linear").reshape(n, heads, t_len, 2, GATE_OUTPUTS // 2).sum(-1)
        a, b = torch.sigmoid(r).unbind(-1)  # (N, H, T) each
        g = a * (b * w[f"{p}.gru_rel_pos_const"][:, None] - 1.0) + 2.0
        if not gate:
            g = torch.ones_like(g)
        q = split(proj(u, "q") * hd ** -0.5)
        k, v = split(proj(u, "k")), split(proj(u, "v"))
        scores = torch.matmul(q, k.transpose(-1, -2)) + g[..., None] * bias[None]
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(n, t_len, d)
        h = h + proj(ctx, "out")
        if not pre_norm:
            h = norm(h, "attn_norm")
        x = norm(h, "ff_norm") if pre_norm else h
        h = h + proj(F.gelu(proj(x, "ff1")), "ff2")
        if not pre_norm:
            h = norm(h, "ff_norm")
    return F.layer_norm(h, (d,), w["encoder_norm.weight"], w["encoder_norm.bias"], eps)


def sequences(w: Weights, waveforms: Mapping[str, np.ndarray], cfg: Mapping, device,
              group: int = 8, **faults) -> Dict[str, np.ndarray]:
    """{name: (T, D) float32 frames} of each waveform, as the extractor
    defines them: every chunk encoded alone, the frames concatenated.
    Chunks of one length are encoded ``group`` at a time."""
    chunks = []  # (name, order, samples)
    for name, wav in waveforms.items():
        for order, (a, b) in enumerate(chunk_bounds(len(wav), cfg)):
            chunks.append((name, order, np.asarray(wav[a:b], np.float32)))
    by_length: Dict[int, list] = {}
    for c in chunks:
        by_length.setdefault(len(c[2]), []).append(c)
    frames: Dict[tuple, np.ndarray] = {}
    with torch.no_grad():
        for same in by_length.values():
            for start in range(0, len(same), group):
                part = same[start : start + group]
                wav = torch.from_numpy(np.stack([c[2] for c in part])).to(device)
                out = encode(w, wav, cfg, **faults).cpu().numpy()
                for c, o in zip(part, out):
                    frames[(c[0], c[1])] = o
    out: Dict[str, List[np.ndarray]] = {}
    for name, order, _ in chunks:
        out.setdefault(name, []).append(frames[(name, order)])
    return {name: np.concatenate(parts) for name, parts in out.items()}
