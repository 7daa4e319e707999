"""Wav2Vec2-Conformer-Large (relative positions) in plain PyTorch: the
yardstick the benchmark holds the program's Conformer extraction to.

Written from the published architecture (Gulati et al., arXiv:2005.08100;
Dai et al., arXiv:1901.02860; ``facebook/wav2vec2-conformer-rel-pos-large``'s
layout, ``transformers``' ``Wav2Vec2ConformerModel``): a 7-layer strided conv
feature encoder, each conv (with bias) followed by a LayerNorm over the
channels of each frame and GELU; a LayerNorm and projection to the hidden
width; then blocks of ``x + ½ FFN(LN(x))`` (FFN: linear, SiLU, linear),
``x + Attn(LN(x))``, ``x + ConvModule(x)``, ``x + ½ FFN(LN(x))`` and the
block's own LayerNorm; one LayerNorm after the last block. The conv module is
LN, a pointwise conv to twice the width (no bias), GLU, a depthwise conv of
odd kernel K zero-padded by K // 2 a side (no bias), BatchNorm on its running
statistics, SiLU and a pointwise conv (no bias). Attention scores are
``((q + u)·kᵀ + shift((q + v)·Pᵀ)) / √d_head``: ``P`` the layer's bias-free
projection of the sinusoid table of the distances T − 1 … −(T − 1), taken
from a table of ``max(max_source_positions, T)`` positions as published, and
``shift`` the Transformer-XL shift (a zero column, a view, the first T
columns), so that key j of query i reads distance i − j. Chunking is the
extractor's (``reference.wav2vec2.chunk_bounds``), each chunk encoded on its
own and the chunks' frames concatenated, overlap included.

Departures from the published code, none of which changes a value on a chunk
alone: chunks are encoded unpadded, chunks of one length together, so no key
mask is needed; dropout, layer drop and SpecAugment are off (inference). The
published forward builds a positional conv and never calls it; so does this.

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from .wav2vec2 import chunk_bounds
from .weights import _bn

Weights = Mapping[str, torch.Tensor]
CONV_NORM_EPS = 1e-5  # the conv stack's LayerNorms
BLOCK_NORM_EPS = 1e-5  # the blocks' LayerNorms and the BatchNorm: torch's defaults


def conformer_spec(cfg: Mapping) -> list:
    """The Conformer encoder's tensors, in the program's names, for
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
    kd = cfg["conv_depthwise_kernel_size"]
    spec += [("feature_projection.norm.weight", (inp,), "scale", 1.0),
             ("feature_projection.norm.bias", (inp,), "shift", 1.0),
             ("feature_projection.projection.weight", (d, inp), "weight", inp),
             ("feature_projection.projection.bias", (d,), "bias", inp)]

    def norm(name):
        return [(f"{name}.weight", (d,), "scale", 1.0), (f"{name}.bias", (d,), "shift", 1.0)]

    def dense(name, out, fan):
        return [(f"{name}.weight", (out, fan), "weight", fan), (f"{name}.bias", (out,), "bias", fan)]

    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"
        spec += norm(f"{p}.ff1_norm") + dense(f"{p}.ff1_in", ff, d) + dense(f"{p}.ff1_out", d, ff)
        spec += norm(f"{p}.attn_norm")
        for name in ("q", "k", "v", "out"):
            spec += dense(f"{p}.{name}", d, d)
        spec += [(f"{p}.pos.weight", (d, d), "weight", d),
                 (f"{p}.pos_bias_u", (heads, d // heads), "weight", d // heads),
                 (f"{p}.pos_bias_v", (heads, d // heads), "weight", d // heads)]
        spec += norm(f"{p}.conv_norm")
        spec += [(f"{p}.pointwise1.weight", (2 * d, d), "weight", d),
                 (f"{p}.depthwise.weight", (d, 1, kd), "weight", kd)]
        spec += _bn(f"{p}.batch_norm", d)
        spec += [(f"{p}.pointwise2.weight", (d, d), "weight", d)]
        spec += norm(f"{p}.ff2_norm") + dense(f"{p}.ff2_in", ff, d) + dense(f"{p}.ff2_out", d, ff)
        spec += norm(f"{p}.final_norm")
    spec += norm("encoder_norm")
    return spec


def position_table(t_len: int, cfg: Mapping) -> torch.Tensor:
    """(2T − 1, D) float32 sinusoids of the distances T − 1 … −(T − 1), cut
    from the table of ``max(max_source_positions, T)`` positions as the
    published ``Wav2Vec2ConformerRelPositionalEmbedding`` builds and slices
    it, on the CPU."""
    d = cfg["hidden_size"]
    n = max(int(cfg["max_source_positions"]), t_len)
    position = torch.arange(0, n, dtype=torch.int64).float().unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d, 2, dtype=torch.int64).float() * -(math.log(10000.0) / d))
    pe_positive = torch.zeros(n, d)
    pe_negative = torch.zeros(n, d)
    pe_positive[:, 0::2] = torch.sin(position * div_term)
    pe_positive[:, 1::2] = torch.cos(position * div_term)
    pe_negative[:, 0::2] = torch.sin(-1 * position * div_term)
    pe_negative[:, 1::2] = torch.cos(-1 * position * div_term)
    pe = torch.cat([torch.flip(pe_positive, [0]), pe_negative[1:]])
    start = pe.shape[0] // 2 - t_len + 1
    return pe[start : pe.shape[0] // 2 + t_len]


def shift(bd: torch.Tensor) -> torch.Tensor:
    """The published Transformer-XL shift of (N, H, T, 2T − 1) products to
    (N, H, T, T): key j of query i takes column T − 1 − i + j."""
    n, h, t, _ = bd.shape
    padded = torch.cat([torch.zeros(n, h, t, 1, dtype=bd.dtype, device=bd.device), bd], dim=-1)
    padded = padded.view(n, h, 2 * t, t)
    return padded[:, :, 1:].view_as(bd)[:, :, :, : bd.shape[-1] // 2 + 1]


def encode(w: Weights, wav: torch.Tensor, cfg: Mapping, mirrored: bool = False,
           macaron: bool = True) -> torch.Tensor:
    """Hidden states (N, T, D) of N chunks of one length, ``wav`` (N, L).
    ``mirrored`` (the position term of distance j − i in place of i − j) and
    ``macaron=False`` (both FFNs added whole, not halved) are the faults the
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
    heads = cfg["num_heads"]
    hd = d // heads
    pe = position_table(t_len, cfg).to(h.device)
    if mirrored:
        pe = torch.flip(pe, [0])  # row T - 1 - (i - j) then holds distance j - i
    half = 0.5 if macaron else 1.0
    kd = cfg["conv_depthwise_kernel_size"]
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"

        def proj(x, name):
            return F.linear(x, w[f"{p}.{name}.weight"], w.get(f"{p}.{name}.bias"))

        def norm(x, name):
            return F.layer_norm(x, (d,), w[f"{p}.{name}.weight"], w[f"{p}.{name}.bias"],
                                BLOCK_NORM_EPS)

        def ffn(x, name):
            return proj(F.silu(proj(norm(x, f"{name}_norm"), f"{name}_in")), f"{name}_out")

        def split(y):
            return y.reshape(n, -1, heads, hd).transpose(1, 2)

        h = h + half * ffn(h, "ff1")
        u = norm(h, "attn_norm")
        q, k, v = split(proj(u, "q")), split(proj(u, "k")), split(proj(u, "v"))
        pos = proj(pe, "pos").reshape(-1, heads, hd).permute(1, 2, 0)  # (H, hd, 2T - 1)
        ac = torch.matmul(q + w[f"{p}.pos_bias_u"][None, :, None, :], k.transpose(-1, -2))
        bd = shift(torch.matmul(q + w[f"{p}.pos_bias_v"][None, :, None, :], pos))
        probs = torch.softmax((ac + bd) / math.sqrt(hd), dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, t_len, d)
        h = h + proj(ctx, "out")
        # the conv module, on (N, D, T)
        y = norm(h, "conv_norm").transpose(1, 2)
        y = F.glu(F.conv1d(y, w[f"{p}.pointwise1.weight"][:, :, None]), dim=1)
        y = F.conv1d(y, w[f"{p}.depthwise.weight"], padding=(kd - 1) // 2, groups=d)
        y = F.batch_norm(y, w[f"{p}.batch_norm.running_mean"], w[f"{p}.batch_norm.running_var"],
                         w[f"{p}.batch_norm.weight"], w[f"{p}.batch_norm.bias"], False, 0.0,
                         BLOCK_NORM_EPS)
        y = F.conv1d(F.silu(y), w[f"{p}.pointwise2.weight"][:, :, None])
        h = h + y.transpose(1, 2)
        h = h + half * ffn(h, "ff2")
        h = norm(h, "final_norm")
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
