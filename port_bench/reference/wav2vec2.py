"""Wav2Vec2-base and the extractor's chunking in plain PyTorch: the
yardstick the benchmark holds the program's extraction to.

Written from the published architecture (``wav2vec2-base``: a 7-layer
strided conv feature encoder with a per-channel time norm after its first
conv, GELU after each conv, a LayerNorm and projection to the hidden width,
a grouped positional conv of even kernel whose extra frame is dropped, then
post-norm transformer layers) and the reference extractor's chunking: 5 s
chunks every 4 s, a chunk shorter than 0.5 s dropped, each chunk encoded on
its own and the chunks' frames concatenated, overlap included.

Chunks are encoded unpadded, chunks of one length together, so no mask is
needed. Imports torch only.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

Weights = Mapping[str, torch.Tensor]


def chunk_bounds(n_samples: int, cfg: Mapping) -> List[tuple]:
    """(start, end) of each chunk the extractor encodes from a waveform of
    ``n_samples`` (none below ``min_seconds``: the file is skipped)."""
    sr = cfg["sample_rate"]
    size = int(sr * cfg["chunk_seconds"])
    step = int(sr * (cfg["chunk_seconds"] - cfg["overlap_seconds"]))
    least = int(sr * cfg["min_seconds"])
    if n_samples < least:
        return []
    out = []
    for start in range(0, n_samples, step):
        end = min(start + size, n_samples)
        if end - start >= least:
            out.append((start, end))
    return out


def encode(w: Weights, wav: torch.Tensor, cfg: Mapping) -> torch.Tensor:
    """Hidden states (N, T, D) of N chunks of one length, ``wav`` (N, L)."""
    eps = cfg["layer_norm_eps"]
    h = wav[:, None, :]
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        h = F.conv1d(h, w[f"feature_encoder.conv_{i}.weight"], stride=s)
        if i == 0:
            mean = h.mean(dim=2, keepdim=True)
            var = ((h - mean) ** 2).mean(dim=2, keepdim=True)
            h = (h - mean) / torch.sqrt(var + eps)
            h = h * w["feature_encoder.gn_scale"][:, None] + w["feature_encoder.gn_bias"][:, None]
        h = F.gelu(h)
    h = h.transpose(1, 2)
    h = F.layer_norm(h, h.shape[-1:], w["feature_projection.norm.weight"],
                     w["feature_projection.norm.bias"], eps)
    h = F.linear(h, w["feature_projection.projection.weight"], w["feature_projection.projection.bias"])
    t_len = h.shape[1]
    kp = cfg["pos_conv_kernel"]
    pos = F.conv1d(h.transpose(1, 2), w["pos_conv.conv.weight"], w["pos_conv.conv.bias"],
                   padding=kp // 2, groups=cfg["pos_conv_groups"])[:, :, :t_len]
    h = F.layer_norm(h + F.gelu(pos).transpose(1, 2), h.shape[-1:], w["encoder_norm.weight"],
                     w["encoder_norm.bias"], eps)
    heads = cfg["num_heads"]
    n, d = h.shape[0], h.shape[2]
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"

        def proj(x, name):
            return F.linear(x, w[f"{p}.{name}.weight"], w[f"{p}.{name}.bias"])

        def split(y):
            return y.reshape(n, t_len, heads, d // heads).transpose(1, 2)

        q = split(proj(h, "q") * (d // heads) ** -0.5)
        k_, v = split(proj(h, "k")), split(proj(h, "v"))
        probs = torch.softmax(torch.matmul(q, k_.transpose(-1, -2)), dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, t_len, d)
        h = F.layer_norm(h + proj(ctx, "out"), (d,), w[f"{p}.attn_norm.weight"],
                         w[f"{p}.attn_norm.bias"], eps)
        ff = proj(F.gelu(proj(h, "ff1")), "ff2")
        h = F.layer_norm(h + ff, (d,), w[f"{p}.ff_norm.weight"], w[f"{p}.ff_norm.bias"], eps)
    return h


def sequences(w: Weights, waveforms: Mapping[str, np.ndarray], cfg: Mapping,
              device) -> Dict[str, np.ndarray]:
    """{name: (T, D) float32 frames} of each waveform, as the extractor
    defines them: every chunk encoded alone, the frames concatenated."""
    chunks = []  # (name, order, samples)
    for name, wav in waveforms.items():
        for order, (a, b) in enumerate(chunk_bounds(len(wav), cfg)):
            chunks.append((name, order, np.asarray(wav[a:b], np.float32)))
    by_length: Dict[int, list] = {}
    for c in chunks:
        by_length.setdefault(len(c[2]), []).append(c)
    frames: Dict[tuple, np.ndarray] = {}
    with torch.no_grad():
        for group in by_length.values():
            for start in range(0, len(group), 16):
                part = group[start : start + 16]
                wav = torch.from_numpy(np.stack([c[2] for c in part])).to(device)
                out = encode(w, wav, cfg).cpu().numpy()
                for c, o in zip(part, out):
                    frames[(c[0], c[1])] = o
    out: Dict[str, List[np.ndarray]] = {}
    for name, order, _ in chunks:
        out.setdefault(name, []).append(frames[(name, order)])
    return {name: np.concatenate(parts) for name, parts in out.items()}
