"""The CNN-LSTM in plain PyTorch: the yardstick the benchmark holds the
program's classifier to.

Written from the published description (the reference's ``src/models.py``
CNNLSTM) with the framework's length masking and Flax-semantics train-mode
BatchNorm: two residual blocks of k=3 same-padded convs with BatchNorm and a
1×1 conv+BN skip where the widths differ, activation after the add; a
non-overlapping time max-pool between them; a bidirectional LSTM (gate order
i, f, g, o) whose reverse direction reads each sequence's valid prefix
backwards; attention pooling with padded steps masked to −inf; a linear
head. The LSTM is a loop over time of torch ops, one ``bmm`` a step for
every lane and direction. No kernel, cache or library recurrence is used.

Every function takes K lanes of one architecture: each weight has a leading
lane axis (K, ...), the input batch is read by every lane, and logits come
back as (K, B, classes). Lane k is exactly one model with lane k's weights.

Train mode normalises by the batch statistics over (B, T), padded frames
included, with the biased variance, and drops out as the framework
documents: at each site ONE uniform draw of one lane's shape (``draw``),
kept where ``u >= rate`` and scaled by ``1 / max(1 - rate, 1e-6)``; the
residual blocks at their fixed rate, between LSTM layers and on the pooled
vector at each lane's own rate.

Imports torch only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F

Weights = Mapping[str, torch.Tensor]


def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": F.gelu}[name]


def _mask(h: torch.Tensor, lengths: torch.Tensor, time_dim: int) -> torch.Tensor:
    """Zero the frames at or past each row's length (rows on dim 0)."""
    t = torch.arange(h.shape[time_dim], device=h.device)
    shape = [1] * h.ndim
    shape[time_dim] = -1
    keep = t.view(shape) < lengths.view([-1] + [1] * (h.ndim - 1))
    return h * keep.to(h.dtype)


def _batch_norm(x: torch.Tensor, w: Weights, prefix: str, k: int, train: bool,
                stats: Optional[Dict] = None, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (B, C, T) of lane ``k``; in train mode the batch's
    mean and biased variance go into ``stats[(prefix, k)]`` when given."""
    if train:
        mean = x.mean(dim=(0, 2))
        var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
        if stats is not None:
            stats[(prefix, k)] = (mean.detach(), var.detach())
    else:
        mean, var = w[f"{prefix}.running_mean"][k], w[f"{prefix}.running_var"][k]
    scale = w[f"{prefix}.weight"][k] / torch.sqrt(var + eps)
    return (x - mean[:, None]) * scale[:, None] + w[f"{prefix}.bias"][k][:, None]


def _dropout(xs: List[torch.Tensor], u: torch.Tensor, rates: List[torch.Tensor]) -> List[torch.Tensor]:
    """Lane k of ``xs`` kept where ``u >= rate_k`` and scaled by
    ``1 / max(1 - rate_k, 1e-6)`` (rates as float64 scalars)."""
    out = []
    for x, r in zip(xs, rates):
        scale = torch.clamp(1.0 - r, min=1e-6).to(x.dtype)
        out.append(torch.where(u >= r.to(x.dtype), x / scale, torch.zeros_like(x)))
    return out


def _residual_block(xs: List[torch.Tensor], w: Weights, prefix: str, cfg: Mapping, k_lanes: int,
                    train: bool, draw: Optional[Callable], stats: Optional[Dict]) -> List[torch.Tensor]:
    """One residual block of every lane; ``xs`` is one (B, C, T) input a
    lane (or one input that every lane reads)."""
    act = _act(cfg["activation_fn"])
    pad = cfg["kernel_size"] // 2
    inputs = xs if len(xs) == k_lanes else xs * k_lanes

    def conv(x, name, k, padding):
        return F.conv1d(x, w[f"{prefix}.{name}.weight"][k], w[f"{prefix}.{name}.bias"][k],
                        padding=padding)

    a = [act(_batch_norm(conv(x, "conv1", k, pad), w, f"{prefix}.bn1", k, train, stats))
         for k, x in enumerate(inputs)]
    if train:
        rate = torch.tensor(float(cfg["block_dropout"]), dtype=torch.float64, device=a[0].device)
        a = _dropout(a, draw(a[0].shape), [rate] * k_lanes)
    b = [_batch_norm(conv(h, "conv2", k, pad), w, f"{prefix}.bn2", k, train, stats)
         for k, h in enumerate(a)]
    if f"{prefix}.shortcut.0.weight" in w:
        skip = [_batch_norm(conv(x, "shortcut.0", k, 0), w, f"{prefix}.shortcut.1", k, train,
                            stats)
                for k, x in enumerate(inputs)]
    else:
        skip = inputs
    return [act(h + s) for h, s in zip(b, skip)]


def _recurrence(gx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """G LSTMs over time: gx (G, B, T, 4H) input gates with bias, wh
    (G, 4H, H) → hidden states (G, B, T, H), a loop of torch ops."""
    g, b, t_len, four_h = gx.shape
    hdim = four_h // 4
    h = gx.new_zeros((g, b, hdim))
    c = gx.new_zeros((g, b, hdim))
    wt = wh.transpose(1, 2)
    out = []
    for t in range(t_len):
        z = gx[:, :, t] + torch.bmm(h, wt)
        i = torch.sigmoid(z[..., :hdim])
        f = torch.sigmoid(z[..., hdim : 2 * hdim])
        gg = torch.tanh(z[..., 2 * hdim : 3 * hdim])
        o = torch.sigmoid(z[..., 3 * hdim :])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=2)


def forward(w: Weights, x: torch.Tensor, lengths: torch.Tensor, cfg: Mapping,
            train: bool = False, rates: Optional[torch.Tensor] = None,
            draw: Optional[Callable] = None, stats: Optional[Dict] = None) -> torch.Tensor:
    """Logits (K, B, classes) of K lanes over the batch ``x`` (B, T, D) with
    valid ``lengths`` (B,). Train mode needs ``rates`` ((K,) float64) and
    ``draw(shape)``, the next site's uniforms (:func:`draw_shapes` in
    order), and fills ``stats`` with each BatchNorm's batch statistics."""
    k_lanes = w["fc.weight"].shape[0]
    lane_rates = None if rates is None else [rates[k] for k in range(k_lanes)]
    h = _mask(x, lengths, 1).transpose(1, 2)  # (B, D, T)
    hs = _residual_block([h], w, "res_block1", cfg, k_lanes, train, draw, stats)
    hs = [F.max_pool1d(_mask(h, lengths, 2), kernel_size=2, stride=2) for h in hs]
    lengths = torch.clamp(lengths // 2, min=1)
    hs = [_mask(h, lengths, 2) for h in hs]
    hs = _residual_block(hs, w, "res_block2", cfg, k_lanes, train, draw, stats)
    hs = [_mask(h, lengths, 2).transpose(1, 2) for h in hs]  # (B, T, C) a lane

    b, t_len = hs[0].shape[0], hs[0].shape[1]
    steps = torch.arange(t_len, device=x.device)
    idx = (lengths[:, None] - 1 - steps[None, :]).clamp(0, t_len - 1)

    def reverse(a: torch.Tensor) -> torch.Tensor:  # (B, T, C): valid prefix reversed
        return torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))

    for layer in range(cfg["lstm_layers"]):
        gx, wh = [], []
        for sfx, read in ((f"l{layer}", lambda a: a), (f"l{layer}_reverse", reverse)):
            for k in range(k_lanes):
                bias = w[f"lstm.bias_ih_{sfx}"][k] + w[f"lstm.bias_hh_{sfx}"][k]
                gx.append(torch.matmul(read(hs[k]), w[f"lstm.weight_ih_{sfx}"][k].t()) + bias)
                wh.append(w[f"lstm.weight_hh_{sfx}"][k])
        out = _recurrence(torch.stack(gx), torch.stack(wh))  # (2K, B, T, H)
        hs = [torch.cat([out[k], reverse(out[k_lanes + k])], dim=-1) for k in range(k_lanes)]
        if train and layer < cfg["lstm_layers"] - 1:
            hs = _dropout(hs, draw((b, t_len, hs[0].shape[2])), lane_rates)

    pooled = []
    for k in range(k_lanes):
        scores = torch.matmul(hs[k], w["attention_pooling.attention_weights.weight"][k].t())
        scores = scores + w["attention_pooling.attention_weights.bias"][k]
        valid = steps[None, :, None] < lengths[:, None, None]
        scores = scores.masked_fill(~valid, float("-inf"))
        pooled.append(torch.sum(hs[k] * torch.softmax(scores, dim=1), dim=1))
    if train:
        pooled = _dropout(pooled, draw(pooled[0].shape), lane_rates)
    return torch.stack([torch.matmul(p, w["fc.weight"][k].t()) + w["fc.bias"][k]
                        for k, p in enumerate(pooled)])


def draw_shapes(cfg: Mapping, b: int, t_len: int) -> List[tuple]:
    """The shapes that a train-mode :func:`forward` of a (b, t_len, D) batch
    draws, in order: each residual block's, between LSTM layers, the pooled
    vector's."""
    c, t2, h2 = cfg["cnn_out_channels"], t_len // 2, 2 * cfg["lstm_hidden_dim"]
    return [(b, c, t_len), (b, c, t2)] + [(b, t2, h2)] * (cfg["lstm_layers"] - 1) + [(b, h2)]


def lanes(weights: Weights, k_lanes: int) -> Dict[str, torch.Tensor]:
    """``k_lanes`` copies of one model's weights on a leading lane axis."""
    return {n: v.expand(k_lanes, *v.shape).clone() for n, v in weights.items()}
