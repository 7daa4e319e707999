"""Seeded random weights for both sides of a comparison, made on the device.

The names and shapes are the published ones the program's modules also use
(the reference checkpoints' ``state_dict`` names for the CNN-LSTM, the
encoder tree of ``wav2vec2-base`` for Wav2Vec2): one dict of tensors goes to
the program and the same dict to the plain reference. Every value comes from
ONE normal draw of a ``torch.Generator`` on the device, cut into the tensors
in the order of the spec and scaled by each tensor's role.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # name, shape, role, fan


def _bn(prefix: str, c: int) -> Spec:
    return [(f"{prefix}.weight", (c,), "scale", 1.0), (f"{prefix}.bias", (c,), "shift", 1.0),
            (f"{prefix}.running_mean", (c,), "shift", 1.0), (f"{prefix}.running_var", (c,), "var", 1.0),
            (f"{prefix}.num_batches_tracked", (), "count", 1.0)]


def _conv(prefix: str, out: int, inp: int, k: int) -> Spec:
    return [(f"{prefix}.weight", (out, inp, k), "weight", inp * k),
            (f"{prefix}.bias", (out,), "bias", inp * k)]


def cnnlstm_spec(cfg: Mapping) -> Spec:
    """The CNN-LSTM's state dict, in the reference checkpoints' names."""
    d, c, h = cfg["input_dim"], cfg["cnn_out_channels"], cfg["lstm_hidden_dim"]
    k = cfg["kernel_size"]
    spec: Spec = []
    for block, inp in (("res_block1", d), ("res_block2", c)):
        spec += _conv(f"{block}.conv1", c, inp, k) + _bn(f"{block}.bn1", c)
        spec += _conv(f"{block}.conv2", c, c, k) + _bn(f"{block}.bn2", c)
        if inp != c:
            spec += _conv(f"{block}.shortcut.0", c, inp, 1) + _bn(f"{block}.shortcut.1", c)
    for layer in range(cfg["lstm_layers"]):
        inp = c if layer == 0 else 2 * h
        for sfx in (f"l{layer}", f"l{layer}_reverse"):
            spec += [(f"lstm.weight_ih_{sfx}", (4 * h, inp), "weight", inp),
                     (f"lstm.weight_hh_{sfx}", (4 * h, h), "weight", h),
                     (f"lstm.bias_ih_{sfx}", (4 * h,), "bias", h),
                     (f"lstm.bias_hh_{sfx}", (4 * h,), "bias", h)]
    spec += [("attention_pooling.attention_weights.weight", (1, 2 * h), "weight", 2 * h),
             ("attention_pooling.attention_weights.bias", (1,), "bias", 2 * h),
             ("fc.weight", (cfg["num_classes"], 2 * h), "weight", 2 * h),
             ("fc.bias", (cfg["num_classes"],), "bias", 2 * h)]
    return spec


def wav2vec2_spec(cfg: Mapping) -> Spec:
    """The Wav2Vec2-base encoder's tensors, in the encoder tree's names."""
    spec: Spec = []
    inp = 1
    for i, (dim, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        spec.append((f"feature_encoder.conv_{i}.weight", (dim, inp, k), "weight", inp * k))
        inp = dim
    c0, d, ff = cfg["conv_dim"][0], cfg["hidden_size"], cfg["intermediate_size"]
    spec += [("feature_encoder.gn_scale", (c0,), "scale", 1.0),
             ("feature_encoder.gn_bias", (c0,), "shift", 1.0),
             ("feature_projection.norm.weight", (inp,), "scale", 1.0),
             ("feature_projection.norm.bias", (inp,), "shift", 1.0),
             ("feature_projection.projection.weight", (d, inp), "weight", inp),
             ("feature_projection.projection.bias", (d,), "bias", inp)]
    groups, kp = cfg["pos_conv_groups"], cfg["pos_conv_kernel"]
    spec += [("pos_conv.conv.weight", (d, d // groups, kp), "weight", d // groups * kp),
             ("pos_conv.conv.bias", (d,), "bias", d // groups * kp),
             ("encoder_norm.weight", (d,), "scale", 1.0), ("encoder_norm.bias", (d,), "shift", 1.0)]
    for i in range(cfg["num_layers"]):
        p = f"layer_{i}"
        for name in ("q", "k", "v", "out"):
            spec += [(f"{p}.{name}.weight", (d, d), "weight", d), (f"{p}.{name}.bias", (d,), "bias", d)]
        spec += [(f"{p}.attn_norm.weight", (d,), "scale", 1.0), (f"{p}.attn_norm.bias", (d,), "shift", 1.0),
                 (f"{p}.ff1.weight", (ff, d), "weight", d), (f"{p}.ff1.bias", (ff,), "bias", d),
                 (f"{p}.ff2.weight", (d, ff), "weight", ff), (f"{p}.ff2.bias", (d,), "bias", ff),
                 (f"{p}.ff_norm.weight", (d,), "scale", 1.0), (f"{p}.ff_norm.bias", (d,), "shift", 1.0)]
    return spec


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The spec's tensors from one normal draw on ``device`` seeded with
    ``seed``: weights N(0, 1/fan_in), biases N(0, 0.25/fan_in), norm scales
    1 + N(0, 0.01), shifts and running means N(0, 0.01), running variances
    exp(N(0, 0.04)), counts 0."""
    device = torch.device(device)
    sizes = [math.prod(shape) for _, shape, role, _ in spec if role != "count"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    start = 0
    with torch.no_grad():
        for name, shape, role, fan in spec:
            if role == "count":
                out[name] = torch.zeros((), dtype=torch.int64, device=device)
                continue
            n = math.prod(shape)
            z = flat[start : start + n].view(shape)
            start += n
            if role == "weight":
                out[name] = z * (1.0 / math.sqrt(fan))
            elif role == "bias":
                out[name] = z * (0.5 / math.sqrt(fan))
            elif role == "scale":
                out[name] = 1.0 + 0.1 * z
            elif role == "shift":
                out[name] = 0.1 * z
            else:  # "var"
                out[name] = torch.exp(0.2 * z)
    return out
