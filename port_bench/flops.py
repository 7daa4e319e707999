"""Model FLOPs that the inputs need, counted from shapes at their real
(unpadded) lengths: the products of convolutions, projections, attention and
the LSTM recurrence, 2 operations a multiply-add. Elementwise work, norms and
softmax are left out, so a step's share of the peak is a floor.

Training counts each product's forward and its backward (the input's and the
weight's gradient, each as large as the forward), except the input gradient
of the convolutions that read the batch itself, which nothing needs.
"""

from __future__ import annotations

from typing import Mapping, Sequence


def cnnlstm_parts(cfg: Mapping, frames: int) -> dict:
    """Forward FLOPs of one sequence of ``frames`` real frames through the
    CNN-LSTM, by part; ``cfg`` holds the configuration's widths."""
    d, c, h = cfg["input_dim"], cfg["cnn_out_channels"], cfg["lstm_hidden_dim"]
    k, layers, classes = cfg["kernel_size"], cfg["lstm_layers"], cfg["num_classes"]
    half = max(frames // 2, 1)
    parts = {
        "input_convs": 2 * frames * d * c * k + 2 * frames * d * c,  # res_block1.conv1 + shortcut
        "convs": 2 * frames * c * c * k + 2 * 2 * half * c * c * k,  # res_block1.conv2, res_block2
        "lstm_input": 0,
        "lstm_recurrence": 0,
        "pooling": 2 * 2 * half * 2 * h + 2 * 2 * h * classes,
    }
    for layer in range(layers):
        width = c if layer == 0 else 2 * h
        parts["lstm_input"] += 2 * 2 * half * width * 4 * h
        parts["lstm_recurrence"] += 2 * 2 * half * h * 4 * h
    return parts


def cnnlstm_forward(cfg: Mapping, lengths: Sequence[int]) -> float:
    """Forward FLOPs of the sequences of ``lengths`` frames."""
    return float(sum(sum(cnnlstm_parts(cfg, int(n)).values()) for n in lengths))


def cnnlstm_train(cfg: Mapping, lengths: Sequence[int]) -> float:
    """Forward and backward FLOPs of one train step over sequences of
    ``lengths`` frames, for one model."""
    total = 0.0
    for n in lengths:
        parts = cnnlstm_parts(cfg, int(n))
        total += 3 * sum(parts.values()) - parts["input_convs"]
    return total


def wav2vec2_chunk(cfg: Mapping, n_samples: int) -> float:
    """Forward FLOPs of the Wav2Vec2 encoder over one chunk of ``n_samples``."""
    t, in_dim, total = int(n_samples), 1, 0.0
    for dim, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
        total += 2 * t * dim * in_dim * k
        in_dim = dim
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    total += 2 * t * in_dim * d  # feature projection
    total += 2 * t * d * (d // cfg["pos_conv_groups"]) * cfg["pos_conv_kernel"]
    per_layer = 4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * ff
    return total + cfg["num_layers"] * per_layer


def wav2vec2_frames(cfg: Mapping, n_samples: int) -> int:
    """Frames the conv stack makes of ``n_samples`` samples."""
    t = int(n_samples)
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        t = (t - k) // s + 1
    return t
