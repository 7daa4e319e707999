"""CNN-LSTM sequence classifier (PyTorch).

Counterpart of ``robust_speech_analysis_framework_tpu/models/cnn_lstm.py``:
two residual Conv1d blocks → time max-pool ×2 → 2-layer bidirectional LSTM →
attention pooling → linear head. Public tensors are feature-last
``(B, T, C)`` as in the JAX package; the conv blocks transpose to torch's
``(B, C, T)`` inside.

Parameter names follow the reference PyTorch checkpoints
(``final_tuned_cnn_lstm_*.pt``), so those load with ``load_state_dict``:
``res_block{1,2}.{conv1,bn1,conv2,bn2,shortcut.0,shortcut.1}``,
``lstm.{weight_ih,weight_hh,bias_ih,bias_hh}_l{k}[_reverse]`` (gate order
i, f, g, o), ``attention_pooling.attention_weights`` and ``fc``.

The biLSTM does not run ``nn.LSTM``: its input projections are one matmul
per layer and both directions' recurrences go through one launch of a CUDA
kernel on the card, or its plain version on the CPU: K1
(:func:`..ops.cuda.lstm.lstm_scan_grouped`) when no gradient is needed, K5
(:func:`..ops.cuda.lstm.lstm_recurrence_grouped`: K3 forward, K4 backward)
when one is. Like the TPU kernels, the recurrence does not freeze state past
``lengths``; nothing downstream reads those frames (attention masks them,
the backward direction reads the reversed valid prefix, and padding is
trailing), so they get a zero gradient and the gradients of valid frames
equal those of the JAX package's frozen scan.

Train mode (``model.train()``) follows the JAX model, not torch's defaults:

* BatchNorm (:class:`BatchNorm`) normalises by the batch statistics over
  (B, T), padded frames included, with the biased variance, and updates the
  running statistics as Flax does: ``ra = 0.99 * ra + 0.01 * batch`` for the
  mean and for the biased variance (torch's own would take 0.1 and the
  unbiased variance).
* Dropout (:func:`dropout`) keeps each element with probability ``1 - rate``
  and scales it by ``1 / max(1 - rate, 1e-6)``, drawing from the generator
  given to ``forward`` (torch's default generator for the device if None). It
  applies after the first conv of each residual block at the block's fixed
  ``dropout`` (0.2), between biLSTM layers and on the pooled vector, at the
  ``dropout_rate`` given to ``forward`` or else the model's ``dropout_rate``.

:class:`CNNLSTMLanes` is K CNNLSTMs of one architecture stacked on a
leading lane axis (the JAX package's ``jax.vmap`` over trials, written out):
one conv call serves every lane, and each biLSTM layer's recurrence is ONE
launch at G = 2K groups (direction, lane).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, fp32_convs, resolve_device
from ..ops.cuda.lstm import lstm_recurrence_grouped, lstm_scan_grouped
from .init import init_weights_
from .weights import infer_architecture


def get_activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """silu/gelu lookup; gelu is the exact erf form (torch's default)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return F.gelu
    raise ValueError(f"Unsupported activation function: {name}")


def _mask_pad(h: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero frames at or past each length; h is (B, T, C)."""
    if lengths is None:
        return h
    t = torch.arange(h.shape[1], device=h.device)
    return h.masked_fill(t[None, :, None] >= lengths[:, None, None], 0.0)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keep each element with probability ``1 - rate``, scaled by
    ``1 / max(1 - rate, 1e-6)`` (the JAX model's ``RateDropout``)."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) >= rate
    return torch.where(keep, x / max(1.0 - rate, 1e-6), 0.0)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C, T) with Flax's train-mode semantics.

    Eval mode is torch's (running statistics). Train mode normalises with
    the batch mean and the biased batch variance ``E[x²] − E[x]²`` (clipped
    at 0), as ``flax.linen.BatchNorm`` does, and moves the running statistics
    by Flax's momentum 0.99 (torch's ``momentum=0.01``) with the biased
    variance, unless ``update_running_stats`` is False (a recomputed forward
    under rematerialisation must not count its batch twice). The state-dict
    names are ``nn.BatchNorm1d``'s.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)
        self.update_running_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2))
        var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
        if self.update_running_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var + m * var)
                self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class ResidualBlock(nn.Module):
    """Two k=3 same-padded convs with BN, plus a 1×1 conv+BN skip when the
    channel counts differ; post-add activation; in train mode, dropout at
    the fixed rate ``dropout`` after the first conv's activation. Operates
    on (B, T, C)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 activation_fn: str = "silu", dropout: float = 0.2):
        super().__init__()
        pad = kernel_size // 2
        self.dropout = dropout
        self.conv1 = nn.Conv1d(in_channels, out_channels, kernel_size, padding=pad)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = nn.Conv1d(out_channels, out_channels, kernel_size, padding=pad)
        self.bn2 = BatchNorm(out_channels)
        if in_channels != out_channels:
            self.shortcut = nn.Sequential(
                nn.Conv1d(in_channels, out_channels, 1), BatchNorm(out_channels)
            )
        else:
            self.shortcut = nn.Identity()
        self.act = get_activation_fn(activation_fn)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.transpose(1, 2)
        with fp32_convs():
            h = self.act(self.bn1(self.conv1(x)))
            if self.training:
                h = dropout(h, self.dropout, generator)
            h = self.bn2(self.conv2(h))
            skip = self.shortcut(x)
        return self.act(h + skip).transpose(1, 2)


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM holding ``nn.LSTM``'s parameter names."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 2):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else 2 * hidden_dim
            for sfx in (f"l{layer}", f"l{layer}_reverse"):
                self.register_parameter(
                    f"weight_ih_{sfx}", nn.Parameter(torch.empty(4 * hidden_dim, in_dim)))
                self.register_parameter(
                    f"weight_hh_{sfx}", nn.Parameter(torch.empty(4 * hidden_dim, hidden_dim)))
                self.register_parameter(
                    f"bias_ih_{sfx}", nn.Parameter(torch.empty(4 * hidden_dim)))
                self.register_parameter(
                    f"bias_hh_{sfx}", nn.Parameter(torch.empty(4 * hidden_dim)))

    def _direction(self, layer: int, reverse: bool):
        sfx = f"l{layer}" + ("_reverse" if reverse else "")
        p = lambda n: getattr(self, f"{n}_{sfx}")  # noqa: E731
        return p("weight_ih"), p("weight_hh"), p("bias_ih") + p("bias_hh")

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, C) → (B, T, 2H); in train mode, dropout at ``dropout_rate``
        between layers."""
        h = x
        b, t, _ = x.shape
        if lengths is None:
            idx = None
        else:
            # Reverse only the valid prefix of each sequence (clipped gather).
            steps = torch.arange(t, device=x.device)
            idx = (lengths[:, None] - 1 - steps[None, :]).clamp(0, t - 1)
        for layer in range(self.num_layers):
            if idx is None:
                bwd_in = torch.flip(h, dims=(1,))
            else:
                bwd_in = torch.gather(h, 1, idx[:, :, None].expand(-1, -1, h.shape[2]))
            wx_f, wh_f, bias_f = self._direction(layer, False)
            wx_b, wh_b, bias_b = self._direction(layer, True)
            # both directions' input projections in one batched matmul
            inputs = torch.stack([h, bwd_in])  # (2, B, T, C)
            wx = torch.stack([wx_f.t(), wx_b.t()])  # (2, C, 4H)
            gates = torch.matmul(inputs.reshape(2, b * t, -1), wx)
            gates = gates + torch.stack([bias_f, bias_b])[:, None, :]
            gates = gates.reshape(2, b, t, -1).permute(2, 0, 1, 3).contiguous()  # (T, 2, B, 4H)
            wh = torch.stack([wh_f.t(), wh_b.t()])  # (2, H, 4H)
            if gates.requires_grad or wh.requires_grad:
                hs = lstm_recurrence_grouped(gates, wh)  # K5: K3 now, K4 in backward
            else:
                hs = lstm_scan_grouped(gates, wh)  # K1; (T, 2, B, H)
            fwd = hs[:, 0].transpose(0, 1)
            bwd = hs[:, 1].transpose(0, 1)
            if idx is None:
                bwd = torch.flip(bwd, dims=(1,))
            else:
                bwd = torch.gather(bwd, 1, idx[:, :, None].expand(-1, -1, bwd.shape[2]))
            h = torch.cat([fwd, bwd], dim=-1)
            if self.training and layer < self.num_layers - 1:
                h = dropout(h, dropout_rate, generator)
        return h


class AttentionPooling(nn.Module):
    """Learned softmax pooling over time; padded steps masked to -inf."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.attention_weights = nn.Linear(input_dim, 1)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        scores = self.attention_weights(x)  # (B, T, 1)
        if lengths is not None:
            t = torch.arange(x.shape[1], device=x.device)
            mask = t[None, :, None] < lengths[:, None, None]
            scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=1)
        return torch.sum(x * probs, dim=1)  # (B, 2H)


class CNNLSTM(nn.Module):
    """Residual CNN front end + biLSTM + attention pooling classifier."""

    def __init__(
        self,
        input_dim: int = 768,
        num_classes: int = 2,
        cnn_out_channels: int = 128,
        lstm_hidden_dim: int = 128,
        lstm_layers: int = 2,
        dropout_rate: float = 0.5,
        activation_fn: str = "silu",
    ):
        super().__init__()
        self.input_dim = input_dim
        self.num_classes = num_classes
        self.cnn_out_channels = cnn_out_channels
        self.lstm_hidden_dim = lstm_hidden_dim
        self.lstm_layers = lstm_layers
        self.dropout_rate = dropout_rate
        self.activation_fn = activation_fn
        self.res_block1 = ResidualBlock(input_dim, cnn_out_channels, activation_fn=activation_fn)
        self.res_block2 = ResidualBlock(
            cnn_out_channels, cnn_out_channels, activation_fn=activation_fn)
        self.lstm = BiLSTM(cnn_out_channels, lstm_hidden_dim, lstm_layers)
        self.attention_pooling = AttentionPooling(2 * lstm_hidden_dim)
        self.fc = nn.Linear(2 * lstm_hidden_dim, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        dropout_rate: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, T, input_dim) [+ lengths (B,)] → logits (B, num_classes).

        ``dropout_rate`` overrides the model's own between biLSTM layers and
        on the pooled vector; ``generator`` draws the dropout masks. Both
        matter in train mode only.
        """
        rate = self.dropout_rate if dropout_rate is None else float(dropout_rate)
        h = _mask_pad(x, lengths)
        h = _mask_pad(self.res_block1(h, generator), lengths)
        # Non-overlapping max-pool halves T (odd last frame dropped).
        h = F.max_pool1d(h.transpose(1, 2), kernel_size=2, stride=2).transpose(1, 2)
        if lengths is not None:
            # clamp to >= 1: a 0/1-frame sequence would otherwise mask every
            # attention score to -inf and NaN its row through softmax
            lengths = torch.clamp(lengths // 2, min=1)
        h = _mask_pad(h, lengths)
        h = _mask_pad(self.res_block2(h, generator), lengths)
        h = self.lstm(h, lengths, rate if self.lstm_layers > 1 else 0.0, generator)
        pooled = self.attention_pooling(h, lengths)
        if self.training:
            pooled = dropout(pooled, rate, generator)
        return self.fc(pooled)


def stability_probe(model: CNNLSTM) -> torch.Tensor:
    """Per-input-dim importance: mean |res_block1.conv1 weight| over output
    channels and taps → (input_dim,)."""
    return model.res_block1.conv1.weight.detach().abs().mean(dim=(0, 2))


def build_cnn_lstm(
    input_dim: int = 768,
    cnn_out_channels: int = 128,
    lstm_hidden_dim: int = 128,
    lstm_layers: int = 2,
    num_classes: int = 2,
    activation_fn: str = "silu",
    dropout_rate: float = 0.5,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> CNNLSTM:
    """A seeded random-init CNNLSTM in eval mode on ``device``."""
    dev = resolve_device(device)
    model = CNNLSTM(
        input_dim=input_dim, num_classes=num_classes,
        cnn_out_channels=cnn_out_channels, lstm_hidden_dim=lstm_hidden_dim,
        lstm_layers=lstm_layers, dropout_rate=dropout_rate,
        activation_fn=activation_fn,
    )
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


# --- K lanes of one architecture ------------------------------------------------------

Rate = Union[float, torch.Tensor]


def dropout_lanes(x: torch.Tensor, rate: Rate, lane_dim: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`dropout` of K lanes stacked on dim ``lane_dim`` of ``x``.

    ONE uniform draw of one lane's shape (the draw ``CNNLSTM`` makes at this
    site) serves every lane: lane k keeps an element where ``u >= rate_k``
    (in ``x``'s dtype, as :func:`dropout` compares) and scales it by
    ``1 / max(1 - rate_k, 1e-6)``, computed in ``rate``'s dtype and rounded to
    ``x``'s. ``rate`` is a float for every lane (0.0 draws nothing, as in
    :func:`dropout`) or a (K,) tensor, which always draws: a lane at rate 0
    keeps every element but advances the generator where ``CNNLSTM`` would not.
    """
    if isinstance(rate, torch.Tensor):
        shape = (-1,) + (1,) * (x.ndim - lane_dim - 1)
        scale = torch.clamp(1.0 - rate, min=1e-6).to(x.dtype).view(shape)
        rate = rate.to(x.dtype).view(shape)
    elif rate == 0.0:
        return x
    else:
        scale = max(1.0 - rate, 1e-6)
    one_lane = x.shape[:lane_dim] + x.shape[lane_dim + 1:]
    u = torch.rand(one_lane, generator=generator, device=x.device, dtype=x.dtype)
    return torch.where(u.unsqueeze(lane_dim) >= rate, x / scale, 0.0)


class LaneConv1d(nn.Module):
    """K ``nn.Conv1d`` of one shape: weight (K, out, in, k), bias (K, out).

    The input is (B, in, T), read by every lane (one conv with K·out output
    channels), or (B, K·in, T) lane-major (a ``groups=K`` conv); the output
    is (B, K·out, T), lane-major."""

    def __init__(self, lanes: int, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(lanes, out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(lanes, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, out, inp, ks = self.weight.shape
        with fp32_convs():
            return F.conv1d(x, self.weight.reshape(k * out, inp, ks), self.bias.reshape(-1),
                            padding=self.padding, groups=x.shape[1] // inp)


class LaneLinear(nn.Module):
    """K ``nn.Linear`` of one shape: weight (K, out, in), bias (K, out);
    (K, N, in) → (K, N, out)."""

    def __init__(self, lanes: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(lanes, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(lanes, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias[:, None], x, self.weight.transpose(1, 2))


class ResidualBlockLanes(nn.Module):
    """K :class:`ResidualBlock`: (B, T, C_in) read by every lane, or
    (B, T, K·C_in) lane-major → (B, T, K·C_out). Its BatchNorms run over
    K·C_out channels, which is each lane's BatchNorm side by side."""

    def __init__(self, lanes: int, in_channels: int, out_channels: int, kernel_size: int = 3,
                 activation_fn: str = "silu", dropout: float = 0.2):
        super().__init__()
        pad = kernel_size // 2
        self.lanes = lanes
        self.dropout = dropout
        self.conv1 = LaneConv1d(lanes, in_channels, out_channels, kernel_size, pad)
        self.bn1 = BatchNorm(lanes * out_channels)
        self.conv2 = LaneConv1d(lanes, out_channels, out_channels, kernel_size, pad)
        self.bn2 = BatchNorm(lanes * out_channels)
        if in_channels != out_channels:
            self.shortcut = nn.Sequential(
                LaneConv1d(lanes, in_channels, out_channels, 1), BatchNorm(lanes * out_channels)
            )
        else:
            self.shortcut = nn.Identity()
        self.act = get_activation_fn(activation_fn)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.transpose(1, 2)
        h = self.act(self.bn1(self.conv1(x)))
        if self.training:
            h = dropout_lanes(h.unflatten(1, (self.lanes, -1)), self.dropout, 1,
                              generator).flatten(1, 2)
        h = self.bn2(self.conv2(h))
        skip = self.shortcut(x)
        if skip.shape[1] != h.shape[1]:  # the identity of an input every lane reads
            skip = skip.repeat(1, self.lanes, 1)
        return self.act(h + skip).transpose(1, 2)


class BiLSTMLanes(nn.Module):
    """K :class:`BiLSTM` under ``nn.LSTM``'s names, each tensor with a
    leading lane axis; (K, B, T, C) → (K, B, T, 2H). Each layer's recurrence
    is ONE call at G = 2K, the groups direction-major (the K forward lanes,
    then the K backward ones)."""

    def __init__(self, lanes: int, input_dim: int, hidden_dim: int, num_layers: int = 2):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        for layer in range(num_layers):
            in_dim = input_dim if layer == 0 else 2 * hidden_dim
            for sfx in (f"l{layer}", f"l{layer}_reverse"):
                for name, shape in (("weight_ih", (4 * hidden_dim, in_dim)),
                                    ("weight_hh", (4 * hidden_dim, hidden_dim)),
                                    ("bias_ih", (4 * hidden_dim,)),
                                    ("bias_hh", (4 * hidden_dim,))):
                    self.register_parameter(
                        f"{name}_{sfx}", nn.Parameter(torch.empty(lanes, *shape)))

    def _layer(self, layer: int):
        """wx (2K, C, 4H), bias (2K, 1, 4H) and wh (2K, H, 4H) of both
        directions, in :class:`BiLSTM`'s layout per group."""

        def both(name: str) -> torch.Tensor:  # (2, K, ...)
            return torch.stack([getattr(self, f"{name}_l{layer}"),
                                getattr(self, f"{name}_l{layer}_reverse")])

        wx = both("weight_ih").transpose(-1, -2).flatten(0, 1)
        bias = (both("bias_ih") + both("bias_hh")).flatten(0, 1)[:, None]
        wh = both("weight_hh").transpose(-1, -2).flatten(0, 1)
        return wx, bias, wh

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                dropout_rate: Rate = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        k, b, t, _ = x.shape
        h = x
        if lengths is None:
            idx = None
        else:
            # reverse only the valid prefix of each sequence (clipped gather)
            steps = torch.arange(t, device=x.device)
            idx = (lengths[:, None] - 1 - steps[None, :]).clamp(0, t - 1)

        def reverse(a: torch.Tensor) -> torch.Tensor:
            if idx is None:
                return torch.flip(a, dims=(2,))
            return torch.gather(a, 2, idx[None, :, :, None].expand(k, -1, -1, a.shape[3]))

        for layer in range(self.num_layers):
            wx, bias, wh = self._layer(layer)
            # every (direction, lane) input projection in one batched matmul
            inputs = torch.stack([h, reverse(h)]).reshape(2 * k, b * t, -1)
            gates = torch.matmul(inputs, wx) + bias
            gates = gates.reshape(2 * k, b, t, -1).permute(2, 0, 1, 3).contiguous()
            if gates.requires_grad or wh.requires_grad:
                hs = lstm_recurrence_grouped(gates, wh)  # K5 at G = 2K
            else:
                hs = lstm_scan_grouped(gates, wh)  # K1 at G = 2K
            hs = hs.permute(1, 2, 0, 3)  # (2K, B, T, H)
            h = torch.cat([hs[:k], reverse(hs[k:])], dim=-1)
            if self.training and layer < self.num_layers - 1:
                h = dropout_lanes(h, dropout_rate, 0, generator)
        return h


class AttentionPoolingLanes(nn.Module):
    """K :class:`AttentionPooling`; (K, B, T, C) → (K, B, C)."""

    def __init__(self, lanes: int, input_dim: int):
        super().__init__()
        self.attention_weights = LaneLinear(lanes, input_dim, 1)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, b, t, c = x.shape
        scores = self.attention_weights(x.reshape(k, b * t, c)).reshape(k, b, t, 1)
        if lengths is not None:
            steps = torch.arange(t, device=x.device)
            mask = steps[None, :, None] < lengths[:, None, None]
            scores = scores.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(scores, dim=2)
        return torch.sum(x * probs, dim=2)


class CNNLSTMLanes(nn.Module):
    """K :class:`CNNLSTM` of one architecture on a leading lane axis.

    Every parameter and BatchNorm statistic has the name it has in
    ``CNNLSTM`` and a lane axis in front: (K, ...), or K·C channels
    lane-major for the BatchNorms. The forward computes, lane by lane, what
    ``CNNLSTM.forward`` computes with that lane's weights and dropout rate:
    ``res_block1``'s first conv and shortcut read the input once for all
    lanes, the convs after them are ``groups=K`` convs, each biLSTM layer is
    one K5 (train) or K1 (eval) call at G = 2K, pooling and ``fc`` are
    per-lane products. In train mode each dropout site draws ONE uniform
    tensor of the shape ``CNNLSTM`` draws, in ``CNNLSTM``'s order, and each
    lane thresholds it at its own rate (:func:`dropout_lanes`), so lane k
    reproduces ``CNNLSTM`` at rate k from the same generator state.
    """

    def __init__(
        self,
        lanes: int,
        input_dim: int = 768,
        num_classes: int = 2,
        cnn_out_channels: int = 128,
        lstm_hidden_dim: int = 128,
        lstm_layers: int = 2,
        dropout_rate: float = 0.5,
        activation_fn: str = "silu",
    ):
        super().__init__()
        self.lanes = lanes
        self.input_dim = input_dim
        self.num_classes = num_classes
        self.cnn_out_channels = cnn_out_channels
        self.lstm_hidden_dim = lstm_hidden_dim
        self.lstm_layers = lstm_layers
        self.dropout_rate = dropout_rate
        self.activation_fn = activation_fn
        self.res_block1 = ResidualBlockLanes(lanes, input_dim, cnn_out_channels,
                                             activation_fn=activation_fn)
        self.res_block2 = ResidualBlockLanes(lanes, cnn_out_channels, cnn_out_channels,
                                             activation_fn=activation_fn)
        self.lstm = BiLSTMLanes(lanes, cnn_out_channels, lstm_hidden_dim, lstm_layers)
        self.attention_pooling = AttentionPoolingLanes(lanes, 2 * lstm_hidden_dim)
        self.fc = LaneLinear(lanes, 2 * lstm_hidden_dim, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        dropout_rate: Optional[Rate] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(B, T, input_dim) [+ lengths (B,)], read by every lane → logits
        (K, B, num_classes). ``dropout_rate``: a float for every lane or a
        (K,) tensor (None: the model's own); it matters in train mode only."""
        rate = self.dropout_rate if dropout_rate is None else dropout_rate
        h = _mask_pad(x, lengths)
        h = _mask_pad(self.res_block1(h, generator), lengths)
        h = F.max_pool1d(h.transpose(1, 2), kernel_size=2, stride=2).transpose(1, 2)
        if lengths is not None:
            lengths = torch.clamp(lengths // 2, min=1)
        h = _mask_pad(h, lengths)
        h = _mask_pad(self.res_block2(h, generator), lengths)  # (B, T, K·C)
        h = h.unflatten(2, (self.lanes, -1)).permute(2, 0, 1, 3)  # (K, B, T, C)
        h = self.lstm(h, lengths, rate if self.lstm_layers > 1 else 0.0, generator)
        pooled = self.attention_pooling(h, lengths)
        if self.training:
            pooled = dropout_lanes(pooled, rate, 0, generator)
        return self.fc(pooled)

    def architecture(self) -> Dict[str, object]:
        """The keyword arguments of one lane's :class:`CNNLSTM`."""
        return dict(input_dim=self.input_dim, num_classes=self.num_classes,
                    cnn_out_channels=self.cnn_out_channels,
                    lstm_hidden_dim=self.lstm_hidden_dim, lstm_layers=self.lstm_layers,
                    dropout_rate=self.dropout_rate, activation_fn=self.activation_fn)

    def lane_shapes(self) -> Dict[str, torch.Size]:
        """Each state-dict entry's shape in one lane's :class:`CNNLSTM`."""
        with torch.device("meta"):
            return {k: v.shape for k, v in CNNLSTM(**self.architecture()).state_dict().items()}

    @classmethod
    def from_state_dict(cls, state_dict: Mapping[str, torch.Tensor], lanes: int,
                        activation_fn: str = "silu",
                        dropout_rate: float = 0.5) -> "CNNLSTMLanes":
        """``lanes`` copies of one :class:`CNNLSTM` state dict (the
        reference names), on that state dict's device."""
        with torch.device(state_dict["fc.weight"].device):
            model = cls(lanes, **infer_architecture(state_dict), dropout_rate=dropout_rate,
                        activation_fn=activation_fn)
        own = model.state_dict()
        model.load_state_dict({
            name: v if name.endswith("num_batches_tracked")
            else v.expand(lanes, *v.shape).reshape(own[name].shape)
            for name, v in state_dict.items()
        })
        return model

    def lane_state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """Lane ``i`` as a :class:`CNNLSTM` state dict (copies). BatchNorm's
        ``num_batches_tracked`` is one count for all lanes."""
        shapes = self.lane_shapes()
        return {
            name: v.clone() if name.endswith("num_batches_tracked")
            else v.detach().reshape(self.lanes, -1)[i].reshape(shapes[name]).clone()
            for name, v in self.state_dict().items()
        }

    def lane_model(self, i: int) -> CNNLSTM:
        """Lane ``i`` as a :class:`CNNLSTM` on this model's device, in its
        mode, with its residual blocks' dropout rate."""
        with torch.device(self.fc.weight.device):
            model = CNNLSTM(**self.architecture())
        model.load_state_dict(self.lane_state_dict(i))
        for block in ("res_block1", "res_block2"):
            getattr(model, block).dropout = getattr(self, block).dropout
        return model.train(self.training)
