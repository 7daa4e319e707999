"""The yardstick's arithmetic against hand counts, and the generators'
determinism per seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import common, flops, peaks, trace
from port_bench.reference.weights import cnnlstm_spec, make_weights, wav2vec2_spec

SMALL_CNN = dict(input_dim=4, cnn_out_channels=2, lstm_hidden_dim=3, lstm_layers=1, kernel_size=3,
                 num_classes=2)


def test_cnnlstm_forward_flops_by_hand():
    # 6 frames, 3 after the pool. res_block1: conv1 2·6·4·2·3 = 288, shortcut
    # 2·6·4·2 = 96; conv2 2·6·2·2·3 = 144; res_block2 2·(2·3·2·2·3) = 144;
    # LSTM: input 2 dirs · 2·3·2·12 = 288, recurrence 2 · 2·3·3·12 = 432;
    # pooling 2·2·3·6 = 72 and the head 2·6·2 = 24
    assert flops.cnnlstm_forward(SMALL_CNN, [6]) == 288 + 96 + 144 + 144 + 288 + 432 + 72 + 24
    parts = flops.cnnlstm_parts(SMALL_CNN, 6)
    assert flops.cnnlstm_train(SMALL_CNN, [6]) == 3 * sum(parts.values()) - (288 + 96)


def test_flagship_forward_flops_per_frame():
    cfg = dict(input_dim=768, cnn_out_channels=128, lstm_hidden_dim=128, lstm_layers=2,
               kernel_size=3, num_classes=2)
    per_frame = flops.cnnlstm_forward(cfg, [4378]) / 4378
    assert per_frame == pytest.approx(1.638e6, rel=2e-3)


W2V_BASE = dict(conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
                hidden_size=768, intermediate_size=3072, num_layers=12, pos_conv_kernel=128,
                pos_conv_groups=16)


def test_wav2vec2_chunk_flops():
    assert flops.wav2vec2_frames(W2V_BASE, 80000) == 249
    assert flops.wav2vec2_chunk(W2V_BASE, 80000) == pytest.approx(72e9, rel=0.02)
    tiny = dict(conv_dim=[2], conv_kernel=[3], conv_stride=[2], hidden_size=4, intermediate_size=8,
                num_layers=1, pos_conv_kernel=2, pos_conv_groups=2)
    # 9 samples -> 4 frames: conv 2·4·2·1·3 = 48, projection 2·4·2·4 = 64,
    # positional conv 2·4·4·2·2 = 128, a layer 4·2·4·16 + 2·2·16·4 + 2·2·4·32 = 1280
    assert flops.wav2vec2_chunk(tiny, 9) == 48 + 64 + 128 + 1280


def test_bounds_by_hand():
    ms, by = peaks.bound_ms(3.35e9, 1.0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = peaks.bound_ms(1.0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    t, g, b, h = 10, 2, 3, 4
    ops = t * g * b * (2 * h * 4 * h + 4 * h + 5 * h)
    assert peaks.lstm_bound_ms(t, g, b, h)[0] == pytest.approx(
        max(ops / 67e12, 4 * (t * g * b * 4 * h + g * h * 4 * h + t * g * b * h) / 3.35e12) * 1e3)
    assert peaks.lstm_bwd_bound_ms(t, g, b, h)[0] >= peaks.gate_acts_bound_ms(t, g, b, h)[0]
    assert peaks.dwh_bound_ms(1, g, b, h)[1] == "bytes"  # no product at one step


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert trace.union_us(spans, 0, 10) == 3 + 1 + 1
    assert trace.gaps_us(spans, 0, 10) == [(3, 5), (6, 9)]
    assert trace.gaps_us([], 0, 4) == [(0, 4)]


def test_fixed_lengths_same_set_any_seed():
    spec = {"a": [3, 1.0, 3.0], "b": [2, 10.0, 20.0]}
    one, two = common.fixed_lengths(spec, 1, 0), common.fixed_lengths(spec, 2**31 + 7, 0)
    assert sorted(one) == sorted(two) == [1.0, 2.0, 3.0, 10.0, 20.0]
    assert one == common.fixed_lengths(spec, 1, 0)


def test_speech_is_deterministic_per_seed():
    a = common.speech([0.5, 0.3], 2**31 + 5, "cpu")
    b = common.speech([0.5, 0.3], 2**31 + 5, "cpu")
    c = common.speech([0.5, 0.3], 2**31 + 6, "cpu")
    assert [len(x) for x in a] == [8000, 4800]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert np.abs(a[0]).max() <= 1.0 and np.all(np.round(a[0] * 32768) == a[0] * 32768)


@pytest.mark.parametrize("spec", [cnnlstm_spec(dict(SMALL_CNN, lstm_layers=2)),
                                  wav2vec2_spec(dict(W2V_BASE, conv_dim=[4] * 7, hidden_size=8,
                                                     intermediate_size=8, num_layers=1,
                                                     num_heads=2, pos_conv_kernel=4,
                                                     pos_conv_groups=2))])
def test_weights_are_deterministic_per_seed(spec):
    a, b = make_weights(spec, 2**33 + 1, "cpu"), make_weights(spec, 2**33 + 1, "cpu")
    c = make_weights(spec, 2**33 + 2, "cpu")
    assert list(a) == [n for n, *_ in spec]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert any(not torch.equal(a[n], c[n]) for n in a if a[n].dtype.is_floating_point)
    assert all(float(v.min()) > 0 for n, v in a.items() if n.endswith("running_var"))


def test_comparisons():
    assert common.max_rel_err(np.array([1.0, 2.0]), np.array([1.0, 2.5])) == pytest.approx(0.2)
    assert common.max_rel_err(np.zeros(2), np.zeros(3)) == float("inf")
    gap = common.worst_leaf_gap({"a": 1.0, "b": 0.0, "c": 2.4}, {"a": 1.0, "b": 1e-9, "c": 2.0})
    assert gap == pytest.approx(0.2)  # "b" measured against the median leaf, 1.0


def test_op_device_s_counts_kernels_launched_inside_the_outermost_ops():
    kernels = [("k1", 0.0, 4.0), ("k2", 5.0, 6.0), ("k3", 7.0, 10.0), ("k4", 11.0, 12.0)]
    launchers = [(1, 1.5), (1, 2.5), (2, 1.5), None]
    spans = [("aten::convolution", 1, 1.0, 3.0), ("aten::cudnn_convolution", 1, 2.0, 2.8),
             ("aten::add", 1, 3.5, 4.0), ("aten::add", 2, 1.0, 2.0)]
    t = trace.Trace(0.0, 12.0, kernels, sorted(spans, key=lambda s: s[2]), launchers)
    assert t.op_device_s(["aten::convolution", "aten::cudnn_convolution"]) == pytest.approx(5e-6)
    assert t.op_device_s(["aten::add"]) == pytest.approx(3e-6)
    assert t.op_device_s(["aten::mul"]) is None
