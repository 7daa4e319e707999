"""The plain references against the program at tiny widths on the CPU. The
test imports both; the references themselves import nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench.reference import cnn_lstm as ref_cnn_lstm
from port_bench.reference import wav2vec2 as ref_w2v
from port_bench.reference.weights import cnnlstm_spec, make_weights, wav2vec2_spec
from port_bench.traffic.extract import build_extractor
from port_bench.traffic.score import build_classifier

CNN = dict(input_dim=12, cnn_out_channels=6, lstm_hidden_dim=5, lstm_layers=2, kernel_size=3,
           num_classes=2, activation_fn="silu", dropout_rate=0.5, block_dropout=0.2)
W2V = dict(hidden_size=16, num_layers=2, num_heads=4, intermediate_size=24, conv_dim=[8] * 7,
           conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2], pos_conv_kernel=8,
           pos_conv_groups=4, layer_norm_eps=1e-5, sample_rate=16000, chunk_seconds=5.0,
           overlap_seconds=1.0, min_seconds=0.5, extract_batch_size=4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_spec_matches_the_programs_classifier(act):
    from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM

    for cfg in (CNN, dict(CNN, input_dim=768, cnn_out_channels=128, lstm_hidden_dim=128)):
        with torch.device("meta"):
            sd = CNNLSTM(cfg["input_dim"], 2, cfg["cnn_out_channels"], cfg["lstm_hidden_dim"],
                         cfg["lstm_layers"], activation_fn=act).state_dict()
        assert {n: tuple(v.shape) for n, v in sd.items()} == {n: s for n, s, *_ in cnnlstm_spec(cfg)}


def test_spec_matches_the_programs_encoder():
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    from port_bench.traffic.extract import encoder_config

    base = dict(W2V, hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072,
                conv_dim=[512] * 7, pos_conv_kernel=128, pos_conv_groups=16)
    for cfg in (W2V, base):
        sd = Wav2Vec2Model(encoder_config(cfg)).state_dict()
        assert {n: tuple(v.shape) for n, v in sd.items()} == {n: s for n, s, *_ in wav2vec2_spec(cfg)}


def test_classifier_eval_matches_the_program():
    w = make_weights(cnnlstm_spec(CNN), 11, "cpu")
    model = build_classifier(CNN, w, "cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 32, CNN["input_dim"], generator=gen)
    lengths = torch.tensor([32, 19, 7])
    x[1, 19:] = 0.0
    x[2, 7:] = 0.0
    with torch.no_grad():
        program = model(x, lengths)
        ref = ref_cnn_lstm.forward(ref_cnn_lstm.lanes(w, 1), x, lengths, CNN)[0]
    torch.testing.assert_close(ref, program, rtol=1e-5, atol=1e-6)


def test_lanes_train_forward_matches_the_program():
    """Train mode: batch-statistics BatchNorm and the lanes' dropout draws,
    from one generator state on both sides."""
    from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTMLanes

    k = 3
    w = make_weights(cnnlstm_spec(CNN), 12, "cpu")
    lanes = CNNLSTMLanes.from_state_dict(w, k, activation_fn=CNN["activation_fn"]).train()
    x = torch.randn(4, 24, CNN["input_dim"], generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([24, 20, 9, 16])
    rates = torch.tensor([0.2, 0.35, 0.5], dtype=torch.float64)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    with torch.no_grad():
        program = lanes(x, lengths, rates, g1)
        ref = ref_cnn_lstm.forward(ref_cnn_lstm.lanes(w, k), x, lengths, CNN, train=True,
                                   rates=rates, draw=lambda s: torch.rand(s, generator=g2))
    torch.testing.assert_close(ref, program, rtol=1e-5, atol=1e-6)


def test_draw_shapes_are_the_forward_draws():
    w = make_weights(cnnlstm_spec(CNN), 14, "cpu")
    x = torch.randn(3, 22, CNN["input_dim"], generator=torch.Generator().manual_seed(2))
    drawn = []

    def draw(shape):
        drawn.append(tuple(shape))
        return torch.rand(shape)

    ref_cnn_lstm.forward(ref_cnn_lstm.lanes(w, 2), x, torch.tensor([22, 15, 7]), CNN, train=True,
                         rates=torch.tensor([0.2, 0.4], dtype=torch.float64), draw=draw)
    assert drawn == ref_cnn_lstm.draw_shapes(CNN, 3, 22)


def test_batch_statistics_move_the_programs_running_statistics():
    """The program's train-mode BatchNorm moves its running statistics by
    0.01 of the batch's mean and biased variance, as the reference's
    statistics say."""
    from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTMLanes

    k = 2
    w = make_weights(cnnlstm_spec(CNN), 15, "cpu")
    lanes = CNNLSTMLanes.from_state_dict(w, k, activation_fn=CNN["activation_fn"]).train()
    before = {n: b.clone() for n, b in lanes.named_buffers() if ".running_" in n}
    x = torch.randn(3, 20, CNN["input_dim"], generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([20, 11, 6])
    rates = torch.tensor([0.3, 0.45], dtype=torch.float64)
    g1, g2 = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    stats = {}
    with torch.no_grad():
        lanes(x, lengths, rates, g1)
        ref_cnn_lstm.forward(ref_cnn_lstm.lanes(w, k), x, lengths, CNN, train=True, rates=rates,
                             draw=lambda s: torch.rand(s, generator=g2), stats=stats)
    after = dict(lanes.named_buffers())
    assert before
    for name, old in before.items():
        prefix, which = name.rsplit(".", 1)
        batch = torch.stack([stats[(prefix, i)][which == "running_var"] for i in range(k)])
        want = 0.99 * old.view(k, -1) + 0.01 * batch
        torch.testing.assert_close(after[name].view(k, -1), want, rtol=1e-5, atol=1e-6)


def test_encoder_sequences_match_the_program():
    w = make_weights(wav2vec2_spec(W2V), 13, "cpu")
    extractor = build_extractor(W2V, w, "cpu")
    rng = np.random.default_rng(2)
    waves = {"a": rng.standard_normal(16000 * 11).astype(np.float32) * 0.1,
             "b": rng.standard_normal(9000).astype(np.float32) * 0.1,
             "c": rng.standard_normal(5000).astype(np.float32) * 0.1}  # under 0.5 s: skipped
    program = extractor.extract_sequences(waves, verbose=False)
    ref = ref_w2v.sequences(w, waves, W2V, "cpu")
    assert set(program) == set(ref) == {"a", "b"}
    for name in ref:
        np.testing.assert_allclose(program[name], ref[name], rtol=1e-4, atol=1e-5)


def test_chunk_bounds():
    cfg = dict(sample_rate=10, chunk_seconds=5.0, overlap_seconds=1.0, min_seconds=0.5)
    assert ref_w2v.chunk_bounds(4, cfg) == []
    assert ref_w2v.chunk_bounds(50, cfg) == [(0, 50), (40, 50)]
    assert ref_w2v.chunk_bounds(83, cfg) == [(0, 50), (40, 83)]  # (80, 83) is under 0.5 s
