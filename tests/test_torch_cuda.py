"""Tests of the port that need the card. They import no JAX, so they also run
on a machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM, build_cnn_lstm
from robust_speech_analysis_framework_tpu_torch.ops.cuda import lstm as lstm_ops
from robust_speech_analysis_framework_tpu_torch.train import loops

pytestmark = pytest.mark.cuda

ATOL = 1e-5  # fp32 kernel vs fp32 plain version: summation order only
DWH_TOL = 1e-4  # dWh sums T·B products: relative


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # torch's fp32_precision API only, as the port's own switch
    # (device.fp32_convs): torch raises where the legacy allow_tf32 flags
    # are read after the new API has set them
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    torch.backends.cudnn.rnn.fp32_precision = "ieee"
    return torch.device("cuda")


def _tf32_flags():
    return (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cudnn.rnn.fp32_precision)


def test_convs_run_in_fp32_under_torchs_default_flags():
    """Under torch's default flags (cuDNN convolutions allowed TF32) the
    flagship model's logits hold to the CPU within 1e-4 and resample_poly
    within 1e-5 of the input's scale: the port runs its convolutions in IEEE
    float32 itself, and leaves the caller's flags as they were. This test
    does not take the TF32-off fixture."""
    from robust_speech_analysis_framework_tpu_torch.audio.resample import resample_poly

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = _tf32_flags()
    try:
        torch.backends.cuda.matmul.fp32_precision = "none"  # torch's defaults
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        torch.backends.cudnn.rnn.fp32_precision = "tf32"
        defaults = _tf32_flags()
        rng = np.random.default_rng(5)
        model = build_cnn_lstm(input_dim=768, cnn_out_channels=128, lstm_hidden_dim=128,
                               seed=3, device="cuda")
        x = torch.from_numpy(rng.normal(size=(2, 1200, 768)).astype(np.float32))
        lengths = torch.tensor([1200, 777], dtype=torch.int32)
        with torch.inference_mode():
            card = model(x.cuda(), lengths.cuda()).cpu()
            assert _tf32_flags() == defaults
            cpu = model.cpu()(x, lengths)
        torch.testing.assert_close(card, cpu, rtol=0, atol=1e-4)
        wave = torch.from_numpy(rng.uniform(-1, 1, 160_000).astype(np.float32))
        y_card = resample_poly(wave.cuda(), 5, 8).cpu()
        assert _tf32_flags() == defaults
        torch.testing.assert_close(y_card, resample_poly(wave, 5, 8), rtol=0, atol=1e-5)
    finally:
        (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision,
         torch.backends.cudnn.rnn.fp32_precision) = saved


SCAN_TILES = (1, 2)  # the forward scan's batch tiles


@pytest.mark.parametrize("t,b,h", [
    (37, 3, 8), (300, 17, 128), (64, 9, 40), (1, 5, 16),
    (33, 5, 24),   # H % 32 != 0: the kernel runs at the next multiple of 32, zero-padded
    (48, 67, 64),  # H = 64; 2 x 67 rows outnumber the SMs: batch tile 2, ragged last tile
])
def test_kernel_matches_plain_version(cuda_device, t, b, h):
    rng = np.random.default_rng(0)
    gates = torch.from_numpy((rng.normal(size=(t, 2, b, 4 * h)) * 0.5).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(2, h, 4 * h)) / h**0.5).astype(np.float32))
    gates, wh = gates.to(cuda_device), wh.to(cuda_device)
    before = (lstm_ops.lstm_scan_grouped.launches, lstm_ops.lstm_scan.launches)
    out = lstm_ops.lstm_scan_grouped(gates, wh)
    out1 = lstm_ops.lstm_scan(gates[:, 0].contiguous(), wh[0])
    torch.cuda.synchronize()
    assert (lstm_ops.lstm_scan_grouped.launches, lstm_ops.lstm_scan.launches) == (
        before[0] + 1, before[1] + 1)
    ref, ref_cs = lstm_ops.lstm_scan_fwd_res_reference_grouped(gates, wh)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(out1, ref[:, 0], rtol=0, atol=ATOL)
    # every batch tile the kernel keeps, with and without the saved c
    for tile in SCAN_TILES:
        torch.testing.assert_close(lstm_ops._launch(gates, wh, tile), ref, rtol=0, atol=ATOL)
        hs, cs = lstm_ops._launch(gates, wh, tile, save_c=True)
        torch.testing.assert_close(hs, ref, rtol=0, atol=ATOL)
        torch.testing.assert_close(cs, ref_cs, rtol=0, atol=ATOL)
        assert torch.equal(hs, out)  # neither the tile nor save_c changes a row's arithmetic


def test_kernel_rejects_unsupported_hidden_size(cuda_device):
    gates = torch.zeros(4, 2, 1, 4 * 6, device=cuda_device)
    with pytest.raises(ValueError, match="H % 8"):
        lstm_ops.lstm_scan_grouped(gates, torch.zeros(2, 6, 24, device=cuda_device))


def test_cnn_lstm_on_card_matches_cpu(cuda_device):
    """Ragged batch through the model on the card (two kernel launches) and
    on the CPU (plain path); logits agree within 1e-4."""
    model = build_cnn_lstm(input_dim=24, cnn_out_channels=16, lstm_hidden_dim=16,
                           seed=1, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 64, 24)).astype(np.float32))
    lengths = torch.tensor([64, 41, 7], dtype=torch.int32)
    before = lstm_ops.lstm_scan_grouped.launches
    with torch.inference_mode():
        card = model(x.to(cuda_device), lengths.to(cuda_device)).cpu()
        cpu = model.cpu()(x, lengths)
    assert lstm_ops.lstm_scan_grouped.launches == before + 2
    torch.testing.assert_close(card, cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("t,b,h", [
    (37, 3, 8), (300, 17, 128), (64, 9, 40), (1, 5, 16),
    (33, 5, 24),   # H < 32: the sweep's whole Whᵀ in registers
    (48, 67, 64),  # H = 64; 2 x 67 rows outnumber the SMs: batch tile 2, ragged last tile
    (2, 3, 8),     # dWh: one step's rows, a single short chunk
    (700, 1, 64),  # dWh: B = 1, 699 rows in slices whose last ends short
    (130, 3, 128), # dWh: 387 rows, fewer chunks than a wave has room for slices
])
def test_training_kernels_match_plain_versions(cuda_device, t, b, h):
    """K3 (hs, cs), K4 (its gate pre-pass, dgates) and the dWh kernel against
    their plain versions on the card, one launch each."""
    rng = np.random.default_rng(1)
    gates = torch.from_numpy((rng.normal(size=(t, 2, b, 4 * h)) * 0.5).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(2, h, 4 * h)) / h**0.5).astype(np.float32))
    dhout = torch.from_numpy(rng.normal(size=(t, 2, b, h)).astype(np.float32))
    gates, wh, dhout = gates.to(cuda_device), wh.to(cuda_device), dhout.to(cuda_device)
    counters = (lstm_ops.lstm_scan_fwd_res_grouped, lstm_ops.lstm_gate_acts_grouped,
                lstm_ops.lstm_scan_bwd_grouped, lstm_ops.lstm_dwh_grouped)
    before = [c.launches for c in counters]
    hs, cs = lstm_ops.lstm_scan_fwd_res_grouped(gates, wh)
    dg, dwh = lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    ref_hs, ref_cs = lstm_ops.lstm_scan_fwd_res_reference_grouped(gates, wh)
    torch.testing.assert_close(hs, ref_hs, rtol=0, atol=ATOL)
    torch.testing.assert_close(cs, ref_cs, rtol=0, atol=ATOL)
    ref_dg, ref_dwh = lstm_ops.lstm_scan_bwd_reference_grouped(gates, hs, cs, wh, dhout)
    torch.testing.assert_close(dg, ref_dg, rtol=0, atol=ATOL)
    torch.testing.assert_close(dwh, ref_dwh, rtol=DWH_TOL, atol=DWH_TOL)
    # the slices' sums are added in a fixed order: a second call gives the same bits
    assert torch.equal(lstm_ops.lstm_dwh_grouped(hs, dg), dwh)
    assert counters[3].launches == before[3] + 2
    if t == 1:
        assert not dwh.any()
    acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
    assert counters[1].launches == before[1] + 2
    ref_acts = lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh)
    torch.testing.assert_close(acts, ref_acts, rtol=0, atol=ATOL)
    # the sweep alone, in place over the plain activations, at every batch tile
    ref_sweep = lstm_ops.lstm_sweep_from_acts_reference_grouped(ref_acts, cs, wh, dhout)
    for tile in (1, 2, 4):
        buf = ref_acts.clone()
        lstm_ops._launch_sweep(buf, cs, wh, dhout, tile)
        torch.testing.assert_close(buf, ref_sweep, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t,b,h", [(300, 4, 64), (300, 4, 128), (97, 3, 40)])
def test_kernels_at_sixteen_groups_match_plain_versions(cuda_device, t, b, h):
    """A round of 8 lanes runs every LSTM kernel at G = 16: K1, K3, K4 (its
    pre-pass, its sweep) and dWh against their plain versions there."""
    rng = np.random.default_rng(3)
    g = 16
    gates = torch.from_numpy((rng.normal(size=(t, g, b, 4 * h)) * 0.5).astype(np.float32))
    wh = torch.from_numpy((rng.normal(size=(g, h, 4 * h)) / h**0.5).astype(np.float32))
    dhout = torch.from_numpy(rng.normal(size=(t, g, b, h)).astype(np.float32))
    gates, wh, dhout = gates.to(cuda_device), wh.to(cuda_device), dhout.to(cuda_device)
    hs, cs = lstm_ops.lstm_scan_fwd_res_grouped(gates, wh)
    ref_hs, ref_cs = lstm_ops.lstm_scan_fwd_res_reference_grouped(gates, wh)
    torch.testing.assert_close(hs, ref_hs, rtol=0, atol=ATOL)
    torch.testing.assert_close(cs, ref_cs, rtol=0, atol=ATOL)
    assert torch.equal(lstm_ops.lstm_scan_grouped(gates, wh), hs)
    dg, dwh = lstm_ops.lstm_scan_bwd_grouped(gates, hs, cs, wh, dhout)
    ref_dg, ref_dwh = lstm_ops.lstm_scan_bwd_reference_grouped(gates, hs, cs, wh, dhout)
    torch.testing.assert_close(dg, ref_dg, rtol=0, atol=ATOL)
    torch.testing.assert_close(dwh, ref_dwh, rtol=DWH_TOL, atol=DWH_TOL)
    acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
    torch.testing.assert_close(acts, lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh),
                               rtol=0, atol=ATOL)
    buf = acts.clone()
    lstm_ops._launch_sweep(buf, cs, wh, dhout)
    torch.testing.assert_close(
        buf, lstm_ops.lstm_sweep_from_acts_reference_grouped(acts, cs, wh, dhout),
        rtol=0, atol=ATOL)


def test_lane_trials_on_card_match_cpu_and_launch_once_for_all_lanes(cuda_device):
    """train_trials_device of 3 lanes (dropout off) on the card and on the
    CPU from the same weights: histories to 1e-4 relative; one lane step
    launches K3, K4, its pre-pass and dWh once a layer, K1 once a layer an
    eval batch."""
    rng = np.random.default_rng(4)
    seqs = [rng.normal(size=(int(n), 24)).astype(np.float32) for n in rng.integers(30, 64, 12)]
    labels = np.arange(12) % 2
    template = CNNLSTM(input_dim=24, cnn_out_channels=16, lstm_hidden_dim=16, dropout_rate=0.0)
    template.res_block1.dropout = template.res_block2.dropout = 0.0
    cfg = loops.TrainConfig(epochs=2, batch_size=4, seed=1, dropout_rate=0.0, use_plateau=False,
                            restore_best=False)
    hists = {}
    for where in (cuda_device, "cpu"):
        trainer = loops.Trainer(template, adam_eps=1e-3, device=where)
        counters = (lstm_ops.lstm_scan_fwd_res_grouped, lstm_ops.lstm_scan_bwd_grouped,
                    lstm_ops.lstm_gate_acts_grouped, lstm_ops.lstm_dwh_grouped,
                    lstm_ops.lstm_scan_grouped)
        before = [c.launches for c in counters]
        _, hist = loops.train_trials_device(trainer, seqs[:8], labels[:8], seqs[8:], labels[8:],
                                            cfg, [1e-3, 3e-3, 2e-3], [0.0] * 3)
        hists[str(where)] = hist.result()
        if where != "cpu":
            # 2 epochs x 2 steps; 2 epochs x 1 val batch
            assert [c.launches - n for c, n in zip(counters, before)] == [8, 8, 8, 8, 4]
    for (th, vh), (cth, cvh) in zip(hists[str(cuda_device)], hists["cpu"]):
        np.testing.assert_allclose(th + vh, cth + cvh, rtol=1e-4)


def test_train_step_on_card_matches_cpu(cuda_device):
    """One Adam step (dropout off) on the card, through K3/K4, and on the CPU
    through the plain versions, from the same weights."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 64, 24)).astype(np.float32)
    lengths = np.array([64, 41, 7], np.int32)
    labels = np.array([0, 1, 1])
    template = CNNLSTM(input_dim=24, cnn_out_channels=16, lstm_hidden_dim=16, dropout_rate=0.0)
    template.res_block1.dropout = template.res_block2.dropout = 0.0
    weights = loops.Trainer(template, device="cpu").init_state(0, 1e-3).model.state_dict()
    losses, states = [], []
    for dev in (cuda_device, "cpu"):
        trainer = loops.Trainer(template, device=dev, adam_eps=1e-5)
        state = trainer.init_state(0, 1e-3, weights)
        before = lstm_ops.lstm_scan_fwd_res_grouped.launches, lstm_ops.lstm_scan_bwd_grouped.launches
        losses.append(float(trainer.train_step(state, x, lengths, labels, None)))
        after = lstm_ops.lstm_scan_fwd_res_grouped.launches, lstm_ops.lstm_scan_bwd_grouped.launches
        assert after == ((before[0] + 2, before[1] + 2) if dev != "cpu" else before)
        states.append({k: v.cpu() for k, v in state.model.state_dict().items()})
    assert losses[0] == pytest.approx(losses[1], abs=1e-5)
    for key in states[1]:
        torch.testing.assert_close(states[0][key], states[1][key], rtol=0, atol=1e-5)


VITERBI_SCHEMES = {"opensmile": (10.0, 0.0, 10.0), "praat": (0.175, 0.0, 0.07)}


def test_resident_fold_on_card_matches_streaming_and_cpu(cuda_device):
    """The device-resident fold on the card: batches gathered from a corpus
    tensor on the card launch K3/K4 (two each a step), upload nothing but
    labels, plans and row indices, and give the streaming fold's and the
    CPU's losses (one-bucket data, dropout off: 1e-5)."""
    from robust_speech_analysis_framework_tpu_torch.ops.framing import collect

    rng = np.random.default_rng(2)
    seqs = [rng.normal(size=(int(t), 24)).astype(np.float32) for t in rng.integers(33, 65, 12)]
    labels = np.arange(12) % 2
    template = CNNLSTM(input_dim=24, cnn_out_channels=16, lstm_hidden_dim=16, dropout_rate=0.0)
    template.res_block1.dropout = template.res_block2.dropout = 0.0
    cfg = dict(learning_rate=1e-2, epochs=2, batch_size=4, min_bucket=16, dropout_rate=0.0)
    hist, uploads = {}, []
    real = loops.Trainer._tensor
    for where, fold in ((cuda_device, "on"), (cuda_device, "off"), ("cpu", "on")):
        corpus = loops.DeviceCorpus(seqs, align=64, device=where)
        assert corpus.x.device.type == torch.device(where).type
        view = corpus.view(np.arange(12))
        trainer = loops.Trainer(template, device=where)
        counters = (lstm_ops.lstm_scan_fwd_res_grouped, lstm_ops.lstm_scan_bwd_grouped)
        before = [c.launches for c in counters]
        if (where, fold) == (cuda_device, "on"):
            trainer._tensor = lambda a, dtype: (
                uploads.append(0 if isinstance(a, torch.Tensor) else np.asarray(a).nbytes)
                or real(trainer, a, dtype))
        state, train_hist, val_hist = loops.train_model(
            trainer, view.subset(np.arange(8)), labels[:8], view.subset(np.arange(8, 12)),
            labels[8:], loops.TrainConfig(**cfg, device_fold=fold))
        hist[(str(where), fold)] = train_hist + val_hist
        if where != "cpu":
            assert [c.launches - b for c, b in zip(counters, before)] == [8, 8]  # 4 steps x 2 layers
            deferred = loops.evaluate_model_deferred(trainer, state, view, labels,
                                                     loops.TrainConfig(**cfg))
            assert all(t.is_cuda for t in deferred.arrays)
            y_true, y_pred, y_prob = collect([deferred])[0]
            assert y_prob.shape == (12,) and np.isfinite(y_prob).all()
    assert max(uploads) <= 8 * 2 * 8  # the int64 plan of 2 epochs x 8 train rows
    on, off, cpu = hist[("cuda", "on")], hist[("cuda", "off")], hist[("cpu", "on")]
    np.testing.assert_allclose(on, off, rtol=0, atol=1e-5)
    np.testing.assert_allclose(on, cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("scheme", sorted(VITERBI_SCHEMES))
@pytest.mark.parametrize("b,t,c", [(3, 37, 7), (4, 2000, 7), (2, 500, 15), (5, 1, 3),
                                   (1, 300, 32), (2, 129, 1)])
def test_viterbi_kernels_equal_plain_versions(cuda_device, b, t, c, scheme):
    """K6 forward costs and the K7 path bit-equal to their plain versions on
    the card; one K6 launch for K6, one K6 (both directions) and one K7
    launch for the path."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi

    rng = np.random.default_rng(b * t + c)
    freqs = np.where(rng.random((b, t, c)) < 0.3, 0.0, rng.uniform(60, 500, (b, t, c)))
    lf = torch.from_numpy(np.log2(np.where(freqs > 0, freqs, 1.0)).astype(np.float32))
    v = torch.from_numpy((freqs > 0).astype(np.float32))
    local = torch.from_numpy(rng.uniform(-1.0, 3.0, (b, t, c)).astype(np.float32))
    lf, v, local = lf.to(cuda_device), v.to(cuda_device), local.to(cuda_device)
    w = VITERBI_SCHEMES[scheme]
    before = viterbi.viterbi_forward_costs.launches, viterbi.viterbi_path.launches
    costs = viterbi.viterbi_forward_costs(lf, v, local, *w)
    path = viterbi.viterbi_path(lf, v, local, *w)
    torch.cuda.synchronize()
    assert (viterbi.viterbi_forward_costs.launches, viterbi.viterbi_path.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(costs, viterbi.viterbi_forward_costs_reference(lf, v, local, *w))
    assert torch.equal(path, viterbi.viterbi_path_reference(lf, v, local, *w))


def test_opensmile_on_card_matches_cpu(cuda_device):
    """Two short speech-like files through the extractor on the card (K7 per
    sub-batch) and on the CPU, with the tolerance families of the JAX
    package's batched-vs-serial test."""
    from robust_speech_analysis_framework_tpu_torch.features.opensmile import (
        OpenSmileExtractor,
        feature_columns,
    )
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi

    rng = np.random.default_rng(0)
    waves = {}
    for i, seconds in enumerate((1.3, 2.2)):
        t = np.arange(int(seconds * 16000)) / 16000
        voiced = sum(np.sin(2 * np.pi * k * (125 + 20 * i) * t) / k for k in range(1, 12))
        x = 0.3 * np.where((t % 0.6) < 0.42, 1.0, 0.02) * voiced / np.abs(voiced).max()
        waves[f"w{i}.wav"] = (x + 0.002 * rng.normal(size=len(t))).astype(np.float32)
    before = viterbi.viterbi_path.launches
    names, card = OpenSmileExtractor(device=cuda_device).extract_arrays(waves, verbose=False)
    assert viterbi.viterbi_path.launches == before + 2  # one per bucket
    cpu_names, cpu = OpenSmileExtractor(device="cpu").extract_arrays(waves, verbose=False)
    assert names == cpu_names and card.shape == (2, 912) and np.isfinite(card).all()
    rel = np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-3)
    vq = np.array([any(k in col for k in ("jitter", "shimmer", "logHNR"))
                   for col in feature_columns()])
    assert np.median(rel) < 1e-5
    assert rel[:, ~vq].mean() < 2e-4
    assert rel[:, vq].mean() < 5e-2


def _mshds_speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like 16-bit PCM (11 harmonics, 3 Hz vibrato, syllable gating)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    x = 0.3 * np.where((t % 0.6) < 0.42, 1.0, 0.02) * v / np.abs(v).max()
    x = x + 0.002 * rng.normal(size=len(t))
    return np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0


def test_mshds_pitch_half_on_card_matches_cpu(cuda_device):
    """The corpus buffer (bit-equal), the ac and cc pitch passes (one K7
    launch per variant; frames agree on voicing and f0 within 1e-4 on 99 %),
    intensity (1e-3 dB), HNR (NaN masks equal, 0.05 dB) and the pulse march
    (99 % of the pulses identical) on the card against the CPU."""
    from robust_speech_analysis_framework_tpu_torch.ops import (
        framing,
        harmonicity,
        intensity,
        pitch,
        pulses,
    )
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi

    xs = [_mshds_speech(2.0, 100, 0), _mshds_speech(3.1, 200, 1), _mshds_speech(0.005, 150, 2)]
    bufs = {dev: framing.corpus_buffer(xs, pad=4096, align=8, device=dev)
            for dev in (cuda_device, "cpu")}
    assert torch.equal(bufs[cuda_device].x_cat.cpu(), bufs["cpu"].x_cat)
    variants = [pitch.PitchParams(time_step=0.005, floor=60, ceiling=250),
                pitch.PitchParams(time_step=0.005, floor=60, ceiling=250, voicing_threshold=0.3)]
    cc = pitch.PitchParams(time_step=0.005, floor=60, ceiling=250, method="cc")
    out = {}
    for dev, buf in bufs.items():
        before = viterbi.viterbi_path.launches
        out[dev] = (pitch.pitch_track_batch_shared(None, 16000, variants, buf=buf)
                    + [pitch.pitch_track_batch(None, 16000, cc, buf=buf)])
        assert viterbi.viterbi_path.launches - before == (3 if dev == cuda_device else 0)
        out[dev] += [
            intensity.intensity_contour_batch(None, 16000, minimum_pitch=60, time_step=0.005,
                                              buf=buf),
            harmonicity.harmonicity_cc_batch(None, 16000, time_step=0.005, minimum_pitch=60,
                                             buf=buf),
            pulses.point_process_cc_batch(None, 16000, out[dev][2] + out[dev][1], buf=buf),
        ]
    card, cpu = out[cuda_device], out["cpu"]
    for tracks_card, tracks_cpu in zip(card[:3], cpu[:3]):
        for a, b in zip(tracks_card, tracks_cpu):
            voiced = b.f0 > 0
            agree = ((a.f0 > 0) == voiced) & (~voiced | (np.abs(a.f0 - b.f0) <= 1e-4 * b.f0))
            assert not len(b.f0) or agree.mean() >= 0.99
    for a, b in zip(card[3], cpu[3]):
        np.testing.assert_allclose(a.values_db, b.values_db, rtol=0, atol=1e-3)
    for a, b in zip(card[4], cpu[4]):
        np.testing.assert_array_equal(np.isnan(a.hnr_db), np.isnan(b.hnr_db))
        both = np.isfinite(b.hnr_db)
        np.testing.assert_allclose(a.hnr_db[both], b.hnr_db[both], rtol=0, atol=0.05)
    for a, b in zip(card[5], cpu[5]):
        assert not len(b) or np.isin(np.round(b, 9), np.round(a, 9)).mean() >= 0.99
    assert sum(len(p) for p in card[5]) > 500


def test_mshds_extractor_on_card_matches_cpu(cuda_device):
    """The whole MSHDS-25 extractor (extract_mshds_arrays) on the card and on
    the CPU: K7 once per pitch pass (wide, speech-rate, then main, CPP and cc
    per range group), NaN masks equal, every feature within its tolerance
    (chip_smoke.py's MSHDS_TOL)."""
    import chip_smoke
    from robust_speech_analysis_framework_tpu_torch.features import mshds
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi

    xs = [_mshds_speech(2.0, 100, 0), _mshds_speech(3.1, 200, 1), _mshds_speech(1.4, 130, 2)]
    before = viterbi.viterbi_path.launches
    card = mshds.extract_mshds_arrays(xs, 16000, device=cuda_device)
    assert viterbi.viterbi_path.launches - before == 2 + 3 * 2  # both range groups
    cpu = mshds.extract_mshds_arrays(xs, 16000, device="cpu")
    np.testing.assert_array_equal(np.isnan(card), np.isnan(cpu))
    assert np.isfinite(cpu).sum() >= 70
    for k, name in enumerate(mshds.FEATURE_NAMES):
        rtol, atol = chip_smoke.MSHDS_TOL[name]
        np.testing.assert_allclose(card[:, k], cpu[:, k], rtol=rtol, atol=atol, err_msg=name)
