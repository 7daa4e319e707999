"""Tests of the port that need the card. They import no JAX, so they also run
on a machine without it (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test here skips.
"""

import copy
import zlib

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


@pytest.mark.parametrize("t,g,b,h", [
    (1, 1, 5, 8),      # T = 1, fewer rows than a tile
    (2, 2, 1, 8),      # B = 1, two rows
    (37, 3, 3, 24),    # 111 rows: below one tile, G = 3
    (700, 1, 1, 64),   # B = 1, 700 rows: a ragged last tile
    (48, 2, 67, 128),  # B = 67, 3216 rows: 26 tiles, the last of 16 rows
    (47, 3, 67, 64),   # 150 items, 2 a block: runs cross column groups
    (300, 16, 4, 64),  # G = 16: 320 items, 3 a block
    (97, 16, 3, 128),  # G = 16 at H = 128: 192 items, 2 a block
    (1, 16, 4, 24),    # T = 1 at G = 16
])
def test_gate_acts_kernel_ragged_shapes(cuda_device, t, g, b, h):
    """The pre-pass alone against its plain version at ragged shapes (tiles
    past T·B, runs of items that cross column groups, T = 1), one launch a
    call, two calls the same bits."""
    rng = np.random.default_rng(t * g + b + h)
    gates = torch.from_numpy((rng.normal(size=(t, g, b, 4 * h)) * 2).astype(np.float32))
    hs = torch.from_numpy(rng.uniform(-1, 1, size=(t, g, b, h)).astype(np.float32))
    wh = torch.from_numpy((rng.uniform(-1, 1, size=(g, h, 4 * h)) / h**0.5).astype(np.float32))
    gates, hs, wh = gates.to(cuda_device), hs.to(cuda_device), wh.to(cuda_device)
    before = lstm_ops.lstm_gate_acts_grouped.launches
    acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
    again = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
    torch.cuda.synchronize()
    assert lstm_ops.lstm_gate_acts_grouped.launches == before + 2
    ref = lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh)
    torch.testing.assert_close(acts, ref, rtol=0, atol=ATOL)
    assert torch.equal(acts, again)


def test_gate_acts_kernel_extreme_inputs(cuda_device):
    """Gate inputs of up to ~±300: sigmoid's divisor reaches 2^126 and inf,
    where the kernel takes the IEEE division; outputs stay within ATOL of
    the plain version and in [0, 1] (sigmoid) and [-1, 1] (tanh)."""
    rng = np.random.default_rng(11)
    t, g, b, h = 37, 2, 3, 64
    gates = torch.from_numpy((rng.normal(size=(t, g, b, 4 * h)) * 100).astype(np.float32))
    hs = torch.from_numpy(rng.uniform(-1, 1, size=(t, g, b, h)).astype(np.float32))
    wh = torch.from_numpy((rng.uniform(-1, 1, size=(g, h, 4 * h)) / h**0.5).astype(np.float32))
    gates, hs, wh = gates.to(cuda_device), hs.to(cuda_device), wh.to(cuda_device)
    acts = lstm_ops.lstm_gate_acts_grouped(gates, hs, wh)
    ref = lstm_ops.lstm_gate_acts_reference_grouped(gates, hs, wh)
    torch.testing.assert_close(acts, ref, rtol=0, atol=ATOL)
    sig = torch.cat([acts[..., : 2 * h], acts[..., 3 * h :]], dim=-1)
    assert bool((sig >= 0).all() and (sig <= 1).all() and (acts.abs() <= 1).all())
    assert bool((sig == 0).any() and (sig == 1).any())


def test_gate_acts_plan_matches_the_kernel(cuda_device):
    """The wrapper's plan (grid, shared memory) equals the kernel file's own
    count, and the profile build gives the timed build's bits with a row of
    clocks a block whose phases add up to no more than its total."""
    import ctypes

    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build

    lib = _build.load("lstm_train")
    smem, grid = lib.lstm_gate_acts_smem_bytes, lib.lstm_gate_acts_grid
    smem.argtypes, grid.argtypes = [ctypes.c_int], [ctypes.c_int] * 4
    smem.restype = grid.restype = ctypes.c_int
    for n_rows, g, h, n_sms in ((1, 1, 8, 132), (111, 3, 24, 132), (3216, 2, 128, 132),
                                (32768, 2, 128, 132), (8704, 16, 64, 132), (8704, 16, 128, 132),
                                (4800, 16, 40, 7), (65536, 140, 128, 132)):
        plan = lstm_ops._acts_plan(n_rows, g, h, n_sms)
        assert smem(h) == plan.smem_bytes
        assert grid(n_rows, g, h, n_sms) == plan.grid
    rng = np.random.default_rng(12)
    t, g, b, h = 300, 2, 17, 128
    gates = torch.from_numpy(rng.normal(size=(t, g, b, 4 * h)).astype(np.float32)).to(cuda_device)
    hs = torch.from_numpy(rng.uniform(-1, 1, size=(t, g, b, h)).astype(np.float32)).to(cuda_device)
    wh = torch.from_numpy((rng.uniform(-1, 1, size=(g, h, 4 * h)) / h**0.5).astype(
        np.float32)).to(cuda_device)
    before = lstm_ops.lstm_gate_acts_grouped.launches
    acts, prof = lstm_ops.lstm_gate_acts_profile(gates, hs, wh)
    assert lstm_ops.lstm_gate_acts_grouped.launches == before
    assert torch.equal(acts, lstm_ops.lstm_gate_acts_grouped(gates, hs, wh))
    n_sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert prof.shape == (lstm_ops._acts_plan(t * b, g, h, n_sms).grid, 6)
    assert bool((prof[:, 1:] >= 0).all() and (prof[:, 1:].sum(1) <= prof[:, 0]).all())


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


def test_period_march_kernel_matches_plain_version(cuda_device):
    """The period march kernel against its plain version on the card, over
    speech-like files with unvoiced stretches, digital silence under a
    voiced contour and a lane that hits its cap: one launch; ≥ 99.9 % of
    boundaries equal (both sum in float64, in other orders), amplitudes and
    correlations within 1e-6 where they agree, zero rows past each count."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops

    sr, hop = 16000, 160
    waves = [_mshds_speech(s, f, i).astype(np.float32)
             for i, (s, f) in enumerate(((2.5, 110.0), (1.7, 180.0), (3.0, 230.0)))]
    waves[1][int(0.8 * sr):] = 0.0  # exact zeros under a voiced contour
    stack = np.zeros((len(waves), max(len(x) for x in waves)), np.float32)
    f0 = np.zeros((len(waves), stack.shape[1] // hop), np.float32)
    for i, x in enumerate(waves):
        stack[i, : len(x)] = x
        frames = np.arange(len(x) // hop)
        f0[i, : len(frames)] = np.where(frames % 60 < 42, 100.0 + 60.0 * i, 0.0)
    f0[1, : len(waves[1]) // hop] = 170.0
    ns = torch.tensor([len(x) for x in waves], dtype=torch.int32)
    nf = torch.tensor([len(x) // hop for x in waves], dtype=torch.int32)
    for p_max in (stack.shape[1] // 16, 40):
        args = (float(sr), hop, 0.25, 40.0, p_max)
        x, f, n, m = (t.to(cuda_device) for t in (torch.from_numpy(stack), torch.from_numpy(f0),
                                                  ns, nf))
        before = march_ops.march_periods.launches
        card = march_ops.march_periods(x, f, n, m, *args)
        torch.cuda.synchronize()
        assert march_ops.march_periods.launches == before + 1
        plain = march_ops.march_periods_reference(x, f, n, m, *args)
        card, plain = [[t.cpu().numpy() for t in out] for out in (card, plain)]
        assert (card[4] > 0).all()
        if p_max == 40:
            assert (card[4] == 40).all() and (plain[4] == 40).all()
        for i in range(len(waves)):
            k = min(card[4][i], plain[4][i])
            assert abs(int(card[4][i]) - int(plain[4][i])) <= max(1, k // 1000)
            same = card[0][i, :k] == plain[0][i, :k]
            assert same.mean() >= 0.999
            np.testing.assert_allclose(card[2][i, :k][same], plain[2][i, :k][same], atol=1e-6)
            np.testing.assert_allclose(card[3][i, :k][same], plain[3][i, :k][same], atol=1e-6)
            for t in card[:4]:
                assert not t[i, card[4][i]:].any()


def _march_case(name):
    """(stack, f0, ns, nf) of a march case: speech-like files (float32 PCM
    values) with F0 contours that drive one part of the kernel's ring."""
    sr, hop = 16000, 160
    if name == "ring-wraps":  # 4 s voiced throughout: the 8192-sample ring wraps 7 times
        waves = [_mshds_speech(4.0, 120.0, 1)]
        contours = [lambda nfr: np.full(nfr, 120.0)]
    elif name == "jumps":  # 1.2 s unvoiced (19,200 samples, past the ring's end), and
        # a file whose last voiced frame leaves the cursor within 16 samples of n
        waves = [_mshds_speech(3.0, 150.0, 2), _mshds_speech(2.0, 200.0, 3)]
        contours = [lambda nfr: np.where((np.arange(nfr) < 50) | (np.arange(nfr) >= 170),
                                         150.0, 0.0),
                    lambda nfr: np.where(np.arange(nfr) < nfr - 30, 200.0, 0.0)]
    elif name == "f0-min":  # F0 below f0_min reads as f0_min: the widest window, GW
        waves = [_mshds_speech(3.0, 40.0, 4), _mshds_speech(2.5, 42.0, 5)]
        contours = [lambda nfr: np.full(nfr, 30.0), lambda nfr: np.full(nfr, 40.0)]
    elif name == "sixteen":
        waves = [_mshds_speech(1.0 + 0.1 * i, 90.0 + 12.0 * i, 10 + i) for i in range(16)]
        contours = [lambda nfr, i=i: np.where(np.arange(nfr) % 60 < 42, 90.0 + 12.0 * i, 0.0)
                    for i in range(16)]
    else:  # "one": one file, alone in its launch
        waves = [_mshds_speech(2.2, 170.0, 6)]
        contours = [lambda nfr: np.where(np.arange(nfr) % 50 < 35, 170.0, 0.0)]
    width = max(len(x) for x in waves) | 1  # an odd N: rows are not 16-byte aligned
    stack = np.zeros((len(waves), width), np.float32)
    f0 = np.zeros((len(waves), width // hop), np.float32)
    for i, (x, contour) in enumerate(zip(waves, contours)):
        stack[i, : len(x)] = x
        f0[i, : len(x) // hop] = contour(len(x) // hop)
    ns = torch.tensor([len(x) for x in waves], dtype=torch.int32)
    nf = torch.tensor([len(x) // hop for x in waves], dtype=torch.int32)
    return stack, f0, ns, nf, (float(sr), hop, 0.25, 40.0, width // 16)


def _assert_march_agrees(card, plain):
    """The thresholds of test_period_march_kernel_matches_plain_version."""
    card, plain = [[t.cpu().numpy() for t in out] for out in (card, plain)]
    assert (card[4] > 0).all()
    for i in range(len(card[4])):
        k = min(card[4][i], plain[4][i])
        assert abs(int(card[4][i]) - int(plain[4][i])) <= max(1, k // 1000)
        same = card[0][i, :k] == plain[0][i, :k]
        assert same.mean() >= 0.999
        np.testing.assert_allclose(card[2][i, :k][same], plain[2][i, :k][same], atol=1e-6)
        np.testing.assert_allclose(card[3][i, :k][same], plain[3][i, :k][same], atol=1e-6)
        for t in card[:4]:
            assert not t[i, card[4][i]:].any()
    return card


@pytest.mark.parametrize("case", ["ring-wraps", "jumps", "f0-min", "sixteen", "one"])
def test_period_march_kernel_ring_cases_match_plain_version(cuda_device, case):
    """The kernel against its plain version where its ring is stressed: a
    voiced stretch that wraps the ring several times, an unvoiced jump past
    the ring's end and one to within 16 samples of n, F0 pinned at f0_min
    (windows of GW samples), B = 16 and B = 1; every stack has an odd N. One
    launch each, the thresholds of the test above."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops

    stack, f0, ns, nf, args = _march_case(case)
    x, f, n, m = (t.to(cuda_device) for t in (torch.from_numpy(stack), torch.from_numpy(f0),
                                              ns, nf))
    assert stack.shape[1] % 2 == 1
    before = march_ops.march_periods.launches
    card = march_ops.march_periods(x, f, n, m, *args)
    torch.cuda.synchronize()
    assert march_ops.march_periods.launches == before + 1
    got = _assert_march_agrees(card, march_ops.march_periods_reference(x, f, n, m, *args))
    if case == "jumps":  # the second lane's last period starts before its voicing ends
        hop = args[1]
        last = got[0][1, got[4][1] - 1]
        assert last < (int(nf[1]) - 30) * hop <= last + got[1][1, got[4][1] - 1] + 2 * hop
    if case == "ring-wraps":
        assert got[0][0, got[4][0] - 1] > 7 * march_ops.march_plan(16000, 0.25, 40.0, 160).ring


@pytest.mark.parametrize("case", ["jumps", "sixteen"])
def test_period_march_profile_build_equals_timed_build(cuda_device, case):
    """The profile build's outputs bit-equal to the timed build's, its phase
    sums within its total clocks, its step counts consistent with the rows
    found, and no launch counted."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops

    stack, f0, ns, nf, args = _march_case(case)
    x, f, n, m = (t.to(cuda_device) for t in (torch.from_numpy(stack), torch.from_numpy(f0),
                                              ns, nf))
    timed = march_ops.march_periods(x, f, n, m, *args)
    before = march_ops.march_periods.launches
    out, prof = march_ops.march_periods_profile(x, f, n, m, *args)
    torch.cuda.synchronize()
    assert march_ops.march_periods.launches == before
    for a, b in zip(out, timed):
        assert torch.equal(a, b)
    bd = march_ops.profile_breakdown(prof)
    assert prof.shape == (len(ns), 8) and prof.dtype == torch.int64
    sums = sum(bd[name] for name in march_ops.PHASES)
    assert (bd["total"] > 0).all() and (sums <= bd["total"]).all()
    assert all((bd[name] >= 0).all() for name in march_ops.PHASES)
    # every row is a voiced step; a broken lane's last voiced step finds none
    counts = timed[4].cpu().numpy()
    assert ((bd["voiced_steps"] == counts) | (bd["voiced_steps"] == counts + 1)).all()
    if case == "jumps":
        assert (bd["unvoiced_steps"] >= 1).all()


def test_period_march_smem_plan_matches_the_kernel(cuda_device):
    """The wrapper's shared-memory count equals the kernel's own, and a plan
    that no block can hold raises before any launch."""
    import ctypes

    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops

    fn = _build.load("period_march").period_march_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for sr, srr, f0_min, hop in ((16000, 0.25, 40.0, 160), (16000, 0.5, 25.0, 80),
                                 (8000, 0.25, 40.0, 80), (48000, 0.25, 40.0, 480)):
        plan = march_ops.march_plan(sr, srr, f0_min, hop)
        assert fn(plan.ring, plan.chunk, plan.queue) == plan.smem_bytes
    x = torch.zeros(1, 4001, device=cuda_device)
    f = torch.full((1, 4), 100.0, device=cuda_device)
    n = torch.tensor([4001], dtype=torch.int32, device=cuda_device)
    m = torch.tensor([4], dtype=torch.int32, device=cuda_device)
    before = march_ops.march_periods.launches
    with pytest.raises(ValueError, match="shared memory"):
        march_ops.march_periods(x, f, n, m, 48000.0, 480, 0.25, 20.0, 250)
    assert march_ops.march_periods.launches == before


def test_resumed_train_state_on_card_takes_the_uninterrupted_step(cuda_device, tmp_path):
    """Two train steps on the card, a whole-state checkpoint, a restore into
    a fresh state, one more step on each: parameters, BatchNorm statistics
    and Adam's moments within 3e-7 (the card's run-to-run spread of a step:
    cuDNN's backward adds in varying orders), the same rate and step counts."""
    from robust_speech_analysis_framework_tpu_torch.train import checkpoints

    rng = np.random.default_rng(1)
    batches = [(rng.normal(size=(4, 64, 12)).astype(np.float32), np.array([64, 50, 33, 20]),
                rng.integers(0, 2, size=4)) for _ in range(3)]
    trainer = loops.Trainer(CNNLSTM(input_dim=12, cnn_out_channels=8, lstm_hidden_dim=8),
                            device=cuda_device)

    def step(state, i):
        x, lengths, y = batches[i]
        trainer.train_step(state, x, lengths, y, torch.Generator(device=cuda_device)
                           .manual_seed(i), dropout_rate=0.5)

    whole = trainer.init_state(seed=3, lr=1e-3)
    step(whole, 0)
    step(whole, 1)
    whole.lr = 1e-4  # as after a plateau decay
    checkpoints.save_train_state(str(tmp_path), whole, step=2)
    resumed = checkpoints.restore_train_state(str(tmp_path),
                                              trainer.init_state(seed=9, lr=0.5), step=2)
    step(whole, 2)
    step(resumed, 2)
    assert resumed.lr == whole.lr == 1e-4
    sa, sb = whole.model.state_dict(), resumed.model.state_dict()
    for key in sa:
        assert float((sa[key].double() - sb[key].double()).abs().max()) <= 3e-7, key
    oa, ob = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        assert float(oa[i]["step"]) == float(ob[i]["step"]) == 3.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert float((oa[i][key] - ob[i][key]).abs().max()) <= 3e-7, (i, key)


def test_opensmile_on_card_matches_cpu(cuda_device):
    """Two short speech-like files through the extractor on the card (K7 and
    the period march per sub-batch) and on the CPU, with the tolerance families of the JAX
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
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops

    before = viterbi.viterbi_path.launches, march_ops.march_periods.launches
    names, card = OpenSmileExtractor(device=cuda_device).extract_arrays(waves, verbose=False)
    # one K7 and one period march per sub-batch, here one per bucket
    assert (viterbi.viterbi_path.launches, march_ops.march_periods.launches) == (
        before[0] + 2, before[1] + 2)
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


W2V_SMALL = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                 conv_dim=(16,) * 7, pos_conv_kernel=16, pos_conv_groups=4)


def _cos(a, b) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_wav2vec2_extraction_on_card_matches_cpu(cuda_device):
    """The Wav2Vec2 extractor's paths on the card (the pinned, three-stream
    pipeline): float32 sequences vs the CPU to 1e-4; the resident buffer
    and its regrouping equal to the card's own downloads and their host
    concatenation, bit for bit; the transfer dtypes and bfloat16 within the
    JAX package's contracts of the card's float32 path; embeddings the
    per-file means to 1e-5."""
    from robust_speech_analysis_framework_tpu_torch.data.aggregate import participant_clips
    from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    rng = np.random.default_rng(0)
    waves = {f"c{i}.wav": (0.1 * rng.normal(size=int(s * 16000))).astype(np.float32)
             for i, s in enumerate([6.2, 4.0, 8.9, 1.1, 0.3, 12.0, 3.3])}
    with pytest.warns(UserWarning):
        cpu = Wav2Vec2Extractor(config=Wav2Vec2Config(**W2V_SMALL), allow_random_init=True,
                                batch_size=3, device="cpu")
    sd = cpu.model.state_dict()

    def card(**kw):
        return Wav2Vec2Extractor(params=sd, config=Wav2Vec2Config(**W2V_SMALL), batch_size=3,
                                 device=cuda_device, **kw)

    f32 = card().extract_sequences(waves, verbose=False)
    ref = cpu.extract_sequences(waves, verbose=False)
    assert list(f32) == list(ref) and "c4.wav" not in f32
    for name in ref:
        np.testing.assert_allclose(f32[name], ref[name], rtol=0, atol=1e-4)

    res = card().extract_sequences_resident(waves, verbose=False)
    assert res.x.is_cuda and res.x.shape[1] == -(-int(res.lengths.max()) // 128) * 128
    for name in f32:
        np.testing.assert_array_equal(res[name], f32[name])
    rows = [{"filename": n, "unique_participant_id": f"p{i % 3}"} for i, n in enumerate(waves)]
    grouped = res.regroup(participant_clips(rows))
    for pid, clips in participant_clips(rows).items():
        np.testing.assert_array_equal(grouped[pid], np.vstack([f32[c] for c in clips
                                                               if c in f32]))
    x = grouped.x.cpu().numpy()
    for i, n in enumerate(grouped.lengths):
        assert (x[i, n:] == 0).all()

    for transfer in (np.int16, "int24", np.int8, np.float16):
        got = card(sequence_transfer_dtype=transfer).extract_sequences(waves, verbose=False)
        for name, a in f32.items():
            b = got[name]
            fmax = np.abs(a).max(axis=1, keepdims=True)
            if transfer is np.int16:
                assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-4
                assert (np.abs(a - b) <= fmax * (1.0 / 65534.0 + 2e-6) + 1e-9).all()
            elif transfer == "int24":
                floor = 1e-3 * float(np.abs(a).max())
                assert np.max(np.abs(a - b) / np.maximum(np.abs(a), floor)) <= 1e-4
            elif transfer is np.int8:
                assert (np.abs(a - b) <= fmax / 254.0 + 1e-3 * fmax + 1e-7).all()
                assert _cos(a, b) > 0.9999
            else:
                assert 1.0 - _cos(a, b) <= 1e-2
    bf16 = card(compute_dtype="bfloat16").extract_sequences(waves, verbose=False)
    for name, a in f32.items():
        assert 1.0 - _cos(a, bf16[name]) <= 1e-2
    lattice = {"pcm.wav": (rng.integers(-20000, 20000, size=70000) / 32768.0).astype(np.float32)}
    np.testing.assert_array_equal(
        card(upload_dtype=np.int16).extract_sequences(lattice, verbose=False)["pcm.wav"],
        card().extract_sequences(lattice, verbose=False)["pcm.wav"])

    names, means = card().extract_embeddings_arrays(waves, verbose=False)
    assert names == list(f32)
    np.testing.assert_allclose(means, np.stack([f32[n].mean(0) for n in names]),
                               rtol=0, atol=1e-5)


CONV0_TOL = 1e-5  # of max |ref|: a 10-product conv in another order, exact float64 statistics


def _conv0_case(name):
    """(wav (B, L), weight (C, 1, 10), scale, bias, frames (B,) int32 or
    None): the extraction cell's batch and the kernel's edges."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    c = 512
    weight = rng.normal(size=(c, 1, 10)) / np.sqrt(10)
    if name == "cell":  # 16 chunks of 80,000 samples: ragged, one at min_samples, a padded row
        samples = np.array([80_000] * 9 + [8_000, 43_217, 79_999, 12_345, 65_536, 8_000, 8_000])
    elif name == "length-not-a-multiple-of-5":
        samples = np.array([20_003, 17_001, 9_999])
    elif name == "ragged-tile":  # T = 933 = 7 tiles of 128 frames and 37
        samples = np.array([5 * 932 + 13, 2_222, 4_000])
    elif name == "low-variance":  # a high-pass channel over smooth rows
        samples = np.array([32_000, 32_000, 20_000])
        weight[0, 0] = 0.0
        weight[0, 0, :2] = (0.3, -0.3)
    elif name == "edges":  # no valid frame, one frame, more frames than the row has
        samples = np.array([3, 10, 15, 40_000])
    elif name == "no-lengths":
        samples = None
    n = 48_000 if samples is None else int(samples.max())
    b = 4 if samples is None else len(samples)
    wav = 0.1 * rng.normal(size=(b, n))
    if name == "low-variance":
        t = np.arange(n) / 16_000
        wav[:] = 0.5 * np.sin(2 * np.pi * 100 * t) + 0.1
    frames = None
    if samples is not None:
        for i, m in enumerate(samples):
            wav[i, m:] = 0.0
        if name == "cell":
            wav[-1] = 0.0  # the batch's padded tail row
        frames = torch.from_numpy(((samples - 10) // 5 + 1).astype(np.int32))
        if name == "edges":
            frames[-1] = 10**6
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f32(wav), f32(weight), f32(1 + 0.2 * rng.normal(size=c)),
            f32(0.1 * rng.normal(size=c)), frames)


@pytest.mark.parametrize("case", ["cell", "length-not-a-multiple-of-5", "ragged-tile",
                                  "low-variance", "edges", "no-lengths"])
def test_conv0_kernel_matches_plain_version(cuda_device, case):
    """The first block's kernel against its plain version (cuDNN's conv and
    the masked norm chain) on the card, over the whole output."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    args = [None if a is None else a.to(cuda_device) for a in _conv0_case(case)]
    with torch.no_grad():
        ref = w2v_ops.conv0_norm_gelu_reference(*args, 1e-5)
        before = w2v_ops.conv0_norm_gelu.launches
        got = w2v_ops.conv0_norm_gelu(*args, 1e-5)
        torch.cuda.synchronize()
    assert w2v_ops.conv0_norm_gelu.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= CONV0_TOL * scale, (case, err, scale)
    again = w2v_ops.conv0_norm_gelu(*args, 1e-5)
    assert torch.equal(again, got)  # no atomics in any sum: the same bits every call


def test_conv0_kernel_counts_one_launch_a_call_and_rejects_what_it_does_not_take(cuda_device):
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    wav, weight, scale, bias, frames = (a.to(cuda_device) for a in _conv0_case("ragged-tile"))
    w2v_ops.conv0_norm_gelu.launches = 0
    with torch.no_grad():
        for _ in range(3):
            w2v_ops.conv0_norm_gelu(wav, weight, scale, bias, frames, 1e-5)
        empty = w2v_ops.conv0_norm_gelu(wav[:0], weight, scale, bias, frames[:0], 1e-5)
        assert empty.shape == (0, 512, 933)
        assert w2v_ops.conv0_norm_gelu.launches == 3
        with pytest.raises(ValueError, match="taps at stride"):
            w2v_ops.conv0_norm_gelu(wav, weight[:, :, :9], scale, bias, frames, 1e-5)
        with pytest.raises(TypeError, match="float32"):
            w2v_ops.conv0_norm_gelu(wav.double(), weight, scale, bias, frames, 1e-5)
    with pytest.raises(RuntimeError, match="no backward"):
        w2v_ops.conv0_norm_gelu(wav, weight.requires_grad_(), scale, bias, frames, 1e-5)
    # 4096 channels' records (256 KiB) do not fit a block's shared memory: the
    # .cu refuses before any launch and leaves no CUDA error behind
    wide = torch.ones((4096, 1, 10), device=cuda_device)
    with torch.no_grad(), pytest.raises(RuntimeError, match="cudaError"):
        w2v_ops.conv0_norm_gelu(wav, wide, wide[:, 0, 0], wide[:, 0, 0], frames, 1e-5)
    assert float(torch.ones(8, device=cuda_device).sum()) == 8.0
    torch.cuda.synchronize()
    assert w2v_ops.conv0_norm_gelu.launches == 3


def test_wav2vec2_model_on_card_matches_cpu_and_runs_the_conv0_kernel(cuda_device):
    """A Wav2Vec2 model with the base config's 512-channel feature encoder:
    hidden states on the card against the CPU on valid frames, one kernel
    call a forward."""
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import (
        Wav2Vec2Config,
        Wav2Vec2Model,
    )
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    torch.manual_seed(0)
    cfg = Wav2Vec2Config(**dict(W2V_SMALL, conv_dim=(512,) * 7))
    cpu = Wav2Vec2Model(cfg).eval()
    card = Wav2Vec2Model(cfg).to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    lengths = np.array([24_000, 8_000, 17_003], np.int32)
    wav = (0.1 * rng.normal(size=(3, 24_000))).astype(np.float32)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    before = w2v_ops.conv0_norm_gelu.launches
    with torch.no_grad():
        ref, ref_lens = cpu(torch.from_numpy(wav), torch.from_numpy(lengths))
        got, got_lens = card(torch.from_numpy(wav).to(cuda_device),
                             torch.from_numpy(lengths).to(cuda_device))
    assert w2v_ops.conv0_norm_gelu.launches == before + 1
    np.testing.assert_array_equal(got_lens.cpu().numpy(), ref_lens.numpy())
    for i, n in enumerate(ref_lens.tolist()):
        np.testing.assert_allclose(got[i, :n].cpu().numpy(), ref[i, :n].numpy(), rtol=0,
                                   atol=1e-4)


POS_CONV_TOL = 1e-5  # of max |ref|: 6,144 / 8,192 products an output in another order
POS_CONV_CASES = {  # B, T, C, groups, K, each row's valid frames (the rest zeroed) or None
    "w2v2-cell": (16, 249, 768, 16, 128, (249,) * 12 + (200, 97, 12, 0)),
    "wavlm-batch": (16, 799, 1024, 16, 128, (799,) * 12 + (649, 400, 150, 24)),
    "t1": (3, 1, 768, 16, 128, None),
    "t-below-64": (2, 37, 1024, 16, 128, (37, 20)),
    "t-not-a-tile": (3, 300, 768, 16, 128, None),
    "b1": (1, 249, 768, 16, 128, None),
    "small-groups": (2, 50, 32, 4, 16, None),
    "odd-k": (2, 70, 96, 2, 15, None),
    "k-not-a-multiple-of-4": (2, 70, 40, 1, 18, None),
}


def _pos_conv_case(name, device):
    """(x (B, T, C), weight (C, C/G, K), bias (C,), groups) on ``device``."""
    b, t, c, groups, k, frames = POS_CONV_CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.normal(size=(b, t, c))
    for i, n in enumerate(frames or ()):
        x[i, n:] = 0.0
    cg = c // groups
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return (f32(x), f32(rng.normal(size=(c, cg, k)) / np.sqrt(cg * k)),
            f32(0.1 * rng.normal(size=c)), groups)


@pytest.mark.parametrize("case", sorted(POS_CONV_CASES))
def test_pos_conv_kernel_matches_plain_version(cuda_device, case):
    """The positional conv's kernel against its plain version (cuDNN's
    grouped conv, the extra frame dropped, GELU) over the whole output."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    args = _pos_conv_case(case, cuda_device)
    with torch.no_grad():
        ref = w2v_ops.pos_conv_gelu_reference(*args)
        before = w2v_ops.pos_conv_gelu.launches
        got = w2v_ops.pos_conv_gelu(*args)
        torch.cuda.synchronize()
    assert w2v_ops.pos_conv_gelu.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.float32 and got.is_contiguous()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= POS_CONV_TOL * scale, (case, err, scale)
    again = w2v_ops.pos_conv_gelu(*args)
    assert torch.equal(again, got)  # no atomics, a fixed order of sums: the same bits every call


def test_pos_conv_kernel_counts_one_launch_a_call_and_rejects_what_it_does_not_take(cuda_device):
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    x, weight, bias, groups = _pos_conv_case("t-not-a-tile", cuda_device)
    w2v_ops.pos_conv_gelu.launches = 0
    with torch.no_grad():
        for _ in range(3):
            w2v_ops.pos_conv_gelu(x, weight, bias, groups)
        assert w2v_ops.pos_conv_gelu(x[:0], weight, bias, groups).shape == (0, 300, 768)
        assert w2v_ops.pos_conv_gelu(x[:, :0], weight, bias, groups).shape == (3, 0, 768)
        assert w2v_ops.pos_conv_gelu.launches == 3
        with pytest.raises(TypeError, match="float32"):
            w2v_ops.pos_conv_gelu(x.double(), weight, bias, groups)
        with pytest.raises(ValueError, match="contiguous"):
            w2v_ops.pos_conv_gelu(x.transpose(0, 1).contiguous().transpose(0, 1), weight, bias,
                                  groups)
        with pytest.raises(ValueError, match="groups of 8"):  # 9 channels a group
            w2v_ops.pos_conv_gelu(x[:, :, :144], weight[:144, :9], bias[:144], groups)
        with pytest.raises(ValueError, match="groups of 8"):  # 72 channels a group
            w2v_ops.pos_conv_gelu(x[:, :, :144].contiguous(), torch.zeros(144, 72, 128,
                                  device=cuda_device), bias[:144], 2)
    with pytest.raises(RuntimeError, match="no backward"):
        w2v_ops.pos_conv_gelu(x, weight.requires_grad_(), bias, groups)
    assert float(torch.ones(8, device=cuda_device).sum()) == 8.0
    torch.cuda.synchronize()
    assert w2v_ops.pos_conv_gelu.launches == 3


def test_pos_conv_smem_plan_matches_the_kernel(cuda_device):
    """The wrapper's shared-memory sizes, which its tile plan reads, are the
    .cu file's own."""
    import ctypes

    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    fn = _build.load("pos_conv").pos_conv_gelu_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    for cg in (8, 48, 64):
        for kp in (16, 128):
            for tile in w2v_ops.POS_TILES:
                assert fn(cg, kp, tile) == w2v_ops.pos_conv_smem_bytes(cg, kp, tile)


@pytest.mark.parametrize("encoder", ["wav2vec2", "wavlm"])
def test_encoder_on_card_matches_cpu_and_runs_the_pos_conv_kernel(cuda_device, encoder):
    """Two layers of each encoder at its published width (Wav2Vec2-base's
    768 channels in groups of 48, WavLM-Large's 1024 in groups of 64):
    hidden states on the card against the CPU on valid frames, one
    positional-conv launch a forward."""
    from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import (
        Wav2Vec2Config,
        Wav2Vec2Model,
    )
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    if encoder == "wav2vec2":
        cpu = Wav2Vec2Model(Wav2Vec2Config(num_layers=2))
    else:
        cpu = WavLMModel(WavLMConfig(num_layers=2))
    init_weights_(cpu, torch.Generator().manual_seed(1))
    cpu = cpu.eval()
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(8)
    lengths = np.array([24_000, 8_000, 17_003], np.int32)
    wav = (0.1 * rng.normal(size=(3, 24_000))).astype(np.float32)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    before = w2v_ops.pos_conv_gelu.launches
    with torch.no_grad():
        ref, ref_lens = cpu(torch.from_numpy(wav), torch.from_numpy(lengths))
        got, got_lens = card(torch.from_numpy(wav).to(cuda_device),
                             torch.from_numpy(lengths).to(cuda_device))
    assert w2v_ops.pos_conv_gelu.launches == before + 1
    np.testing.assert_array_equal(got_lens.cpu().numpy(), ref_lens.numpy())
    for i, n in enumerate(ref_lens.tolist()):
        np.testing.assert_allclose(got[i, :n].cpu().numpy(), ref[i, :n].numpy(), rtol=0,
                                   atol=1e-4)


FEAT_CONV_TOL = 1e-5  # of max |ref|: 1,024 / 1,536 products an output in another order
FEAT_CONV_CASES = {  # B, T_in, C_in, C_out, K, stride, GELU, bias
    "w2v2-conv1": (16, 15_999, 512, 512, 3, 2, True, False),
    "wavlm-conv5": (16, 3_199, 512, 512, 2, 2, False, False),
    "wavlm-conv2-bias": (16, 25_599, 512, 512, 3, 2, False, True),
    "b1-conv1": (1, 15_999, 512, 512, 3, 2, True, False),
    "b1-conv6-bias": (1, 499, 512, 512, 2, 2, True, True),
    "odd-t-out": (3, 2_000, 512, 512, 3, 2, True, True),  # 999 frames: no tile's multiple
    "one-frame": (2, 3, 512, 512, 3, 2, False, True),
    "narrow": (3, 301, 16, 64, 3, 2, True, True),  # C_in 16: one stage a tap
    "odd-widths": (2, 401, 20, 72, 3, 2, True, True),  # K C_in 60, C_out 72: masked tails
}


def _feat_conv_case(name, device):
    """(x (B, T, C_in), weight (C_out, C_in, K), bias or None, stride, gelu) on ``device``."""
    b, t, c_in, c_out, k, stride, gelu, with_bias = FEAT_CONV_CASES[name]
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(name.encode()))
    x = torch.randn((b, t, c_in), device=device, generator=gen)
    weight = torch.randn((c_out, c_in, k), device=device, generator=gen) / float(np.sqrt(c_in * k))
    bias = 0.1 * torch.randn(c_out, device=device, generator=gen) if with_bias else None
    return x, weight, bias, stride, gelu


@pytest.mark.parametrize("case", sorted(FEAT_CONV_CASES))
def test_feature_conv_kernel_matches_plain_version(cuda_device, case):
    """The strided convs' kernel against its plain version (cuDNN's conv on
    the (B, C, T) view, GELU) over the whole output, one launch a call, two
    calls bit-equal; at the plan the wrapper picks and at every other tile
    and a split of the reduction."""
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    x, weight, bias, stride, gelu = _feat_conv_case(case, cuda_device)
    with torch.no_grad():
        ref = w2v_ops.feature_conv_reference(x, weight, bias, stride, gelu)
        before = w2v_ops.feature_conv.launches
        got = w2v_ops.feature_conv(x, weight, bias, stride, gelu)
        torch.cuda.synchronize()
        assert w2v_ops.feature_conv.launches == before + 1
        assert got.shape == ref.shape and got.dtype == torch.float32 and got.is_contiguous()
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= FEAT_CONV_TOL * scale, case
        assert torch.equal(w2v_ops.feature_conv(x, weight, bias, stride, gelu), got)
        wt = w2v_ops._feature_conv_weights(weight)
        for tile in w2v_ops.FEAT_TILES:
            for splits in (1, 2):
                out = torch.empty_like(got)
                w2v_ops._launch_feature_conv(x, wt, bias, out, stride, (*tile, splits), gelu)
                err = float((out - ref).abs().max())
                assert err <= FEAT_CONV_TOL * scale, (case, tile, splits, err)


def test_feature_conv_kernel_counts_one_launch_a_call_and_rejects_what_it_does_not_take(
        cuda_device):
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    x, weight, bias, stride, gelu = _feat_conv_case("narrow", cuda_device)
    w2v_ops.feature_conv.launches = 0
    with torch.no_grad():
        for _ in range(3):
            w2v_ops.feature_conv(x, weight, bias, stride, gelu)
        assert w2v_ops.feature_conv(x[:0], weight, bias, stride, gelu).shape == (0, 150, 64)
        assert w2v_ops.feature_conv.launches == 3
        # a transposed view is read once made contiguous
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        assert torch.equal(w2v_ops.feature_conv(xt, weight, bias, stride, gelu),
                           w2v_ops.feature_conv(x, weight, bias, stride, gelu))
        with pytest.raises(TypeError, match="float32"):
            w2v_ops.feature_conv(x.double(), weight, bias, stride, gelu)
        with pytest.raises(ValueError, match="multiples of 4"):  # 6 input channels
            w2v_ops.feature_conv(x[:, :, :6], weight[:, :6], bias, stride, gelu)
        with pytest.raises(ValueError, match="multiples of 4"):  # 90 output channels
            w2v_ops.feature_conv(x, torch.zeros(90, 16, 3, device=cuda_device), None, 2, gelu)
        with pytest.raises(ValueError, match="16-byte aligned"):
            _misaligned(w2v_ops, x, weight)
    with pytest.raises(RuntimeError, match="no backward"):
        w2v_ops.feature_conv(x, weight.requires_grad_(), bias, stride, gelu)
    assert float(torch.ones(8, device=cuda_device).sum()) == 8.0
    torch.cuda.synchronize()
    assert w2v_ops.feature_conv.launches == 5


def _misaligned(w2v_ops, x, weight):
    """x one float past a 16-byte boundary: the kernel's 16-byte copies refuse it."""
    flat = torch.empty(x.numel() + 1, device=x.device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    return w2v_ops.feature_conv(shifted, weight, None, 2, True)


def test_feature_conv_smem_plan_matches_the_kernel(cuda_device):
    """The wrapper's shared-memory sizes, which its plan reads, are the .cu
    file's own, and the file builds no tile the plan does not know."""
    import ctypes

    from robust_speech_analysis_framework_tpu_torch.ops.cuda import _build
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    fn = _build.load("feature_conv").feature_conv_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    for bm, bn in w2v_ops.FEAT_TILES:
        assert fn(bm, bn) == w2v_ops.feature_conv_smem_bytes(bm, bn)
    assert fn(32, 64) == 0 and fn(128, 64) == 0


@pytest.mark.parametrize("encoder", ["wav2vec2", "wavlm"])
def test_encoder_on_card_matches_cpu_and_runs_the_feature_conv_kernel_six_times(cuda_device,
                                                                                encoder):
    """Each encoder's conv stack at its published widths (512 channels, K =
    3, 3, 3, 3, 2, 2 at stride 2): hidden states on the card against the CPU
    on valid frames, six strided-conv launches a forward, and the feature
    encoder's output contiguous (B, T, C)."""
    from robust_speech_analysis_framework_tpu_torch.models.init import init_weights_
    from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import (
        Wav2Vec2Config,
        Wav2Vec2Model,
    )
    from robust_speech_analysis_framework_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from robust_speech_analysis_framework_tpu_torch.ops.cuda import wav2vec2 as w2v_ops

    if encoder == "wav2vec2":
        cpu = Wav2Vec2Model(Wav2Vec2Config(num_layers=1))
    else:
        cpu = WavLMModel(WavLMConfig(num_layers=1))
    init_weights_(cpu, torch.Generator().manual_seed(3))
    cpu = cpu.eval()
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(9)
    lengths = np.array([32_000, 9_000, 20_003], np.int32)
    wav = (0.1 * rng.normal(size=(3, 32_000))).astype(np.float32)
    for i, n in enumerate(lengths):
        wav[i, n:] = 0.0
    before = w2v_ops.feature_conv.launches
    with torch.no_grad():
        feats, _ = card.feature_encoder(torch.from_numpy(wav).to(cuda_device),
                                        torch.from_numpy(lengths).to(cuda_device))
        assert feats.is_contiguous() and feats.shape[2] == 512
        ref, ref_lens = cpu(torch.from_numpy(wav), torch.from_numpy(lengths))
        got, got_lens = card(torch.from_numpy(wav).to(cuda_device),
                             torch.from_numpy(lengths).to(cuda_device))
    assert w2v_ops.feature_conv.launches == before + 12
    np.testing.assert_array_equal(got_lens.cpu().numpy(), ref_lens.numpy())
    for i, n in enumerate(ref_lens.tolist()):
        np.testing.assert_allclose(got[i, :n].cpu().numpy(), ref[i, :n].numpy(), rtol=0,
                                   atol=1e-4)
