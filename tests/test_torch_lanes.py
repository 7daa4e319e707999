"""The port's lane-stacked model and lane trainer against its own sequential
ones, on the CPU: ``CNNLSTMLanes`` vs ``CNNLSTM``, ``LaneAdam`` vs
``torch.optim.Adam``, ``train_trials_device`` vs ``train_model`` and
``_inner_cv_scores_batch`` vs ``_inner_cv_score``, each lane against the
sequential run of its trial, with dropout ON (the lanes draw the sequential
model's uniforms from the same generator); and the nested engine's choice
of schedule. Against the JAX package: ``tests/test_torch_trials.py``.

Small widths: input 10, cnn 8, lstm 8, 2 layers, 3 lanes, 12 sequences of
16–39 frames. Tolerances:

* logits atol 1e-6, gradients rtol 1e-5 of each tensor's largest element:
  the lanes' grouped convs, batched matmuls and per-lane products add in
  other orders. The six parameters whose true gradient is zero (a conv bias
  before a train-mode BatchNorm, the attention score bias) carry rounding
  noise of ~1e-9 on both sides and are held to atol 1e-7 instead.
* ``LaneAdam``: bit-equal to ``torch.optim.Adam`` at each lane's rate.
* ``train_trials_device``: histories rtol 1e-5 and of equal lengths, final
  parameters atol 1e-5, rates equal; inner-CV scores atol 1e-6 (macro-F1 of
  the same predictions). Trainers take ``adam_eps=1e-5`` so
  that the zero-gradient parameters' noise moves nothing (see
  ``tests/test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.models import cnn_lstm as port_model
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM, CNNLSTMLanes
from robust_speech_analysis_framework_tpu_torch.models.init import init_training_weights_
from robust_speech_analysis_framework_tpu_torch.train import loops
from tests.test_torch_dl_cv import SPACE, _participants
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

DIMS = dict(input_dim=10, cnn_out_channels=8, lstm_hidden_dim=8)
LOGIT_ATOL = 1e-6
GRAD_RTOL = 1e-5
NOISE_ATOL = 1e-7
HIST_RTOL = 1e-5
PARAM_ATOL = 1e-5
ADAM_EPS = 1e-5
ZERO_GRAD = ("res_block1.conv1.bias", "res_block1.conv2.bias", "res_block1.shortcut.0.bias",
             "res_block2.conv1.bias", "res_block2.conv2.bias",
             "attention_pooling.attention_weights.bias")
RATES = (0.2, 0.35, 0.5)
HP = {"cnn_out_channels": 8, "lstm_hidden_dim": 8, "activation_fn": "silu"}
SCORE_ATOL = 1e-6


def _models(n: int = 3):
    return [init_training_weights_(CNNLSTM(**DIMS), torch.Generator().manual_seed(i))
            for i in range(n)]


def _stacked(models) -> CNNLSTMLanes:
    """Lanes holding each model's own weights."""
    lanes = CNNLSTMLanes.from_state_dict(models[0].state_dict(), len(models))
    with torch.no_grad():
        for name, v in lanes.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                v.copy_(torch.stack([m.state_dict()[name] for m in models]).reshape(v.shape))
    return lanes


def _batch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 40, 10)).astype(np.float32))
    return x, torch.tensor([40, 33, 17, 25])


def _corpus(seed: int = 3, n: int = 12):
    rng = np.random.default_rng(seed)
    seqs = [rng.normal(size=(int(rng.integers(16, 40)), 10)).astype(np.float32) for _ in range(n)]
    labels = np.arange(n) % 2
    for s, y in zip(seqs, labels):
        s[:, :3] += 0.8 * y
    return seqs, labels


# --- the lane-stacked model ------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("masked", [True, False], ids=["lengths", "no_lengths"])
def test_lanes_forward_matches_cnnlstm(train, masked):
    models = _models()
    lanes = _stacked(models).train(train)
    x, lengths = _batch()
    lengths = lengths if masked else None
    rates = torch.tensor(RATES, dtype=torch.float64)
    with torch.no_grad():
        out = lanes(x, lengths, rates, torch.Generator().manual_seed(5))
        assert out.shape == (3, 4, 2)
        for i, m in enumerate(models):
            ref = m.train(train)(x, lengths, RATES[i], torch.Generator().manual_seed(5))
            torch.testing.assert_close(out[i], ref, rtol=0, atol=LOGIT_ATOL)


def test_lanes_gradients_and_batchnorm_statistics_match_cnnlstm():
    models = _models()
    lanes = _stacked(models).train()
    x, lengths = _batch()
    rates = torch.tensor(RATES, dtype=torch.float64)
    lanes(x, lengths, rates, torch.Generator().manual_seed(5)).square().sum().backward()
    for i, m in enumerate(models):
        m.train()(x, lengths, RATES[i], torch.Generator().manual_seed(5)).square().sum().backward()
    for name, p in lanes.named_parameters():
        grads = p.grad.reshape(3, -1)
        for i, m in enumerate(models):
            ref = m.get_parameter(name).grad.reshape(-1)
            if name in ZERO_GRAD:
                torch.testing.assert_close(grads[i], ref, rtol=0, atol=NOISE_ATOL)
            else:
                torch.testing.assert_close(grads[i], ref, rtol=0,
                                           atol=GRAD_RTOL * float(ref.abs().max()))
    for i, m in enumerate(models):
        lane = lanes.lane_state_dict(i)
        for name, v in m.state_dict().items():
            if "running" in name:
                torch.testing.assert_close(lane[name], v, rtol=0, atol=LOGIT_ATOL)


def test_lane_state_dict_round_trip_and_replication():
    models = _models()
    lanes = _stacked(models)
    for i, m in enumerate(models):
        sd = lanes.lane_state_dict(i)
        assert sd.keys() == m.state_dict().keys()
        for name, v in m.state_dict().items():
            assert torch.equal(sd[name], v), name
        assert torch.equal(lanes.lane_model(i).fc.weight, m.fc.weight)
    one = CNNLSTMLanes.from_state_dict(models[1].state_dict(), 2, dropout_rate=0.3)
    assert one.architecture() == dict(DIMS, num_classes=2, lstm_layers=2, dropout_rate=0.3,
                                      activation_fn="silu")
    assert one.res_block1.conv1.weight.shape == (2, 8, 10, 3)
    assert one.res_block1.bn1.running_mean.shape == (16,)
    for i in range(2):
        for name, v in models[1].state_dict().items():
            assert torch.equal(one.lane_state_dict(i)[name], v), name


def test_replicated_lanes_keep_the_residual_blocks_dropout():
    template = CNNLSTM(**DIMS, dropout_rate=0.0)
    template.res_block1.dropout = template.res_block2.dropout = 0.0
    start = loops.Trainer(template, device="cpu").init_state(0, 1e-3)
    state = loops.LaneTrainState.replicate(start, torch.tensor([1e-3, 2e-3], dtype=torch.float64))
    lane = state.lane_state(1).model
    assert state.model.res_block1.dropout == state.model.res_block2.dropout == 0.0
    assert lane.res_block1.dropout == lane.res_block2.dropout == 0.0 and lane.dropout_rate == 0.0
    x, lengths = _batch()
    state.model.train()
    out = state.model(x, lengths, torch.zeros(2, dtype=torch.float64))
    torch.testing.assert_close(out[0], start.model.train()(x, lengths), rtol=0, atol=LOGIT_ATOL)


def test_lane_step_runs_each_layer_once_for_all_lanes(monkeypatch):
    """K5 with a gradient, K1 without: one call a biLSTM layer at G = 2K."""
    calls = []
    for name in ("lstm_scan_grouped", "lstm_recurrence_grouped"):
        real = getattr(port_model, name)
        monkeypatch.setattr(port_model, name, lambda gates, wh, _n=name, _f=real: (
            calls.append((_n, gates.shape[1], wh.shape[0])) or _f(gates, wh)))
    lanes = _stacked(_models())
    x, lengths = _batch()
    lanes.train()(x, lengths, torch.tensor(RATES, dtype=torch.float64)).sum().backward()
    assert calls == [("lstm_recurrence_grouped", 6, 6)] * 2
    calls.clear()
    with torch.no_grad():
        lanes.eval()(x, lengths)
    assert calls == [("lstm_scan_grouped", 6, 6)] * 2


def test_dropout_lanes_thresholds_one_draw_at_each_rate():
    x = torch.ones(2000, 3, 5)
    out = port_model.dropout_lanes(x, torch.tensor([0.0, 0.25, 0.5], dtype=torch.float64), 1,
                                   torch.Generator().manual_seed(0))
    u = torch.rand(2000, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out[:, 0], x[:, 0])  # rate 0 keeps all, the draw is made anyway
    assert torch.equal(out[:, 1], torch.where(u >= 0.25, 1 / 0.75, 0.0))
    assert torch.equal(out[:, 2], torch.where(u >= 0.5, 2.0, 0.0))
    assert port_model.dropout_lanes(x, 0.0, 1, None) is x


# --- the lane optimizer and state ------------------------------------------------------


def test_lane_adam_matches_torch_adam_bit_for_bit():
    """3 steps of 3 lanes at 3 rates from one start, the gradients of each
    lane's own loss; then lane_state carries the moments and step count."""
    lrs = [1e-3, 4e-3, 2.5e-2]
    trainer = loops.Trainer(CNNLSTM(**DIMS), device="cpu")
    start = trainer.init_state(0, lrs[0])
    state = loops.LaneTrainState.replicate(start, torch.tensor(lrs, dtype=torch.float64))
    seqs = [trainer.init_state(0, lr) for lr in lrs]
    x, lengths = _batch()
    labels = torch.tensor([0, 1, 1, 0])
    for step in range(3):
        xs = x + 0.1 * step
        state.optimizer.zero_grad()
        logits = state.model.train()(xs, lengths, 0.0)
        loops._lane_cross_entropy(logits, labels).sum().backward()
        state.optimizer.step(state.lr)
        for i, s in enumerate(seqs):
            s.optimizer.zero_grad()
            # the lane's own gradient, so only Adam's arithmetic is compared
            for name, p in s.model.named_parameters():
                if p.requires_grad:
                    lane_grad = state.model.get_parameter(name).grad.reshape(3, -1)[i]
                    p.grad = lane_grad.reshape(p.shape).clone()
            for group in s.optimizer.param_groups:
                group["lr"] = s.lr
            s.optimizer.step()
    assert state.optimizer.steps == [3, 3, 3]
    for i, s in enumerate(seqs):
        lane = state.lane_state(i)
        assert lane.lr == lrs[i]
        named = dict(lane.model.named_parameters())
        for name, p in s.model.named_parameters():
            assert torch.equal(named[name], p), name
            if p.requires_grad:
                mine, ref = lane.optimizer.state[named[name]], s.optimizer.state[p]
                assert float(mine["step"]) == float(ref["step"]) == 3.0
                assert torch.equal(mine["exp_avg"], ref["exp_avg"]), name
                assert torch.equal(mine["exp_avg_sq"], ref["exp_avg_sq"]), name
            else:  # bias_hh: folded into bias_ih, zero and frozen
                assert name.split(".")[-1].startswith("bias_hh") and not p.any()


# --- train_trials_device vs train_model --------------------------------------------------


CASES = {
    # the inner-CV trial: fixed epochs, final weights
    "fixed": dict(epochs=3, patience=4, use_plateau=False, restore_best=False),
    # plateau decay after every flat epoch, early stop at patience 2, restore
    "plateau-restore": dict(epochs=6, patience=2, plateau_patience=0),
    # the same without restore: a stopped lane keeps the state it stopped in
    "plateau-stop": dict(epochs=6, patience=2, plateau_patience=0, restore_best=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_trials_device_lane_matches_train_model(case):
    seqs, labels = _corpus()
    trainer = loops.Trainer(CNNLSTM(**DIMS), adam_eps=ADAM_EPS, device="cpu")
    lrs, rates = [4e-3, 1e-3, 2e-3], [0.2, 0.4, 0.3]
    cfg = loops.TrainConfig(learning_rate=lrs[0], batch_size=4, seed=2, dropout_rate=rates[0],
                            **CASES[case])
    # labels against the signal: the val loss rises as a lane learns, and the
    # lanes stop after 4, 3 and 3 epochs (each decision by a relative margin
    # of 2.8e-4 or more)
    val_labels = labels[8:] if case == "fixed" else 1 - labels[8:]
    split = (seqs[:8], labels[:8], seqs[8:], val_labels)
    states, hist = loops.train_trials_device(trainer, *split, cfg, lrs, rates)
    hists = hist.result()
    assert states.lr.shape == (3,) and len(hists) == 3
    lengths = []
    for i in range(3):
        cfg_i = dataclasses.replace(cfg, learning_rate=lrs[i], dropout_rate=rates[i])
        ref, th, vh = loops.train_model(trainer, *split, cfg_i)
        lengths.append(len(th))
        assert len(hists[i][0]) == len(hists[i][1]) == len(th)
        np.testing.assert_allclose(hists[i][0], th, rtol=HIST_RTOL)
        np.testing.assert_allclose(hists[i][1], vh, rtol=HIST_RTOL)
        lane = states.lane_state(i)
        assert lane.lr == pytest.approx(ref.lr, rel=1e-12)
        for name, v in ref.model.state_dict().items():
            if "num_batches" not in name:
                torch.testing.assert_close(lane.model.state_dict()[name], v, rtol=0,
                                           atol=PARAM_ATOL)
    if case != "fixed":
        assert len(set(lengths)) > 1  # lanes stopped at different epochs


def test_train_trials_device_rejects_bad_arguments():
    seqs, labels = _corpus()
    trainer = loops.Trainer(CNNLSTM(**DIMS), device="cpu")
    split = (seqs[:8], labels[:8], seqs[8:], labels[8:])
    cfg = loops.TrainConfig(epochs=1, batch_size=4, dropout_rate=0.2)
    with pytest.raises(ValueError, match="align"):
        loops.train_trials_device(trainer, *split, cfg, [1e-3, 2e-3], [0.2])
    with pytest.raises(ValueError, match="dropout_rate"):
        loops.train_trials_device(trainer, *split, dataclasses.replace(cfg, dropout_rate=None),
                                  [1e-3], [0.2])


def test_train_trials_device_remat_matches_plain():
    seqs, labels = _corpus()
    trainer = loops.Trainer(CNNLSTM(**DIMS), device="cpu")
    split = (seqs[:8], labels[:8], seqs[8:], labels[8:])
    cfg = loops.TrainConfig(epochs=2, batch_size=4, seed=3, dropout_rate=0.3)
    out = [loops.train_trials_device(trainer, *split, dataclasses.replace(cfg, remat=r),
                                     [1e-3, 3e-3], [0.3, 0.45]) for r in (False, True)]
    assert out[0][1].result() == out[1][1].result()
    for a, b in zip(out[0][0].model.state_dict().values(), out[1][0].model.state_dict().values()):
        assert torch.equal(a, b)


def test_eval_logits_trials_equal_each_lane_eval():
    seqs, labels = _corpus()
    trainer = loops.Trainer(CNNLSTM(**DIMS), device="cpu")
    cfg = loops.TrainConfig(epochs=1, batch_size=4, seed=1, dropout_rate=0.3)
    states, _ = loops.train_trials_device(trainer, seqs[:8], labels[:8], seqs[8:], labels[8:],
                                          cfg, [1e-3, 3e-3], [0.3, 0.4])
    corpus = loops.DeviceCorpus(seqs, device="cpu")
    for sequences in (seqs[5:], corpus.view(np.arange(5, 12))):
        logits = trainer.eval_logits_trials_deferred(states, sequences, cfg).result()
        assert logits.shape == (2, 7, 2)
        for i in range(2):
            ref = trainer.eval_logits(states.lane_state(i), sequences, cfg)
            np.testing.assert_allclose(logits[i], ref, rtol=0, atol=LOGIT_ATOL)


# --- the CV engine's rounds ---------------------------------------------------------------


PLIST = [{"learning_rate": 1e-3, "dropout_rate": 0.2, **HP},
         {"learning_rate": 3e-3, "dropout_rate": 0.3, **HP},
         {"learning_rate": 5e-3, "dropout_rate": 0.25, **HP},
         # another architecture: a group of its own
         {"learning_rate": 2e-3, "dropout_rate": 0.4, **HP, "activation_fn": "gelu"}]


def test_inner_cv_scores_batch_matches_sequential_with_dropout():
    X, y = _corpus(1)
    cache = dl_cv._TrainerCache(input_dim=10, device="cpu")
    calls = []
    real = dl_cv.train_trials_device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dl_cv, "train_trials_device",
                   lambda *a, **k: calls.append(len(a[6])) or real(*a, **k))
        batched = dl_cv._inner_cv_scores_batch(cache, PLIST, X, y, 2, 2, 4, 42)
    assert calls == [3, 3, 1, 1]  # two architectures × two inner folds
    sequential = [dl_cv._inner_cv_score(cache, p, X, y, 2, 2, 4, 42) for p in PLIST]
    np.testing.assert_allclose(batched, sequential, atol=SCORE_ATOL)


def test_trial_batch_over_budget_takes_the_sequential_schedule(monkeypatch):
    """A corpus that is neither resident nor within the device-fold budget
    is searched trial by trial, as the JAX package's ``use_batched`` rule
    says: the same study as ``trial_batch=1``."""
    seqs, meta = _participants()
    monkeypatch.setenv("RSAF_CORPUS_BUDGET_BYTES", "1")
    monkeypatch.setattr(dl_cv, "TrainConfig",
                        lambda **kw: loops.TrainConfig(device_fold_budget_bytes=1, **kw))

    def no_lanes(*args, **kwargs):
        raise AssertionError("an over-budget corpus went to train_trials_device")

    monkeypatch.setattr(dl_cv, "train_trials_device", no_lanes)
    kw = dict(n_splits_outer=2, n_splits_inner=2, n_trials=3, epochs=1, patience=3,
              batch_size=4, inner_epochs=1, search_space=SPACE, trial_batch=4)
    batched = dl_cv.run_dl_nested_cv(seqs, meta, device="cpu", **kw)
    sequential = dl_cv.run_dl_nested_cv(seqs, meta, device="cpu", **dict(kw, trial_batch=1))
    assert list(batched[0]["best_params"]) == list(sequential[0]["best_params"])
    for a, b in zip(batched[1], sequential[1]):
        np.testing.assert_array_equal(a["y_prob"], b["y_prob"])
