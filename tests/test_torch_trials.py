"""The port's lane-batched trials vs the JAX package's, on the CPU:
``train_trials_device``, ``eval_logits_trials_deferred``,
``_inner_cv_scores_batch`` and ``nested_cv``/``run_dl_nested_cv`` with
``trial_batch`` > 1.

12–20 synthetic sequences of 16–39 frames, input 10, cnn 8, lstm 8. Both
sides start from the same weights with dropout off and ``adam_eps=1e-5``
(``tests/test_torch_dl_cv.py``'s ``same_start``). The port against its own
sequential schedule, with dropout on, is ``tests/test_torch_lanes.py``.

Tolerances: histories rtol 1e-4 (the JAX package's own lane test holds
3e-4), final parameters atol 1e-4, logits atol 1e-5, inner-CV scores atol
1e-6 (macro-F1 of the same predictions: equal), ``y_prob`` atol 1e-4,
``best_params`` equal.
"""

import numpy as np
import pytest

import jax
import torch

from robust_speech_analysis_framework_tpu.eval import dl_cv as jax_dl_cv
from robust_speech_analysis_framework_tpu.ops.framing import collect as jax_collect
from robust_speech_analysis_framework_tpu.train import checkpoints as jax_ckpt
from robust_speech_analysis_framework_tpu.train import loops as jax_loops
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTMLanes
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_flat_from_state_dict,
    cnn_lstm_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.train import loops
from tests.test_torch_dl_cv import (  # noqa: F401  (same_start: a fixture)
    SPACE,
    _participants,
    same_start,
    same_start_patches,
)
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

HIST_RTOL = 1e-4
PARAM_ATOL = 1e-4
LOGIT_ATOL = 1e-5
SCORE_ATOL = 1e-6
PROB_ATOL = 1e-4
HP = {"cnn_out_channels": 8, "lstm_hidden_dim": 8, "activation_fn": "silu"}
LRS = [1e-3, 5e-3, 3e-3]


def _data(seed: int = 3, n: int = 12):
    rng = np.random.default_rng(seed)
    X = [rng.normal(size=(int(rng.integers(16, 40)), 10)).astype(np.float32) for _ in range(n)]
    return X, np.array([0, 1] * (n // 2))


def _cfg(module, lr: float, **kw):
    return module.TrainConfig(learning_rate=lr, epochs=3, patience=4, batch_size=4, seed=7,
                              dropout_rate=0.0, use_plateau=False, restore_best=False, **kw)


def _jax_lane_flat(jstates, i: int) -> dict:
    lane = jax.tree.map(lambda a: np.asarray(a)[i],
                        {"params": jstates.params, "batch_stats": jstates.batch_stats})
    return jax_ckpt.flatten_params(lane)


@pytest.fixture(scope="module")
def both_lanes():
    """One train_trials_device call of three lanes on each side, from the
    same start, without dropout."""
    X, y = _data()
    split = (X[:8], y[:8], X[8:], y[8:])
    with same_start_patches():
        trainer = dl_cv._TrainerCache(input_dim=10, device="cpu").get(HP)
        jtrainer = jax_dl_cv._TrainerCache(input_dim=10).get(HP)
        states, hist = loops.train_trials_device(trainer, *split, _cfg(loops, LRS[0]),
                                                 LRS, [0.0] * 3)
        jstates, jhist = jax_loops.train_trials_device(jtrainer, *split, _cfg(jax_loops, LRS[0]),
                                                       LRS, [0.0] * 3)
        jhist = jax_collect([jhist])[0]
    return dict(X=X, trainer=trainer, jtrainer=jtrainer, states=states, hist=hist.result(),
                jstates=jstates, jhist=jhist)


def test_train_trials_device_matches_jax(both_lanes):
    states, jstates = both_lanes["states"], both_lanes["jstates"]
    assert states.lr.shape == jstates.lr.shape == (3,)
    np.testing.assert_allclose(states.lr.numpy(), np.asarray(jstates.lr), rtol=1e-6)
    for (th, vh), (jth, jvh) in zip(both_lanes["hist"], both_lanes["jhist"]):
        assert len(th) == len(jth) == 3
        np.testing.assert_allclose(th, jth, rtol=HIST_RTOL)
        np.testing.assert_allclose(vh, jvh, rtol=HIST_RTOL)
    for i in range(3):
        mine = cnn_lstm_flat_from_state_dict(states.model.lane_state_dict(i))
        ref = _jax_lane_flat(jstates, i)
        assert mine.keys() == ref.keys()
        for key, v in ref.items():
            np.testing.assert_allclose(mine[key], v, rtol=0, atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("resident", [False, True], ids=["list", "seqview"])
def test_eval_logits_trials_matches_jax(both_lanes, resident):
    """Both sides score the JAX lanes' weights, over a host list
    (length-sorted padded batches) and over a resident corpus's view."""
    X, jstates = both_lanes["X"], both_lanes["jstates"]
    lanes = CNNLSTMLanes.from_state_dict(
        cnn_lstm_state_dict_from_flat(_jax_lane_flat(jstates, 0)), 3)
    for name, v in lanes.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            v.copy_(torch.stack([cnn_lstm_state_dict_from_flat(_jax_lane_flat(jstates, i))[name]
                                 for i in range(3)]).reshape(v.shape))
    states = loops.LaneTrainState(model=lanes, optimizer=None, lr=torch.tensor(LRS))
    cfg, jcfg = _cfg(loops, LRS[0]), _cfg(jax_loops, LRS[0])
    seqs, jseqs = X[3:], X[3:]
    if resident:
        seqs = loops.DeviceCorpus(X, device="cpu").view(np.arange(3, 12))
        jseqs = jax_loops.DeviceCorpus(X).view(np.arange(3, 12))
    logits = both_lanes["trainer"].eval_logits_trials_deferred(states, seqs, cfg).result()
    jlogits = jax_collect([both_lanes["jtrainer"].eval_logits_trials_deferred(
        jstates, jseqs, jcfg)])[0]
    assert logits.shape == jlogits.shape == (3, 9, 2)
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=LOGIT_ATOL)


PLIST = [{"learning_rate": 1e-3, "dropout_rate": 0.0, **HP},
         {"learning_rate": 3e-3, "dropout_rate": 0.0, **HP},
         {"learning_rate": 5e-3, "dropout_rate": 0.0, **HP}]


def test_inner_cv_scores_batch_matches_jax(same_start):
    """Over resident corpora (one compiled JAX program serves both inner
    folds), one architecture."""
    X, y = _data(1)
    rows = np.arange(len(X))
    batched = dl_cv._inner_cv_scores_batch(
        dl_cv._TrainerCache(input_dim=10, device="cpu"), PLIST,
        loops.DeviceCorpus(X, device="cpu").view(rows), y, 2, 2, 4, 42)
    jbatched = jax_dl_cv._inner_cv_scores_batch(
        jax_dl_cv._TrainerCache(input_dim=10), PLIST, jax_loops.DeviceCorpus(X).view(rows), y,
        2, 2, 4, 42)
    assert len(batched) == 3
    np.testing.assert_allclose(batched, jbatched, atol=SCORE_ATOL)


# one architecture, so that both outer folds share the JAX package's compiled programs
NESTED = dict(n_splits_outer=2, n_splits_inner=2, n_trials=4, epochs=2, patience=3,
              batch_size=4, inner_epochs=2, trial_batch=4,
              search_space=dict(SPACE, activation_fn=("categorical", ["silu"])))


def test_nested_cv_trial_batch_matches_jax(same_start):
    """One round of 4 trials a fold on both sides: the same TPE suggestions
    (the samplers are one algorithm), the same scores, so the same
    ``best_params`` and final models."""
    seqs, meta = _participants()
    df, preds, weights = dl_cv.run_dl_nested_cv(seqs, meta, device="cpu", **NESTED)
    jdf, jpreds, jweights = jax_dl_cv.run_dl_nested_cv(seqs, meta, **NESTED)
    for fold in range(2):
        assert df["best_params"][fold] == jdf["best_params"][fold]
        np.testing.assert_array_equal(preds[fold]["y_true"], jpreds[fold]["y_true"])
        np.testing.assert_allclose(preds[fold]["y_prob"], jpreds[fold]["y_prob"], atol=PROB_ATOL)
    np.testing.assert_allclose(weights, jweights, rtol=HIST_RTOL)
