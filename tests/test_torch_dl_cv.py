"""The port's CV engines (eval/dl_cv.py) vs the JAX package's, on the CPU.

20 synthetic participants (input 10, lengths 16–39, a learnable shift on the
Patient class), cnn 8, lstm 8. Both sides start every fold and trial from
the same weights: inside these tests the port's ``Trainer.init_state`` is
patched to load what the JAX ``init_state`` gives for that seed and
architecture. Dropout is neutralised on both sides (rate 0.0 in the
hyperparameters; the residual blocks' fixed 0.2 by a patch of
``flax.linen.Dropout`` and of the port's ``dropout``), and both sides'
trainers are built with ``adam_eps=1e-5`` so that gradients of pure rounding
noise (conv biases before a train-mode BatchNorm) move nothing; see
``tests/test_torch_train.py``.

Tolerances: fold membership and TPE studies exact; ``y_prob`` atol 1e-4,
histories and stability vectors rtol 1e-4 (the tolerances of one fold in
``tests/test_torch_device_fold.py``; the differences seen are below 1e-6);
metrics equal where the predictions are equal.
"""

import contextlib
import logging

import numpy as np
import pandas as pd
import pytest

import torch

from robust_speech_analysis_framework_tpu.eval import dl_cv as jax_dl_cv
from robust_speech_analysis_framework_tpu.models.cnn_lstm import CNNLSTM as JaxCNNLSTM
from robust_speech_analysis_framework_tpu.train import loops as jax_loops
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.models import cnn_lstm as port_model
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.train import loops
from tests.test_torch_train import (  # noqa: F401  (one_torch_thread: autouse fixture)
    _flat,
    _jax_init,
    _jax_without_dropout,
    one_torch_thread,
)

ADAM_EPS = 1e-5
PROB_ATOL = 1e-4
RTOL = 1e-4
HP = {"learning_rate": 3e-3, "dropout_rate": 0.0, "cnn_out_channels": 8,
      "lstm_hidden_dim": 8, "activation_fn": "silu"}
# two points: the activation; the widths are pinned and dropout is off
SPACE = {
    "learning_rate": ("float_log", 1e-3, 5e-3),
    "dropout_rate": ("float", 0.0, 0.0),
    "cnn_out_channels": ("categorical", [8]),
    "lstm_hidden_dim": ("categorical", [8]),
    "activation_fn": ("categorical", ["silu", "gelu"]),
}


def _participants(seed: int = 0, n: int = 20):
    rng = np.random.default_rng(seed)
    seqs, rows = {}, []
    for i in range(n):
        label = "Patient" if i % 2 else "Control"
        pid = f"{i:02d}_{label[0]}"
        t = int(rng.integers(16, 40))
        seqs[pid] = rng.normal(0.8 * (i % 2), 1.0, size=(t, 10)).astype(np.float32)
        rows.append({"unique_participant_id": pid, "label": label})
    # a metadata row with no sequence, and a duplicate: both dropped in alignment
    rows.append({"unique_participant_id": "99_X", "label": "Unknown"})
    rows.append(dict(rows[0]))
    return seqs, pd.DataFrame(rows)


@pytest.fixture(scope="module")
def participants():
    return _participants()


@contextlib.contextmanager
def same_start_patches():
    """Both packages' engines from the same weights, without dropout, with
    ``adam_eps=1e-5``; the JAX engine's trainers kept out of its process-wide
    cache."""
    real_init = loops.Trainer.init_state

    def init_from_jax(self, seed, lr, weights=None):
        if weights is None:
            m = self.model
            jtrainer = jax_loops.Trainer(JaxCNNLSTM(
                input_dim=m.input_dim, num_classes=m.num_classes,
                cnn_out_channels=m.cnn_out_channels, lstm_hidden_dim=m.lstm_hidden_dim,
                activation_fn=m.activation_fn))
            example = np.zeros((1, 64, m.input_dim), np.float32)
            weights = cnn_lstm_state_dict_from_flat(_flat(_jax_init(jtrainer, example, seed, lr)))
        return real_init(self, seed, lr, weights)

    with pytest.MonkeyPatch.context() as mp, _jax_without_dropout():
        mp.setattr(loops.Trainer, "init_state", init_from_jax)
        mp.setattr(port_model, "dropout", lambda x, rate, generator=None: x)
        mp.setattr(port_model, "dropout_lanes", lambda x, rate, lane_dim, generator=None: x)
        mp.setattr(dl_cv, "Trainer", lambda model, device: loops.Trainer(
            model, adam_eps=ADAM_EPS, device=device))
        mp.setattr(jax_dl_cv, "_GLOBAL_TRAINERS", {})
        mp.setattr(jax_dl_cv, "Trainer",
                   lambda model: jax_loops.Trainer(model, adam_eps=ADAM_EPS))
        yield


@pytest.fixture
def same_start():
    with same_start_patches():
        yield


# --- alignment ---------------------------------------------------------------------


def test_alignment_matches_jax(participants):
    seqs, meta = participants
    X, y, pids = dl_cv.align_sequences_and_labels(seqs, meta)
    jX, jy, jpids = jax_dl_cv.align_sequences_and_labels(seqs, meta)
    assert pids == jpids == sorted(seqs) and len(X) == 20  # "99_X" dropped
    np.testing.assert_array_equal(y, jy)
    assert y.sum() == 10
    for a, b in zip(X, jX):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32
    with pytest.raises(ValueError, match="no overlap"):
        dl_cv.align_sequences_and_labels({"clip.wav": X[0]}, meta)


def test_alignment_of_a_resident_corpus_matches_jax(participants):
    seqs, meta = participants
    shuffled = {k: seqs[k] for k in sorted(seqs, reverse=True)}
    rc = loops.ResidentCorpus(shuffled, device="cpu")
    jrc = jax_loops.ResidentCorpus(shuffled)
    X, y, pids = dl_cv.align_sequences_and_labels(rc, meta)
    jX, jy, jpids = jax_dl_cv.align_sequences_and_labels(jrc, meta)
    assert isinstance(X, loops.SeqView) and X.corpus.x is rc.device_corpus().x  # no new upload
    assert pids == jpids
    np.testing.assert_array_equal(X.idx, jX.idx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(X.corpus.x.numpy(), np.asarray(jX.corpus.x))
    np.testing.assert_array_equal(X[3], seqs[pids[3]])


def test_resident_rows_outside_the_metadata_do_not_set_the_padded_length(participants):
    """The host path pads to the aligned max length of the participants the
    metadata names; a resident corpus that also holds a longer recording is
    cut to that length (the JAX package computes at the longer one)."""
    seqs, meta = participants
    extra = dict(seqs, zz_unlisted=np.zeros((300, 10), np.float32))
    rc = loops.ResidentCorpus(extra, device="cpu")
    assert rc.device_corpus().x.shape[1] == 384
    X, _, pids = dl_cv.align_sequences_and_labels(rc, meta)
    assert "zz_unlisted" not in pids and X.corpus.x.shape[1] == 128
    assert X.corpus.x.data_ptr() == rc.device_corpus().x.data_ptr()
    listed = dl_cv._as_device_corpus(dl_cv.align_sequences_and_labels(seqs, meta)[0], "cpu")
    np.testing.assert_array_equal(X.corpus.x[X.idx].numpy(), listed.corpus.x.numpy())


# --- the standard engine -----------------------------------------------------------


@pytest.fixture
def standard_both(participants, same_start):
    seqs, meta = participants
    kw = dict(n_splits=2, epochs=3, patience=3, batch_size=4)
    return (dl_cv.run_dl_standard_kfold_cv(seqs, meta, HP, device="cpu", **kw),
            jax_dl_cv.run_dl_standard_kfold_cv(seqs, meta, HP, **kw))


def test_standard_kfold_matches_jax(standard_both):
    (df, preds, hists, weights), (jdf, jpreds, jhists, jweights) = standard_both
    assert list(df.columns) == list(jdf.columns) and list(df["fold"]) == [1, 2]
    assert len(preds) == len(hists) == 2 and weights.shape == jweights.shape == (2, 10)
    for fold in range(2):
        # the same fold membership: the test labels in the same order
        np.testing.assert_array_equal(preds[fold]["y_true"], jpreds[fold]["y_true"])
        np.testing.assert_allclose(preds[fold]["y_prob"], jpreds[fold]["y_prob"], atol=PROB_ATOL)
        for key in ("train", "val"):
            assert len(hists[fold][key]) == 3
            np.testing.assert_allclose(hists[fold][key], jhists[fold][key], rtol=RTOL)
        if np.array_equal(preds[fold]["y_prob"] > 0.5, jpreds[fold]["y_prob"] > 0.5):
            for col in ("accuracy", "f1_score", "precision", "recall"):
                assert df[col][fold] == pytest.approx(jdf[col][fold], abs=1e-12)
        assert df["auc"][fold] == pytest.approx(jdf["auc"][fold], abs=0.05)
    np.testing.assert_allclose(weights, jweights, rtol=RTOL)
    assert any(np.array_equal(p["y_prob"] > 0.5, j["y_prob"] > 0.5)
               for p, j in zip(preds, jpreds))  # the metrics were compared


# --- the nested engine ---------------------------------------------------------------


def test_nested_cv_matches_jax(participants, same_start):
    """3 sequential trials a fold (all inside the sampler's random startup, so
    the suggestions do not depend on the scores). ``best_params`` is the
    FIRST trial with the best mean inner macro-F1 (``Study.best_trial`` takes
    ``min`` over trials in order): a tie of scores goes to the earlier trial
    on both sides, and the scores, being F1 over 5 predictions a fold, tie
    often."""
    seqs, meta = participants
    kw = dict(n_splits_outer=2, n_splits_inner=2, n_trials=3, epochs=2, patience=3,
              batch_size=4, inner_epochs=2, search_space=SPACE)
    df, preds, weights = dl_cv.run_dl_nested_cv(seqs, meta, device="cpu", **kw)
    jdf, jpreds, jweights = jax_dl_cv.run_dl_nested_cv(seqs, meta, **kw)
    assert list(df.columns) == list(jdf.columns) and "best_params" in df.columns
    for fold in range(2):
        assert df["best_params"][fold] == jdf["best_params"][fold]
        assert set(df["best_params"][fold]) == set(SPACE)
        np.testing.assert_array_equal(preds[fold]["y_true"], jpreds[fold]["y_true"])
        np.testing.assert_allclose(preds[fold]["y_prob"], jpreds[fold]["y_prob"], atol=PROB_ATOL)
    np.testing.assert_allclose(weights, jweights, rtol=RTOL)
    assert weights.shape == (2, 10)


def test_trial_batch_above_one_runs_rounds_of_lanes(participants, monkeypatch):
    """Both front doors take ``trial_batch`` > 1: each inner fold of a round
    trains its trials in one ``train_trials_device`` call."""
    seqs, meta = participants
    lanes = []
    real = dl_cv.train_trials_device
    monkeypatch.setattr(dl_cv, "train_trials_device", lambda *a, **k: (
        lanes.append(len(a[6])) or real(*a, **k)))
    kw = dict(n_splits_outer=2, n_splits_inner=2, epochs=1, inner_epochs=1, batch_size=4,
              search_space=SPACE, device="cpu")
    df, preds, weights = dl_cv.run_dl_nested_cv(seqs, meta, n_trials=3, trial_batch=2, **kw)
    assert lanes == [2, 2, 1, 1] * 2  # rounds of 2 and 1 trials, 2 inner folds each
    assert len(df) == 2 and weights.shape == (2, 10)
    lanes.clear()
    X, y, _ = dl_cv.align_sequences_and_labels(seqs, meta)
    results, preds, weights = dl_cv.nested_cv(X, y, n_trials=3, trial_batch=8, **kw)
    assert lanes == [3, 3] * 2
    assert all(np.isfinite(p["y_prob"]).all() for p in preds) and len(results) == 2


# --- one upload for both engines --------------------------------------------------------


def test_resident_corpus_shared_by_both_engines_uploads_once(participants, monkeypatch):
    seqs, meta = participants
    uploads = []
    real = loops.DeviceCorpus.__init__
    monkeypatch.setattr(loops.DeviceCorpus, "__init__",
                        lambda self, *a, **k: uploads.append(1) or real(self, *a, **k))
    rc = loops.ResidentCorpus(seqs, device="cpu")
    assert len(uploads) == 1
    std_kw = dict(n_splits=2, epochs=2, patience=3, batch_size=4, device="cpu")
    nested_kw = dict(n_splits_outer=2, n_splits_inner=2, n_trials=2, epochs=2, patience=3,
                     batch_size=4, inner_epochs=1, search_space=SPACE, device="cpu")
    df_r, _, hist_r, w_r = dl_cv.run_dl_standard_kfold_cv(rc, meta, HP, **std_kw)
    ndf_r, npreds_r, _ = dl_cv.run_dl_nested_cv(rc, meta, **nested_kw)
    assert len(uploads) == 1  # neither engine uploaded the corpus again
    df_h, _, hist_h, w_h = dl_cv.run_dl_standard_kfold_cv(seqs, meta, HP, **std_kw)
    ndf_h, npreds_h, _ = dl_cv.run_dl_nested_cv(seqs, meta, **nested_kw)
    assert len(uploads) == 3  # a plain dict is uploaded once per engine call
    # the same tensor either way: the same numbers, exactly
    pd.testing.assert_frame_equal(df_r, df_h)
    assert hist_r == hist_h
    np.testing.assert_array_equal(w_r, w_h)
    pd.testing.assert_frame_equal(ndf_r, ndf_h)
    for a, b in zip(npreds_r, npreds_h):
        np.testing.assert_array_equal(a["y_prob"], b["y_prob"])


# --- the budget and the failure paths ----------------------------------------------------


def _toy(n=4, t=12, d=6):
    rng = np.random.default_rng(0)
    return [rng.normal(size=(t, d)).astype(np.float32) for _ in range(n)]


def test_corpus_budget_bytes(monkeypatch):
    """A quarter of the card's memory; the 4 GiB literal on the CPU; the
    environment variable over both."""
    monkeypatch.delenv("RSAF_CORPUS_BUDGET_BYTES", raising=False)
    assert dl_cv._corpus_budget_bytes(torch.device("cpu")) == 4 << 30 \
        == jax_dl_cv._CORPUS_BUDGET_FALLBACK_BYTES

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    assert dl_cv._corpus_budget_bytes(torch.device("cuda", 0)) == 20 << 30
    monkeypatch.setenv("RSAF_CORPUS_BUDGET_BYTES", "12345")
    assert dl_cv._corpus_budget_bytes(torch.device("cuda", 0)) == 12345
    assert dl_cv._corpus_budget_bytes(torch.device("cpu")) == 12345
    monkeypatch.setenv("RSAF_CORPUS_BUDGET_BYTES", "a lot")
    assert dl_cv._corpus_budget_bytes(torch.device("cpu")) == 4 << 30


def test_over_budget_corpus_streams_from_host(monkeypatch):
    X = _toy()
    view = dl_cv._as_device_corpus(X, "cpu")
    assert isinstance(view, loops.SeqView) and len(view) == 4
    assert dl_cv._as_device_corpus(view, "cpu") is view  # already resident
    monkeypatch.setenv("RSAF_CORPUS_BUDGET_BYTES", "1")
    assert dl_cv._as_device_corpus(X, "cpu") is X  # untouched host list: the folds stream


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError, MemoryError])
def test_allocation_failure_streams_with_a_warning(error, monkeypatch, caplog):
    class ExplodingCorpus:
        nbytes_estimate = staticmethod(loops.DeviceCorpus.nbytes_estimate)

        def __init__(self, *a, **k):
            raise error("out of memory")

    monkeypatch.setattr(dl_cv, "DeviceCorpus", ExplodingCorpus)
    X = _toy()
    with caplog.at_level(logging.WARNING):
        assert dl_cv._as_device_corpus(X, "cpu") is X
    assert any("resident-corpus upload failed" in r.message for r in caplog.records)


@pytest.mark.parametrize("error", [TypeError, RuntimeError])
def test_any_other_error_propagates(error, monkeypatch):
    """Only an allocation failure is caught: a programming error, or a
    device error that is no out-of-memory, is not hidden behind streaming."""
    class BuggyCorpus:
        nbytes_estimate = staticmethod(loops.DeviceCorpus.nbytes_estimate)

        def __init__(self, *a, **k):
            raise error("bad argument")

    monkeypatch.setattr(dl_cv, "DeviceCorpus", BuggyCorpus)
    with pytest.raises(error, match="bad argument"):
        dl_cv._as_device_corpus(_toy(), "cpu")


def test_trainer_cache_keys_on_architecture_and_device():
    cache = dl_cv._TrainerCache(input_dim=10, device="cpu")
    a = cache.get({**HP, "dropout_rate": 0.2})
    assert cache.get({**HP, "dropout_rate": 0.45}) is a  # the rate is a call-time argument
    b = cache.get({**HP, "activation_fn": "gelu"})
    assert b is not a and a.device == torch.device("cpu")
    assert (a.model.cnn_out_channels, a.model.lstm_hidden_dim, b.model.activation_fn) == \
        (8, 8, "gelu")
    assert dl_cv._TrainerCache(input_dim=10, device="cpu").get(HP) is not a  # one per call
    view = dl_cv._as_device_corpus(_toy(), "cpu")
    assert dl_cv._input_dim(view) == dl_cv._input_dim(_toy()) == 6
    assert len(dl_cv._subset(view, np.array([1, 3]))) == len(dl_cv._subset(_toy(), [1, 3])) == 2


# --- the cores need no pandas ---------------------------------------------------------------


def test_array_cores_run_without_pandas(participants, monkeypatch):
    seqs, meta = participants
    X, y, _ = dl_cv.align_sequences_and_labels(seqs, meta)
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)  # import pandas now fails
    with pytest.raises(ImportError):
        dl_cv.run_dl_standard_kfold_cv(seqs, meta, HP, device="cpu")
    results, preds, hists, weights = dl_cv.standard_kfold_cv(
        X, y, HP, n_splits=2, epochs=1, batch_size=4, device="cpu")
    assert [r["fold"] for r in results] == [1, 2] and len(preds) == len(hists) == 2
    assert {"accuracy", "f1_score", "precision", "recall", "auc"} <= set(results[0])
    assert weights.shape == (2, 10) and np.isfinite(weights).all()
    results, preds, weights = dl_cv.nested_cv(
        X, y, n_splits_outer=2, n_splits_inner=2, n_trials=2, epochs=1, batch_size=4,
        inner_epochs=1, search_space=SPACE, device="cpu")
    assert [set(r["best_params"]) for r in results] == [set(SPACE)] * 2
    assert all(np.isfinite(p["y_prob"]).all() for p in preds) and weights.shape == (2, 10)


def test_stability_vector_is_the_probe():
    trainer = loops.Trainer(port_model.CNNLSTM(input_dim=10, cnn_out_channels=8,
                                               lstm_hidden_dim=8), device="cpu")
    state = trainer.init_state(0, 1e-3)
    expected = state.model.res_block1.conv1.weight.detach().abs().mean(dim=(0, 2)).numpy()
    np.testing.assert_array_equal(dl_cv._stability_vector(state), expected)
    np.testing.assert_array_equal(dl_cv._stability_deferred(state).result(), expected)
