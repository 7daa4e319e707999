"""The port's device-resident fold (train/loops.py) vs its own streaming fold
and vs the JAX package's resident fold, on the CPU.

Small widths (input 12, cnn 8, lstm 8), seeded numpy data, the same initial
weights on both sides (the JAX init carried into the port), dropout
neutralised on both sides as in ``tests/test_torch_train.py``, and
``adam_eps=1e-5`` for the multi-epoch runs so that gradients of pure
rounding noise move nothing.

Tolerances: port resident vs port streaming on one-bucket data: exact (the
gathered batch is the padded batch, bit for bit, and both paths draw the
dropout generator once a step). Port vs JAX: histories rtol 1e-4, final
logits atol 1e-4, the tolerances of ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.models.cnn_lstm import CNNLSTM as JaxCNNLSTM
from robust_speech_analysis_framework_tpu.train import loops as jax_loops
from robust_speech_analysis_framework_tpu_torch.data import batching
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.ops.framing import Deferred, collect
from robust_speech_analysis_framework_tpu_torch.train import loops
from tests.test_torch_train import (
    DIMS,
    HIST_RTOL,
    PROB_ATOL,
    _flat,
    _jax_init,
    _jax_without_dropout,
    _port_template,
    one_torch_thread,  # noqa: F401  (autouse fixture)
)

ADAM_EPS = 1e-5


def _corpus(seed: int, n: int, lo: int = 33, hi: int = 65):
    """``n`` sequences of ``lo`` ≤ T < ``hi`` frames with a learnable signal;
    the default lengths share the bucket 64 at min_bucket 16."""
    rng = np.random.default_rng(seed)
    seqs = [rng.normal(size=(t, 12)).astype(np.float32) for t in rng.integers(lo, hi, size=n)]
    labels = np.arange(n) % 2
    for s, y in zip(seqs, labels):
        s[:, :3] += 0.8 * y
    return seqs, labels


def _states_equal(a: loops.TrainState, b: loops.TrainState) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


# --- the batch plan and the resident corpus --------------------------------------


@pytest.mark.parametrize("n,epochs,batch,seed", [(11, 3, 4, 9), (8, 2, 4, 0), (3, 2, 8, 5)])
def test_epoch_batch_plan_matches_jax_and_batch_iterator(n, epochs, batch, seed):
    full, rem = loops._epoch_batch_plan(n, epochs, batch, seed)
    jfull, jrem = jax_loops._epoch_batch_plan(n, epochs, batch, seed)
    np.testing.assert_array_equal(full, jfull)
    np.testing.assert_array_equal(rem, jrem)
    assert full.shape == (epochs, n // batch, batch) and rem.shape == (epochs, n % batch)
    # the streaming path's own order: labels carry the sequence index
    seqs = [np.zeros((2, 1), np.float32)] * n
    for e in range(epochs):
        order = [labs for _, _, labs in batching.batch_iterator(
            seqs, np.arange(n), batch, shuffle=True, seed=seed + e)]
        np.testing.assert_array_equal(np.concatenate(order),
                                      np.concatenate([full[e].ravel(), rem[e]]))


@pytest.mark.parametrize("align", [8, 128])
def test_device_corpus_contents_match_jax(align):
    seqs, _ = _corpus(0, 5, 10, 40)
    ours = loops.DeviceCorpus(seqs, align=align, device="cpu")
    theirs = jax_loops.DeviceCorpus(seqs, align=align)
    np.testing.assert_array_equal(ours.x.numpy(), np.asarray(theirs.x))
    np.testing.assert_array_equal(ours.lengths.numpy(), np.asarray(theirs.lengths))
    np.testing.assert_array_equal(ours.host_lengths, theirs.host_lengths)
    assert ours.x.shape[1] % align == 0 and ours.x.dtype == torch.float32
    assert loops.DeviceCorpus.nbytes_estimate(seqs, align) == \
        jax_loops.DeviceCorpus.nbytes_estimate(seqs, align) == ours.x.numel() * 4


def test_seq_view_is_a_list_of_rows():
    seqs, _ = _corpus(1, 4, 10, 20)
    corpus = loops.DeviceCorpus(seqs, align=8, device="cpu")
    view = corpus.view(np.arange(4))
    sub = view.subset(np.array([2, 0]))
    assert isinstance(sub, loops.SeqView) and sub.corpus is corpus
    assert len(sub) == 2 and [len(s) for s in sub] == [len(seqs[2]), len(seqs[0])]
    np.testing.assert_array_equal(sub[1], seqs[0])
    np.testing.assert_array_equal(corpus.x[sub.idx[0], : len(seqs[2])].numpy(), seqs[2])
    assert not corpus.x[sub.idx[0], len(seqs[2]):].any()


def test_resident_corpus_is_a_mapping_over_one_upload():
    seqs, _ = _corpus(2, 4, 10, 20)
    named = {f"p{i}": s for i, s in enumerate(seqs)}
    rc = loops.ResidentCorpus(named, align=8, device="cpu")
    assert rc.is_resident_sequences and len(rc) == 4 and "p2" in rc and "zz" not in rc
    assert list(rc) == rc.keys() == list(named) and rc.row("p3") == 3
    np.testing.assert_array_equal(rc["p1"], named["p1"])
    assert [k for k, _ in rc.items()] == list(named)
    assert loops.DeviceCorpus.from_resident(rc) is rc.device_corpus()


def test_from_resident_adopts_a_device_tensor():
    """An extractor's resident output (a padded tensor with a scratch row,
    lengths, names, rows by name) is adopted without a copy; host rows
    download only when indexed."""
    seqs, _ = _corpus(3, 3, 5, 9)
    x = torch.zeros(4, 16, 12)
    for i, s in enumerate(seqs):
        x[i, : len(s)] = torch.from_numpy(s)

    class Resident:
        names = ["a", "b", "c"]
        lengths = [len(s) for s in seqs]
        downloads = 0

        def __getitem__(self, name):
            self.downloads += 1
            i = self.names.index(name)
            return self.x[i, : self.lengths[i]].numpy()

    resident = Resident()
    resident.x = x
    corpus = loops.DeviceCorpus.from_resident(resident)
    assert corpus.x is x and corpus.lengths.tolist() == resident.lengths
    assert len(corpus.seqs) == 3 and resident.downloads == 0
    np.testing.assert_array_equal(corpus.view(np.array([2]))[0], seqs[2])
    assert resident.downloads == 1


def test_trimmed_to_cuts_the_time_axis_to_the_rows_kept():
    seqs = [np.ones((t, 3), np.float32) for t in (5, 30, 9)]
    corpus = loops.DeviceCorpus(seqs, align=8, device="cpu")
    assert corpus.x.shape == (3, 32, 3)
    cut = corpus.trimmed_to(np.array([0, 2]), align=8)
    assert cut.x.shape == (3, 16, 3) and cut.x.data_ptr() == corpus.x.data_ptr()
    assert cut.lengths is corpus.lengths and cut.seqs is corpus.seqs
    assert corpus.trimmed_to(np.array([0, 1]), align=8) is corpus


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16, "env"])
def test_bfloat16_storage(dtype, monkeypatch):
    seqs, _ = _corpus(4, 3, 10, 20)
    if dtype == "env":
        monkeypatch.setenv("RSAF_CORPUS_DTYPE", "bfloat16")
        dtype = None
    ours = loops.DeviceCorpus(seqs, align=8, dtype=dtype, device="cpu")
    theirs = jax_loops.DeviceCorpus(seqs, align=8, dtype=jnp.bfloat16)
    assert ours.x.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.x.float().numpy(),
                                  np.asarray(theirs.x.astype(jnp.float32)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        loops.DeviceCorpus(seqs, dtype="float16", device="cpu")


# --- Deferred and collect ----------------------------------------------------------


def test_deferred_and_collect():
    a = Deferred((torch.arange(3.0), [torch.ones(2, 2), torch.zeros(1)]),
                 lambda h: (h[0].sum(), [type(x).__name__ for x in h[1]]))
    assert a.result() == (3.0, ["ndarray", "ndarray"])
    b = Deferred.ready("done")
    c = Deferred(torch.tensor([2.0], requires_grad=True), lambda h: float(h[0]) * 2)
    assert collect([a, b, c]) == [(3.0, ["ndarray", "ndarray"]), "done", 4.0]
    assert collect([]) == []


# --- the resident fold against the streaming fold (port) -----------------------------


def _fold_inputs(kind: str, train, val):
    """The fold's sequences as host lists, or as two views of one corpus
    padded to the lists' bucket (align 64 = bucket_length(≤64, 16))."""
    (train_x, train_y), (val_x, val_y) = train, val
    if kind == "views":
        corpus = loops.DeviceCorpus(train_x + val_x, align=64, device="cpu")
        n = len(train_x)
        return (corpus.view(np.arange(n)), train_y,
                corpus.view(np.arange(n, n + len(val_x))), val_y)
    return train_x, train_y, val_x, val_y


@pytest.mark.parametrize("kind", ["lists", "views"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_resident_fold_equals_streaming_fold_bit_for_bit(kind, remat):
    """One-bucket data, dropout ON (0.3 and the blocks' 0.2), a remainder
    batch (11 = 2 × 4 + 3) and a remainder val batch (5 = 4 + 1): histories
    and every tensor of the final state are equal, not close."""
    train, val = _corpus(1, 11), _corpus(2, 5)
    runs = {}
    for fold in ("on", "off"):
        trainer = loops.Trainer(CNNLSTM(**DIMS, dropout_rate=0.3), device="cpu")
        cfg = loops.TrainConfig(learning_rate=1e-2, epochs=3, batch_size=4, min_bucket=16,
                                seed=6, remat=remat, device_fold=fold)
        args = _fold_inputs(kind if fold == "on" else "lists", train, val)
        runs[fold] = loops.train_model(trainer, *args, cfg)
    (s_on, t_on, v_on), (s_off, t_off, v_off) = runs["on"], runs["off"]
    assert t_on == t_off and v_on == v_off and len(t_on) == 3
    _states_equal(s_on, s_off)
    assert t_on[-1] < t_on[0]


def test_resident_fold_uploads_no_batch(monkeypatch):
    """The fold's uploads through ``Trainer._tensor``: the label vector, the
    batch plans and the view's row indices, never a batch."""
    train, val = _corpus(1, 11), _corpus(2, 5)
    args = _fold_inputs("views", train, val)
    uploads = []
    real = loops.Trainer._tensor

    def counting(self, a, dtype):
        if not isinstance(a, torch.Tensor):
            uploads.append(np.asarray(a).nbytes)
        return real(self, a, dtype)

    monkeypatch.setattr(loops.Trainer, "_tensor", counting)
    trainer = loops.Trainer(_port_template(), device="cpu")
    cfg = loops.TrainConfig(epochs=2, batch_size=4, min_bucket=16, dropout_rate=0.0)
    state, _, _ = loops.train_model(trainer, *args, cfg)
    assert len(uploads) == 5  # y, full, rem, va_full, va_rem
    trainer.eval_logits(state, args[2], cfg)
    assert len(uploads) == 6  # the view's rows
    assert max(uploads) <= 8 * 16  # the 16 corpus rows' labels as int64
    uploads.clear()
    loops.train_model(trainer, *_fold_inputs("lists", train, val),
                      loops.TrainConfig(epochs=2, batch_size=4, min_bucket=16,
                                        dropout_rate=0.0, device_fold="off"))
    assert max(uploads) == 4 * 64 * 12 * 4  # streaming: a padded batch a step


# --- the resident fold against the JAX package's -------------------------------------


def _run_both_resident(kind: str, cfg_kwargs: dict, train, val):
    """``train_model(device_fold="on")`` on both sides from the JAX init."""
    (train_x, train_y), (val_x, val_y) = train, val
    jcfg = jax_loops.TrainConfig(**cfg_kwargs, device_fold="on")
    pcfg = loops.TrainConfig(**cfg_kwargs, device_fold="on")
    n = len(train_x)
    with _jax_without_dropout():
        jtrainer = jax_loops.Trainer(JaxCNNLSTM(**DIMS, dropout_rate=0.0), adam_eps=ADAM_EPS)
        if kind == "views":
            jcorpus = jax_loops.DeviceCorpus(train_x + val_x)
            jargs = (jcorpus.view(np.arange(n)), train_y,
                     jcorpus.view(np.arange(n, n + len(val_x))), val_y)
        else:
            jargs = (train_x, train_y, val_x, val_y)
        example = jax_loops._init_example(jargs[0], jcfg)
        init = _flat(_jax_init(jtrainer, example, jcfg.seed, jcfg.learning_rate))
        jstate, jtrain, jval = jax_loops.train_model(jtrainer, *jargs, jcfg)
        jlogits = jtrainer.eval_logits(jstate, jargs[2], jcfg)
    trainer = loops.Trainer(_port_template(), adam_eps=ADAM_EPS, device="cpu")
    if kind == "views":
        corpus = loops.DeviceCorpus(train_x + val_x, device="cpu")
        pargs = (corpus.view(np.arange(n)), train_y,
                 corpus.view(np.arange(n, n + len(val_x))), val_y)
    else:
        pargs = (train_x, train_y, val_x, val_y)
    state, ptrain, pval = loops.train_model(
        trainer, *pargs, pcfg, initial_weights=cnn_lstm_state_dict_from_flat(init))
    plogits = trainer.eval_logits(state, pargs[2], pcfg)
    return dict(jax=(jstate, jtrain, jval, jlogits), port=(state, ptrain, pval, plogits),
                trainer=trainer, val=pargs[2:], cfg=pcfg)


@pytest.fixture(scope="module", params=["lists", "views"])
def resident_three_epochs(request):
    """Lengths 20–64 fall in the buckets 32 and 64, so the resident fold's
    one padded length (64 for lists, 128 for the corpus) differs from the
    streaming path's per-batch buckets: the padded length is part of the
    result, and both packages must compute at the same one. 11 train and 5
    val sequences at batch 4 leave a remainder batch in both."""
    cfg = dict(learning_rate=1e-2, epochs=3, batch_size=4, min_bucket=16, dropout_rate=0.0, seed=0)
    return _run_both_resident(request.param, cfg, _corpus(1, 11, 20, 65), _corpus(2, 5, 20, 65))


def test_resident_fold_histories_match_jax(resident_three_epochs):
    _, jtrain, jval, _ = resident_three_epochs["jax"]
    _, ptrain, pval, _ = resident_three_epochs["port"]
    assert len(ptrain) == len(pval) == 3
    np.testing.assert_allclose(ptrain, jtrain, rtol=HIST_RTOL)
    np.testing.assert_allclose(pval, jval, rtol=HIST_RTOL)
    assert ptrain[-1] < ptrain[0]


def test_resident_fold_final_logits_match_jax(resident_three_epochs):
    jlogits, plogits = resident_three_epochs["jax"][3], resident_three_epochs["port"][3]
    assert plogits.shape == (5, 2)
    np.testing.assert_allclose(plogits, jlogits, atol=PROB_ATOL)


def test_resident_fold_differs_from_streaming_off_one_bucket():
    """The same multi-bucket data through the streaming path gives other
    numbers (train-mode BatchNorm sees other padded lengths): what the
    parity above pins is the resident path's own length."""
    (train_x, train_y), (val_x, val_y) = _corpus(1, 11, 20, 65), _corpus(2, 5, 20, 65)
    corpus = loops.DeviceCorpus(train_x + val_x, device="cpu")  # one length: 128 frames
    args = (corpus.view(np.arange(11)), train_y, corpus.view(np.arange(11, 16)), val_y)
    hist = {}
    for fold in ("on", "off"):
        trainer = loops.Trainer(_port_template(), device="cpu")
        cfg = loops.TrainConfig(learning_rate=1e-2, epochs=2, batch_size=4, min_bucket=16,
                                dropout_rate=0.0, device_fold=fold)
        hist[fold] = loops.train_model(trainer, *args, cfg)[1]
    assert hist["on"] != hist["off"]
    np.testing.assert_allclose(hist["on"], hist["off"], rtol=0.2)


def test_resident_early_stop_plateau_and_restore_match_jax():
    """Validation labels set against the training signal, so the val loss
    turns up: plateau decay on every bad epoch, an early stop after two, and
    the best epoch's weights restored, on the resident path of both sides."""
    train = _corpus(1, 12)
    val_x, val_y = _corpus(2, 4)
    run = _run_both_resident(
        "views", dict(learning_rate=1e-2, epochs=10, patience=2, plateau_patience=0,
                      batch_size=4, min_bucket=16, dropout_rate=0.0, seed=3),
        train, (val_x, 1 - val_y))
    jstate, jtrain, jval, jlogits = run["jax"]
    state, ptrain, pval, plogits = run["port"]
    assert len(pval) == len(jval) < 10  # stopped early
    np.testing.assert_allclose(ptrain, jtrain, rtol=HIST_RTOL)
    np.testing.assert_allclose(pval, jval, rtol=HIST_RTOL)
    # the one difference by design: the port restores the best epoch's rate
    # with its weights, the JAX resident fold only the weights
    assert state.lr == 1e-2 and float(jstate.lr) < 1e-2
    np.testing.assert_allclose(plogits, jlogits, atol=PROB_ATOL)
    view, labels = run["val"]
    idx = torch.from_numpy(view.idx)
    best = loops._val_loss(run["trainer"], state, [
        (view.corpus.x[idx], view.corpus.lengths[idx], torch.from_numpy(labels))], run["cfg"])
    assert best == pytest.approx(min(pval), rel=1e-6)


# --- which path a fold takes ------------------------------------------------------------


@pytest.mark.parametrize("case,expected", [
    ("auto_fits", "resident"), ("auto_over_budget", "streams"), ("off", "streams"),
    ("on_over_budget", "resident"), ("auto_shared_views_over_budget", "resident"),
    ("off_shared_views", "streams"),
])
def test_device_fold_rule(case, expected, monkeypatch):
    """The JAX package's rule: "on", or views of one corpus, or padded
    arrays within ``device_fold_budget_bytes``; "off" always streams."""
    train, val = _corpus(1, 6), _corpus(2, 4)
    fold = case.split("_")[0]
    budget = 1 if "over_budget" in case else 4 << 30
    cfg = loops.TrainConfig(epochs=1, batch_size=4, min_bucket=16, dropout_rate=0.0,
                            device_fold=fold, device_fold_budget_bytes=budget)
    args = _fold_inputs("views" if "views" in case else "lists", train, val)
    assert loops._device_fold_fits(args[0], args[2], cfg) == (budget > 1)
    jcfg = jax_loops.TrainConfig(min_bucket=16, device_fold_budget_bytes=budget)
    assert jax_loops._device_fold_fits(train[0], val[0], jcfg) == (budget > 1)
    took = []
    real = loops._train_model_device
    monkeypatch.setattr(loops, "_train_model_device",
                        lambda *a, **k: took.append("resident") or real(*a, **k))
    _, train_hist, _ = loops.train_model(loops.Trainer(_port_template(), device="cpu"),
                                         *args, cfg)
    assert (took or ["streams"]) == [expected] and np.isfinite(train_hist).all()


def test_defer_histories_returns_a_ready_deferred():
    train, val = _corpus(1, 6), _corpus(2, 4)
    trainer = loops.Trainer(_port_template(), device="cpu")
    for fold in ("on", "off"):
        cfg = loops.TrainConfig(epochs=2, batch_size=4, min_bucket=16, dropout_rate=0.0,
                                device_fold=fold)
        state, hist = loops.train_model(trainer, *train, *val, cfg, defer_histories=True)
        train_hist, val_hist = hist.result()
        assert isinstance(hist, Deferred) and len(train_hist) == len(val_hist) == 2
        assert (train_hist, val_hist) == loops.train_model(trainer, *train, *val, cfg)[1:]


# --- evaluation over a view ----------------------------------------------------------------


def test_eval_over_a_view_matches_the_list_path_and_jax():
    """One-bucket data: batches in view order gathered from the corpus give
    the length-sorted list path's logits (atol 1e-6: other rows share a
    batch), and the JAX package's over its own corpus (atol 1e-4)."""
    seqs, labels = _corpus(5, 7)
    trainer = loops.Trainer(_port_template(), device="cpu")
    cfg = loops.TrainConfig(batch_size=4, min_bucket=16)
    with _jax_without_dropout():
        jtrainer = jax_loops.Trainer(JaxCNNLSTM(**DIMS, dropout_rate=0.0))
        jstate = _jax_init(jtrainer, np.zeros((1, 16, 12), np.float32), 0, 1e-3)
        jview = jax_loops.DeviceCorpus(seqs, align=64).view(np.array([6, 0, 3, 2, 5, 1, 4]))
        jlogits = jtrainer.eval_logits(jstate, jview, jax_loops.TrainConfig(
            batch_size=4, min_bucket=16))
    state = trainer.init_state(0, 1e-3, cnn_lstm_state_dict_from_flat(_flat(jstate)))
    view = loops.DeviceCorpus(seqs, align=64, device="cpu").view(np.array([6, 0, 3, 2, 5, 1, 4]))
    logits = trainer.eval_logits(state, view, cfg)
    listed = trainer.eval_logits(state, [seqs[i] for i in view.idx], cfg)
    assert logits.shape == (7, 2)
    np.testing.assert_allclose(logits, listed, atol=1e-6)
    np.testing.assert_allclose(logits, jlogits, atol=PROB_ATOL)
    deferred = loops.evaluate_model_deferred(trainer, state, view, labels[view.idx], cfg)
    y_true, y_pred, y_prob = collect([deferred])[0]
    ey, ep, eprob = loops.evaluate_model(trainer, state, [seqs[i] for i in view.idx],
                                         labels[view.idx], cfg)
    np.testing.assert_array_equal(y_true, ey)
    np.testing.assert_array_equal(y_pred, ep)
    np.testing.assert_allclose(y_prob, eprob, atol=1e-6)
    assert y_prob.dtype == np.float32


def test_bfloat16_fold_trains_close_to_float32():
    """bfloat16 storage quantises the inputs by ~3e-3 relative: the same
    fold's losses stay close (as the JAX package's own test holds it)."""
    train, val = _corpus(1, 12), _corpus(2, 4)
    hist = {}
    for dtype in (torch.float32, torch.bfloat16):
        corpus = loops.DeviceCorpus(train[0] + val[0], align=64, dtype=dtype, device="cpu")
        trainer = loops.Trainer(_port_template(), device="cpu")
        cfg = loops.TrainConfig(learning_rate=1e-2, epochs=3, batch_size=4, min_bucket=16,
                                dropout_rate=0.0)
        _, t, v = loops.train_model(trainer, corpus.view(np.arange(12)), train[1],
                                    corpus.view(np.arange(12, 16)), val[1], cfg)
        hist[dtype] = t + v
    assert hist[torch.float32] != hist[torch.bfloat16]
    np.testing.assert_allclose(hist[torch.bfloat16], hist[torch.float32], rtol=2e-2)
