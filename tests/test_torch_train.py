"""Port's CNN-LSTM training (train/loops.py) vs the JAX package's, on the CPU.

Small widths (input 12, cnn 8, lstm 8, 2 layers), seeded numpy data, and the
same initial weights on both sides (the JAX init carried into the port).

Dropout is neutralised on both sides, since the two frameworks' random bits
differ: ``dropout_rate=0.0`` for the model's own rates, and the residual
blocks' fixed 0.2 set to 0 on the port's modules and, for the JAX model
(which hard-codes it), by a monkeypatch of ``flax.linen.Dropout`` to the
identity that lives only inside these tests' fixtures.

Two parameters have a true gradient of zero: a conv bias feeding a
train-mode BatchNorm (the batch mean removes it) and the attention score
bias (softmax ignores a shift). Their computed gradients are rounding noise
(~1e-9) in both frameworks, and Adam's normalised step turns noise into a
step of ±lr. The one-step test therefore checks those six for a zero
gradient and a step no larger than lr, and every other parameter to atol
1e-6. The multi-epoch runs use ``adam_eps=1e-5`` on both sides, so noise
gradients move nothing and the histories stay comparable (rtol 1e-4).
"""

import contextlib
from typing import Optional

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.eval import metrics as jax_metrics
from robust_speech_analysis_framework_tpu.eval import splits as jax_splits
from robust_speech_analysis_framework_tpu.data import batching as jax_batching
from robust_speech_analysis_framework_tpu.models.cnn_lstm import CNNLSTM as JaxCNNLSTM
from robust_speech_analysis_framework_tpu.train import checkpoints as jax_ckpt
from robust_speech_analysis_framework_tpu.train import loops as jax_loops
from robust_speech_analysis_framework_tpu_torch.data import batching
from robust_speech_analysis_framework_tpu_torch.eval import metrics, splits
from robust_speech_analysis_framework_tpu_torch.models import cnn_lstm as port_model
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM, dropout
from robust_speech_analysis_framework_tpu_torch.models.init import init_training_weights_
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_flat_from_state_dict,
    cnn_lstm_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.train import checkpoints
from robust_speech_analysis_framework_tpu_torch.train import loops

DIMS = dict(input_dim=12, cnn_out_channels=8, lstm_hidden_dim=8)
LR = 1e-3
PARAM_ATOL = 1e-6  # one Adam step, float32 gradients summed in other orders
HIST_RTOL = 1e-4  # per-epoch mean losses after a few epochs of steps
PROB_ATOL = 1e-4
ZERO_GRAD = (
    "params/res_block1/conv1/bias", "params/res_block1/conv2/bias",
    "params/res_block1/shortcut_conv/bias", "params/res_block2/conv1/bias",
    "params/res_block2/conv2/bias", "params/attention_pooling/score/bias",
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: torch's intra-op threads gain nothing on them
    and, with several test workers on one machine, only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoDropout(flax.linen.Module):
    """Stands in for ``flax.linen.Dropout`` inside these tests: the identity."""

    rate: float = 0.0
    deterministic: Optional[bool] = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@contextlib.contextmanager
def _jax_without_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        yield


def _port_template() -> CNNLSTM:
    model = CNNLSTM(**DIMS, dropout_rate=0.0)
    model.res_block1.dropout = model.res_block2.dropout = 0.0
    return model


def _jax_init(trainer, example: np.ndarray, seed: int, lr: float):
    """The JAX ``train_model``'s own init: PRNGKey(seed) split once."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    return trainer.init_state(init_rng, jnp.asarray(example), lr)


def _flat(state) -> dict:
    return jax_ckpt.flatten_params({"params": state.params, "batch_stats": state.batch_stats})


def _corpus(seed: int, n: int):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(33, 65, size=n)  # one bucket (64) at min_bucket 16
    seqs = [rng.normal(size=(t, 12)).astype(np.float32) for t in lengths]
    labels = np.arange(n) % 2
    for s, y in zip(seqs, labels):
        s[:, :3] += 0.8 * y  # a learnable signal
    return seqs, labels


# --- one train step ---------------------------------------------------------


@pytest.fixture(scope="module", params=[True, False], ids=["lengths", "no_lengths"])
def one_step(request):
    """One train step on both sides, with length masking (the default) and
    without (the reference's unmasked behaviour)."""
    masked = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 64, 12)).astype(np.float32)
    lengths = np.array([64, 41, 9], np.int32)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    labels = np.array([0, 1, 1])
    with _jax_without_dropout():
        jtrainer = jax_loops.Trainer(JaxCNNLSTM(**DIMS, dropout_rate=0.0))
        jstate = _jax_init(jtrainer, x[:1, :16], 0, LR)
        before = _flat(jstate)
        jnew, jloss = jtrainer._train_step(
            jstate, (jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(labels)),
            jax.random.PRNGKey(1), masked, None, False)
    trainer = loops.Trainer(_port_template(), device="cpu")
    state = trainer.init_state(0, LR, cnn_lstm_state_dict_from_flat(before))
    loss = trainer.train_step(state, x, lengths, labels, None, masked)
    return dict(before=before, jax=_flat(jnew), jax_loss=float(jloss), port_state=state,
                port=cnn_lstm_flat_from_state_dict(state.model.state_dict()),
                port_loss=float(loss))


def test_train_step_loss_and_params_match_jax(one_step):
    assert one_step["port_loss"] == pytest.approx(one_step["jax_loss"], abs=1e-6)
    jax_new, port_new, before = one_step["jax"], one_step["port"], one_step["before"]
    assert jax_new.keys() == port_new.keys()
    grads = {n: p.grad for n, p in one_step["port_state"].model.named_parameters()}
    assert float(grads["attention_pooling.attention_weights.bias"].abs().max()) < 1e-6
    assert float(grads["res_block1.conv1.bias"].abs().max()) < 1e-6
    for key in jax_new:
        if not key.startswith("params/"):
            continue
        if key in ZERO_GRAD:
            for new in (jax_new[key], port_new[key]):
                assert np.abs(new - before[key]).max() <= LR * (1 + 1e-5), key
        else:
            np.testing.assert_allclose(port_new[key], jax_new[key], atol=PARAM_ATOL, err_msg=key)
            assert np.abs(port_new[key] - before[key]).max() > 0, key  # it did train


def test_train_step_batchnorm_running_stats_match_jax(one_step):
    stats = [k for k in one_step["jax"] if k.startswith("batch_stats/")]
    assert len(stats) == 10
    for key in stats:
        np.testing.assert_allclose(one_step["port"][key], one_step["jax"][key],
                                   atol=PARAM_ATOL, err_msg=key)
        assert np.abs(one_step["port"][key] - one_step["before"][key]).max() > 1e-4, key


def test_single_bias_adam_step_matches_jax(one_step):
    """Each LSTM direction trains one bias, as the JAX cell has: bias_hh stays
    zero and out of the optimizer, and bias_ih + bias_hh moves by JAX's step
    (about lr per element), not twice it."""
    model = one_step["port_state"].model
    in_opt = {id(p) for g in one_step["port_state"].optimizer.param_groups for p in g["params"]}
    for name, p in model.lstm.named_parameters():
        if name.startswith("bias_hh"):
            assert not p.requires_grad and id(p) not in in_opt and not p.any()
    for cell in ("fwd_0", "bwd_0", "fwd_1", "bwd_1"):
        key = f"params/lstm/{cell}/bias"
        jax_step = one_step["jax"][key] - one_step["before"][key]
        port_step = one_step["port"][key] - one_step["before"][key]
        np.testing.assert_allclose(port_step, jax_step, atol=PARAM_ATOL)
        assert np.abs(jax_step).max() == pytest.approx(LR, rel=1e-2)


def test_training_both_biases_would_double_the_step():
    """The fault the fold prevents: Adam over bias_ih and bias_hh moves the
    effective bias by 2·lr on the first step."""
    model = init_training_weights_(_port_template(), torch.Generator().manual_seed(0))
    torch.nn.init.zeros_(model.lstm.bias_ih_l0)
    torch.nn.init.zeros_(model.lstm.bias_hh_l0)
    opt = torch.optim.Adam([model.lstm.bias_ih_l0, model.lstm.bias_hh_l0], lr=LR)
    model.train()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 12)).astype(np.float32))
    torch.nn.functional.cross_entropy(model(x), torch.tensor([0, 1])).backward()
    opt.step()
    both = (model.lstm.bias_ih_l0 + model.lstm.bias_hh_l0).detach().abs().max()
    assert float(both) == pytest.approx(2 * LR, rel=1e-2)


# --- train_model over a few epochs -------------------------------------------


def _run_both(cfg_kwargs: dict, adam_eps: float = 1e-5, flip_val: bool = False):
    train_x, train_y = _corpus(1, 12)
    val_x, val_y = _corpus(2, 4)
    if flip_val:  # labels against the signal: the val loss rises as the model learns
        val_y = 1 - val_y
    jcfg = jax_loops.TrainConfig(**cfg_kwargs, device_fold="off", parallel_warmup=False)
    pcfg = loops.TrainConfig(**cfg_kwargs)
    with _jax_without_dropout():
        jtrainer = jax_loops.Trainer(JaxCNNLSTM(**DIMS, dropout_rate=0.0), adam_eps=adam_eps)
        example = jax_loops._init_example(train_x, jcfg)
        init = _flat(_jax_init(jtrainer, example, jcfg.seed, jcfg.learning_rate))
        jstate, jtrain, jval = jax_loops.train_model(
            jtrainer, train_x, train_y, val_x, val_y, jcfg)
        jeval = jax_loops.evaluate_model(jtrainer, jstate, val_x, val_y, jcfg)
    trainer = loops.Trainer(_port_template(), adam_eps=adam_eps, device="cpu")
    state, ptrain, pval = loops.train_model(
        trainer, train_x, train_y, val_x, val_y, pcfg,
        initial_weights=cnn_lstm_state_dict_from_flat(init))
    peval = loops.evaluate_model(trainer, state, val_x, val_y, pcfg)
    logits = (jtrainer.eval_logits(jstate, val_x, jcfg), trainer.eval_logits(state, val_x, pcfg))
    return dict(jax=(jstate, jtrain, jval, jeval), port=(state, ptrain, pval, peval),
                logits=logits, val=(val_x, val_y), cfg=pcfg, trainer=trainer,
                jmodel=jtrainer.model)


@pytest.fixture(scope="module")
def three_epochs():
    return _run_both(dict(learning_rate=1e-2, epochs=3, batch_size=4, min_bucket=16,
                          dropout_rate=0.0, seed=0))


def test_train_model_histories_match_jax(three_epochs):
    _, jtrain, jval, _ = three_epochs["jax"]
    _, ptrain, pval, _ = three_epochs["port"]
    assert len(ptrain) == len(pval) == 3
    np.testing.assert_allclose(ptrain, jtrain, rtol=HIST_RTOL)
    np.testing.assert_allclose(pval, jval, rtol=HIST_RTOL)
    assert ptrain[-1] < ptrain[0]  # it learns


def test_train_model_final_logits_match_jax(three_epochs):
    jax_logits, port_logits = three_epochs["logits"]
    assert port_logits.shape == (4, 2)
    np.testing.assert_allclose(port_logits, jax_logits, atol=PROB_ATOL)


def test_evaluate_model_matches_jax(three_epochs):
    """evaluate_model's three outputs: labels, predictions, P(class 1)."""
    jy, jpred, jprob = three_epochs["jax"][3]
    py, ppred, pprob = three_epochs["port"][3]
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(ppred, jpred)
    np.testing.assert_allclose(pprob, jprob, atol=PROB_ATOL)
    assert pprob.shape == (4,) and ((pprob >= 0) & (pprob <= 1)).all()


def test_checkpoint_round_trip_into_jax(three_epochs, tmp_path):
    """A port-trained model → the reference pickle → the JAX CNNLSTM: the same
    logits; and the JAX loader's own checkpoint back into the port."""
    state, ptrain, pval, _ = three_epochs["port"]
    val_x, _ = three_epochs["val"]
    cfg = three_epochs["cfg"]
    path = tmp_path / "model.pkl"
    checkpoints.save_model_checkpoint(str(path), {"dropout_rate": 0.0}, state.model, ptrain, pval)
    payload = jax_ckpt.load_model_checkpoint(str(path))
    assert payload["train_loss_history"] == ptrain
    jmodel = three_epochs["jmodel"]
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 12)), train=False)
    variables = jax_ckpt.unflatten_params(template, payload["model_state_dict"])
    batch, lengths = batching.pad_batch(val_x, min_bucket=16)
    jlogits = np.asarray(jmodel.apply(variables, jnp.asarray(batch), train=False,
                                      lengths=jnp.asarray(lengths)))
    plogits = three_epochs["trainer"].eval_step(state, batch, lengths).numpy()
    np.testing.assert_allclose(plogits, jlogits, atol=1e-5)

    back = tmp_path / "jax_model.pkl"
    jax_ckpt.save_model_checkpoint(str(back), {}, variables, [], [])
    model = _port_template().eval()
    model.load_state_dict(cnn_lstm_state_dict_from_flat(
        checkpoints.load_model_checkpoint(str(back))["model_state_dict"]))
    with torch.no_grad():
        again = model(torch.from_numpy(batch), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(again, plogits, atol=1e-6)


def test_results_pickle_round_trip(tmp_path):
    path = str(tmp_path / "results.pkl")
    checkpoints.save_results_pickle(path, {"auc": [0.5]}, [{"y_true": [0, 1]}], weights=[1.0, 2.0])
    ours = checkpoints.load_results_pickle(path)
    theirs = jax_ckpt.load_results_pickle(path)
    assert ours["results_df"] == theirs["results_df"] == {"auc": [0.5]}
    np.testing.assert_array_equal(ours["weights"], [1.0, 2.0])


def test_early_stop_plateau_and_restore_match_jax():
    """Validation labels set against the training signal, so the val loss
    turns up: plateau decay on every bad epoch, an early stop after two, and
    the best epoch's weights restored, on both sides alike."""
    run = _run_both(dict(learning_rate=1e-2, epochs=10, patience=2, plateau_patience=0,
                         batch_size=4, min_bucket=16, dropout_rate=0.0, seed=3),
                    flip_val=True)
    jstate, jtrain, jval, jeval = run["jax"]
    state, ptrain, pval, peval = run["port"]
    assert len(pval) == len(jval) < 10  # stopped early
    np.testing.assert_allclose(ptrain, jtrain, rtol=HIST_RTOL)
    np.testing.assert_allclose(pval, jval, rtol=HIST_RTOL)
    assert state.lr == pytest.approx(float(jstate.lr), rel=1e-6)
    np.testing.assert_allclose(peval[2], jeval[2], atol=PROB_ATOL)
    # restored: the returned model's val loss is the best epoch's
    best = loops._mean_val_loss(run["trainer"], state, *run["val"], run["cfg"])
    assert best == pytest.approx(min(pval), rel=1e-6)


def test_reduce_lr_on_plateau_matches_jax():
    metrics_seq = [1.0, 0.9, 0.95, 0.91, 0.9, 0.9, 0.89999, 0.7, 0.8, 0.8, 0.8]
    ours, theirs = loops.ReduceLROnPlateau(0.1, 2), jax_loops.ReduceLROnPlateau(0.1, 2)
    lr_a = lr_b = 1e-3
    for m in metrics_seq:
        lr_a, lr_b = ours.step(m, lr_a), theirs.step(m, lr_b)
        assert lr_a == lr_b
    assert lr_a < 1e-3


def test_train_config_defaults_match_jax():
    """Every field of the JAX package's TrainConfig but ``parallel_warmup``
    (it warms up compiled step programs; the port compiles none) is the
    port's, with the same default."""
    ours = {f.name: f.default for f in loops.TrainConfig.__dataclass_fields__.values()}
    theirs = {f.name: f.default for f in jax_loops.TrainConfig.__dataclass_fields__.values()}
    assert theirs.pop("parallel_warmup") is True and "parallel_warmup" not in ours
    assert ours == theirs


def test_remat_matches_plain_training_with_dropout():
    """remat recomputes the forward in the backward pass: with dropout on,
    the recomputation must draw the same masks and must not move the
    BatchNorm running statistics a second time."""
    seqs, labels = _corpus(4, 8)
    results = []
    for remat in (False, True):
        trainer = loops.Trainer(CNNLSTM(**DIMS, dropout_rate=0.3), device="cpu")
        cfg = loops.TrainConfig(epochs=2, batch_size=4, min_bucket=16, remat=remat, seed=5)
        state, train_hist, val_hist = loops.train_model(trainer, seqs, labels, seqs, labels, cfg)
        results.append((train_hist, val_hist, state.model.state_dict()))
    (t0, v0, sd0), (t1, v1, sd1) = results
    np.testing.assert_allclose(t1, t0, rtol=1e-6)
    np.testing.assert_allclose(v1, v0, rtol=1e-6)
    for key in sd0:
        torch.testing.assert_close(sd1[key], sd0[key], rtol=0, atol=1e-6)


# --- the model in train mode ---------------------------------------------------


def test_dropout_share_and_scale():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    out = dropout(x, 0.3, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, out, rtol=0, atol=0)  # the generator decides
    assert dropout(x, 0.0, gen) is x
    assert not dropout(x, 1.0, gen).any()


def test_train_mode_dropout_sites_and_rates():
    """Train mode drops in the residual blocks (fixed 0.2), between biLSTM
    layers and on the pooled vector (the call's rate, else the model's);
    eval mode is deterministic."""
    model = init_training_weights_(CNNLSTM(**DIMS, dropout_rate=0.5),
                                   torch.Generator().manual_seed(0))
    assert model.res_block1.dropout == model.res_block2.dropout == 0.2
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32, 12)).astype(np.float32))
    model.train()
    a = model(x, generator=torch.Generator().manual_seed(1))
    b = model(x, generator=torch.Generator().manual_seed(2))
    c = model(x, generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(a, b)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    model.res_block1.dropout = model.res_block2.dropout = 0.0
    d = model(x, dropout_rate=0.0, generator=torch.Generator().manual_seed(1))
    e = model(x, dropout_rate=0.0, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(d, e, rtol=0, atol=0)  # every site took the rates given
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


def test_bilstm_takes_k5_with_grad_and_k1_without(monkeypatch):
    calls = []
    for name in ("lstm_scan_grouped", "lstm_recurrence_grouped"):
        real = getattr(port_model, name)
        monkeypatch.setattr(port_model, name,
                            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    model = init_training_weights_(CNNLSTM(**DIMS), torch.Generator().manual_seed(0))
    x = torch.zeros(1, 16, 12)
    model.train()
    model(x).sum().backward()
    assert calls == ["lstm_recurrence_grouped"] * 2
    calls.clear()
    model.eval()
    with torch.no_grad():
        model(x)
    assert calls == ["lstm_scan_grouped"] * 2


@pytest.mark.parametrize("seed", [0, 1])
def test_batchnorm_train_mode_matches_flax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, 20, 6)) * 2 + 1).astype(np.float32)  # (B, T, C)
    ra_mean = rng.normal(size=6).astype(np.float32)
    ra_var = rng.uniform(0.5, 2, size=6).astype(np.float32)
    scale = rng.normal(size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    bn = flax.linen.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    ours = port_model.BatchNorm(6).train()
    ours.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(ra_mean),
                          "running_var": torch.from_numpy(ra_var),
                          "num_batches_tracked": torch.tensor(0)})
    out = ours(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-6)


def test_training_init_follows_jax_distributions():
    """Trainer.init_state draws the JAX initialisers: lecun_normal kernels
    (truncated at 2σ), xavier_uniform wx, orthogonal wh, zero biases."""
    model = CNNLSTM(input_dim=64, cnn_out_channels=32, lstm_hidden_dim=16)
    state = loops.Trainer(model, device="cpu").init_state(7, LR)
    m = state.model
    w = m.res_block1.conv1.weight.detach()
    std = (1 / (64 * 3)) ** 0.5
    assert float(w.std()) == pytest.approx(std, rel=0.05)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    wh = m.lstm.weight_hh_l0.detach()  # (4H, H): orthonormal columns
    torch.testing.assert_close(wh.T @ wh, torch.eye(16), rtol=0, atol=1e-5)
    bound = (6 / (32 + 64)) ** 0.5
    assert float(m.lstm.weight_ih_l0.detach().abs().max()) <= bound
    assert not m.lstm.bias_ih_l0.any() and not m.res_block1.conv1.bias.any()
    assert (m.res_block1.bn1.weight == 1).all()
    again = loops.Trainer(model, device="cpu").init_state(7, LR).model
    for (ka, va), (kb, vb) in zip(m.state_dict().items(), again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


# --- splits, metrics and batching copies -------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 123])
def test_folds_bit_identical_to_jax(seed):
    y = np.random.default_rng(seed).integers(0, 2, size=57)
    ours = list(splits.StratifiedKFold(5, shuffle=True, random_state=seed).split(np.zeros(57), y))
    theirs = list(jax_splits.StratifiedKFold(5, shuffle=True, random_state=seed).split(
        np.zeros(57), y))
    for (a_tr, a_te), (b_tr, b_te) in zip(ours, theirs):
        np.testing.assert_array_equal(a_tr, b_tr)
        np.testing.assert_array_equal(a_te, b_te)
    for a, b in zip(splits.train_test_indices(y, seed=seed),
                    jax_splits.train_test_indices(y, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classification_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=30)
    prob = rng.uniform(size=30).round(2)  # ties included
    pred = (prob > 0.5).astype(int)
    assert metrics.classification_metrics(y, pred, prob) == \
        jax_metrics.classification_metrics(y, pred, prob)
    for a, b in zip(metrics.roc_curve(y, prob), jax_metrics.roc_curve(y, prob)):
        np.testing.assert_array_equal(a, b)


def test_batch_order_matches_jax():
    seqs, labels = _corpus(5, 11)
    ours = list(batching.batch_iterator(seqs, labels, 4, shuffle=True, seed=9, min_bucket=16))
    theirs = list(jax_batching.batch_iterator(seqs, labels, 4, shuffle=True, seed=9,
                                              min_bucket=16))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(batching.length_sorted_batches(seqs, 4),
                    jax_batching.length_sorted_batches(seqs, 4)):
        np.testing.assert_array_equal(a, b)
