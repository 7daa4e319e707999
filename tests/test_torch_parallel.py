"""The port's multi-device runs on CPU device lists, against its own
single-device runs and the JAX package's multi-device runs (the JAX side on
the 8 virtual CPU devices ``tests/conftest.py`` sets up).

The port drives every device of a :class:`DeviceGrid` from one process, so a
grid of ``[cpu] * n`` runs each split for real: the shards, lanes, sub-batches
and sub-corpora are cut, computed apart and gathered as on n cards. Widths are
narrow and files short (the plain march and pulse twins are Python loops).

Tolerances:

* port grid vs port single device: bit-equal where a split only moves
  whole pieces of work (openSMILE's sub-batches, lanes replicated on the
  lead, the nested engine with the lanes on one device of the grid); MSHDS
  sub-corpora rtol 1e-7 (a file's batch ops see fewer co-files, as the JAX
  package's own test holds them); lanes split into groups take
  ``tests/test_torch_lanes.py``'s tolerances (a lane count changes the
  order of the BatchNorm and grouped-conv gradient sums: histories rtol
  1e-5, parameters atol 1e-5, ``adam_eps=1e-5``); the sharded train step
  sums its gradients and BatchNorm statistics in another order: loss rtol
  1e-6, parameters and statistics rtol 1e-6 with atol 1e-7, Adam moments
  1e-6 of the model's largest moment (a gradient that is a cancelling sum,
  such as ``fc.bias`` on balanced labels, is exact only to its terms'
  rounding), with ``adam_eps=1e-5`` as the CV engine tests run (Adam's first
  step divides each gradient by its own size, so an element near eps would
  turn a last-bit difference into a visible step); the sharded forward
  1e-6; Wav2Vec2 1e-5 (row-parallel partial products summed across the mp
  row), plus one quantisation step for a quantised download;
* port grid vs the JAX package's mesh run: the tolerance of the matching
  single-device parity test (``tests/test_torch_train.py``,
  ``test_torch_trials.py``, ``test_torch_opensmile.py``,
  ``test_torch_mshds.py``, ``test_torch_wav2vec2.py``), 2e-5 for the
  sharded forward as ``tests/test_parallel.py`` holds it.

As in ``tests/test_torch_train.py``, the parameters whose true gradient is
zero (conv biases feeding a train-mode BatchNorm, the attention score bias)
take an Adam step of up to ±lr on rounding noise and are checked apart.
"""

import json
import os
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from robust_speech_analysis_framework_tpu import parallel as jax_parallel
from robust_speech_analysis_framework_tpu.eval import dl_cv as jax_dl_cv
from robust_speech_analysis_framework_tpu.features import mshds as jax_mshds
from robust_speech_analysis_framework_tpu.features import opensmile as jax_os
from robust_speech_analysis_framework_tpu.features.wav2vec2 import (
    Wav2Vec2Extractor as JaxExtractor,
)
from robust_speech_analysis_framework_tpu.models.cnn_lstm import CNNLSTM as JaxCNNLSTM
from robust_speech_analysis_framework_tpu.models.wav2vec2 import (
    Wav2Vec2Config as JaxW2VConfig,
    Wav2Vec2Model as JaxW2VModel,
)
from robust_speech_analysis_framework_tpu.ops.framing import collect as jax_collect
from robust_speech_analysis_framework_tpu.parallel import distributed as jax_distributed
from robust_speech_analysis_framework_tpu.parallel import sharding as jax_sharding
from robust_speech_analysis_framework_tpu.train import checkpoints as jax_ckpt
from robust_speech_analysis_framework_tpu.train import loops as jax_loops
from robust_speech_analysis_framework_tpu_torch.entry import dryrun_multichip
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv
from robust_speech_analysis_framework_tpu_torch.features import mshds
from robust_speech_analysis_framework_tpu_torch.features import opensmile as port_os
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_flat_from_state_dict,
    cnn_lstm_state_dict_from_flat,
    wav2vec2_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.parallel import (
    DeviceGrid,
    auto_mesh,
    batch_sharding,
    make_mesh,
    replicate,
    resolve_mesh,
    split_dim,
)
from robust_speech_analysis_framework_tpu_torch.parallel import distributed
from robust_speech_analysis_framework_tpu_torch.train import loops
from tests.test_torch_dl_cv import (  # noqa: F401  (same_start: a fixture)
    _participants,
    same_start,
)
from tests.test_torch_mshds import ATOL as MSHDS_ATOL
from tests.test_torch_mshds import RTOL as MSHDS_RTOL
from tests.test_torch_mshds import _speechlike
from tests.test_torch_opensmile import VQ, _rel, _speech
from tests.test_torch_train import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    PARAM_ATOL,
    ZERO_GRAD,
    _jax_without_dropout,
    one_torch_thread,
)
from tests.test_torch_trials import HIST_RTOL, PARAM_ATOL as LANE_PARAM_ATOL
from tests.test_torch_trials import NESTED, _data, _jax_lane_flat
from tests.test_torch_wav2vec2 import ATOL as W2V_ATOL
from tests.test_torch_wav2vec2 import SMALL as W2V_SMALL

CPU = torch.device("cpu")
DIMS = dict(input_dim=16, cnn_out_channels=8, lstm_hidden_dim=8)
LR = 1e-3


def _grid(dp: int, mp: int = 1) -> DeviceGrid:
    return make_mesh(devices=[CPU] * (dp * mp), mp=mp)


def _rel_err(a: torch.Tensor, b: torch.Tensor, scale=None) -> float:
    scale = float(b.abs().max()) if scale is None else scale
    return float((a - b).abs().max()) / max(scale, 1e-30)


# --- the grid and the rules ----------------------------------------------------------


@pytest.mark.parametrize("n,mp", [(8, 2), (8, 1), (4, 2), (6, 3)])
def test_grid_shapes_match_jax(n, mp):
    grid = make_mesh(n, mp=mp, devices=[CPU] * 8)
    mesh = jax_parallel.make_mesh(n, mp=mp)
    assert grid.shape == dict(mesh.shape)
    assert grid.axis_names == tuple(mesh.axis_names)
    assert [len(row) for row in grid.rows] == [mp] * (n // mp)
    assert grid.devices == [CPU] * n


def test_divisibility_error_matches_jax():
    with pytest.raises(ValueError) as ours:
        make_mesh(8, mp=3, devices=[CPU] * 8)
    with pytest.raises(ValueError) as theirs:
        jax_parallel.make_mesh(8, mp=3)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="asked for 9 devices"):
        make_mesh(9, devices=[CPU] * 8)  # no quiet shrink to what exists


def test_auto_mesh_is_none_below_two_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has several CUDA devices")
    assert auto_mesh() is None
    assert resolve_mesh("auto", "cpu") is None
    grid = _grid(2)
    assert resolve_mesh(grid, "cpu") is grid and resolve_mesh(None) is None
    with pytest.raises(ValueError):
        resolve_mesh("all")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh()


def test_batch_split_and_replicas_match_jax():
    """dp row r holds the batch rows JAX's ``batch_sharding`` places on the
    devices of mesh row r; ``replicate`` puts one copy on every position."""
    grid = _grid(4, 2)
    mesh = jax_parallel.make_mesh(8, mp=2)
    index = jax_parallel.batch_sharding(mesh, ndim=2).devices_indices_map((8, 3))
    rows = batch_sharding(grid, 8)
    for r, mesh_row in enumerate(mesh.devices):
        for dev in mesh_row:
            assert index[dev][0] == rows[r]
    with pytest.raises(ValueError, match="not divisible by dp=4"):
        batch_sharding(grid, 6)
    t = torch.arange(6.0)
    copies = replicate(grid, t)
    assert [len(row) for row in copies] == [2] * 4
    assert all(c is t for row in copies for c in row)  # one device: the tensor itself


def _jax_paths(params) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(getattr(k, "key", str(k)) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("model", ["cnn_lstm", "wav2vec2"])
def test_rule_table_matches_jax(model):
    """Every parameter's split dim at mp = 2 is the JAX ``_spec_for``'s mp
    dim on the tree its caller shards (the dryrun's ``params``, the
    extractor's whole variables), carried through the weight transpose (a
    full reversal of the axes for every kernel)."""
    mesh = jax_parallel.make_mesh(8, mp=2)
    if model == "cnn_lstm":
        tree = JaxCNNLSTM(**DIMS).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                       train=False)["params"]
        to_port = lambda path, leaf: cnn_lstm_state_dict_from_flat(  # noqa: E731
            {f"params/{path}": leaf})
    else:
        tree = JaxW2VModel(JaxW2VConfig(**W2V_SMALL)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
        to_port = lambda path, leaf: wav2vec2_state_dict_from_flat({path: leaf})  # noqa: E731
    n_split = 0
    for path, leaf in _jax_paths(tree).items():
        spec = jax_sharding._spec_for(path, leaf.ndim, leaf.shape, mesh,
                                      jax_sharding.DEFAULT_PARAM_RULES)
        jdim = list(spec).index("mp") if "mp" in list(spec) else None
        for name, t in to_port(path, np.asarray(leaf)).items():
            want = None if jdim is None else leaf.ndim - 1 - jdim
            assert split_dim(name, t.shape, 2) == want, (name, path, spec)
            n_split += want is not None
    assert n_split >= 8


# --- the sharded forward and train step --------------------------------------------------


@pytest.fixture(scope="module")
def jax_init():
    """Narrow flagship-shaped JAX weights and the port's copy of them."""
    variables = JaxCNNLSTM(**DIMS).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                        train=False)
    flat = jax_ckpt.flatten_params(variables)
    return variables, cnn_lstm_state_dict_from_flat(flat)


def _batch(n: int = 8, t: int = 32, masked: bool = True):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, t, 16)).astype(np.float32)
    lengths = np.array([t, t - 2, 20, t, 17, t, 25, 9][:n], np.int64) if masked \
        else np.full(n, t, np.int64)
    for i, m in enumerate(lengths):
        x[i, m:] = 0.0
    return x, lengths, np.arange(n) % 2


def test_sharded_forward_matches_single_device_and_jax(jax_init):
    variables, sd = jax_init
    x, _, _ = _batch()
    model = CNNLSTM(**DIMS)
    model.load_state_dict(sd)
    ref = model.eval()(torch.from_numpy(x)).detach()
    trainer = loops.Trainer(CNNLSTM(**DIMS), device="cpu")
    state = loops.ShardedTrainState.shard(trainer.init_state(0, LR, sd), _grid(2, 2))
    out = loops.sharded_eval_step(state, x)
    assert _rel_err(out, ref) <= 1e-6

    mesh = jax_parallel.make_mesh(4, mp=2)
    jmodel = JaxCNNLSTM(**DIMS)
    with mesh:
        xs = jax.device_put(jnp.asarray(x), jax_parallel.batch_sharding(mesh))
        ps = jax.device_put(variables["params"],
                            jax_parallel.shard_params(variables["params"], mesh))
        jout = jax.jit(lambda p, b, x: jmodel.apply({"params": p, "batch_stats": b}, x,
                                                    train=False))(
            ps, variables["batch_stats"], xs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5)


def _zero_grad_port_names():
    return {n for n in cnn_lstm_state_dict_from_flat(
        {k: np.zeros(1) for k in ZERO_GRAD})}


def _step_both(dp: int, mp: int, sd, rate: float, masked: bool = True,
               adam_eps: float = 1e-8):
    """One sharded step and one single-device step from ``sd`` with the
    same dropout generator seed."""
    x, lengths, y = _batch(masked=masked)
    model = CNNLSTM(**DIMS, dropout_rate=rate)
    if rate == 0.0:
        model.res_block1.dropout = model.res_block2.dropout = 0.0
    trainer = loops.Trainer(model, adam_eps=adam_eps, device="cpu")
    sharded = loops.ShardedTrainState.shard(trainer.init_state(0, LR, sd), _grid(dp, mp))
    loss = loops.sharded_train_step(sharded, x, lengths, y, torch.Generator().manual_seed(5),
                                    masked=masked)
    single = trainer.init_state(0, LR, sd)
    ref_loss = trainer.train_step(single, x, lengths, y, torch.Generator().manual_seed(5),
                                  masked)
    return sharded, float(loss), single, float(ref_loss)


@pytest.mark.parametrize("dp,mp", [(2, 2), (4, 1), (1, 2)])
def test_sharded_train_step_matches_single_device(jax_init, dp, mp):
    """Dropout on (0.5 between LSTM layers and on the pooled vector, 0.2 in
    the residual blocks), BatchNorm in train mode: the masks and the
    statistics are the whole batch's."""
    _, sd = jax_init
    sharded, loss, single, ref_loss = _step_both(dp, mp, sd, rate=0.5, adam_eps=1e-5)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    ours, ref = sharded.state_dict(), single.model.state_dict()
    assert ours.keys() == ref.keys()
    zero = _zero_grad_port_names()
    for name, v in ref.items():
        if name.endswith("num_batches_tracked"):
            assert int(ours[name]) == int(v) == 1
        elif name in zero:
            assert float((ours[name] - v).abs().max()) <= 2 * LR + 1e-7, name
        else:  # parameters and BatchNorm statistics
            torch.testing.assert_close(ours[name], v, rtol=1e-6, atol=1e-7, msg=name)
    moments = sharded.moments()
    params = dict(single.model.named_parameters())
    scale = max(float(single.optimizer.state[p]["exp_avg"].abs().max())
                for n, p in params.items() if n in moments)
    scale_sq = max(float(single.optimizer.state[p]["exp_avg_sq"].abs().max())
                   for n, p in params.items() if n in moments)
    assert moments.keys() == {n for n, p in params.items() if p.requires_grad}
    for name, (m, v) in moments.items():
        if name in zero:
            continue
        st = single.optimizer.state[params[name]]
        assert _rel_err(m, st["exp_avg"], scale) <= 1e-6, name
        assert _rel_err(v, st["exp_avg_sq"], scale_sq) <= 1e-6, name


def test_sharded_train_step_matches_jax_dryrun_step(jax_init):
    """The JAX dryrun's step body on a dp 2 × mp 2 mesh, from the same
    weights, with dropout off on both sides (the two frameworks' random bits
    differ)."""
    variables, sd = jax_init
    x, lengths, y = _batch(masked=False)
    sharded, loss, _, _ = _step_both(2, 2, sd, rate=0.0, masked=False)

    mesh = jax_parallel.make_mesh(4, mp=2)
    with _jax_without_dropout():
        model = JaxCNNLSTM(**DIMS, dropout_rate=0.0)
        tx = optax.adam(LR)
        params, stats = variables["params"], variables["batch_stats"]
        opt_state = tx.init(params)

        def train_step(params, batch_stats, opt_state, x, y):
            def loss_fn(p):
                logits, updates = model.apply({"params": p, "batch_stats": batch_stats}, x,
                                              train=True, mutable=["batch_stats"],
                                              rngs={"dropout": jax.random.PRNGKey(1)})
                return (optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(),
                        updates["batch_stats"])

            (jloss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, new_opt = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_stats, new_opt, jloss

        p_sh = jax_parallel.shard_params(params, mesh)
        repl = NamedSharding(mesh, P())
        with mesh:
            step = jax.jit(train_step, in_shardings=(
                p_sh, jax.tree.map(lambda _: repl, stats), jax_parallel.shard_params(
                    opt_state, mesh), jax_parallel.batch_sharding(mesh, 3),
                jax_parallel.batch_sharding(mesh, 1)))
            new_params, new_stats, _, jloss = step(params, stats, opt_state, jnp.asarray(x),
                                                   jnp.asarray(y))
    jflat = jax_ckpt.flatten_params({"params": new_params, "batch_stats": new_stats})
    ours = cnn_lstm_flat_from_state_dict(sharded.state_dict())
    assert ours.keys() == jflat.keys()
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    for key, v in jflat.items():
        if key in ZERO_GRAD:
            assert np.abs(ours[key] - v).max() <= 2 * LR + 1e-7, key
        else:
            np.testing.assert_allclose(ours[key], np.asarray(v), atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_runs_on_cpu_device_lists(n):
    out = dryrun_multichip(n, devices=[CPU] * n, verbose=False)
    assert out["grid"].shape == {"dp": n // 2, "mp": 2}
    assert np.isfinite(out["loss"]) and out["cli_extract_rows"] == 4
    assert out["lane_logits"].shape == (n // 2, 4, 2)


# --- trial lanes and the nested engine ------------------------------------------------------

HP = {"cnn_out_channels": 8, "lstm_hidden_dim": 8, "activation_fn": "silu"}


def _lanes(k: int, mesh, rates, seqs=None):
    X, y = _data()
    data = X if seqs is None else seqs
    trainer = loops.Trainer(CNNLSTM(input_dim=10, **HP), adam_eps=1e-5, device="cpu")
    cfg = loops.TrainConfig(learning_rate=1e-3, epochs=3, patience=2, batch_size=4, seed=7,
                            dropout_rate=rates[0], use_plateau=True, restore_best=True)
    lrs = [1e-3 * (i + 1) for i in range(k)]
    tr, va = dl_cv._subset(data, np.arange(8)), dl_cv._subset(data, np.arange(8, len(X)))
    states, hist = loops.train_trials_device(trainer, tr, y[:8], va, y[8:], cfg, lrs,
                                             rates[:k], mesh=mesh)
    logits = trainer.eval_logits_trials_deferred(states, va, cfg).result()
    return states, hist.result(), logits


@pytest.mark.parametrize("k", [4, 3], ids=["split", "replicated"])
def test_train_trials_device_mesh_equals_single_device(k):
    """K = 4 lanes over dp = 2 (two groups of two, each with its own
    generator), and K = 3 (not divisible: replicated, computed once on the
    lead), with dropout on and plateau decay, over a resident corpus's view:
    lane by lane the single-device run (bit for bit when replicated)."""
    X, _ = _data()
    view = loops.DeviceCorpus(X, device="cpu").view(np.arange(len(X)))
    rates = [0.2, 0.3, 0.4, 0.45]
    ref_states, ref_hist, ref_logits = _lanes(k, None, rates, view)
    states, hist, logits = _lanes(k, _grid(2), rates, view)
    assert isinstance(states, loops.LaneGroups) and states.lanes == k
    assert len(states.parts) == (2 if k == 4 else 1)
    exact = k == 3
    for (th, vh), (rth, rvh) in zip(hist, ref_hist):
        assert len(th) == len(rth) and len(vh) == len(rvh)
        np.testing.assert_allclose(th, rth, rtol=0 if exact else 1e-5)
        np.testing.assert_allclose(vh, rvh, rtol=0 if exact else 1e-5)
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=0 if exact else 1e-5)
    for i in range(k):
        a, b = states.lane_state(i), ref_states.lane_state(i)
        for name, v in b.model.state_dict().items():
            torch.testing.assert_close(a.model.state_dict()[name], v, rtol=0,
                                       atol=0 if exact else 1e-5, msg=name)
        assert a.lr == b.lr


def test_train_trials_device_mesh_matches_jax(same_start):
    """Four lanes over dp = 2 on both sides, from the same start, dropout off."""
    X, y = _data()
    split = (X[:8], y[:8], X[8:], y[8:])
    lrs = [1e-3, 5e-3, 3e-3, 2e-3]
    trainer = dl_cv._TrainerCache(input_dim=10, device="cpu").get(HP)
    jtrainer = jax_dl_cv._TrainerCache(input_dim=10).get(HP)
    kw = dict(epochs=3, patience=4, batch_size=4, seed=7, dropout_rate=0.0, use_plateau=False,
              restore_best=False)
    states, hist = loops.train_trials_device(
        trainer, *split, loops.TrainConfig(learning_rate=lrs[0], **kw), lrs, [0.0] * 4,
        mesh=_grid(2))
    jstates, jhist = jax_loops.train_trials_device(
        jtrainer, *split, jax_loops.TrainConfig(learning_rate=lrs[0], **kw), lrs, [0.0] * 4,
        mesh=jax_parallel.make_mesh(2))
    for (th, vh), (jth, jvh) in zip(hist.result(), jax_collect([jhist])[0]):
        np.testing.assert_allclose(th, jth, rtol=HIST_RTOL)
        np.testing.assert_allclose(vh, jvh, rtol=HIST_RTOL)
    for i in range(4):
        mine = cnn_lstm_flat_from_state_dict(states.lane_state(i).model.state_dict())
        for key, v in _jax_lane_flat(jstates, i).items():
            np.testing.assert_allclose(mine[key], v, rtol=0, atol=LANE_PARAM_ATOL, err_msg=key)


def test_nested_cv_mesh_equals_single_device():
    """Rounds of 4 trials whose lanes split over dp = 2, dropout on: the same
    best parameters, predictions and stability vectors, bit for bit."""
    seqs, meta = _participants()
    X, y, _ = dl_cv.align_sequences_and_labels(seqs, meta)
    kw = dict(NESTED, search_space=dict(NESTED["search_space"],
                                        dropout_rate=("float", 0.2, 0.5)))
    ref = dl_cv.nested_cv(X, y, device="cpu", **kw)
    got = dl_cv.nested_cv(X, y, mesh=_grid(2), **kw)
    assert [r["best_params"] for r in got[0]] == [r["best_params"] for r in ref[0]]
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a["y_prob"], b["y_prob"])
    np.testing.assert_array_equal(got[2], ref[2])


def test_resident_corpus_on_one_device_is_copied_to_every_device_of_a_grid():
    """The JAX fault at ``eval/dl_cv.py:179`` (a resident view handed to a
    multi-device run unchanged) is not copied: a view of a corpus on one
    device meets a grid whose second device is another one (``meta``, so
    nothing runs there) and comes out with a copy on it, made before any
    trial starts; the view returned reads the grid's lead device."""
    X, y = _data()
    view = loops.DeviceCorpus(X, device="cpu").view(np.arange(len(X)))
    grid = DeviceGrid([CPU, torch.device("meta")])
    out = dl_cv._as_device_corpus(view, mesh=grid)
    assert out.corpus.x.device == CPU and np.array_equal(out.idx, view.idx)
    replica = view.corpus._replicas[torch.device("meta")]
    assert replica.x.device.type == "meta" and replica.x.shape == view.corpus.x.shape
    assert out.on("meta").corpus is replica  # made once, shared by every replica
    # a host list meeting the grid goes up to the lead and is copied the same way
    lst = dl_cv._as_device_corpus(X, mesh=grid)
    assert lst.corpus.x.device == CPU and torch.device("meta") in lst.corpus._replicas


# --- the extractors ------------------------------------------------------------------------------

OS_WAVES = {f"p{i}.wav": _speech(0.5 + 0.02 * i, 125 + 10 * i, 10 + i) for i in range(5)}


@pytest.fixture(scope="module")
def opensmile_single():
    return port_os.OpenSmileExtractor(pipeline_rows=2, device="cpu").extract_arrays(
        OS_WAVES, verbose=False)


@pytest.mark.parametrize("dp", [2, 4])
def test_opensmile_mesh_equals_single_device(opensmile_single, dp):
    """Three sub-batches of two files dealt over the dp rows: every row
    equal to the single-device row, in its order."""
    names, feats = port_os.OpenSmileExtractor(pipeline_rows=2, device="cpu").extract_arrays(
        OS_WAVES, verbose=False, mesh=_grid(dp))
    assert names == opensmile_single[0]
    np.testing.assert_array_equal(feats, opensmile_single[1])


def test_opensmile_mesh_matches_jax(opensmile_single):
    mesh = jax_parallel.make_mesh(2, mp=1)
    ref = jax_os.OpenSmileExtractor().extract_batch(OS_WAVES, verbose=False, mesh=mesh)
    got = port_os.OpenSmileExtractor(pipeline_rows=2, device="cpu").extract_batch(
        OS_WAVES, verbose=False, mesh=_grid(2))
    cols = jax_os.feature_columns()
    a = got.set_index("filename").loc[sorted(OS_WAVES)][cols].to_numpy()
    b = ref.set_index("filename").loc[sorted(OS_WAVES)][cols].to_numpy()
    assert np.isfinite(a).all()
    rel = _rel(a, b)
    vq = np.array([any(k in c for k in VQ) for c in cols])
    assert np.nanmedian(rel) < 1e-5
    assert np.nanmean(rel[:, ~vq]) < 2e-4
    assert np.nanmean(rel[:, vq]) < 5e-2


def test_mshds_devices_equal_single_device_and_jax():
    """Files round-robin into a sub-corpus a device, each extracted from
    its own host thread: the rows of the single-device run, in order (to
    the JAX package's own multi-device tolerance, ``tests/test_parallel.py``:
    a file's batch ops see fewer co-files); and the JAX package's
    ``devices=`` run within the MSHDS parity tolerances."""
    xs = [_speechlike(110, 0.3, 4, seed=0), _speechlike(220, 0.35, 4, seed=1),
          _speechlike(150, 0.25, 3, seed=2)]
    ref = mshds.extract_mshds_arrays(xs, 16000, device="cpu")
    got = mshds.extract_mshds_arrays(xs, 16000, devices=[CPU, CPU])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=0)
    jref = jax_mshds.extract_mshds_batch({f"m{i}": x for i, x in enumerate(xs)}, sr=16000,
                                         verbose=False, devices=jax.devices()[:2])
    for j, name in enumerate(mshds.FEATURE_NAMES):
        np.testing.assert_allclose(got[:, j], jref[name].to_numpy(float),
                                   rtol=MSHDS_RTOL.get(name, 0.0),
                                   atol=MSHDS_ATOL.get(name, 0.0), err_msg=name)


@pytest.fixture(scope="module")
def w2v_params():
    model = JaxW2VModel(JaxW2VConfig(**W2V_SMALL))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


@pytest.mark.parametrize("transfer", [np.float32, np.int16], ids=["f32", "int16"])
def test_wav2vec2_mesh_matches_single_device_and_jax(w2v_params, transfer):
    """dp 2 × mp 2: chunk batches over dp, the encoder's weights over mp
    (column-parallel q/k/v/ff1, row-parallel out/ff2 summed across the
    row, the convs and the projection by output channel)."""
    rng = np.random.default_rng(4)
    waves = {"one.wav": (rng.normal(size=19200) * 0.1).astype(np.float32),
             "long.wav": (rng.normal(size=152000) * 0.1).astype(np.float32)}
    sd = wav2vec2_state_dict_from_flat(jax_ckpt.flatten_params(w2v_params))
    kw = dict(params=sd, config=Wav2Vec2Config(**W2V_SMALL), batch_size=4,
              sequence_transfer_dtype=transfer)
    ref = Wav2Vec2Extractor(device="cpu", **kw).extract_sequences(waves, verbose=False)
    ex = Wav2Vec2Extractor(mesh=_grid(2, 2), **kw)
    assert ex.device == CPU
    got = ex.extract_sequences(waves, verbose=False)
    jref = JaxExtractor(params=w2v_params, config=JaxW2VConfig(**W2V_SMALL), batch_size=4,
                        sequence_transfer_dtype=transfer,
                        mesh=jax_parallel.make_mesh(4, mp=2)).extract_sequences(
        waves, verbose=False)
    assert sorted(got) == sorted(ref) == sorted(jref)
    for name in ref:
        # a quantised download may round a value to the next step of its frame
        step = 0.0 if transfer is np.float32 else float(np.abs(ref[name]).max()) / 32767
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-5 + step)
        np.testing.assert_allclose(got[name], jref[name], rtol=0, atol=W2V_ATOL + step)
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        Wav2Vec2Extractor(mesh=_grid(2, 2), **dict(kw, batch_size=3))


# --- the multi-host helpers ---------------------------------------------------------------------

FILES = [f"f{i}.wav" for i in range(7)]


def _dist_worker(rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    joined = distributed.initialize_distributed(
        init_method=f"file://{store}", world_size=2, rank=rank, device="cpu")
    try:
        result = {"joined": joined, "backend": dist.get_backend(),
                  "files": distributed.shard_file_list(FILES),
                  "gathered": distributed.all_gather_host_objects({"rank": rank})}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh)


def test_distributed_helpers_in_a_gloo_world_of_two(tmp_path, monkeypatch):
    ctx = torch.multiprocessing.spawn(
        _dist_worker, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=2, join=False)
    deadline = time.monotonic() + 60.0
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail("the gloo world of two did not finish in 60 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as fh:
            result = json.load(fh)
        assert result["joined"] is True and result["backend"] == "gloo"
        assert result["gathered"] == [{"rank": 0}, {"rank": 1}]
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        assert result["files"] == jax_distributed.shard_file_list(FILES)
    # outside a process group: a world of one
    assert distributed.initialize_distributed(world_size=1) is False
    assert distributed.shard_file_list(FILES) == FILES
    assert distributed.all_gather_host_objects("x") == ["x"]
