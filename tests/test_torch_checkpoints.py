"""Port's whole-train-state checkpoints (train/checkpoints.py), on the CPU.

The JAX package saves and restores a whole TrainState with Orbax
(``train/checkpoints.py:98-118``); the port writes one ``torch.save`` file of
the model's and optimizer's state dicts and the rate. The property that
matters is the JAX package's: a run resumed from a checkpoint takes the
step an uninterrupted run would. On the CPU the arithmetic is the same
either way, so the tests hold it bit for bit: parameters, BatchNorm
statistics, Adam's moments and step counts, and the rate, also after a
plateau decay of the rate. Small widths (input 12, cnn 8, lstm 8), seeded
numpy data, dropout on with one seeded generator a step.
"""

import os

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM
from robust_speech_analysis_framework_tpu_torch.train import checkpoints, loops
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

DIMS = dict(input_dim=12, cnn_out_channels=8, lstm_hidden_dim=8)


def _batches(n_steps: int):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_steps):
        x = rng.normal(size=(4, 24, DIMS["input_dim"])).astype(np.float32)
        lengths = np.array([24, 20, 17, 9])
        y = rng.integers(0, 2, size=4)
        out.append((x, lengths, y))
    return out


def _step(trainer, state, batch, i: int):
    x, lengths, y = batch
    trainer.train_step(state, x, lengths, y, torch.Generator().manual_seed(100 + i),
                       dropout_rate=0.5)


def _trainer():
    return loops.Trainer(CNNLSTM(**DIMS), device="cpu")


def _assert_states_equal(a: loops.TrainState, b: loops.TrainState) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:  # parameters and BatchNorm statistics
        assert torch.equal(sa[key], sb[key]), key
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            va, vb = oa["state"][i][key], ob["state"][i][key]
            assert va.device == vb.device and torch.equal(va, vb), (i, key)
    assert a.lr == b.lr


@pytest.mark.parametrize("decayed", [False, True], ids=["rate", "plateau-decayed-rate"])
def test_resumed_step_equals_uninterrupted(tmp_path, decayed):
    batches = _batches(3)
    trainer = _trainer()
    whole = trainer.init_state(seed=3, lr=1e-3)
    for i in range(2):
        _step(trainer, whole, batches[i], i)
    if decayed:  # a plateau: val loss never improves past patience
        sched = loops.ReduceLROnPlateau(factor=0.1, patience=1)
        for loss in (1.0, 1.0, 1.0):
            whole.lr = sched.step(loss, whole.lr)
        assert whole.lr == pytest.approx(1e-4)
    checkpoints.save_train_state(str(tmp_path), whole, step=2)
    assert sorted(os.listdir(tmp_path)) == ["state_2.pt"]  # no temporary left

    resumed = checkpoints.restore_train_state(str(tmp_path), trainer.init_state(seed=9, lr=0.5),
                                              step=2)
    _assert_states_equal(resumed, whole)
    _step(trainer, whole, batches[2], 2)
    _step(trainer, resumed, batches[2], 2)
    _assert_states_equal(resumed, whole)


def test_restore_is_a_fresh_trainers_state(tmp_path):
    """The restored optimizer keeps Adam's step counts where a fresh one
    keeps them (the host), and step 0 is a separate file from step 5."""
    trainer = _trainer()
    state = trainer.init_state(seed=1, lr=1e-3)
    _step(trainer, state, _batches(1)[0], 0)
    checkpoints.save_train_state(str(tmp_path), state, step=5)
    checkpoints.save_train_state(str(tmp_path), trainer.init_state(seed=1, lr=1e-3))
    assert sorted(os.listdir(tmp_path)) == ["state_0.pt", "state_5.pt"]
    fresh = checkpoints.restore_train_state(str(tmp_path), trainer.init_state(seed=2, lr=1e-3))
    assert fresh.optimizer.state_dict()["state"] == {}
    back = checkpoints.restore_train_state(str(tmp_path), trainer.init_state(seed=2, lr=1e-3),
                                           step=5)
    steps = [s["step"] for s in back.optimizer.state_dict()["state"].values()]
    assert steps and all(s.device.type == "cpu" and float(s) == 1.0 for s in steps)


def test_mismatched_template_raises_naming_the_key(tmp_path):
    trainer = _trainer()
    state = trainer.init_state(seed=0, lr=1e-3)
    checkpoints.save_train_state(str(tmp_path), state)

    wider = loops.Trainer(CNNLSTM(input_dim=12, cnn_out_channels=8, lstm_hidden_dim=16),
                          device="cpu").init_state(seed=0, lr=1e-3)
    with pytest.raises(ValueError, match=r"'lstm\.[a-z_.0-9]+' has shape"):
        checkpoints.restore_train_state(str(tmp_path), wider)

    path = os.path.join(tmp_path, "state_0.pt")
    payload = torch.load(path, weights_only=True)
    key = "res_block1.bn1.running_mean"
    assert key in payload["model"]
    del payload["model"][key]
    torch.save(payload, path)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        checkpoints.restore_train_state(str(tmp_path), trainer.init_state(seed=0, lr=1e-3))
