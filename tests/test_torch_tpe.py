"""The port's TPE (tune/tpe.py) vs the JAX package's: the same seed gives the
same study, exactly (both are numpy; the port keeps its own copy so that it
imports nothing of the JAX package)."""

import math

import numpy as np
import pytest

from robust_speech_analysis_framework_tpu import tune as jax_tune
from robust_speech_analysis_framework_tpu.eval import dl_cv as jax_dl_cv
from robust_speech_analysis_framework_tpu_torch import tune
from robust_speech_analysis_framework_tpu_torch.eval import dl_cv

SPACE = {
    "learning_rate": ("float_log", 1e-5, 1e-3),
    "dropout_rate": ("float", 0.2, 0.5),
    "cnn_out_channels": ("categorical", [32, 64, 128]),
    "lstm_hidden_dim": ("categorical", [64, 128]),
    "activation_fn": ("categorical", ["silu", "gelu"]),
}


def _objective(trial):
    lr = trial.suggest_float("lr", 1e-5, 1e-3, log=True)
    d = trial.suggest_float("dropout", 0.2, 0.5)
    layers = trial.suggest_int("layers", 1, 4)
    c = trial.suggest_categorical("channels", [32, 64, 128])
    return (math.log10(lr) + 4) ** 2 + (d - 0.3) ** 2 + 0.1 * layers + c / 1000


def _score(params):
    return (-(math.log10(params["learning_rate"]) + 3.5) ** 2 - params["dropout_rate"]
            + params["cnn_out_channels"] / 500 + (params["activation_fn"] == "gelu") * 0.05)


def _same_trials(ours, theirs):
    assert len(ours.trials) == len(theirs.trials)
    for a, b in zip(ours.trials, theirs.trials):
        assert a == b  # number, params, value, raw_value: exact


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_optimize_gives_the_same_study(seed, direction):
    """40 trials: 10 random startup trials, then 30 from the Parzen models
    of floats, log-floats, ints and categoricals."""
    ours = tune.create_study(direction=direction, seed=seed)
    theirs = jax_tune.create_study(direction=direction, seed=seed)
    ours.optimize(_objective, n_trials=40)
    theirs.optimize(_objective, n_trials=40)
    _same_trials(ours, theirs)
    assert ours.best_params == theirs.best_params
    assert ours.best_value == theirs.best_value
    assert ours.best_trial["number"] == theirs.best_trial["number"]


@pytest.mark.parametrize("seed", [1, 5])
def test_ask_tell_rounds_give_the_same_study(seed):
    """Rounds of four asks told back together, through each package's own
    ``_suggest_params``."""
    studies = [
        (tune.Study(direction="maximize", sampler=tune.TPESampler(seed=seed, n_startup_trials=4)),
         dl_cv._suggest_params),
        (jax_tune.Study(direction="maximize",
                        sampler=jax_tune.TPESampler(seed=seed, n_startup_trials=4)),
         jax_dl_cv._suggest_params),
    ]
    for study, suggest in studies:
        for _ in range(5):
            asked = [study.ask() for _ in range(4)]
            scores = [_score(suggest(t, SPACE)) for t in asked]
            for t, s in zip(asked, scores):
                study.tell(t, s)
    _same_trials(studies[0][0], studies[1][0])
    assert studies[0][0].best_params == studies[1][0].best_params


def test_suggest_round_pins_the_architecture_like_jax():
    """``_suggest_round``: categoricals drawn once a round and recorded on
    every trial, floats per trial; the same rounds on both sides."""
    rounds = []
    for mod_tune, mod_cv in ((tune, dl_cv), (jax_tune, jax_dl_cv)):
        study = mod_tune.Study(direction="maximize",
                               sampler=mod_tune.TPESampler(seed=3, n_startup_trials=4))
        out = []
        for _ in range(4):
            asked = [study.ask() for _ in range(3)]
            plist = mod_cv._suggest_round(asked, SPACE)
            for t, p in zip(asked, plist):
                assert t.params == p
                study.tell(t, _score(p))
            out.append(plist)
        rounds.append(out)
    assert rounds[0] == rounds[1]
    for plist in rounds[0]:
        assert len({dl_cv._arch_key(p) for p in plist}) == 1  # one architecture a round
        assert len({p["learning_rate"] for p in plist}) == 3  # floats vary
    assert len({dl_cv._arch_key(p) for plist in rounds[0] for p in plist}) > 1


def test_search_space_and_arch_key_match_jax():
    assert dl_cv.DEFAULT_SEARCH_SPACE == jax_dl_cv.DEFAULT_SEARCH_SPACE
    for p in ({}, {"cnn_out_channels": 32, "lstm_hidden_dim": 64, "activation_fn": "gelu"}):
        assert dl_cv._arch_key(p) == jax_dl_cv._arch_key(p)


def test_study_contract():
    """The parts of the study's contract no parity case reaches: the guard
    against a re-suggested space, callbacks, and the errors."""
    study = tune.create_study(seed=0)
    with pytest.raises(ValueError, match="No completed trials"):
        study.best_trial
    seen = []
    study.optimize(lambda t: t.suggest_float("x", 0.0, 1.0), n_trials=3,
                   callbacks=[lambda s, t: seen.append(t["number"])])
    assert seen == [0, 1, 2]
    with pytest.raises(ValueError, match="different space"):
        study.ask().suggest_float("x", 0.0, 2.0)
    with pytest.raises(ValueError, match="Unknown direction"):
        tune.Study(direction="up")
    assert np.isfinite(study.best_value)
