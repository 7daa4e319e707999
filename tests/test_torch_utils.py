"""The port's instrumentation and reliability helpers (``utils/``) against the
JAX package's, case by case (``tests/test_utils.py``), on the CPU."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu import utils as jax_utils
from robust_speech_analysis_framework_tpu.utils import profiling as jax_profiling
from robust_speech_analysis_framework_tpu_torch import utils
from robust_speech_analysis_framework_tpu_torch.models.cnn_lstm import CNNLSTM
from robust_speech_analysis_framework_tpu_torch.utils import profiling


def _fill(meter):
    meter.add("extract", 2.0, audio_seconds=100.0, items=10)
    meter.add("extract", 2.0, audio_seconds=100.0, items=10)
    meter.add("train", 1.5, items=3)
    return meter


def test_throughput_meter_matches_jax():
    ours, theirs = _fill(utils.ThroughputMeter()), _fill(jax_utils.ThroughputMeter())
    assert ours.stages["extract"].audio_sec_per_sec == pytest.approx(50.0)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.report() == theirs.report()


def test_stage_timer_times_and_syncs():
    """``sync`` names the tensors to wait for; on the CPU there is nothing to
    wait for, on the card their devices are synchronised."""
    m = utils.ThroughputMeter()
    x = torch.ones(100, 100)
    with utils.stage_timer(m, "matmul", audio_seconds=1.0, items=2, sync=[x, {"y": x}]):
        x @ x
    assert m.stages["matmul"].seconds > 0 and m.stages["matmul"].items == 2
    assert m.stages["matmul"].audio_seconds == 1.0
    with utils.stage_timer(None, "nothing"):  # no meter: timed into nothing
        pass


def test_deterministic_check_of_a_reduction_matches_jax():
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    f = jax.jit(lambda v: jnp.cumsum(jnp.sin(v) * 1e3))
    assert jax_utils.deterministic_check(lambda: f(jnp.asarray(x)), runs=3)
    t = torch.from_numpy(x)
    assert utils.deterministic_check(lambda: torch.cumsum(torch.sin(t) * 1e3, 0), runs=3)
    draws = iter(range(10))
    assert not utils.deterministic_check(lambda: torch.tensor([next(draws)]))
    assert utils.deterministic_check(lambda: {"a": (t, np.float32(np.nan))})


def test_model_forward_deterministic():
    model = CNNLSTM(input_dim=8, cnn_out_channels=4, lstm_hidden_dim=4).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 8)).astype(np.float32))
    with torch.no_grad():
        assert utils.deterministic_check(lambda: model(x), runs=3)


def _oom_fn(calls, error):
    def fn(batch):
        calls.append(len(batch))
        if len(batch) > 2:
            raise error
        return [x * 10 for x in batch]

    return fn


def test_oom_downshift_splits_as_jax_does():
    ours, theirs = [], []
    out = utils.with_oom_downshift(
        _oom_fn(ours, torch.cuda.OutOfMemoryError("CUDA out of memory")), [1, 2, 3, 4, 5, 6, 7, 8])
    ref = jax_utils.with_oom_downshift(
        _oom_fn(theirs, RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
        [1, 2, 3, 4, 5, 6, 7, 8])
    assert out == ref == [10, 20, 30, 40, 50, 60, 70, 80]
    assert ours == theirs and max(ours[1:]) <= 4  # the same halvings
    with pytest.raises(torch.cuda.OutOfMemoryError):  # one item that still does not fit
        utils.with_oom_downshift(lambda b: (_ for _ in ()).throw(
            torch.cuda.OutOfMemoryError("CUDA out of memory")), [1])


def test_oom_downshift_propagates_other_errors():
    def fn(batch):
        raise ValueError("not an oom")

    with pytest.raises(ValueError):
        utils.with_oom_downshift(fn, [1, 2, 3])
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):  # keyed on the type only
        utils.with_oom_downshift(_oom_fn([], RuntimeError("RESOURCE_EXHAUSTED: oom")), [1, 2, 3])
    assert utils.with_oom_downshift(fn, []) == []


def test_logger_matches_jax(monkeypatch):
    monkeypatch.setenv("RSAF_LOG_LEVEL", "WARNING")
    ours = utils.get_logger("rsaf.torch_test")
    theirs = jax_utils.get_logger("rsaf.jax_test")
    assert ours.name == "rsaf.torch_test" and ours.level == theirs.level == logging.WARNING
    assert len(ours.handlers) == 1 and not ours.propagate
    assert utils.get_logger("rsaf.torch_test", level="DEBUG") is ours
    assert ours.level == logging.DEBUG and len(ours.handlers) == 1
    assert (ours.handlers[0].formatter._fmt == theirs.handlers[0].formatter._fmt)


def test_spans_match_jax():
    """Inside ``tracing()`` the port's spans count the calls the JAX package's
    always-on spans count; outside it they record nothing, which the JAX
    package's do not offer (parity given up on purpose: the port's spans sit
    in hot loops and cost two flag reads while off)."""
    utils.span_report(reset=True)
    jax_profiling.span_report(reset=True)
    for label in ("upload", "upload", "compile"):
        with profiling.span(label), jax_profiling.span(label):
            pass
    assert utils.span_report() == {}
    with utils.tracing():
        for label in ("upload", "upload", "compile"):
            with profiling.span(label):
                pass
    ours, theirs = utils.span_report(), jax_profiling.span_report(reset=True)
    assert {k: v["calls"] for k, v in ours.items()} == {k: v["calls"] for k, v in theirs.items()}
    assert ours["upload"]["calls"] == 2 and ours["upload"]["seconds"] >= 0
    assert ours["upload"]["self_seconds"] == ours["upload"]["seconds"]  # no child spans
    assert utils.span_report(reset=True) == ours and utils.span_report() == {}
