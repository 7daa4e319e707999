"""Whole runs of every cell at tiny sizes on the CPU, past the harness's look
for a card: sound runs come out correct, and runs with the timed path broken
underneath come out not correct, once for each fault a cell can have (one
chip: no exchange between chips to leave out). The control, the plain
reference in TF32 in the program's place, needs the card."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from port_bench import run as harness
from port_bench.tests.tiny import REPO, tiny_root

CELLS = ["flagship-score-b128", "flagship-train-lanes8", "w2v2-extract-androids"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _run(root: str, cell: str, trace: int = 0, seed: int = 2**31 + 99) -> dict:
    args = harness.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                               "--trace", str(trace)])
    return harness.run(args, root=root, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(root, cell):
    result = _run(root, cell)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared" and result["attempted"] > 0 and result["failed"] == 0
    cfg = harness.load_cell(cell, root)
    assert set(result["metrics"]) == {m["name"] for m in cfg.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_gives_busy_window_and_breakdown(root, cell):
    result = _run(root, cell, trace=1)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())
    names = {m["name"] for m in harness.load_cell(cell, root).per_layer}
    assert set(result["metrics"]) <= names


def _alter_classifier(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.models import cnn_lstm

    forward = cnn_lstm.CNNLSTM.forward
    monkeypatch.setattr(cnn_lstm.CNNLSTM, "forward",
                        lambda self, *a, **k: forward(self, *a, **k) * 1.01)


def _alter_sequences(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.features import wav2vec2

    quantize = wav2vec2.quantize_sequences
    monkeypatch.setattr(wav2vec2, "quantize_sequences",
                        lambda hidden, transfer: quantize(hidden * 1.01, transfer))


def _state_unchanged(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.train import loops

    monkeypatch.setattr(loops.LaneAdam, "step", lambda self, lr: None)


def _half_batch(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.train import loops

    loss = loops._lane_cross_entropy
    monkeypatch.setattr(loops, "_lane_cross_entropy",
                        lambda logits, labels: loss(logits[:, : labels.shape[0] // 2],
                                                    labels[: labels.shape[0] // 2]))


def _fast_lane_lr(monkeypatch):
    """The last lane's learning rate doubled as the lanes are set up."""
    from robust_speech_analysis_framework_tpu_torch.train import loops

    replicate = loops.LaneTrainState.replicate.__func__

    def doubled(cls, state, lr):
        lr = lr.clone()
        lr[-1] *= 2.0
        return replicate(cls, state, lr)

    monkeypatch.setattr(loops.LaneTrainState, "replicate", classmethod(doubled))


def _stale_after_first_steps(monkeypatch):
    """Past a round's first steps, every step returns the state unchanged."""
    from robust_speech_analysis_framework_tpu_torch.train import loops

    step = loops.LaneAdam.step
    monkeypatch.setattr(loops.LaneAdam, "step",
                        lambda self, lr: step(self, lr) if self.steps[0] < 5 else None)


def _alter_eval(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.train import loops

    eval_step = loops.Trainer.eval_step_lanes
    monkeypatch.setattr(loops.Trainer, "eval_step_lanes",
                        lambda self, *a, **k: eval_step(self, *a, **k) * 1.01)


def _alter_loss(monkeypatch):
    from robust_speech_analysis_framework_tpu_torch.train import loops

    loss = loops._lane_cross_entropy
    monkeypatch.setattr(loops, "_lane_cross_entropy", lambda *a: loss(*a) * 1.01)


FAULTS = [
    ("flagship-score-b128", _alter_classifier, "logit_err"),
    ("flagship-train-lanes8", _state_unchanged, "change_gap_slow_lane"),
    ("flagship-train-lanes8", _half_batch, "loss_gap_step1"),
    ("flagship-train-lanes8", _alter_loss, "loss_gap_step1"),
    ("flagship-train-lanes8", _fast_lane_lr, "change_gap_step1"),
    ("flagship-train-lanes8", _stale_after_first_steps, "last_change_gap"),
    ("flagship-train-lanes8", _alter_eval, "eval_logit_err"),
    ("w2v2-extract-androids", _alter_sequences, "sequence_err"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _ in FAULTS])
def test_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    result = _run(root, cell)
    assert not result["correct"]
    assert result["compared"][number]["value"] > result["compared"][number]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control computes in TF32, which only the card has")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct(card, cell, tmp_path):
    """The reference in TF32 put in the program's place fails the cell's
    limits, at the cell's own size and load."""
    from port_bench import control

    rows = control.readings(cell, [2**31 + 3], seconds=2.0, root=REPO)
    limits = harness.load_cell(cell, REPO).workload["limits"]
    for row in rows:
        assert any(row["control"][n] > limits[n] for n in limits), row


def test_state_left_unchanged_reads_one():
    from port_bench.common import worst_leaf_gap

    ref = {"a": 1.0, "b": 3.0, "c": 0.5}
    assert worst_leaf_gap({k: 0.0 for k in ref}, ref) == pytest.approx(1.0)
    assert np.isclose(worst_leaf_gap(ref, ref), 0.0)
