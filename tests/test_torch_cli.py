"""The port's CLI and flagship entry vs the JAX package's, on the CPU.

The ``svm`` command on the float64 host solver prints the JAX CLI's lines
character for character (the same CSVs, the same numbers); ``extract``
writes the JAX schema; the precision presets map to the same extractor
options. The flagship entry carries the JAX entry's weights and input and
gives its logits within ATOL (1e-4, the CNN-LSTM parity tests' bound).
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from robust_speech_analysis_framework_tpu import cli as jax_cli
from robust_speech_analysis_framework_tpu.features.mshds import FEATURE_NAMES as JAX_MSHDS
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch import cli
from robust_speech_analysis_framework_tpu_torch.entry import entry
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    cnn_lstm_state_dict_from_flat,
)
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-4
SUBCOMMANDS = ("extract", "svm", "cnnlstm", "predict", "reproduce")


def test_cli_requires_command():
    with pytest.raises(SystemExit):
        cli.main([])


def test_cli_help_lists_subcommands(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    for cmd in SUBCOMMANDS:
        assert cmd in out
    assert "bench" not in out


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_every_subcommand_takes_a_device(cmd, capsys):
    with pytest.raises(SystemExit) as exit_:
        cli.main([cmd, "--help"])
    assert exit_.value.code == 0
    assert "--device {cuda,cpu}" in capsys.readouterr().out


def test_bench_is_not_carried():
    with pytest.raises(SystemExit):
        cli.main(["bench"])


def test_extract_fails_fast_without_a_wav2vec2_checkpoint(tmp_path, capsys):
    rc = cli.main(["extract", "--corpus", str(tmp_path), "--out", str(tmp_path / "o"),
                   "--device", "cpu"])
    assert rc == 2
    assert "wav2vec2-checkpoint" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("precision", ["strict", "fast", "fastest"])
def test_precision_presets_match_jax(precision):
    assert cli._w2v2_precision_kwargs(precision) == jax_cli._w2v2_precision_kwargs(precision)


def _one_file_corpus(root):
    import struct
    import wave

    hc = root / "c" / "Reading-Task" / "audio" / "HC"
    hc.mkdir(parents=True)
    (root / "c" / "Interview-Task" / "audio_clip").mkdir(parents=True)
    with wave.open(str(hc / "01_CF30_1.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        t = np.arange(16000) / 16000
        x = (0.3 * np.sin(2 * np.pi * 150 * t) * 32767).astype("<i2")
        w.writeframes(struct.pack(f"<{len(x)}h", *x))
    (root / "c" / "fold-lists.csv").write_text("b,,\nfold1,fold1.1\n,\n")
    return root / "c"


def test_extract_mshds_on_the_cpu(tmp_path, capsys):
    corpus = _one_file_corpus(tmp_path)
    rc = cli.main(["extract", "--corpus", str(corpus), "--out", str(tmp_path / "out"),
                   "--features", "mshds", "--quiet", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "features_mshds_reading_task.csv" in out
    df = pd.read_csv(tmp_path / "out" / "features_mshds_reading_task.csv")
    assert list(df.columns[-len(JAX_MSHDS):]) == JAX_MSHDS and len(df) == 1
    assert 140 < df["mean_F0"].iloc[0] < 160


def test_default_device_is_the_card(tmp_path):
    corpus = _one_file_corpus(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["extract", "--corpus", str(corpus), "--out", str(tmp_path / "out"),
                  "--features", "mshds", "--quiet"])


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """Six feature CSVs of 20 participants in the extraction's schema, with
    random features (a few columns each) and one NaN."""
    out = tmp_path_factory.mktemp("processed")
    rng = np.random.default_rng(0)
    widths = {"mshds": 6, "opensmile": 9, "wav2vec2": 5}
    meta = []
    for i in range(20):
        cond = "CP"[i % 2]
        meta.append({"unique_participant_id": f"{i + 1:02d}_{cond}F{30 + i}_1",
                     "original_id_nn": i + 1, "label": "Control" if cond == "C" else "Patient",
                     "gender": "F", "age": 30 + i, "education": 1,
                     "filepath": f"/x/{i}.wav", "filename": f"{i + 1:02d}_{cond}F{30 + i}_1.wav",
                     "task_type": "Reading", "fold": -1})
    y = np.array([m["label"] == "Patient" for m in meta], float)
    for fs, w in widths.items():
        feats = rng.normal(size=(20, w)) + 0.8 * y[:, None] * (np.arange(w) < 2)
        reading = pd.DataFrame(meta).join(pd.DataFrame(feats, columns=[f"{fs}{k}" for k in
                                                                         range(w)]))
        if fs == "mshds":
            reading.loc[3, "mshds1"] = np.nan
        reading.to_csv(out / f"features_{fs}_reading_task.csv", index=False)
        agg = pd.DataFrame(rng.normal(size=(20, 2 * w)) + 0.5 * y[:, None],
                           columns=[f"{fs}{k}_{s}" for k in range(w) for s in ("mean", "std")])
        agg.insert(0, "unique_participant_id", [m["unique_participant_id"] for m in meta])
        agg.to_csv(out / f"features_{fs}_interview_task_aggregated.csv", index=False)
    return out


def test_svm_on_the_host_solver_prints_jax_numbers(processed, tmp_path, capsys):
    assert jax_cli.main(["svm", "--processed", str(processed), "--quiet"]) == 0
    theirs = capsys.readouterr().out.splitlines()
    pkl = tmp_path / "all.pkl"
    assert cli.main(["svm", "--processed", str(processed), "--out", str(pkl), "--quiet",
                     "--solver", "host", "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    assert len(ours) == 18 and ours == theirs
    with open(pkl, "rb") as fh:
        assert sorted(pickle.load(fh)) == sorted(line.split(":")[0] for line in ours)


def test_svm_batched_and_cached(processed, tmp_path, capsys):
    pkl = tmp_path / "all.pkl"
    assert cli.main(["svm", "--processed", str(processed), "--out", str(pkl), "--quiet",
                     "--device", "cpu"]) == 0
    first = capsys.readouterr().out
    mtime = os.path.getmtime(pkl)
    assert cli.main(["svm", "--processed", str(processed), "--out", str(pkl), "--quiet",
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out == first and os.path.getmtime(pkl) == mtime


def test_reproduce_requires_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        cli.main(["reproduce", "--corpus", str(tmp_path), "--processed", str(tmp_path / "p"),
                  "--device", "cpu"])


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as jax_entry

    jax_forward, (variables, x_jax) = jax_entry.entry()
    forward, (model, x) = entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_jax))
    model.load_state_dict(cnn_lstm_state_dict_from_flat(flatten_params(variables)))
    logits = forward(model, x)
    assert logits.shape == (2, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_forward(variables, x_jax)),
                               atol=ATOL)
