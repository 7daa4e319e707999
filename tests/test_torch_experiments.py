"""The port's experiment layer (extraction, SVM and CNN-LSTM batteries) and
its analyses, plots and reproduction report vs the JAX package's, on the CPU.

One synthetic Androids tree (22 participants, 11 a class, one undecodable
reading file) goes through the port's ``extract_all_features`` with a
2-layer, 32-wide Wav2Vec2 carrying the JAX test weights
(``tests/test_torch_wav2vec2.py``). On that processed directory both
packages' dataset builders give bit-equal X, columns, y and groups (the
same CSVs, the pandas merges redone on arrays) and bit-equal sequence sets,
and both SVM batteries equal frames on the float64 host solver (the
batched solver: ``tests/test_torch_svm_cv.py``'s bounds). The sequences
hold to the JAX extractor within ATOL (1e-4, float32 encoders summed in
other orders). The analyses are numpy and pandas copies: frames equal.
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from robust_speech_analysis_framework_tpu import experiments as jax_experiments
from robust_speech_analysis_framework_tpu.audio.native_io import (
    load_corpus_mono_16k as jax_load_corpus,
)
from robust_speech_analysis_framework_tpu.data.aggregate import (
    aggregate_clip_features as jax_aggregate_clip_features,
)
from robust_speech_analysis_framework_tpu.eval import analysis as jax_analysis
from robust_speech_analysis_framework_tpu.eval import plots as jax_plots
from robust_speech_analysis_framework_tpu.eval import reproduce as jax_reproduce
from robust_speech_analysis_framework_tpu.features import wav2vec2 as jax_w2v
from robust_speech_analysis_framework_tpu.features.mshds import FEATURE_NAMES as JAX_MSHDS
from robust_speech_analysis_framework_tpu.features.opensmile import (
    feature_columns as jax_opensmile_columns,
)
from robust_speech_analysis_framework_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch import experiments
from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.eval import analysis, dl_cv, plots, reproduce
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import Wav2Vec2Extractor
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    wav2vec2_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.serving import Predictor
from tests.test_torch_wav2vec2 import ATOL, SMALL, jax_params  # noqa: F401  (fixture)

SR = 16000
N_PER_CLASS = 11
BROKEN = "03_CF32_1.wav"  # a reading file the decoder cannot read
TINY_SPACE = {
    "learning_rate": ("float_log", 1e-4, 1e-3),
    "dropout_rate": ("float", 0.2, 0.5),
    "cnn_out_channels": ("categorical", [8, 12]),
    "lstm_hidden_dim": ("categorical", [8]),
    "activation_fn": ("categorical", ["silu", "gelu"]),
}
DATASETS = [f"{fs}_{kind}" for fs in ("mshds", "opensmile", "wav2vec2")
            for kind in ("reading", "interview", "combined")]


def _speech(f0, seed, seconds=1.2):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    v = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 10))
    gate = np.where((t % 0.5) < 0.35, 1.0, 0.02)
    return (0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Reading files of 1.2 s and two interview clips of 0.9 s a
    participant; controls speak higher than patients, with overlap."""
    root = tmp_path_factory.mktemp("corpus")
    for i in range(N_PER_CLASS):
        for cond, pid, f0 in (("HC", f"{i + 1:02d}_CF{30 + i}_1", 150 + 8 * i),
                              ("PT", f"{i + 21:02d}_PM{40 + i}_2", 110 + 8 * i)):
            rdir = root / "Reading-Task" / "audio" / cond
            rdir.mkdir(parents=True, exist_ok=True)
            if pid + ".wav" == BROKEN:
                (rdir / BROKEN).write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
            else:
                write_wav(str(rdir / f"{pid}.wav"), _speech(f0, 7 * i + len(cond)), SR)
            sess = root / "Interview-Task" / "audio_clip" / pid
            sess.mkdir(parents=True)
            for c in range(2):
                write_wav(str(sess / f"{pid}_clip_{c:03d}.wav"),
                          _speech(f0 + 5 * c, 200 + 2 * i + c + len(cond), 0.9), SR)
    (root / "fold-lists.csv").write_text("banner,,\nfold1,fold2,fold1.1\n,,\n")
    return str(root)


def _extractor(jax_params):
    sd = wav2vec2_state_dict_from_flat(flatten_params(jax_params))
    return Wav2Vec2Extractor(params=sd, config=Wav2Vec2Config(**SMALL), batch_size=4,
                             device="cpu")


@pytest.fixture(scope="module")
def processed(corpus, jax_params, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("processed"))
    paths = experiments.extract_all_features(corpus, out, wav2vec2_extractor=_extractor(jax_params),
                                             verbose=False, device="cpu")
    return out, paths


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The extractors' small tensors gain little past two intra-op threads,
    and several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- extraction -------------------------------------------------------------------------------


def test_extraction_artifacts_and_schemas(processed, corpus):
    out, paths = processed
    assert sorted(paths) == sorted(set(experiments.TABLE_ARTIFACTS.values())
                                   | set(experiments.SEQUENCE_ARTIFACTS.values()))
    assert all(os.path.exists(p) for p in paths.values())
    reading_df, _ = jax_experiments.load_androids_corpus(corpus, verbose=False)
    meta_cols = list(reading_df.columns)

    mshds = pd.read_csv(paths["features_mshds_reading_task.csv"])
    assert list(mshds.columns) == meta_cols + JAX_MSHDS
    assert list(mshds["filename"]) == list(reading_df["filename"])  # every row, row order
    broken = mshds[mshds["filename"] == BROKEN]
    assert broken[JAX_MSHDS].isna().all(axis=None)  # the reference's NaN row
    assert mshds.drop(index=broken.index)["mean_F0"].notna().all()

    osm = pd.read_csv(paths["features_opensmile_reading_task.csv"])
    assert list(osm.columns) == meta_cols + jax_opensmile_columns()
    assert BROKEN not in set(osm["filename"]) and len(osm) == 2 * N_PER_CLASS - 1

    agg = pd.read_csv(paths["features_mshds_interview_task_aggregated.csv"])
    assert list(agg.columns) == ["unique_participant_id"] + [
        f"{c}_{s}" for c in JAX_MSHDS for s in ("mean", "std")]
    assert len(agg) == 2 * N_PER_CLASS and list(agg["unique_participant_id"]) == sorted(
        agg["unique_participant_id"])
    w2v = pd.read_csv(paths["features_wav2vec2_interview_task_aggregated.csv"])
    assert w2v.shape == (2 * N_PER_CLASS, 1 + 2 * SMALL["hidden_size"])


def test_sequences_and_mean_frames_match_jax(processed, corpus, jax_params):
    out, paths = processed
    with open(paths["sequences_wav2vec2_interview.pkl"], "rb") as fh:
        ours = pickle.load(fh)
    _, interview_df = jax_experiments.load_androids_corpus(corpus, verbose=False)
    waves = jax_load_corpus(list(interview_df["filepath"]))
    theirs = jax_w2v.Wav2Vec2Extractor(params=jax_params, config=JaxConfig(**SMALL),
                                       batch_size=4).extract_sequences(waves, verbose=False)
    assert list(ours) == list(theirs)
    for name in theirs:
        np.testing.assert_allclose(ours[name], theirs[name], atol=ATOL)
    with open(paths["sequences_wav2vec2_reading.pkl"], "rb") as fh:
        reading = pickle.load(fh)
    assert BROKEN not in reading and len(reading) == 2 * N_PER_CLASS - 1
    table = pd.read_csv(paths["features_wav2vec2_reading_task.csv"])
    dims = [f"dim_{k}" for k in range(SMALL["hidden_size"])]
    want = np.stack([reading[n].mean(axis=0) for n in table["filename"]])
    np.testing.assert_array_equal(table[dims].to_numpy(np.float32), want)  # float32 repr


def test_aggregate_table_matches_pandas():
    rng = np.random.default_rng(0)
    names = [f"c{i}.wav" for i in range(9)]
    rows = [{"filename": n, "unique_participant_id": f"p{(i * 5) % 4}"}
            for i, n in enumerate(names)]
    values = rng.normal(size=(9, 3))
    values[[1, 4], 0] = np.nan  # p1 has one finite value left
    values[2, 1] = np.nan
    tab = experiments.aggregate_table(rows, names[:-1], values[:-1], ["a", "b", "c"])
    clip_df = pd.DataFrame(values[:-1], columns=["a", "b", "c"]).assign(filename=names[:-1])
    theirs = jax_aggregate_clip_features(clip_df, pd.DataFrame(rows))
    pd.testing.assert_frame_equal(tab.frame(), theirs, check_exact=False, rtol=1e-12)


def test_extraction_caching(processed, corpus, jax_params):
    out, paths = processed
    mtimes = {n: os.path.getmtime(p) for n, p in paths.items()}
    experiments.extract_all_features(corpus, out, features=("mshds",), verbose=False,
                                     device="cpu")
    assert os.path.getmtime(paths["features_mshds_reading_task.csv"]) == \
        mtimes["features_mshds_reading_task.csv"]
    # a missing mean-frame table is rebuilt from the cached sequences
    name = "features_wav2vec2_reading_task.csv"
    before = pd.read_csv(paths[name])
    os.remove(paths[name])
    experiments.extract_all_features(corpus, out, features=("wav2vec2",), verbose=False,
                                     wav2vec2_extractor=_extractor(jax_params), device="cpu")
    pd.testing.assert_frame_equal(pd.read_csv(paths[name]), before)
    assert os.path.getmtime(paths["sequences_wav2vec2_reading.pkl"]) == \
        mtimes["sequences_wav2vec2_reading.pkl"]


def test_extraction_fails_fast_without_wav2vec2_weights(corpus, tmp_path, monkeypatch):
    def no_extraction(*args, **kwargs):
        raise AssertionError("extraction started before the weights guard")

    monkeypatch.setattr(experiments, "extract_tables", no_extraction)
    with pytest.raises(ValueError, match="without weights"):
        experiments.extract_all_features(corpus, str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out").exists()


def test_unknown_artifact_raises():
    with pytest.raises(ValueError, match="unknown artifacts"):
        experiments.extract_tables([], [], ["features.csv"], device="cpu")


# --- SVM datasets and battery -----------------------------------------------------------------


@pytest.fixture(scope="module")
def datasets(processed):
    out, _ = processed
    return jax_experiments.build_svm_datasets(out), experiments.build_svm_datasets(out)


@pytest.mark.parametrize("name", DATASETS)
def test_svm_datasets_bit_equal_to_jax(datasets, name):
    theirs, ours = datasets[0][name], datasets[1][name]
    assert list(ours["X"].columns) == list(theirs["X"].columns)
    np.testing.assert_array_equal(ours["X"].to_numpy(), theirs["X"].to_numpy())
    np.testing.assert_array_equal(ours["y"].to_numpy(), theirs["y"].to_numpy())
    assert list(ours["groups"]) == list(theirs["groups"])


def test_svm_datasets_fill_nan_with_column_means(datasets):
    _, ours = datasets
    X = ours["mshds_reading"]["X"]
    assert len(X) == 2 * N_PER_CLASS and np.isfinite(X.to_numpy()).all()
    # the participant of the undecodable file: its MSHDS row was all NaN
    assert len(ours["opensmile_combined"]["X"]) == 2 * N_PER_CLASS - 1


@pytest.fixture(scope="module")
def svm_battery(processed):
    out, _ = processed
    return (jax_experiments.run_all_svm_experiments(out, verbose=False),
            experiments.run_all_svm_experiments(os.path.join(out), out_path=os.path.join(
                out, "all_svm_results.pkl"), verbose=False, solver="host", device="cpu"))


def test_svm_battery_host_equals_jax(svm_battery, processed):
    theirs, ours = svm_battery
    assert list(ours) == list(theirs) and len(ours) == 18
    for name in theirs:
        pd.testing.assert_frame_equal(ours[name]["results_df"], theirs[name]["results_df"])
        for p, q in zip(ours[name]["predictions"], theirs[name]["predictions"]):
            np.testing.assert_array_equal(p["y_prob"], q["y_prob"])
    out, _ = processed
    with open(os.path.join(out, "all_svm_results.pkl"), "rb") as fh:
        cached = pickle.load(fh)
    pd.testing.assert_frame_equal(cached["mshds_reading_nested"]["results_df"],
                                  ours["mshds_reading_nested"]["results_df"])


def test_svm_battery_cores_without_pandas(datasets, svm_battery, monkeypatch):
    """The array cores, batched on the CPU: the host run's metrics and
    selections (the batched solver's bounds of tests/test_torch_svm_cv.py)."""
    _, host = svm_battery
    ds = {name: experiments.SvmDataset(d["X"].to_numpy(), list(d["X"].columns),
                                       d["y"].to_numpy(), list(d["groups"]))
          for name, d in datasets[1].items() if name.startswith("mshds")}
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    results = experiments.svm_experiments(ds, verbose=False, device="cpu")
    assert len(results) == 6
    for name, r in results.items():
        want = host[name]["results_df"].to_dict("records")
        for got, row in zip(r["results_df"], want):
            assert got["selected_features"] == row["selected_features"]
            assert got.get("best_k_found") == row.get("best_k_found")
            for m in ("accuracy", "f1_score", "precision", "recall"):
                assert abs(got[m] - row[m]) <= 1e-9
            assert abs(got["auc"] - row["auc"]) <= 1e-6


# --- sequence sets and the CNN-LSTM battery -----------------------------------------------------


def test_sequence_sets_equal_jax(processed, corpus):
    out, _ = processed
    theirs, meta_j = jax_experiments.build_sequence_sets(out, corpus, verbose=False)
    ours, meta = experiments.build_sequence_sets(out, corpus, verbose=False)
    assert set(ours) == set(theirs) == {"reading", "interview", "combined"}
    for kind in theirs:
        assert sorted(ours[kind]) == sorted(theirs[kind])
        for pid in theirs[kind]:
            np.testing.assert_array_equal(ours[kind][pid], theirs[kind][pid])
    assert list(ours["combined"]) == sorted(ours["combined"])
    assert meta.to_numpy().tolist() == meta_j.to_numpy().tolist()
    assert list(meta.columns) == ["unique_participant_id", "label"]


DEPTH = dict(n_trials=2, nested_epochs=1, nested_patience=1, standard_epochs=1,
             standard_patience=1, batch_size=8, trial_batch=2, n_splits=2, n_splits_outer=2,
             n_splits_inner=2, inner_epochs=1, search_space=TINY_SPACE)


@pytest.fixture(scope="module")
def cnn_lstm(processed, corpus, tmp_path_factory):
    """The battery's core at cut depth (2 folds, 2 trials a round, 1 epoch),
    with DataFrame results as the front door builds them."""
    out, _ = processed
    dirs = tmp_path_factory.mktemp("dl")
    sets, meta = experiments.build_sequence_sets(out, corpus, verbose=False)
    results = experiments.cnn_lstm_experiments(
        sets, meta.to_dict("records"), str(dirs / "results"), models_dir=str(dirs / "models"),
        verbose=False, frame=pd.DataFrame, device="cpu", **DEPTH)
    return results, dirs, sets


def test_cnn_lstm_front_door_keeps_jax_defaults(processed, corpus, monkeypatch, tmp_path):
    out, _ = processed
    seen = {}

    def core(sets, meta, out_dir, **kwargs):
        seen.update(kwargs, out_dir=out_dir, kinds=sorted(sets), meta=meta)
        return {}

    monkeypatch.setattr(experiments, "cnn_lstm_experiments", core)
    experiments.run_cnn_lstm_experiments(out, corpus, str(tmp_path), verbose=False, device="cpu")
    assert seen["kinds"] == ["combined", "interview", "reading"]
    assert {k: seen[k] for k in ("n_trials", "nested_epochs", "nested_patience",
                                 "standard_epochs", "standard_patience", "batch_size",
                                 "trial_batch")} == dict(
        n_trials=25, nested_epochs=50, nested_patience=10, standard_epochs=100,
        standard_patience=25, batch_size=8, trial_batch=8)
    assert seen["frame"] is pd.DataFrame and len(seen["meta"]) == 2 * N_PER_CLASS


def test_cnn_lstm_battery_artifacts(cnn_lstm):
    results, dirs, _ = cnn_lstm
    assert sorted(results) == sorted(f"{m}_{k}" for m in ("tuned", "standard")
                                     for k in ("reading", "interview", "combined"))
    for key, r in results.items():
        mode, _, kind = key.partition("_")
        with open(dirs / "results" / f"results_wav2vec2_cnn_lstm_{mode}_{kind}.pkl", "rb") as fh:
            saved = pickle.load(fh)
        want = {"results_df", "predictions", "weights"} | ({"histories"} if mode == "standard"
                                                            else set())
        assert set(saved) == want
        df = saved["results_df"]
        assert isinstance(df, pd.DataFrame) and list(df["fold"]) == [1, 2]
        assert np.isfinite(df[["accuracy", "f1_score", "auc"]].to_numpy()).all()
        assert saved["weights"].shape == (2, SMALL["hidden_size"])
        if mode == "tuned":
            assert all(set(p) == set(TINY_SPACE) for p in df["best_params"])


def test_cnn_lstm_battery_max_f1_rule_and_final_models(cnn_lstm):
    results, dirs, _ = cnn_lstm
    for kind in ("reading", "interview", "combined"):
        tuned = results[f"tuned_{kind}"]["results_df"]
        jax_rule = dict(tuned.loc[tuned["f1_score"].idxmax()]["best_params"])
        assert experiments.best_params(tuned) == jax_rule
        path = dirs / "models" / f"final_tuned_cnn_lstm_{kind}.pkl"
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
        assert set(payload) == {"hyperparameters", "model_state_dict", "train_loss_history",
                                "val_loss_history"}
        assert payload["hyperparameters"] == jax_rule
        predictor = Predictor.from_checkpoint(str(path), device="cpu")
        seq = np.zeros((50, SMALL["hidden_size"]), np.float32)
        assert np.isfinite(predictor.predict_sequence(seq).logits).all()


def test_cnn_lstm_battery_reads_its_cache(cnn_lstm, monkeypatch):
    results, dirs, sets = cnn_lstm

    def no_training(*args, **kwargs):
        raise AssertionError("a cached experiment ran again")

    monkeypatch.setattr(dl_cv, "nested_cv", no_training)
    monkeypatch.setattr(dl_cv, "standard_kfold_cv", no_training)
    meta = [{"unique_participant_id": p, "label": "Patient" if p[3] == "P" else "Control"}
            for p in sets["reading"]]
    again = experiments.cnn_lstm_experiments(
        sets, meta, str(dirs / "results"), models_dir=str(dirs / "models"), verbose=False,
        device="cpu")
    for key in results:
        pd.testing.assert_frame_equal(again[key]["results_df"], results[key]["results_df"])


def test_best_params_rule():
    rows = [{"f1_score": 0.5, "best_params": {"a": 1}}, {"f1_score": np.nan, "best_params": {}},
            {"f1_score": 0.7, "best_params": {"a": 2}}, {"f1_score": 0.7, "best_params": {"a": 3}}]
    assert experiments.best_params(rows) == {"a": 2}
    df = pd.DataFrame(rows)
    assert experiments.best_params(df) == dict(df.loc[df["f1_score"].idxmax()]["best_params"])
    with pytest.raises(ValueError, match="finite"):
        experiments.best_params([{"f1_score": np.nan, "best_params": {}}])


# --- analyses, plots and the reproduction report --------------------------------------------


def _fake_results():
    rng = np.random.default_rng(0)

    def df(mean):
        return pd.DataFrame({
            "fold": range(1, 6),
            **{m: mean + rng.normal(0, 0.02, 5)
               for m in ("accuracy", "f1_score", "precision", "recall")},
            "auc": mean + 0.05 + rng.normal(0, 0.02, 5),
            "selected_features": [["a", "b"], ["a", "c"], ["a", "b"], ["b", "c"], ["a", "b"]],
            "best_params": [{"learning_rate": float(rng.uniform(1e-4, 1e-3)), "lstm": h}
                            for h in (64, 128, 64, 64, 128)],
        })

    preds = [{"y_true": np.arange(8) % 2, "y_prob": rng.uniform(size=8)} for _ in range(5)]
    hist = [{"train": list(rng.uniform(size=4)), "val": list(rng.uniform(size=4))}] * 2
    return {
        "mshds_reading_standard": {"results_df": df(0.74), "predictions": preds},
        "mshds_reading_nested": {"results_df": df(0.70), "predictions": preds},
        "mshds_interview_standard": {"results_df": df(0.72), "histories": hist},
        "mshds_interview_nested": {"results_df": df(0.73)},
        "wav2vec2_cnn_lstm_tuned_reading": {"results_df": df(0.71)},
    }


@pytest.mark.parametrize("fn", ["summarize_results", "optimism_bias", "task_gain",
                                "feature_selection_stability", "tuned_param_summary"])
def test_analysis_frames_equal_jax(fn):
    res = _fake_results()
    arg = res["mshds_reading_standard"]["results_df"] if fn in (
        "feature_selection_stability", "tuned_param_summary") else res
    pd.testing.assert_frame_equal(getattr(analysis, fn)(arg), getattr(jax_analysis, fn)(arg))


def test_dimension_stability_equals_jax():
    rng = np.random.default_rng(1)
    base = rng.random(100)
    weights = np.stack([base + 0.01 * rng.random(100) for _ in range(5)])
    ours, theirs = analysis.dimension_stability(weights, 20), \
        jax_analysis.dimension_stability(weights, 20)
    pd.testing.assert_frame_equal(ours["counts"], theirs["counts"])
    assert ours["mean_jaccard"] == theirs["mean_jaccard"]
    assert ours["always_selected"] == theirs["always_selected"]


def test_plots_render_the_figure_set(tmp_path):
    res = _fake_results()
    written = plots.save_all(res, str(tmp_path / "ours"))
    assert sorted(written) == sorted(jax_plots.save_all(res, str(tmp_path / "jax")))
    for path in written.values():
        with open(path, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_compare_to_published_equals_jax():
    res = _fake_results()
    res["mshds_reading_nested"]["results_df"].loc[2, "auc"] = np.nan
    ours, theirs = reproduce.compare_to_published(res), jax_reproduce.compare_to_published(res)
    pd.testing.assert_frame_equal(ours, theirs)
    assert reproduce.reproduction_report(ours) == jax_reproduce.reproduction_report(theirs)


def test_reproduction_needs_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        reproduce.run_reproduction(str(tmp_path), str(tmp_path / "p"), device="cpu")
