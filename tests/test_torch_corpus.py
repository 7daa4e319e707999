"""The port's corpus loader and aggregation vs the JAX package's, on the CPU.

Synthetic Androids trees written with the port's ``write_wav``: both
loaders must give the same rows, column for column (exact: no arithmetic),
including unparseable names, a missing ``fold-lists.csv`` (fold -1) and a
corpus without an Interview-Task directory. Aggregation: clip features to
1e-12 (the same pandas calls), sequences bit for bit.
"""

import os

import numpy as np
import pandas as pd
import pytest

from robust_speech_analysis_framework_tpu.data import aggregate as jax_aggregate
from robust_speech_analysis_framework_tpu.data import corpus as jax_corpus
from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.data import aggregate, corpus

READING = {"HC": ["01_CF56_1.wav", "02_CM30_2.wav", "bad_name.wav", ".hidden.wav"],
           "PT": ["03_PF41_3.wav", "59_PF36_x.wav", "04_PM28_1.wav", "notes.txt"]}
SESSIONS = {"01_CF56_1": ["01_CF56_1_a.wav", "01_CF56_1_b.wav"], "03_PF41_3": ["c1.wav"],
            "04_PM28_1": ["z.wav", "a.wav"], "xx_session": ["q.wav"]}
FOLDS = [["banner", "", "", "", ""],
         ["fold1", "fold2", "fold1", "fold2", "fold3"],
         ["'01_CF56_1.wav'", "02_CM30_2", "01_CF56_1", "03_PF41_3.wav", "nan"],
         ["03_PF41_3", "", "", "04_PM28_1", ""]]


def _tree(root, interview: bool = True, folds: bool = True) -> str:
    rng = np.random.default_rng(0)
    for cond, names in READING.items():
        d = os.path.join(root, "Reading-Task", "audio", cond)
        os.makedirs(d, exist_ok=True)
        for name in names:
            write_wav(os.path.join(d, name), rng.normal(size=800) * 0.1, 16000)
    if interview:
        for session, clips in SESSIONS.items():
            d = os.path.join(root, "Interview-Task", "audio_clip", session)
            os.makedirs(d, exist_ok=True)
            for clip in clips:
                write_wav(os.path.join(d, clip), rng.normal(size=800) * 0.1, 16000)
        open(os.path.join(root, "Interview-Task", "audio_clip", "stray.wav"), "w").close()
    if folds:
        with open(os.path.join(root, "fold-lists.csv"), "w") as fh:
            fh.write("\n".join(",".join(r) for r in FOLDS) + "\n")
    return str(root)


@pytest.mark.parametrize("layout", ["full", "no-folds", "no-interview"])
def test_load_androids_corpus_matches_jax(tmp_path, capsys, layout):
    root = _tree(tmp_path, interview=layout != "no-interview", folds=layout != "no-folds")
    ours = corpus.load_androids_corpus(root)
    out = capsys.readouterr().out
    ref = jax_corpus.load_androids_corpus(root)
    assert capsys.readouterr().out == out  # the same messages
    assert "unparseable reading filename 'bad_name.wav'" in out
    for a, b in zip(ours, ref):
        pd.testing.assert_frame_equal(a, b)
    reading, interview = ours
    assert len(reading) == 4
    if layout == "no-interview":
        assert interview.empty and list(interview.columns) == []
    else:
        assert list(interview["filename"]) == ["01_CF56_1_a.wav", "01_CF56_1_b.wav", "c1.wav",
                                               "a.wav", "z.wav"]
    folds = dict(zip(reading["filename"], reading["fold"]))
    if layout == "no-folds":
        assert set(folds.values()) == {-1}
    else:
        assert folds == {"01_CF56_1.wav": 1, "02_CM30_2.wav": 2, "03_PF41_3.wav": 1,
                         "04_PM28_1.wav": -1}
        if layout == "full":
            assert dict(zip(interview["original_session_filename"], interview["fold"])) == {
                "01_CF56_1": 1, "03_PF41_3": 2, "04_PM28_1": 2}


def test_rows_core_needs_no_pandas(tmp_path):
    reading, interview = corpus.load_androids_rows(_tree(tmp_path), verbose=False)
    assert isinstance(reading, list) and isinstance(reading[0], dict)
    assert list(interview[0]) == ["unique_participant_id", "original_id_nn", "label", "gender",
                                  "age", "education", "filepath", "filename",
                                  "original_session_filename", "task_type", "fold"]
    ref_reading, ref_interview = jax_corpus.load_androids_corpus(_tree(tmp_path), verbose=False)
    assert reading == ref_reading.to_dict("records")
    assert interview == ref_interview.to_dict("records")


@pytest.mark.parametrize("name", ["01_CF56_1.wav", "7_XM99_0.wav", "59_PF36_x.wav",
                                  "123_CF56_1.wav", "01_CF56_1.WAV", "01_QF56_1.wav"])
def test_parse_androids_filename_matches_jax(name):
    ours, ref = corpus.parse_androids_filename(name), jax_corpus.parse_androids_filename(name)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert ours.as_dict() == ref.as_dict()


@pytest.mark.parametrize("names", [["a", "b"], ["fold1", "fold1", "fold1"],
                                   ["x", "x", "x.1", "x"], ["fold2", "fold2.1", "fold2"]])
def test_mangle_duplicate_columns_matches_jax(names):
    assert corpus._mangle_duplicate_columns(names) == jax_corpus._mangle_duplicate_columns(names)


def test_load_fold_lists_with_duplicate_columns(tmp_path):
    path = tmp_path / "fold-lists.csv"
    path.write_text("banner\nfold1,fold1,fold2.1,fold2,fold2\n"
                    "a.wav,\"s1\",s2,b,s3\n'c',,nan,d.wav,\n")
    ours = corpus.load_fold_lists(str(path))
    assert ours == jax_corpus.load_fold_lists(str(path))
    assert ours == ({"a": 1, "c": 1, "b": 2, "d": 2}, {"s1": 1, "s2": 2})
    assert corpus.load_fold_lists(str(tmp_path / "absent.csv")) == ({}, {})
    (tmp_path / "one_row.csv").write_text("banner only\n")
    assert corpus.load_fold_lists(str(tmp_path / "one_row.csv")) == ({}, {})


def _clips():
    rng = np.random.default_rng(1)
    meta = pd.DataFrame([
        {"filename": f, "unique_participant_id": p}
        for f, p in [("c0", "p2"), ("c1", "p1"), ("c2", "p2"), ("c3", "p10"), ("c4", "p1"),
                     ("gone", "p3")]])
    feats = pd.DataFrame({"filename": ["c0", "c1", "c2", "c3", "c4"],
                          "f_a": rng.normal(size=5), "f_b": rng.normal(size=5)})
    seqs = {f: rng.normal(size=(int(rng.integers(3, 9)), 4)).astype(np.float32)
            for f in ("c0", "c1", "c2", "c3", "c4")}
    return meta, feats, seqs


def test_aggregate_clip_features_matches_jax():
    meta, feats, _ = _clips()
    ours = aggregate.aggregate_clip_features(feats, meta)
    ref = jax_aggregate.aggregate_clip_features(feats, meta)
    assert list(ours.columns) == ["unique_participant_id", "f_a_mean", "f_a_std", "f_b_mean",
                                  "f_b_std"]
    pd.testing.assert_frame_equal(ours, ref, check_exact=False, rtol=0, atol=1e-12)
    assert np.isnan(ours.set_index("unique_participant_id").loc["p10", "f_a_std"])  # ddof 1
    assert aggregate.aggregate_clip_features(pd.DataFrame(), meta).empty
    assert aggregate.aggregate_clip_features(feats, pd.DataFrame()).empty


def test_aggregate_interview_sequences_matches_jax():
    meta, _, seqs = _clips()
    ours = aggregate.aggregate_interview_sequences(seqs, meta)
    ref = jax_aggregate.aggregate_interview_sequences(seqs, meta)
    assert list(ours) == list(ref) == ["p1", "p10", "p2"]  # sorted; p3 has no clip left
    for pid in ref:
        np.testing.assert_array_equal(ours[pid], ref[pid])
    np.testing.assert_array_equal(ours["p2"], np.vstack([seqs["c0"], seqs["c2"]]))
    groups = aggregate.participant_clips(meta.to_dict("records"))
    assert groups == {"p1": ["c1", "c4"], "p10": ["c3"], "p2": ["c0", "c2"], "p3": ["gone"]}
    rows = aggregate.concat_groups(seqs, groups)  # the array core, without pandas
    assert list(rows) == list(ours)
    for pid in ours:
        np.testing.assert_array_equal(rows[pid], ours[pid])
    assert aggregate.aggregate_interview_sequences(seqs, pd.DataFrame()) == {}
