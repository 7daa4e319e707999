"""The port's resident Wav2Vec2 extraction, regrouping, embeddings and
front doors vs the JAX package's, on the CPU.

The SMALL config of ``tests/test_torch_wav2vec2.py`` (hidden 32, 2 layers)
with the same perturbed JAX weights. Tolerances: against JAX, ATOL (1e-4,
float32 encoders summed in other orders); the port's resident buffer against
its own ``extract_sequences`` and host aggregation: bit for bit (the same
batches, the same arithmetic, only copies in between); embeddings against
JAX 1e-5 (means of float32 sums, added per file in float64 on both sides);
the CV engines on the resident corpus against the host sequences: the JAX
test's bounds (metrics 1e-5, stability weights 1e-5 + 1e-4 relative).
"""

import numpy as np
import pandas as pd
import pytest

import torch

from robust_speech_analysis_framework_tpu.data.aggregate import (
    aggregate_interview_sequences as jax_aggregate_interview_sequences,
)
from robust_speech_analysis_framework_tpu.features import wav2vec2 as jax_w2v
from robust_speech_analysis_framework_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from robust_speech_analysis_framework_tpu.train.checkpoints import flatten_params
from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav
from robust_speech_analysis_framework_tpu_torch.data.aggregate import (
    aggregate_interview_sequences,
    participant_clips,
)
from robust_speech_analysis_framework_tpu_torch.eval.dl_cv import run_dl_standard_kfold_cv
from robust_speech_analysis_framework_tpu_torch.features import wav2vec2 as port_w2v
from robust_speech_analysis_framework_tpu_torch.features.wav2vec2 import (
    ResidentSequences,
    Wav2Vec2Extractor,
)
from robust_speech_analysis_framework_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from robust_speech_analysis_framework_tpu_torch.models.weights import (
    wav2vec2_state_dict_from_flat,
)
from robust_speech_analysis_framework_tpu_torch.train.loops import DeviceCorpus, ResidentCorpus
from tests.test_torch_wav2vec2 import ATOL, SMALL, jax_params  # noqa: F401  (fixture)

SR = 16000
EMB_ATOL = 1e-5
META = [  # interview rows: f4 is too short, missing.wav is not extracted
    {"filename": "f0.wav", "unique_participant_id": "p1"},
    {"filename": "f2.wav", "unique_participant_id": "p1"},
    {"filename": "f1.wav", "unique_participant_id": "p0"},
    {"filename": "f3.wav", "unique_participant_id": "p2"},
    {"filename": "f4.wav", "unique_participant_id": "p3"},
    {"filename": "missing.wav", "unique_participant_id": "p3"},
]


def _corpus(seed: int = 0):
    """Multi-chunk files, an 8.9 s file (its 4.9 s middle chunk is short and
    not the last), a partial final chunk, and a 0.3 s file that is skipped."""
    rng = np.random.default_rng(seed)
    secs = {"f0.wav": 6.2, "f1.wav": 4.0, "f2.wav": 8.9, "f3.wav": 1.1, "f4.wav": 0.3}
    return {n: (0.1 * rng.normal(size=int(s * SR))).astype(np.float32) for n, s in secs.items()}


def _port(jax_params, **kw):
    sd = wav2vec2_state_dict_from_flat(flatten_params(jax_params))
    return Wav2Vec2Extractor(params=sd, config=Wav2Vec2Config(**SMALL), batch_size=3,
                             device="cpu", **kw)


def _jax(jax_params, **kw):
    return jax_w2v.Wav2Vec2Extractor(params=jax_params, config=JaxConfig(**SMALL),
                                     batch_size=3, **kw)


def _check_padding_zero(res) -> None:
    x = res.x.numpy()
    for name in res.names:
        i = res.row(name)
        assert (x[i, int(res.lengths[i]):] == 0.0).all()


@pytest.fixture(scope="module")
def resident(jax_params):
    return _port(jax_params).extract_sequences_resident(_corpus(), verbose=False)


def test_resident_matches_jax(jax_params, resident):
    ref = _jax(jax_params).extract_sequences_resident(_corpus(), verbose=False)
    assert resident.names == ref.names == ["f0.wav", "f1.wav", "f2.wav", "f3.wav"]
    np.testing.assert_array_equal(resident.lengths, ref.lengths)
    assert resident.lengths[2] == 249 + 244 + 44  # 5 s + 4.9 s + 0.9 s, overlaps kept
    assert tuple(resident.x.shape) == np.asarray(ref.x).shape == (4, 640, 32)
    assert resident.x.dtype == torch.float32 and resident.is_resident_sequences
    np.testing.assert_allclose(resident.x.numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)
    _check_padding_zero(resident)


@pytest.mark.parametrize("kw", [{}, {"upload_dtype": np.int16}, {"compute_dtype": "bfloat16"}],
                         ids=["f32", "int16-upload", "bf16"])
def test_resident_equals_extract_sequences(jax_params, kw):
    ex = _port(jax_params, **kw)
    host = ex.extract_sequences(_corpus(), verbose=False)
    res = ex.extract_sequences_resident(_corpus(), verbose=False)
    assert list(res) == list(host) and len(res) == 4 and "f4.wav" not in res
    for name, seq in host.items():
        np.testing.assert_array_equal(res[name], seq)
    _check_padding_zero(res)
    # the shape, padding included, of a host upload of the same sequences
    uploaded = ResidentCorpus(host, device="cpu").device_corpus().x
    assert res.x.shape == uploaded.shape
    assert torch.equal(res.x, uploaded)
    assert DeviceCorpus.from_resident(res).x is res.x  # adopted, not copied


def test_short_inputs_give_an_empty_corpus(jax_params):
    res = _port(jax_params).extract_sequences_resident(
        {"x.wav": np.zeros(1000, np.float32)}, verbose=False)
    assert len(res) == 0 and res.x is None and res.keys() == []
    assert len(res.regroup({"p": ["x.wav"]})) == 0


def test_regroup_matches_jax_and_host_aggregation(jax_params, resident):
    meta = pd.DataFrame(META)
    groups = participant_clips(META)
    assert list(groups) == ["p0", "p1", "p2", "p3"]
    assert groups["p1"] == ["f0.wav", "f2.wav"]
    got = resident.regroup(groups)
    assert isinstance(got, ResidentSequences) and got.names == ["p0", "p1", "p2"]

    ref = _jax(jax_params).extract_sequences_resident(_corpus(), verbose=False).regroup(groups)
    assert got.names == ref.names
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    assert tuple(got.x.shape) == np.asarray(ref.x).shape
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=ATOL)

    host = {n: resident[n] for n in resident}
    want = aggregate_interview_sequences(host, meta)
    jax_want = jax_aggregate_interview_sequences(host, meta)
    assert list(want) == list(jax_want) == got.names
    for pid in want:
        np.testing.assert_array_equal(want[pid], jax_want[pid])
        np.testing.assert_array_equal(got[pid], want[pid])
    assert torch.equal(got.x, ResidentCorpus(want, device="cpu").device_corpus().x)
    _check_padding_zero(got)


def test_embeddings_match_jax(jax_params):
    waves = _corpus()
    ex = _port(jax_params)
    names, means = ex.extract_embeddings_arrays(waves, verbose=False)
    ref = _jax(jax_params).extract_embeddings(waves, verbose=False)
    dims = [f"dim_{k}" for k in range(32)]
    assert names == list(ref["filename"]) and means.dtype == np.float64
    np.testing.assert_allclose(means, ref[dims].to_numpy(), rtol=0, atol=EMB_ATOL)
    df = ex.extract_embeddings(waves, verbose=False)
    assert list(df.columns) == list(ref.columns)
    pd.testing.assert_frame_equal(df, ref, check_exact=False, rtol=0, atol=EMB_ATOL)
    # the per-file mean of every frame of every chunk, overlaps included
    host = ex.extract_sequences(waves, verbose=False)
    np.testing.assert_allclose(means, np.stack([host[n].mean(0) for n in names]),
                               rtol=0, atol=EMB_ATOL)
    assert ex.extract_embeddings({"x.wav": np.zeros(100, np.float32)}, verbose=False).empty


def test_dl_cv_on_resident_matches_host(jax_params):
    """The CV engine consumes resident sequences with the results of the
    same sequences as host arrays (JAX ``test_dl_cv_on_resident_matches_host``)."""
    ex = _port(jax_params)
    rng = np.random.default_rng(3)
    waves = {f"{i:02d}_{'P' if i % 2 else 'C'}":
             (0.1 * rng.normal(size=int(SR * (1 + 0.2 * i)))).astype(np.float32)
             for i in range(20)}
    res = ex.extract_sequences_resident(waves, verbose=False)
    host = ex.extract_sequences(waves, verbose=False)
    meta = pd.DataFrame([{"unique_participant_id": k,
                          "label": "Patient" if k.endswith("P") else "Control"} for k in waves])
    hp = {"learning_rate": 1e-3, "dropout_rate": 0.3, "cnn_out_channels": 8,
          "lstm_hidden_dim": 8, "activation_fn": "silu"}
    kw = dict(n_splits=2, epochs=2, patience=3, batch_size=4, device="cpu")
    df_r, _, hist_r, w_r = run_dl_standard_kfold_cv(res, meta, hp, **kw)
    df_h, _, hist_h, w_h = run_dl_standard_kfold_cv(host, meta, hp, **kw)
    pd.testing.assert_frame_equal(df_r, df_h, atol=1e-5)
    np.testing.assert_allclose(w_r, w_h, atol=1e-5, rtol=1e-4)
    for a, b in zip(hist_r, hist_h):
        np.testing.assert_allclose(a["train"], b["train"], rtol=1e-5)


def test_front_doors_handle_empty_dataframe():
    empty = pd.DataFrame()
    assert port_w2v.extract_wav2vec2_sequences(empty) == {}
    assert port_w2v.extract_wav2vec2_embeddings(empty).empty
    assert jax_w2v.extract_wav2vec2_sequences(empty) == {}


def test_front_doors_match_jax_with_a_duplicate_basename(jax_params, tmp_path, capsys):
    rng = np.random.default_rng(5)
    paths = []
    for sub, name, seconds in [("a", "x.wav", 1.4), ("a", "y.wav", 5.6), ("b", "x.wav", 2.0)]:
        (tmp_path / sub).mkdir(exist_ok=True)
        path = str(tmp_path / sub / name)
        write_wav(path, (0.1 * rng.normal(size=int(seconds * SR))).astype(np.float32), SR)
        paths.append(path)
    bad = tmp_path / "a" / "bad.wav"
    bad.write_bytes(b"not a wav")
    df = pd.DataFrame({"filepath": paths + [str(bad)]})

    ours = port_w2v.extract_wav2vec2_sequences(df, extractor=_port(jax_params))
    out = capsys.readouterr().out
    assert "duplicate basename 'x.wav'" in out and "ERROR loading 'bad.wav'" in out
    ref = jax_w2v.extract_wav2vec2_sequences(df, extractor=_jax(jax_params), verbose=False)
    assert sorted(ours) == sorted(ref) == ["x.wav", "y.wav"]
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], rtol=0, atol=ATOL)

    emb = port_w2v.extract_wav2vec2_embeddings(df, extractor=_port(jax_params), verbose=False)
    emb_ref = jax_w2v.extract_wav2vec2_embeddings(df, extractor=_jax(jax_params), verbose=False)
    pd.testing.assert_frame_equal(emb, emb_ref, check_exact=False, rtol=0, atol=EMB_ATOL)
    # decoded audio handed in: the file decode is skipped
    waves = {"z.wav": (0.1 * rng.normal(size=SR)).astype(np.float32)}
    got = port_w2v.extract_wav2vec2_sequences(df, extractor=_port(jax_params), waveforms=waves)
    assert list(got) == ["z.wav"]
