"""Port's openSMILE-912 extraction vs the JAX package, on the CPU.

The same seeded numpy inputs go through both packages, stage by stage and
end to end. Tolerances, each with its reason:

* frame stage: rtol 1e-5 with atol 1e-5 × the stream's largest magnitude
  (two FFT libraries; near-zero bins carry only their rounding);
* functionals: rtol 1e-5, atol 1e-6 (float32 reductions in other orders);
* SHS pitch: F0 equal within 1e-3 relative on ≥ 99.5 % of frames (the
  JAX chain on the CPU takes the associative-scan path finder, the port the
  sequential one: near-ties may pick other states);
* whole extraction: the families of the JAX package's own batched-vs-serial
  test (``tests/test_opensmile.py:298-310``): median relative difference
  < 1e-5, mean < 2e-4 off the voice-quality columns, mean < 5e-2 on them
  (both batches march periods on the device, the JAX package scoring lags
  in float32 through DFT correlations, the port with float64 sums: the
  plain version of its march kernel here);
* the numpy copies (bucketing, period march, conf parser) and the prefix
  sums: bit-equal.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.features import conf_parser as jax_conf
from robust_speech_analysis_framework_tpu.features import opensmile as jax_os
from robust_speech_analysis_framework_tpu.ops import bucketing as jax_bucketing
from robust_speech_analysis_framework_tpu.ops import functionals as jax_fn
from robust_speech_analysis_framework_tpu.ops import jitter as jax_jitter
from robust_speech_analysis_framework_tpu_torch.features import conf_parser as port_conf
from robust_speech_analysis_framework_tpu_torch.features import opensmile as port_os
from robust_speech_analysis_framework_tpu_torch.ops import bucketing as port_bucketing
from robust_speech_analysis_framework_tpu_torch.ops import functionals as port_fn
from robust_speech_analysis_framework_tpu_torch.ops import jitter as port_jitter
from robust_speech_analysis_framework_tpu_torch.ops import shs_pitch as port_shs
from robust_speech_analysis_framework_tpu_torch.ops.prefix_sum import cumsum
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

# the JAX package's ops/__init__ re-exports a function named shs_pitch
jax_shs = importlib.import_module("robust_speech_analysis_framework_tpu.ops.shs_pitch")

SR = 16000


def _speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like test audio: 11 harmonics with 3 Hz vibrato, syllable
    gating, a little noise, quantised to 16-bit PCM (the recipe of
    ``benchmarks/suite.py:31-43``, with the vibrato's phase integrated)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    # 3 Hz vibrato of ±1 % as a true frequency modulation: the benchmark's
    # phase f0·(1 + 0.01·sin)·t sweeps ±0.19·f0·t Hz, so its files stop
    # being voiced after a few seconds
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    return (np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


# 1.0 s falls in the 18000-sample bucket, 1.3 s and 1.6 s in the 27000 one
WAVES = {f"f{i}.wav": _speech(s, 120 + 15 * i, i) for i, s in enumerate((1.0, 1.3, 1.6))}
VQ = ("jitter", "shimmer", "logHNR")


@pytest.fixture(scope="module")
def jax_batch():
    """The JAX extractor's batched DataFrame, computed once for the module."""
    return jax_os.OpenSmileExtractor().extract_batch(WAVES, verbose=False)


@pytest.fixture(scope="module")
def port_batch():
    return port_os.OpenSmileExtractor(device="cpu").extract_batch(WAVES, verbose=False)


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


# ---- numpy copies and prefix sums: bit-equal ----------------------------------


@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 265, 6487])
def test_prefix_sum_equals_jax_cumsum(n):
    x = np.random.default_rng(n).random((n, 3)).astype(np.float32)
    for axis in (0, 1):
        ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=axis))
        np.testing.assert_array_equal(cumsum(torch.from_numpy(x), dim=axis).numpy(), ref)


def test_bucketing_equals_jax():
    for n in (1, 64, 65, 400, 8000, 8001, 16000, 25600, 960000):
        for min_bucket in (64, 8000):
            assert port_bucketing.bucket_size(n, min_bucket) == jax_bucketing.bucket_size(n, min_bucket)
    assert port_bucketing.bucket_size(960000, 8000) == 1037971  # 6485 frames
    frames = np.random.default_rng(0).random((70, 5)).astype(np.float32)
    got, n = port_bucketing.pad_frames(frames)
    ref, n_ref = jax_bucketing.pad_frames(frames)
    assert n == n_ref == 70
    np.testing.assert_array_equal(got, ref)


def test_period_march_equals_jax():
    x = WAVES["f2.wav"].astype(np.float64)
    f0 = np.where(np.arange(len(x) // 160) % 60 < 42, 150.0, 0.0)
    ours = port_jitter.mark_periods(x, SR, f0)
    ref = jax_jitter.mark_periods(x, SR, f0)
    assert len(ours.starts) > 50
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_jitter.periods_to_llds(ours, f0, SR),
                                  jax_jitter.periods_to_llds(ref, f0, SR))
    np.testing.assert_array_equal(port_jitter.jitter_shimmer_llds(x, SR, f0),
                                  jax_jitter.jitter_shimmer_llds(x, SR, f0))


CONF = r"""
; Androids-style excerpt
[componentInstances:cComponentManager]
instance[framer].type = cFramer
[framer:cFramer]
frameSize = 0.030
frameStep = 0.015   ; inline comment
[pe:cVectorPreemphasis]
k = 0.95
[mel:cMelspec]
nBands = 24
lofreq = \cm[lofreq{30}:lower edge]
hifreq = 7000
[mfcc:cMfcc]
firstMfcc = 0
lastMfcc = 12
[scale:cSpecScale]
minF = 20
[shs:cPitchShs]
minPitch = 60
maxPitch = 500
nCandidates = 5
[smooth:cPitchSmootherViterbi]
wTvv = 8
wTuu = 0.5
// full-line comment
[gate:cValbasedSelector]
threshold = 0.002
[jit:cPitchJitter]
searchRangeRel = 0.2
bands[0] = 250-650
"""


def test_conf_parser_equals_jax():
    assert port_conf.parse_conf(CONF) == jax_conf.parse_conf(CONF)
    ours = port_conf.opensmile_config_from_conf(CONF)
    ref = jax_conf.opensmile_config_from_conf(CONF)
    assert ours.frontend.__dict__ == ref.frontend.__dict__
    assert tuple(ours.shs) == tuple(ref.shs)
    for field in ("n_mfcc", "energy_gate", "sma_window", "deltawin", "jitter_search_range",
                  "reference_compat"):
        assert getattr(ours, field) == getattr(ref, field)
    assert ours.n_mfcc == 13 and ours.frontend.frame_len == 480


@pytest.mark.parametrize("reference_compat", [False, True], ids=["912", "911"])
def test_feature_columns_equal_jax(reference_compat):
    cols = port_os.feature_columns(reference_compat)
    assert cols == jax_os.feature_columns(reference_compat)
    assert len(cols) == (911 if reference_compat else 912)
    assert port_os.LLD_NAMES == jax_os.LLD_NAMES


# ---- stages -----------------------------------------------------------------

STREAMS = ["mag", "mfcc", "energy", "zcr", "intensity_loudness", "spectral", "voicing_power"]


@pytest.fixture(scope="module")
def frame_stages():
    x = WAVES["f1.wav"]
    ref = jax_os.OpenSmileExtractor()._frame_stage(jnp.asarray(x))
    ours = port_os.OpenSmileExtractor(device="cpu").frame_stage(torch.from_numpy(x))
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours]


@pytest.mark.parametrize("stream", STREAMS)
def test_frame_stage_matches_jax(frame_stages, stream):
    ref, ours = frame_stages
    i = STREAMS.index(stream)
    assert ours[i].shape == ref[i].shape and ours[i].dtype == np.float32
    np.testing.assert_allclose(ours[i], ref[i], rtol=1e-5, atol=1e-5 * np.abs(ref[i]).max())


FUNCTIONS = ["smooth_sma", "delta_regression", "apply_functionals",
             "smooth_sma_masked", "delta_regression_masked", "apply_functionals_masked"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_functionals_match_jax(name):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 50, 5)) * [1.0, 10.0, 0.1, 100.0, 1.0]).astype(np.float32)
    x[:, :, 4] = np.round(x[:, :, 4])  # a contour with exact ties (maxPos/minPos)
    lengths = np.array([50, 37])
    fn_j, fn_p = getattr(jax_fn, name), getattr(port_fn, name)
    if name.endswith("_masked"):
        ref = np.asarray(jax.vmap(fn_j)(jnp.asarray(x), jnp.asarray(lengths)))
        ours = fn_p(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
        valid = ((np.arange(50)[None, :] < lengths[:, None])[..., None]
                 if not name.startswith("apply") else np.ones_like(ref, bool))
        ref, ours = np.where(valid, ref, 0.0), np.where(valid, ours, 0.0)
    else:
        ref = np.asarray(jax.vmap(fn_j)(jnp.asarray(x)))
        ours = fn_p(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    if name.startswith("apply"):  # positions agree exactly
        np.testing.assert_array_equal(ours[:, 3:5], ref[:, 3:5])


def test_shs_pitch_batch_matches_jax():
    """Both chains fed the JAX frame stage's spectra: F0 per frame."""
    ex = jax_os.OpenSmileExtractor()
    stack = np.zeros((2, 27000), np.float32)
    stack[0, :20800] = WAVES["f1.wav"]
    stack[1, :25600] = WAVES["f2.wav"]
    mag, _, energy, _, _, _, vpow = (np.array(a) for a in ex._frame_stage_batch(jnp.asarray(stack)))
    ref_f0, ref_voc = jax_shs.shs_pitch_batch(mag, SR, energy, win_len=400, voicing_power=vpow)
    f0, voc = port_shs.shs_pitch_batch(torch.from_numpy(mag), SR, torch.from_numpy(energy),
                                       win_len=400, voicing_power=torch.from_numpy(vpow))
    f0, voc = f0.numpy(), voc.numpy()
    assert f0.shape == ref_f0.shape == (2, 167) and f0.dtype == voc.dtype == np.float32
    assert (ref_f0 > 0).mean() > 0.4  # the test audio is mostly voiced
    same = np.isclose(f0, ref_f0, rtol=1e-3, atol=0.0)
    assert same.mean() >= 0.995
    np.testing.assert_allclose(voc, ref_voc, rtol=1e-4, atol=1e-5)


# ---- whole extraction ---------------------------------------------------------


def test_extract_batch_matches_jax(jax_batch, port_batch):
    cols = jax_os.feature_columns()
    assert list(port_batch.columns) == list(jax_batch.columns) == cols + ["filename"]
    assert sorted(port_batch["filename"]) == sorted(WAVES)
    a = port_batch.set_index("filename").loc[sorted(WAVES)][cols].to_numpy()
    b = jax_batch.set_index("filename").loc[sorted(WAVES)][cols].to_numpy()
    assert np.isfinite(a).all()
    rel = _rel(a, b)
    vq = np.array([any(k in c for k in VQ) for c in cols])
    assert np.nanmedian(rel) < 1e-5
    assert np.nanmean(rel[:, ~vq]) < 2e-4
    assert np.nanmean(rel[:, vq]) < 5e-2


def test_reference_compat_911_schema(port_batch):
    ex = port_os.OpenSmileExtractor(port_os.OpenSmileConfig(reference_compat=True), device="cpu")
    names, feats = ex.extract_arrays(WAVES, verbose=False)
    assert feats.shape == (3, 911) and feats.dtype == np.float32
    cols911 = port_os.feature_columns(reference_compat=True)
    full = port_batch.set_index("filename").loc[names][cols911].to_numpy()
    np.testing.assert_array_equal(feats, full.astype(np.float32))
    compat = ex.extract_batch(WAVES, verbose=False)
    assert compat.shape == (3, 912) and port_os.feature_columns()[0] not in compat.columns


def test_single_file_paths_agree_with_the_batch(port_batch):
    """extract_llds / extract_single / extract(batched=False) on one file
    give the batch's row (same bucket, same march)."""
    ex = port_os.OpenSmileExtractor(device="cpu")
    x = WAVES["f0.wav"]
    llds = ex.extract_llds(x)
    assert llds.shape == (98, 38) and np.isfinite(llds).all()
    row = port_batch.set_index("filename").loc["f0.wav"][port_os.feature_columns()].to_numpy()
    np.testing.assert_allclose(ex.extract_single(x), row, rtol=1e-6, atol=1e-7)
    serial = ex.extract({"f0.wav": x}, verbose=False, batched=False)
    np.testing.assert_allclose(serial[port_os.feature_columns()].to_numpy()[0], row,
                               rtol=1e-6, atol=1e-7)


def test_extract_drops_subframe_clips(capsys):
    ex = port_os.OpenSmileExtractor(device="cpu")
    names, feats = ex.extract_arrays({"ok.wav": WAVES["f0.wav"], "tiny.wav": np.zeros(100)})
    assert names == ["ok.wav"] and feats.shape == (1, 912) and np.isfinite(feats).all()
    assert "tiny.wav" in capsys.readouterr().out
    serial = ex.extract({"tiny.wav": np.zeros(100)}, verbose=False, batched=False)
    assert serial.empty


def test_dataframe_front_door(tmp_path, capsys, port_batch):
    """Unreadable files and repeated basenames are dropped with a logged
    error; an empty input gives the empty schema."""
    import pandas as pd

    from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_wav(str(tmp_path / "a" / "rec.wav"), WAVES["f0.wav"], SR)
    write_wav(str(tmp_path / "b" / "rec.wav"), WAVES["f1.wav"], SR)
    df_in = pd.DataFrame({"filepath": [str(tmp_path / "a" / "rec.wav"),
                                       str(tmp_path / "b" / "rec.wav"), "/nonexistent/x.wav"]})
    out = port_os.extract_opensmile_features(df_in, device="cpu")
    assert out.shape == (1, 913) and list(out["filename"]) == ["rec.wav"]
    cols = port_os.feature_columns()
    row = port_batch.set_index("filename").loc["f0.wav"][cols].to_numpy()
    np.testing.assert_array_equal(out[cols].to_numpy()[0], row)  # the WAV holds f0.wav exactly
    assert out.iloc[0]["F0final_sma_amean"] > 30
    logged = capsys.readouterr().out
    assert "duplicate basename" in logged and "x.wav" in logged
    empty = port_os.extract_opensmile_features(pd.DataFrame({"filepath": []}), device="cpu")
    assert empty.empty and list(empty.columns) == ["filename"] + port_os.feature_columns()


def test_pipelined_sub_batches_wrap_the_window(monkeypatch):
    """``pipeline_rows=1`` over five files: five sub-batch chains, three
    queued before the oldest is read, so the window wraps. Chains are queued
    and read in order, and the rows equal a run with a window of one, bit
    for bit."""
    waves = {f"p{i}.wav": _speech(0.5 + 0.1 * i, 125 + 10 * i, 10 + i) for i in range(5)}
    events = []

    def spy(ex):
        real = ex._dispatch

        def dispatch(bucket, part):
            i = len([e for e in events if e[0] == "queue"])
            events.append(("queue", i))
            chain = real(bucket, part)
            finalize = chain.finalize
            chain.finalize = lambda host: (events.append(("read", i)), finalize(host))[1]
            return chain

        ex._dispatch = dispatch
        return ex

    wide = spy(port_os.OpenSmileExtractor(pipeline_rows=1, device="cpu"))
    names, feats = wide.extract_arrays(waves, verbose=False)
    assert [e for e in events] == [("queue", 0), ("queue", 1), ("queue", 2), ("read", 0),
                                   ("queue", 3), ("read", 1), ("queue", 4), ("read", 2),
                                   ("read", 3), ("read", 4)]
    events.clear()
    monkeypatch.setattr(port_os, "_MAX_INFLIGHT", 1)
    one = spy(port_os.OpenSmileExtractor(pipeline_rows=1, device="cpu"))
    names1, feats1 = one.extract_arrays(waves, verbose=False)
    assert events == [(kind, i) for i in range(5) for kind in ("queue", "read")]
    assert names == names1 and sorted(names) == sorted(waves)
    np.testing.assert_array_equal(feats, feats1)
    assert feats.shape == (5, 912) and np.isfinite(feats).all()
