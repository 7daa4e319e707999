"""Port's whole MSHDS-25 extractor vs the JAX package's, on the CPU, and
the JAX package's extractor oracles run on the port.

One module-scoped run of each package's ``_extract_corpus`` over three
speech-like files of 1.7–2.5 s whose f0s form both pitch range groups.
The port follows the JAX package's pitch tracks by frame share, not bit for
bit (its K7 path finder against JAX's associative scan on the CPU), and
every later feature reads those tracks or the pulses marched on them, so
each feature has its own tolerance:

* speech rate (five features): 1e-6 relative (counts and durations);
* mean_F0, stdev_F0_Semitone, mean_dB, range_ratio_dB: 1e-5 relative;
* HNR_dB: 2e-3 dB (frames with r near 1 amplify float32 differences);
* Spectral_Slope, Spectral_Tilt: 1e-4 relative;
* Cepstral_Peak_Prominence: 5e-3 dB; every segment mean of these files lies
  far from the 4 dB cut, so no segment flips;
* the eight formant features: 1e-3 relative (read at the glottal pulses,
  so only at voiced, energetic frames: no silent frame's degenerate roots);
* the four spectral moments: 1e-5 relative;
* NaN masks equal.
"""

import numpy as np
import pandas as pd
import pytest

from robust_speech_analysis_framework_tpu.features import mshds as jax_mshds
from robust_speech_analysis_framework_tpu_torch.features import mshds

SR = 16000
RTOL = {**dict.fromkeys(mshds._TEMPORAL, 1e-6),
        **dict.fromkeys(["mean_F0", "stdev_F0_Semitone", "mean_dB", "range_ratio_dB"], 1e-5),
        "Spectral_Slope": 1e-4, "Spectral_Tilt": 1e-4,
        **{f"{s}_{k}_Loc": 1e-3 for s in ("mean", "std") for k in ("F1", "B1", "F2", "B2")},
        **dict.fromkeys(["Spectral_Gravity", "Spectral_Std_Dev", "Spectral_Skewness",
                         "Spectral_Kurtosis"], 1e-5)}
ATOL = {"HNR_dB": 2e-3, "Cepstral_Peak_Prominence": 5e-3}


def _speechlike(f0_base=120.0, seconds_v=0.35, n_bursts=5, seed=0):
    """Harmonic bursts with rising f0 between pauses, a little noise (the
    recipe of the JAX package's MSHDS tests)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_bursts):
        t = np.arange(int(seconds_v * SR)) / SR
        f0 = f0_base + 8 * i
        v = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 12))
        env = np.minimum(1, 12 * np.minimum(t, seconds_v - t))
        parts.append(0.3 * env * v / np.abs(v).max())
        parts.append(np.zeros(int((0.4 if i % 2 == 0 else 0.15) * SR)))
    x = np.concatenate(parts)
    return x + 0.001 * rng.normal(size=len(x))


@pytest.fixture(scope="module")
def corpus():
    return [_speechlike(110, 0.3, 4, seed=0), _speechlike(220, 0.35, 4, seed=1),
            _speechlike(150, 0.25, 3, seed=2)]


@pytest.fixture(scope="module")
def both(corpus):
    return (mshds._extract_corpus(corpus, SR, verbose=False, device="cpu"),
            jax_mshds._extract_corpus(corpus, SR, verbose=False))


def test_corpus_forms_both_range_groups(corpus):
    ranges = [mshds.speaker_pitch_range(x, SR, device="cpu") for x in corpus]
    assert ranges == [(60, 250), (100, 500), (60, 250)]
    assert ranges == [jax_mshds.speaker_pitch_range(x, SR) for x in corpus]


@pytest.mark.parametrize("name", mshds.FEATURE_NAMES)
def test_feature_matches_jax(both, name):
    ours, ref = both
    a = np.array([r[name] for r in ours])
    b = np.array([r[name] for r in ref])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, rtol=RTOL.get(name, 0.0), atol=ATOL.get(name, 0.0))


def test_all_features_present_finite_and_plausible(both):
    assert mshds.FEATURE_NAMES == jax_mshds.FEATURE_NAMES
    for f in both[0]:
        assert list(f) == mshds.FEATURE_NAMES
        assert all(np.isfinite(v) for v in f.values()), [k for k, v in f.items()
                                                         if not np.isfinite(v)]
    f = both[0][0]
    assert 100 < f["mean_F0"] < 200 and 0 < f["stdev_F0_Semitone"] < 6
    assert 50 < f["mean_dB"] < 90 and f["HNR_dB"] > 5
    assert 0.3 < f["Phonation_Ratio"] < 1.0 and 0 < f["Speaking_Rate"] < 8
    assert f["Articulation_Rate"] >= f["Speaking_Rate"]
    assert f["Cepstral_Peak_Prominence"] > 4
    assert 100 < f["Spectral_Gravity"] < 2000 and 100 < f["mean_F1_Loc"] < 1200


def test_arrays_core_equals_the_dict_rows(corpus, both):
    arr = mshds.extract_mshds_arrays(corpus, SR, device="cpu")
    assert arr.shape == (3, 25) and arr.dtype == np.float64
    rows = np.array([[r[k] for k in mshds.FEATURE_NAMES] for r in both[0]])
    np.testing.assert_array_equal(arr, rows)
    assert mshds.extract_mshds_arrays([], SR, device="cpu").shape == (0, 25)


def test_batch_equals_serial(corpus, both):
    df = mshds.extract_mshds_batch({"a.wav": corpus[0], "b.wav": corpus[1]}, SR, verbose=False,
                                   device="cpu")
    assert list(df.columns) == ["filename"] + mshds.FEATURE_NAMES
    for i, name in enumerate(("a.wav", "b.wav")):
        single = mshds.extract_mshds_single(corpus[i], SR, device="cpu")
        for k, v in single.items():
            got = df.set_index("filename").loc[name, k]
            assert got == pytest.approx(v, rel=1e-4, abs=1e-6, nan_ok=True), (name, k)


def test_host_and_device_marches_agree(corpus, both, monkeypatch):
    """Below the voiced-seconds rule the host march runs (as for these
    files); with the rule at zero the device march runs on the same tracks:
    the same pulses, to 99 %, and the same features within the tolerances."""
    seen = {}
    real_batch, real_host = mshds.point_process_cc_batch, mshds.point_process_cc

    def spy_batch(*args, **kwargs):
        seen["device"] = real_batch(*args, **kwargs)
        return seen["device"]

    def spy_host(x, sr, track):
        seen.setdefault("host", []).append(real_host(x, sr, track))
        return seen["host"][-1]

    monkeypatch.setattr(mshds, "point_process_cc_batch", spy_batch)
    monkeypatch.setattr(mshds, "point_process_cc", spy_host)
    host_rows = mshds._extract_corpus(corpus, SR, verbose=False, device="cpu")
    assert "device" not in seen and len(seen["host"]) == 6
    monkeypatch.setattr(mshds, "DEVICE_MARCH_MIN_VOICED_S", 0.0)
    device_rows = mshds._extract_corpus(corpus, SR, verbose=False, device="cpu")
    assert len(seen["device"]) == 6
    for a, b in zip(seen["device"], seen["host"]):
        assert len(b) > 20
        assert np.isin(np.round(b, 9), np.round(a, 9)).mean() >= 0.99
    for name in mshds.FEATURE_NAMES:
        a = np.array([r[name] for r in device_rows])
        b = np.array([r[name] for r in host_rows])
        np.testing.assert_allclose(a, b, rtol=max(RTOL.get(name, 0.0), 1e-3),
                                   atol=ATOL.get(name, 0.0) * 10)
    assert host_rows == both[0]


def test_formant_pulse_train_oracle():
    """A glottal pulse train through resonators at 600 and 1700 Hz with a
    silent tail: every feature finite, and pitch, CPP and formants recover
    the construction."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(1)
    n = int(SR * 2.0)
    x = np.zeros(n)
    x[: n - 100 : int(SR / 120.0)] = 1.0

    def resonator(f, bw):
        r = np.exp(-np.pi * bw / SR)
        return [1.0], [1.0, -2 * r * np.cos(2 * np.pi * f / SR), r * r]

    x = lfilter(*resonator(1700, 120), lfilter(*resonator(600, 80), x))
    x = 0.3 * x / np.abs(x).max() + 0.002 * rng.normal(size=n)
    x[int(0.85 * n):] = 0.0
    row = mshds.extract_mshds_single(x, SR, device="cpu")
    assert all(np.isfinite(v) for v in row.values()), [k for k, v in row.items()
                                                       if not np.isfinite(v)]
    assert row["mean_F0"] == pytest.approx(120.0, abs=2.0)
    assert row["Cepstral_Peak_Prominence"] > 8 and row["HNR_dB"] > 15
    assert row["mean_F1_Loc"] == pytest.approx(600, abs=80)
    assert row["mean_F2_Loc"] == pytest.approx(1700, abs=200)
    assert row["Phonation_Ratio"] > 0.8


def test_intensity_matches_analytic_spl():
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * 1.5)) / SR
    x = 0.2 * np.sin(2 * np.pi * 140 * t) + 0.0005 * rng.normal(size=len(t))
    row = mshds.extract_mshds_single(x, SR, device="cpu")
    assert row["mean_dB"] == pytest.approx(20 * np.log10(0.2 / np.sqrt(2) / 2e-5), abs=0.3)


def test_hnr_matches_constructed_snr():
    rng = np.random.default_rng(0)
    t = np.arange(int(SR * 1.5)) / SR
    v = sum(np.sin(2 * np.pi * k * 140 * t) / k for k in range(1, 10))
    v = v / np.sqrt(np.mean(v * v))
    for snr_db in (10.0, 20.0, 30.0):
        noise = rng.normal(size=len(t))
        noise /= np.sqrt(np.mean(noise * noise))
        row = mshds.extract_mshds_single(0.2 * (v + noise * 10 ** (-snr_db / 20)), SR,
                                         device="cpu")
        assert row["HNR_dB"] == pytest.approx(snr_db, abs=1.0)


def test_speaker_pitch_range():
    assert mshds.speaker_pitch_range(_speechlike(f0_base=110), SR, device="cpu") == (60, 250)
    assert mshds.speaker_pitch_range(_speechlike(f0_base=230), SR, device="cpu") == (100, 500)
    assert mshds.speaker_pitch_range(np.zeros(SR), SR, device="cpu") == (75, 500)


def _bench_speech(seconds, f0, seed):
    """The JAX package's benchmark recipe (vibrato on the frequency, 0.6 s
    syllable gating), quantised to 16-bit PCM."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    v = sum(np.sin(2 * np.pi * k * f0 * (1 + 0.01 * np.sin(2 * np.pi * 3 * t)) * t) / k
            for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    return (np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


def test_cpps_short_voiced_segment_nans_only_the_files_cpp():
    """A voiced sliver shorter than one cepstrogram window (this file, at
    t ≈ 5.86 s) NaNs the file's CPP and nothing else; a sibling file without
    one keeps a finite CPP."""
    rows = mshds._extract_corpus([_bench_speech(20.0, 150, 2), _bench_speech(20.0, 120, 0)],
                                 SR, verbose=False, device="cpu")
    assert np.isnan(rows[0]["Cepstral_Peak_Prominence"])
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "Cepstral_Peak_Prominence")
    assert np.isfinite(rows[1]["Cepstral_Peak_Prominence"])


def _harmonic(seconds, f0, sr):
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    v = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 12))
    return 0.3 * v / np.abs(v).max() + 0.001 * rng.normal(size=len(t))


def _spy_marches(monkeypatch):
    taken = []
    real_batch, real_host = mshds.point_process_cc_batch, mshds.point_process_cc
    monkeypatch.setattr(mshds, "point_process_cc_batch",
                        lambda *a, **k: taken.append("device") or real_batch(*a, **k))
    monkeypatch.setattr(mshds, "point_process_cc",
                        lambda *a, **k: taken.append("host") or real_host(*a, **k))
    return taken


def test_48k_file_gives_finite_features(monkeypatch):
    """A 1.2 s file at 48 kHz (under the voiced-seconds rule: the host
    march): the features the JAX package's 48 kHz test reads are right."""
    taken = _spy_marches(monkeypatch)
    row = mshds.extract_mshds_batch({"a.wav": _harmonic(1.2, 130, 48000)}, sr=48000,
                                    verbose=False, device="cpu").iloc[0]
    assert set(taken) == {"host"}
    assert np.isfinite(row["HNR_dB"]) and row["HNR_dB"] > 10
    assert 50 < row["mean_dB"] < 90
    assert row["mean_F0"] == pytest.approx(130, abs=3)
    assert np.isfinite(row[mshds.FEATURE_NAMES].astype(float)).all()


@pytest.mark.parametrize("f0,march", [(130.0, "device"), (80.0, "host")])
def test_march_follows_the_window_rule_at_48k(monkeypatch, f0, march):
    """Above the voiced-seconds rule the device march runs when its fixed
    gather windows cover the lowest f0 at the sample rate (2·sr/f0 seed
    samples: 740 at 130 Hz, 1202 at 80 Hz against 1088), the host march
    otherwise; both give the voice's pitch and finite pulse features."""
    monkeypatch.setattr(mshds, "DEVICE_MARCH_MIN_VOICED_S", 0.0)
    taken = _spy_marches(monkeypatch)
    row = mshds.extract_mshds_single(_harmonic(1.0, f0, 48000), 48000, device="cpu")
    assert set(taken) == {march}
    assert row["mean_F0"] == pytest.approx(f0, abs=3)
    assert np.isfinite(row["mean_F1_Loc"]) and np.isfinite(row["Spectral_Slope"])


def test_dataframe_front_door_gives_a_nan_row_for_an_unreadable_file(tmp_path, corpus):
    from robust_speech_analysis_framework_tpu_torch.audio.io import write_wav

    path = tmp_path / "01_CF56_1.wav"
    write_wav(str(path), corpus[2], SR)
    df_in = pd.DataFrame({"filepath": [str(path), str(tmp_path / "missing.wav")]})
    out = mshds.extract_mshds_features(df_in, verbose=False, device="cpu")
    assert out.shape == (2, 26) and list(out.columns) == ["filename"] + mshds.FEATURE_NAMES
    assert np.isfinite(out.iloc[0]["mean_F0"])
    assert out.iloc[1][mshds.FEATURE_NAMES].isna().all()
    injected = mshds.extract_mshds_features(pd.DataFrame({"filepath": ["/nowhere/a.wav"]}),
                                            verbose=False, waveforms={"a.wav": corpus[0]},
                                            device="cpu")
    assert np.isfinite(injected.iloc[0]["mean_F0"])
    assert mshds.extract_mshds_features(pd.DataFrame({"filepath": []}), device="cpu").empty
