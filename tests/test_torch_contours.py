"""Port's intensity and harmonicity (HNR) contours vs the JAX package, on the CPU.

The same seeded speech-like 16-bit PCM files (2–3.1 s, plus one shorter
than every window) go through both packages' corpus buffers at the MSHDS
parameters. Tolerances, each with its reason:

* intensity: max |Δ| 1e-4 dB per frame (float32 windowed sums in another
  order), and the same on every contour statistic;
* HNR: the NaN masks (silent or unvoiced frames) equal; max |Δ| 0.02 dB where
  both are finite (10·log10(r/(1−r)) magnifies a float32 difference in r by
  4.3/(1−r): 0.005 dB seen at r ≈ 0.997); ``mean_db`` within 2e-3 dB;
* the physical oracles of ``tests/test_ops_pitch.py``, with their bounds.
"""

import numpy as np
import pytest

from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu.ops import harmonicity as jax_hnr
from robust_speech_analysis_framework_tpu.ops import intensity as jax_int
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing
from robust_speech_analysis_framework_tpu_torch.ops import harmonicity as port_hnr
from robust_speech_analysis_framework_tpu_torch.ops import intensity as port_int

SR = 16000
DB_TOL = 1e-4
HNR_TOL, HNR_MEAN_TOL = 0.02, 2e-3


def _speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like audio (11 harmonics, 3 Hz vibrato, syllable gating, a
    little noise) quantised to 16-bit PCM; silent after ``seconds / 2`` for
    odd seeds, so the contours also see silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    if seed % 2:
        x[len(x) // 2 :] = 0.0
    return np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0


@pytest.fixture(scope="module")
def buffers():
    xs = [_speech(2.0, 100, 0), _speech(3.1, 200, 1), _speech(0.005, 150, 2),
          _speech(1.5, 130, 3)]
    return (xs, jax_framing.corpus_buffer(xs, pad=4096, align=8),
            port_framing.corpus_buffer(xs, pad=4096, align=8, device="cpu"))


@pytest.mark.parametrize("minimum_pitch,time_step", [(50, 0.016), (60, 0.005), (100, 0.005)])
def test_intensity_matches_jax(buffers, minimum_pitch, time_step):
    kw = dict(minimum_pitch=minimum_pitch, time_step=time_step, subtract_mean=True)
    ref = jax_int.intensity_contour_batch(None, SR, buf=buffers[1], **kw)
    ours = port_int.intensity_contour_batch(None, SR, buf=buffers[2], **kw)
    assert len(ours[2].values_db) == 0  # shorter than the window
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        if not len(b.values_db):
            continue
        assert a.values_db.dtype == b.values_db.dtype
        np.testing.assert_allclose(a.values_db, b.values_db, rtol=0, atol=DB_TOL)
        for stat in ("mean_energy_db", "mean_db", "min_db", "max_db"):
            assert getattr(a, stat)() == pytest.approx(getattr(b, stat)(), abs=DB_TOL)
        assert a.min_db(parabolic=False) == pytest.approx(b.min_db(parabolic=False), abs=DB_TOL)
        for q in (0.0, 0.1, 0.5, 0.99, 1.0):
            assert a.quantile(q) == pytest.approx(b.quantile(q), abs=DB_TOL)
        for t in (0.0, 0.3, 0.777, 1.2):
            assert a.value_at_time(t) == pytest.approx(b.value_at_time(t), abs=DB_TOL)
        assert a.min_in_range(0.2, 0.9) == pytest.approx(b.min_in_range(0.2, 0.9), abs=DB_TOL)
        assert np.isnan(a.min_in_range(5.0, 6.0)) and np.isnan(b.min_in_range(5.0, 6.0))


def test_intensity_without_mean_subtraction_and_serial(buffers):
    xs = buffers[0]
    ref = jax_int.intensity_contour_batch(xs, SR, minimum_pitch=100, subtract_mean=False)
    ours = port_int.intensity_contour_batch(xs, SR, minimum_pitch=100, subtract_mean=False,
                                            device="cpu")
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.values_db, b.values_db, rtol=0, atol=DB_TOL)
    one = port_int.intensity_contour(xs[1], SR, minimum_pitch=100, subtract_mean=False,
                                     device="cpu")
    np.testing.assert_array_equal(one.values_db, ours[1].values_db)


def test_intensity_statistics_of_short_contours():
    for values in ([], [61.0], [60.0, 62.0, 61.0]):
        args = (np.arange(len(values)) * 0.01, np.asarray(values))
        a, b = port_int.IntensityContour(*args), jax_int.IntensityContour(*args)
        np.testing.assert_equal(a.quantile(0.5), b.quantile(0.5))
        if values:
            assert (a.min_db(), a.max_db()) == (b.min_db(), b.max_db())


@pytest.mark.parametrize("minimum_pitch", [60, 100])
def test_harmonicity_matches_jax(buffers, minimum_pitch):
    kw = dict(time_step=0.005, minimum_pitch=minimum_pitch, silence_threshold=0.1,
              periods_per_window=4.5)
    ref = jax_hnr.harmonicity_cc_batch(None, SR, buf=buffers[1], **kw)
    ours = port_hnr.harmonicity_cc_batch(None, SR, buf=buffers[2], **kw)
    assert len(ours[2].hnr_db) == 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        if not len(b.hnr_db):
            continue
        np.testing.assert_array_equal(np.isnan(a.hnr_db), np.isnan(b.hnr_db))
        both = np.isfinite(b.hnr_db)
        assert both.any()
        np.testing.assert_allclose(a.hnr_db[both], b.hnr_db[both], rtol=0, atol=HNR_TOL)
        assert a.mean_db() == pytest.approx(b.mean_db(), abs=HNR_MEAN_TOL)
    silent = ours[1].hnr_db[ours[1].times > 1.8]  # the file's silent half
    assert len(silent) and np.isnan(silent).all()


def test_harmonicity_serial_and_deferred(buffers):
    xs = buffers[0]
    d = port_hnr.harmonicity_cc_batch(xs, SR, 0.005, 75, defer=True, device="cpu")
    batch = port_framing.collect([d])[0]
    one = port_hnr.harmonicity_cc(xs[0], SR, 0.005, 75, device="cpu")
    np.testing.assert_array_equal(one.hnr_db, batch[0].hnr_db)


def test_buffer_pad_below_the_window_raises(buffers):
    buf = port_framing.corpus_buffer(buffers[0], pad=256, device="cpu")
    with pytest.raises(ValueError, match="pad 256"):
        port_int.intensity_contour_batch(None, SR, minimum_pitch=60, buf=buf)
    with pytest.raises(ValueError, match="pad 256"):
        port_hnr.harmonicity_cc_batch(None, SR, minimum_pitch=60, buf=buf)


def _harmonic(f0, seconds=0.8, n_harm=9):
    t = np.arange(int(seconds * SR)) / SR
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, n_harm))
    return x / np.abs(x).max()


def test_intensity_absolute_level_and_contrast():
    t = np.arange(SR) / SR
    x = 0.1 * np.sin(2 * np.pi * 1000 * t)
    ic = port_int.intensity_contour(x, SR, minimum_pitch=100, time_step=0.005, device="cpu")
    expected = 10 * np.log10((0.1**2 / 2) / 4e-10)
    assert ic.mean_db() == pytest.approx(expected, abs=0.05)
    assert ic.mean_energy_db() == pytest.approx(expected, abs=0.05)
    assert ic.quantile(0.5) == pytest.approx(expected, abs=0.1)
    x = np.sin(2 * np.pi * 500 * t) * np.where(t < 0.5, 0.01, 0.3)
    ic = port_int.intensity_contour(x, SR, minimum_pitch=100, time_step=0.01, device="cpu")
    assert ic.max_db() - ic.min_db() > 20


def test_hnr_orders_and_silence():
    clean = _harmonic(150)
    noisy = clean + 0.1 * np.random.default_rng(1).normal(size=len(clean))
    h_clean = port_hnr.harmonicity_cc(clean, SR, 0.005, 75, device="cpu").mean_db()
    h_noisy = port_hnr.harmonicity_cc(noisy, SR, 0.005, 75, device="cpu").mean_db()
    assert h_clean > 30 and 5 < h_noisy < h_clean
    x = np.concatenate([np.zeros(SR // 2), _harmonic(150, 0.5)])
    h = port_hnr.harmonicity_cc(x, SR, 0.005, 75, device="cpu")
    assert np.isnan(h.hnr_db[h.times < 0.4]).mean() > 0.8
