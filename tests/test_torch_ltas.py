"""Port's pitch-corrected LTAS vs the JAX package, on the CPU.

Both packages get the same waveforms (in corpus buffers equal bit for bit)
and the same glottal pulses (the port's host march over one cc track).
Tolerances, each with its reason:

* the device path against the JAX package's device path: 1e-3 dB a band
  (float32 FFTs of the same periods, summed in another order), slope and
  tilt to 1e-4 relative;
* the device path against the port's host path (numpy float64): 1e-2 dB a
  band (float32 against float64 spectra);
* the band rule exactly: f = 0 and bins above the maximum frequency
  dropped, never clipped onto an edge band.
"""

import numpy as np
import pytest

from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu.ops import ltas as jax_ltas
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing
from robust_speech_analysis_framework_tpu_torch.ops import ltas as port_ltas
from robust_speech_analysis_framework_tpu_torch.ops import pitch as port_pitch
from robust_speech_analysis_framework_tpu_torch.ops import pulses as port_pulses

SR = 16000
JAX_DB, HOST_DB, STAT_RTOL = 1e-3, 1e-2, 1e-4


def _speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    """Speech-like audio (11 harmonics, 3 Hz vibrato, syllable gating, a
    little noise) quantised to 16-bit PCM."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    return np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0


def _pulses(x, floor=60, ceiling=250):
    track = port_pitch.pitch_track_cc(x, SR, time_step=0.005, floor=floor, ceiling=ceiling,
                                      device="cpu")
    return port_pulses.point_process_cc(x, SR, track)


@pytest.fixture(scope="module")
def corpus():
    xs = [_speech(1.4, 115, 0), _speech(2.0, 200, 1), _speech(0.3, 150, 2)]
    pulses = [_pulses(xs[0]), _pulses(xs[1], 100, 500), np.array([0.1, 0.11])]
    jbuf = jax_framing.corpus_buffer(xs, pad=4096, align=8)
    pbuf = port_framing.corpus_buffer(xs, pad=4096, align=8, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbuf.x_cat), pbuf.x_cat.numpy())
    return xs, pulses, jbuf, pbuf


def _stats(lt):
    return lt.slope_db(50, 1000, 1000, 4000), lt.spectral_tilt(100, 5000)


def test_device_path_matches_jax_and_the_host_path(corpus):
    xs, pulses, jbuf, pbuf = corpus
    assert min(len(p) for p in pulses[:2]) > 100
    ref = jax_ltas.ltas_pitch_corrected_batch(xs, SR, pulses, buf=jbuf)
    ours = port_ltas.ltas_pitch_corrected_batch(xs, SR, pulses, buf=pbuf)
    host = port_ltas.ltas_pitch_corrected_batch(xs, SR, pulses)
    assert len(ours) == 3
    for a, b, h in zip(ours[:2], ref[:2], host[:2]):
        np.testing.assert_array_equal(a.freqs, b.freqs)
        assert np.isfinite(a.power_db).all()
        np.testing.assert_allclose(a.power_db, b.power_db, rtol=0, atol=JAX_DB)
        np.testing.assert_allclose(a.power_db, h.power_db, rtol=0, atol=HOST_DB)
        np.testing.assert_allclose(_stats(a), _stats(b), rtol=STAT_RTOL)
    # two pulses make no interior period: every band undefined, NaN statistics
    for lt in (ours[2], ref[2], host[2]):
        assert np.isnan(lt.power_db).all() and all(np.isnan(v) for v in _stats(lt))
    # the host path equals the JAX package's host path
    for h, b in zip(host, jax_ltas.ltas_pitch_corrected_batch(xs, SR, pulses)):
        np.testing.assert_allclose(h.power_db, b.power_db, rtol=1e-12, atol=1e-9)


def test_deferred_and_repeated_runs_give_the_same_bits(corpus):
    """The per-file sum is a product with a one-hot matrix: the same bits
    every run, deferred or not."""
    xs, pulses, _, pbuf = corpus
    first = port_ltas.ltas_pitch_corrected_batch(xs, SR, pulses, buf=pbuf)
    d = port_ltas.ltas_pitch_corrected_batch(xs, SR, pulses, buf=pbuf, defer=True)
    for a, b in zip(first, port_framing.collect([d])[0]):
        np.testing.assert_array_equal(a.power_db, b.power_db)


def test_ltas_slope_sign():
    """A pulse train through a low-pass: energy concentrated low, so a
    positive low-minus-high slope and a falling tilt (the JAX package's
    oracle)."""
    t = np.arange(SR) / SR
    v = sum(np.sin(2 * np.pi * k * 130.0 * t) / (k * k) for k in range(1, 25))
    v /= np.abs(v).max()
    track = port_pitch.pitch_track_cc(v, SR, time_step=0.01, floor=75, ceiling=400, device="cpu")
    lt = port_ltas.ltas_pitch_corrected(v, SR, port_pulses.point_process_cc(v, SR, track))
    assert np.isfinite(lt.power_db[:40]).all()
    assert lt.slope_db(50, 1000, 1000, 4000) > 0
    assert lt.spectral_tilt(100, 5000) < 0


def test_band_rule_drops_zero_and_bins_above_the_maximum():
    f = np.array([0.0, 1e-9, 50.0, 100.0, 100.0 + 1e-9, 4999.0, 5000.0, 5000.1, 8000.0])
    idx, keep = port_ltas._praat_bands(f, 100.0, 50)
    np.testing.assert_array_equal(keep, [False, True, True, True, True, True, True, False, False])
    np.testing.assert_array_equal(idx[keep], [0, 0, 0, 1, 49, 49])


def test_energy_above_the_maximum_stays_out_of_the_top_band():
    """Over a 6.5 kHz tone stronger than the voice, the 50 bands to 5 kHz
    read what the first 50 bands of an 8 kHz LTAS read: nothing above the
    maximum is clipped onto the 4950 Hz band."""
    t = np.arange(SR) / SR
    x = sum(np.sin(2 * np.pi * k * 125.0 * t) / k for k in range(1, 30))
    x = x + 30.0 * np.sin(2 * np.pi * 6500.0 * t)
    pulses = [np.arange(0.01, 0.99, 1 / 125.0)]
    buf = port_framing.corpus_buffer([x], pad=4096, device="cpu")
    for kw, atol in ((dict(xs=[x]), 1e-9), (dict(xs=None, buf=buf), 1e-4)):
        lo = port_ltas.ltas_pitch_corrected_batch(sr=SR, pulses_list=pulses, **kw)[0]
        hi = port_ltas.ltas_pitch_corrected_batch(sr=SR, pulses_list=pulses,
                                                  max_frequency=8000.0, **kw)[0]
        assert len(lo.power_db) == 50 and len(hi.power_db) == 80
        np.testing.assert_allclose(lo.power_db, hi.power_db[:50], rtol=0, atol=atol)
        assert hi.power_db[65] > lo.power_db[-1] + 20  # the tone's own band is loud


def test_device_path_rejects_a_pad_shorter_than_a_period(corpus):
    xs, pulses, _, _ = corpus
    buf = port_framing.corpus_buffer(xs, pad=64, device="cpu")
    with pytest.raises(ValueError, match="pad 64 < period window"):
        port_ltas.ltas_pitch_corrected_batch(None, SR, pulses, buf=buf)
