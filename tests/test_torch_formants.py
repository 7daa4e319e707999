"""Port's Burg formants vs the JAX package, on the CPU.

Both packages read one 10 kHz preemphasized corpus buffer (the same float32
samples) and the same frame starts. Tolerances, each with its reason:

* ``burg_coeffs``: 1e-3 absolute on coefficients of order 10 over 500
  float32 samples a frame (the two packages add in other orders; the
  Levinson recursion carries each step's rounding into the next);
* ``durand_kerner_roots`` fed the same coefficients: the same roots within
  1e-4 (60 complex64 steps from the same ring), in the same slots on at
  least 99 % of the frames (rounding can leave two roots of a set swapped
  between slots);
* ``formant_track_burg_batch``: F1/F2 within 0.5 Hz and B1/B2 within 1 Hz
  on frames with energy, where both are finite, and finite on the same
  frames on at least 99 % of them. A frame of near-silence has Burg
  coefficients ≈ 0, so its polynomial is ≈ z¹⁰: a root of multiplicity 10,
  to which Durand–Kerner converges slowly and erratically, so such frames
  are not compared (the extractor reads formants at glottal pulses, which
  lie in voiced frames).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from robust_speech_analysis_framework_tpu.ops import formants as jax_formants
from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu_torch.ops import formants as port_formants
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing
from robust_speech_analysis_framework_tpu_torch.ops.cepstrum import cepstrum_preprocess
from robust_speech_analysis_framework_tpu_torch.ops.spectral import praat_gaussian_window

import jax.numpy as jnp

SR = 16000
BURG_ATOL, ROOT_ATOL = 1e-3, 1e-4
F_ATOL, B_ATOL, FINITE_SHARE = 0.5, 1.0, 0.99


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


@pytest.fixture(scope="module")
def buffers():
    """The 10 kHz preemphasized waveforms in both packages' buffers."""
    x10k = [cepstrum_preprocess(x, SR)[0] for x in
            (_speech(1.3, 120, 0), _speech(2.0, 205, 1), _speech(0.03, 150, 2))]
    jbuf = jax_framing.corpus_buffer(x10k, pad=1024)
    pbuf = port_framing.corpus_buffer(x10k, pad=1024, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbuf.x_cat), pbuf.x_cat.numpy())
    return x10k, jbuf, pbuf


def _energetic_frames(x10k, pbuf, win_len=500, hop=50):
    """Frame starts (in the buffer) of windows whose RMS is within 20 dB of
    the file's loudest, and the windowed frames."""
    starts = []
    for x, off in zip(x10k[:2], pbuf.offsets):
        s = np.arange(0, len(x) - win_len, hop)
        rms = np.sqrt(np.array([np.mean(x[a : a + win_len] ** 2) for a in s]))
        starts.append(s[rms > 0.1 * rms.max()] + off)
    starts = np.concatenate(starts)
    window = praat_gaussian_window(win_len).astype(np.float32)
    frames = pbuf.x_cat.numpy()[starts[:, None] + np.arange(win_len)] * window
    return starts, frames


def test_burg_coeffs_match_jax(buffers):
    _, frames = _energetic_frames(buffers[0], buffers[2])
    ours = port_formants.burg_coeffs(torch.from_numpy(frames), 10).numpy()
    ref = np.asarray(jax_formants.burg_coeffs(jnp.asarray(frames), 10))
    assert ours.shape == ref.shape == (len(frames), 10) and len(frames) > 200
    np.testing.assert_allclose(ours, ref, rtol=0, atol=BURG_ATOL)


def test_burg_recovers_ar2():
    rng = np.random.default_rng(0)
    a_true = [1, -1.5, 0.9]
    x = sps.lfilter([1], a_true, rng.normal(size=3000)).astype(np.float32)
    a = port_formants.burg_coeffs(torch.from_numpy(x[None, :2000]), 2).numpy()[0]
    np.testing.assert_allclose(a, a_true[1:], atol=0.05)


def test_durand_kerner_matches_jax(buffers):
    _, frames = _energetic_frames(buffers[0], buffers[2])
    coeffs = np.asarray(jax_formants.burg_coeffs(jnp.asarray(frames), 10))
    re, im = port_formants.durand_kerner_roots(torch.from_numpy(coeffs.copy()))
    ref_re, ref_im = jax_formants.durand_kerner_roots(jnp.asarray(coeffs))
    z = re.numpy() + 1j * im.numpy()
    zr = np.asarray(ref_re) + 1j * np.asarray(ref_im)
    # every root of each side lies within ROOT_ATOL of a root of the other
    dist = np.abs(z[:, :, None] - zr[:, None, :])
    assert dist.min(axis=2).max() < ROOT_ATOL and dist.min(axis=1).max() < ROOT_ATOL
    # and in the same slot on nearly every frame (a few frames end with two
    # roots of the set swapped between slots; the formants sort them anyway)
    assert (np.abs(z - zr).max(axis=1) < ROOT_ATOL).mean() >= FINITE_SHARE


def test_durand_kerner_known_roots():
    roots_true = np.array([0.5, -0.25, 0.1j, -0.1j])  # (z−0.5)(z+0.25)(z−0.1j)(z+0.1j)
    coeffs = np.poly(roots_true)
    re, im = port_formants.durand_kerner_roots(torch.from_numpy(coeffs[None, 1:].real.copy()))
    got = re.numpy()[0] + 1j * im.numpy()[0]
    assert np.max(np.abs(np.sort(np.abs(got)) - np.sort(np.abs(roots_true)))) < 1e-3


def test_formant_track_batch_matches_jax_on_energetic_frames(buffers):
    x10k, jbuf, pbuf = buffers
    kw = dict(time_step=0.005, max_formants=5, max_formant_hz=5000, window_length=0.025,
              preemphasis_from=50, preprocessed=True)
    ref = jax_formants.formant_track_burg_batch(None, 10000.0, buf=jbuf, **kw)
    ours = port_formants.formant_track_burg_batch(None, 10000.0, buf=pbuf, **kw)
    assert len(ours) == 3 and len(ours[2].times) == 0 and ours[2].freqs.shape == (0, 5)
    compared = 0
    for a, b, x in zip(ours[:2], ref[:2], x10k):
        np.testing.assert_array_equal(a.times, b.times)
        starts = np.clip(np.round(a.times * 10000 - 250).astype(int), 0, len(x) - 500)
        rms = np.sqrt(np.array([np.mean(x[s : s + 500] ** 2) for s in starts]))
        loud = rms > 0.1 * rms.max()
        for k in (0, 1):
            fa, fb = a.freqs[loud, k], b.freqs[loud, k]
            assert (np.isfinite(fa) == np.isfinite(fb)).mean() >= FINITE_SHARE
            both = np.isfinite(fa) & np.isfinite(fb)
            np.testing.assert_allclose(fa[both], fb[both], rtol=0, atol=F_ATOL)
            ba, bb = a.bands[loud, k], b.bands[loud, k]
            np.testing.assert_allclose(ba[both], bb[both], rtol=0, atol=B_ATOL)
            compared += int(both.sum())
    assert compared > 300
    # the deferred form and the upload form give the buffer form's tracks
    d = port_formants.formant_track_burg_batch(None, 10000.0, buf=pbuf, defer=True, **kw)
    up = port_formants.formant_track_burg_batch(x10k, 10000.0, device="cpu", **kw)
    for a, b, c in zip(port_framing.collect([d])[0], up, ours):
        np.testing.assert_array_equal(a.freqs, c.freqs)
        np.testing.assert_array_equal(b.freqs, c.freqs)


def test_formant_batch_rejects_a_pad_shorter_than_the_window(buffers):
    buf = port_framing.corpus_buffer(buffers[0], pad=256, device="cpu")
    with pytest.raises(ValueError, match="pad 256 < window 500"):
        port_formants.formant_track_burg_batch(None, 10000.0, buf=buf)


def test_formants_on_synthetic_vowel():
    """A 120 Hz pulse train through resonators at 700 and 1200 Hz: the host
    track's median F1 and F2 within 60 Hz (the JAX package's oracle)."""
    pulses = np.zeros(SR)
    pulses[:: SR // 120] = 1.0
    v = pulses
    for fc, bw in [(700, 90), (1200, 110)]:
        r = np.exp(-np.pi * bw / SR)
        th = 2 * np.pi * fc / SR
        v = sps.lfilter([1], [1, -2 * r * np.cos(th), r * r], v)
    ft = port_formants.formant_track_burg(v, SR, time_step=0.01)
    assert abs(np.nanmedian(ft.freqs[:, 0]) - 700) < 60
    assert abs(np.nanmedian(ft.freqs[:, 1]) - 1200) < 60
    # value_at / bandwidth_at interpolate the track; off the grid is NaN
    t = ft.times[3] + 0.25 * (ft.times[4] - ft.times[3])
    assert ft.value_at(1, t) == pytest.approx(0.75 * ft.freqs[3, 0] + 0.25 * ft.freqs[4, 0])
    assert ft.bandwidth_at(2, ft.times[5]) == pytest.approx(ft.bands[5, 1])
    assert np.isnan(ft.value_at(1, ft.times[-1] + 1.0))
