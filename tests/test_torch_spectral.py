"""Port's spectrogram and spectral moments vs the JAX package, on the CPU.

The same seeded speech-like 16-bit PCM files, in both packages' corpus
buffers (equal bit for bit), and the same voiced predicates go through
both. Tolerances, each with its reason:

* per-frame moments (``_gathered_frame_moments``, FFT-bin units): gravity
  and spread to 1e-5 relative, skewness and kurtosis to 1e-4 relative
  (float32 sums over 1024 bins; the kurtosis raises bin offsets of up to
  512 to the fourth power), NaN masks equal;
* voiced means (``voiced_mean_moments_batch``): 1e-5 relative (means of
  thousands of frames);
* the host oracles (numpy float64 here, float32 FFTs in the JAX package):
  1e-4 relative.
"""

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu.ops import spectral as jax_spectral
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing
from robust_speech_analysis_framework_tpu_torch.ops import spectral as port_spectral

import jax.numpy as jnp

SR = 16000
MOMENT_RTOL = (1e-5, 1e-5, 1e-4, 1e-4)
MEAN_RTOL = 1e-5
HOST_RTOL = 1e-4


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


def _gated(t):
    """Voiced where the recipe's syllable gate is open."""
    return (np.atleast_1d(t) % 0.6) < 0.42


@pytest.fixture(scope="module")
def corpus():
    xs = [_speech(1.2, 110, 0), _speech(2.1, 210, 1), _speech(0.02, 150, 2)]
    jbuf = jax_framing.corpus_buffer(xs, pad=4096, align=8)
    pbuf = port_framing.corpus_buffer(xs, pad=4096, align=8, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbuf.x_cat), pbuf.x_cat.numpy())
    return xs, jbuf, pbuf


def test_gathered_frame_moments_match_jax(corpus):
    xs, jbuf, pbuf = corpus
    win_len, n_fft = 800, 1024
    window = port_spectral.praat_gaussian_window(win_len)
    starts = np.concatenate([np.arange(0, len(x) - win_len, 80) + off
                             for x, off in zip(xs[:2], pbuf.offsets)])
    ref = np.asarray(jax_spectral._gathered_frame_moments(
        jbuf.x_cat, jnp.asarray(starts.astype(np.int32)), jnp.asarray(window, jnp.float32),
        win_len, n_fft))
    ours = port_spectral._gathered_frame_moments(
        pbuf.x_cat, torch.from_numpy(starts), torch.from_numpy(window.astype(np.float32)),
        win_len, n_fft).numpy()
    assert ours.shape == ref.shape == (len(starts), 4)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    for c, rtol in enumerate(MOMENT_RTOL):
        np.testing.assert_allclose(ours[:, c], ref[:, c], rtol=rtol)


@pytest.mark.parametrize("defer", [False, True])
def test_voiced_mean_moments_batch_matches_jax(corpus, defer):
    """Same buffer, same voiced predicates; deferred with the predicates
    bound only at finalize time (a zero-argument callable)."""
    xs, jbuf, pbuf = corpus
    ref = jax_spectral.voiced_mean_moments_batch(None, SR, [_gated] * 3, buf=jbuf)
    bound = []
    ours = port_spectral.voiced_mean_moments_batch(
        None, SR, (lambda: bound) if defer else [_gated] * 3, buf=pbuf, defer=defer)
    if defer:
        bound.extend([_gated] * 3)  # after the device pass was queued
        ours = port_framing.collect([ours])[0]
    assert len(ours) == 3
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=MEAN_RTOL)
        assert 100 < a[0] < 2000 and a[1] > 0
    assert all(np.isnan(v) for v in ours[2]) and all(np.isnan(v) for v in ref[2])
    # the upload form (no buffer) gives the buffer form's values
    upload = port_spectral.voiced_mean_moments_batch(xs, SR, [_gated] * 3, device="cpu")
    np.testing.assert_allclose(np.asarray(upload), np.asarray(ours), rtol=1e-6)


def test_batch_rejects_a_pad_shorter_than_the_window(corpus):
    xs = corpus[0]
    buf = port_framing.corpus_buffer(xs, pad=512, device="cpu")
    with pytest.raises(ValueError, match="pad 512 < window 800"):
        port_spectral.voiced_mean_moments_batch(None, SR, [_gated] * 3, buf=buf)


def test_host_oracles_match_jax(corpus):
    x = corpus[0][1]
    sg, ref = port_spectral.spectrogram(x, SR), jax_spectral.spectrogram(x, SR)
    np.testing.assert_allclose(sg.times, ref.times)
    np.testing.assert_allclose(sg.freqs, ref.freqs)
    ours_m = port_spectral.spectral_moments(sg.power, sg.freqs)
    ref_m = jax_spectral.spectral_moments(ref.power, ref.freqs)
    for a, b in zip(ours_m, ref_m):
        np.testing.assert_allclose(a, b, rtol=HOST_RTOL)
    np.testing.assert_allclose(port_spectral.voiced_mean_moments(x, SR, _gated),
                               jax_spectral.voiced_mean_moments(x, SR, _gated), rtol=HOST_RTOL)
    # the batch on the CPU against the host oracle of the same file
    batch = port_spectral.voiced_mean_moments_batch([x], SR, [_gated], device="cpu")[0]
    np.testing.assert_allclose(batch, port_spectral.voiced_mean_moments(x, SR, _gated),
                               rtol=HOST_RTOL)


def test_spectral_moments_of_a_tone():
    """A 1 kHz tone: gravity at 1000 Hz, a narrow spread (the JAX package's
    oracle test)."""
    t = np.arange(SR) / SR
    sg = port_spectral.spectrogram(np.sin(2 * np.pi * 1000 * t), SR)
    g, s, _, _ = port_spectral.spectral_moments(sg.power, sg.freqs)
    assert np.nanmean(g) == pytest.approx(1000.0, abs=5.0)
    assert np.nanmean(s) < 50
    short = port_spectral.spectrogram(np.zeros(100), SR)
    assert short.power.shape == (0, 0)
    assert all(np.isnan(v) for v in port_spectral.voiced_mean_moments(np.zeros(100), SR, _gated))
