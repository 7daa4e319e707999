"""Port's CPPS (power cepstrogram, smoothing, robust trend) vs the JAX
package, on the CPU.

Both packages read one 10 kHz preemphasized corpus buffer (the same float32
samples) and the same voiced segments. Tolerances, each with its reason:

* per-frame prominence (``_gathered_cpps_prominence``): 2e-3 dB (float32
  spectra, a log, a second transform, a square and a 5-iteration reweighted
  line fit whose weights move with the rounding of each residual);
* per-file CPPS (``cpps_segments_batch``): 1e-3 dB, with the same segments
  kept; every segment mean of the corpus lies more than 1 dB from
  ``keep_above`` (4 dB), so no segment flips between the packages;
* the batch against the host cepstrogram and ``cpps`` of each segment:
  0.25 dB (the JAX package's own bound: the host smooths the whole segment,
  the batch its frames);
* the median of an even count is the mean of the two middle values, as
  ``jnp.median`` defines it.
"""

import numpy as np
import pytest
import torch

from robust_speech_analysis_framework_tpu.ops import cepstrum as jax_cepstrum
from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu_torch.ops import cepstrum as port_cepstrum
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing

import jax.numpy as jnp

SR, SR10K = 16000, 10000.0
PROM_ATOL, CPPS_ATOL, HOST_ATOL = 2e-3, 1e-3, 0.25


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


def _open_gates(seconds: float):
    """The recipe's open syllable gates, as voiced segments (s)."""
    return [(a + 0.01, min(a + 0.41, seconds)) for a in np.arange(0.0, seconds - 0.1, 0.6)]


@pytest.fixture(scope="module")
def corpus():
    lengths = (1.3, 2.0, 0.5)
    x10k = [port_cepstrum.cepstrum_preprocess(_speech(s, f0, i), SR)[0]
            for i, (s, f0) in enumerate(zip(lengths, (120, 205, 160)))]
    items = [(x, _open_gates(s)) for x, s in zip(x10k, lengths)]
    items[2] = (x10k[2], [])  # a file without voiced segments
    jbuf = jax_framing.corpus_buffer(x10k, pad=1024)
    pbuf = port_framing.corpus_buffer(x10k, pad=1024, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbuf.x_cat), pbuf.x_cat.numpy())
    return items, jbuf, pbuf


def _frames(items, pbuf):
    """Starts and segment ids of 2 ms frames over every segment (the batch's
    framing, without the Praat grid)."""
    starts, ids = [], []
    for fi, (x, segs) in enumerate(items):
        for a, b in segs:
            s = np.arange(int(a * SR10K), int(b * SR10K) - 333, 20)
            starts.append(s + pbuf.offsets[fi])
            ids.append(np.full(len(s), len(ids)))
    return np.concatenate(starts), np.concatenate(ids)


@pytest.mark.parametrize("trend_lo", [10, 11])  # 247 and 246 trend bins: odd and even
def test_gathered_prominence_matches_jax(corpus, trend_lo):
    items, jbuf, pbuf = corpus
    starts, ids = _frames(items, pbuf)
    k = np.arange(333) - 166
    window = np.exp(-0.5 * (6.0 * k / 333) ** 2).astype(np.float32)
    args = (333, 512, 1.0 / SR10K, trend_lo, 257, 33, 167, 5, 10)
    ref = np.asarray(jax_cepstrum._gathered_cpps_prominence(
        jbuf.x_cat, jnp.asarray(starts.astype(np.int32)), jnp.asarray(window),
        jnp.asarray(ids.astype(np.int32)), *args))
    ours = port_cepstrum._gathered_cpps_prominence(
        pbuf.x_cat, torch.from_numpy(starts), torch.from_numpy(window), torch.from_numpy(ids),
        *args).numpy()
    assert ours.shape == ref.shape and len(ours) > 500 and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PROM_ATOL)


@pytest.mark.parametrize("defer", [False, True])
def test_cpps_segments_batch_matches_jax(corpus, defer):
    items, jbuf, pbuf = corpus
    ref = jax_cepstrum.cpps_segments_batch(items, SR10K, buf=jbuf)
    ours = port_cepstrum.cpps_segments_batch(items, SR10K, buf=pbuf, defer=defer)
    if defer:
        ours = port_framing.collect([ours])[0]
    assert np.isnan(ours[2]) and np.isnan(ref[2])
    # every segment's mean lies more than 1 dB from keep_above, so none flips
    for x, segs in items[:2]:
        for seg in segs:
            m = port_cepstrum.cpps_segments_batch([(x, [seg])], SR10K, keep_above=-np.inf,
                                                  device="cpu")[0]
            assert abs(m - 4.0) > 1.0
    np.testing.assert_allclose(ours[:2], ref[:2], rtol=0, atol=CPPS_ATOL)
    # the upload form; a segment running past its file is clamped into it
    upload = port_cepstrum.cpps_segments_batch(items, SR10K, device="cpu")
    np.testing.assert_allclose(upload, ours, rtol=0, atol=1e-9)
    long = [(x, segs + [(len(x) / SR10K - 0.3, len(x) / SR10K + 5.0)]) for x, segs in items[:2]]
    np.testing.assert_allclose(port_cepstrum.cpps_segments_batch(long, SR10K, device="cpu"),
                               jax_cepstrum.cpps_segments_batch(long, SR10K), rtol=0,
                               atol=CPPS_ATOL)


def test_cpps_batch_matches_host_oracle():
    """The batch equals each segment's host cepstrogram and ``cpps`` (the
    JAX package's oracle test)."""
    t = np.arange(2 * SR) / SR
    v = sum(np.sin(2 * np.pi * k * 140 * t) / k for k in range(1, 15))
    x10k, sr10k = port_cepstrum.cepstrum_preprocess(v / np.abs(v).max(), SR)
    segs = [(0.10, 0.60), (0.80, 1.45)]
    got = port_cepstrum.cpps_segments_batch([(x10k, segs)], sr10k, device="cpu")[0]
    means = []
    for a, b in segs:
        cg = port_cepstrum.power_cepstrogram(x10k[int(a * sr10k) : int(b * sr10k)], sr10k,
                                             preemphasis_from=0.0)
        m, _ = port_cepstrum.cpps(cg)
        if np.isfinite(m) and m > 4.0:
            means.append(m)
    assert got == pytest.approx(float(np.mean(means)), abs=HOST_ATOL)


def test_cpps_voiced_vs_noise():
    t = np.arange(SR) / SR
    v = sum(np.sin(2 * np.pi * k * 150 * t) / k for k in range(1, 20))
    m_voiced, _ = port_cepstrum.cpps(port_cepstrum.power_cepstrogram(v / np.abs(v).max(), SR))
    noise = np.random.default_rng(0).normal(size=SR)
    m_noise, _ = port_cepstrum.cpps(port_cepstrum.power_cepstrogram(noise, SR))
    assert m_voiced > m_noise + 3
    # and the host oracles equal the JAX package's
    ref, _ = jax_cepstrum.cpps(jax_cepstrum.power_cepstrogram(v / np.abs(v).max(), SR))
    assert m_voiced == pytest.approx(ref, abs=2e-3)


def test_median_of_an_even_count_is_the_mean_of_the_middles():
    a = torch.tensor([[1.0, 2.0, 3.0, 4.0], [4.0, 1.0, 3.0, 2.0], [5.0, 1.0, 3.0, 0.0]])
    np.testing.assert_array_equal(port_cepstrum._median_rows(a)[:, 0].numpy(), [2.5, 2.5, 2.0])
    r = np.random.default_rng(0).normal(size=(50, 246)).astype(np.float32)
    np.testing.assert_array_equal(port_cepstrum._median_rows(torch.from_numpy(r)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(r), axis=1, keepdims=True)))
    odd = torch.from_numpy(r[:, :245].copy())  # an odd count: the middle value
    np.testing.assert_array_equal(port_cepstrum._median_rows(odd)[:, 0].numpy(),
                                  torch.median(odd, dim=1).values.numpy())


def test_shift_rows_fills_zeros_and_does_not_wrap():
    a = torch.arange(1.0, 6.0)
    np.testing.assert_array_equal(port_cepstrum._shift_rows(a, 2).numpy(), [0, 0, 1, 2, 3])
    np.testing.assert_array_equal(port_cepstrum._shift_rows(a, -2).numpy(), [3, 4, 5, 0, 0])
    assert port_cepstrum._shift_rows(a, 0) is a


def test_batch_rejects_a_pad_shorter_than_the_window(corpus):
    items = corpus[0]
    buf = port_framing.corpus_buffer([x for x, _ in items], pad=128, device="cpu")
    with pytest.raises(ValueError, match="pad 128 < window 333"):
        port_cepstrum.cpps_segments_batch(items, SR10K, buf=buf)
