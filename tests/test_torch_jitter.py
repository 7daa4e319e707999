"""Port's batched period march and voice-quality LLDs vs the JAX package and
the float64 numpy oracle, on the CPU.

The port marches with the plain version of its march kernel
(``ops/cuda/jitter.py:march_periods_reference``) on CPU tensors; it scores
lags with float64 sums, as the numpy oracle ``mark_periods`` does, where the
JAX package's device march scores them in float32 through DFT
correlations. Tolerances, each with its reason:

* march vs the oracle: ≥ 99 % of boundaries equal (float64 on both sides;
  the oracle's window energies are prefix-sum differences, the march's
  direct sums, so near-ties may break apart);
* march vs JAX's ``mark_periods_batch``: ≥ 97 % of boundaries equal, the
  JAX package's own bound for its march against the oracle
  (``tests/test_opensmile.py:431``), and the LLDs' mean relative difference
  < 5e-3 (``:437``); on exact digital silence under a voiced contour the
  same 97 % (``:575-611``);
* structure (unvoiced jumps, the cap, a lane that ends mid-voicing, a lane
  alone or in a batch): exact;
* ``periods_to_llds_batch`` vs JAX's, fed the same buffers: median relative
  difference < 1e-4 and < 2 % of frames above 1e-2 (float32 on both sides,
  prefix sums in other orders; period centres that land on frame edges
  may change sides; ``tests/test_opensmile.py:482-483``);
* ``upload_pcm_f32``: bit-equal to the JAX package's and to its input.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.features import opensmile as jax_os
from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu.ops import jitter as jax_jitter
from robust_speech_analysis_framework_tpu_torch.features import opensmile as port_os
from robust_speech_analysis_framework_tpu_torch.ops import framing
from robust_speech_analysis_framework_tpu_torch.ops import jitter as port_jitter
from robust_speech_analysis_framework_tpu_torch.ops.cuda import jitter as march_ops
from robust_speech_analysis_framework_tpu_torch.ops.shs_pitch import shs_pitch_batch
from tests.test_torch_train import one_torch_thread  # noqa: F401  (autouse fixture)

SR = 16000
HOP = 160


def _speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    """The speech-like files of tests/test_torch_opensmile.py: 11 harmonics
    with a 3 Hz vibrato, syllable gating, a little noise, 16-bit PCM."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = f0 * (t + 0.01 * (1 - np.cos(2 * np.pi * 3 * t)) / (2 * np.pi * 3))
    v = sum(np.sin(2 * np.pi * k * phase) / k for k in range(1, 12))
    gate = np.where((t % 0.6) < 0.42, 1.0, 0.02)
    x = 0.3 * gate * v / np.abs(v).max() + 0.002 * rng.normal(size=len(t))
    return (np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)


def _pulsed(seconds: float, f0: float) -> np.ndarray:
    """The JAX package's pulse-train recipe (tests/test_opensmile.py:29)."""
    t = np.arange(int(seconds * SR)) / SR
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 12))
    x = 0.3 * x / np.abs(x).max()
    return (x * np.where((t % 0.7) < 0.45, 1.0, 0.02)).astype(np.float32)


def _stack(waves):
    stack = np.zeros((len(waves), max(len(x) for x in waves)), np.float32)
    for i, x in enumerate(waves):
        stack[i, : len(x)] = x
    return stack


def _pad_f0(f0s):
    out = np.zeros((len(f0s), max(len(f) for f in f0s)), np.float32)
    for i, f in enumerate(f0s):
        out[i, : len(f)] = f
    return out


def _same_share(a, b) -> float:
    n = min(len(a.starts), len(b.starts))
    assert n > 10
    return float(np.mean(np.asarray(a.starts[:n]) == np.asarray(b.starts[:n])))


@pytest.fixture(scope="module")
def speech():
    """Three speech files in one stack, with the port's own pitch chain's
    F0 (CPU) as their contours: voiced syllables, unvoiced gaps."""
    waves = [_speech(s, 120 + 15 * i, i) for i, s in enumerate((1.0, 1.3, 1.6))]
    stack = _stack(waves)
    ex = port_os.OpenSmileExtractor(device="cpu")
    mag, _, energy, _, _, _, vpow = ex.frame_stage(torch.from_numpy(stack))
    f0, _ = shs_pitch_batch(mag, SR, energy, win_len=400, voicing_power=vpow)
    nf = [1 + (len(x) - 400) // HOP for x in waves]
    return waves, stack, f0.numpy(), nf


@pytest.fixture(scope="module")
def speech_marches(speech):
    """The port's and the JAX package's batched marches of ``speech``."""
    waves, stack, f0, nf = speech
    ns = [len(x) for x in waves]
    port = port_jitter.mark_periods_batch(torch.from_numpy(stack), SR, torch.from_numpy(f0),
                                          ns, nf)
    ref = jax_jitter.mark_periods_batch(stack, SR, f0, ns, nf)
    return port, ref


# ---- upload ---------------------------------------------------------------------


@pytest.mark.parametrize("lattice", [True, False], ids=["pcm16", "float"])
def test_upload_pcm_f32_matches_jax(lattice):
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, size=(3, 1000)).astype(np.float32)
    if lattice:
        a = (np.round(a * 32767) / 32768.0).astype(np.float32)
        a[0, 0], a[0, 1] = -1.0, 32767 / 32768.0  # both ends of the int16 range
    assert (framing._pcm_int16(a) is not None) == lattice
    got = framing.upload_pcm_f32(a, "cpu")
    assert got.dtype == torch.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_framing.upload_pcm_f32(a)))
    np.testing.assert_array_equal(got.numpy(), a)


# ---- the march against the oracle and the JAX package -----------------------------


def test_march_matches_numpy_oracle_on_speech(speech, speech_marches):
    waves, _, f0, nf = speech
    port, _ = speech_marches
    for i, x in enumerate(waves):
        ref = port_jitter.mark_periods(x.astype(np.float64), SR, f0[i, : nf[i]])
        assert _same_share(port[i], ref) >= 0.99, i
        assert len(port[i].starts) == len(ref.starts)


def test_march_matches_jax_on_speech(speech, speech_marches):
    _, _, f0, nf = speech
    port, ref = speech_marches
    for i in range(len(port)):
        assert _same_share(port[i], ref[i]) >= 0.97, i
        lld_port = port_jitter.periods_to_llds(port[i], f0[i, : nf[i]], SR)
        lld_ref = port_jitter.periods_to_llds(ref[i], f0[i, : nf[i]], SR)
        rel = np.abs(lld_port - lld_ref) / np.maximum(np.abs(lld_ref), 1e-3)
        assert np.nanmean(rel) < 5e-3, i


@pytest.mark.parametrize("f0", [110.0, 140.0, 185.0])
def test_march_matches_oracle_and_jax_on_a_pulse_train(f0):
    x = _pulsed(1.3, f0)
    nf = len(x) // HOP
    contour = np.full(nf, f0, np.float32)
    got = port_jitter.mark_periods_batch(x[None], SR, contour[None], [len(x)], [nf],
                                         device="cpu")[0]
    ref = port_jitter.mark_periods(x.astype(np.float64), SR, contour)
    jax_got = jax_jitter.mark_periods_batch(x[None], SR, contour[None], [len(x)], [nf])[0]
    assert _same_share(got, ref) >= 0.99
    assert _same_share(got, jax_got) >= 0.97
    agree = got.starts == ref.starts
    np.testing.assert_allclose(got.correlations[agree], ref.correlations[agree], atol=1e-6)
    np.testing.assert_array_equal(got.amplitudes[agree],
                                  np.float32(ref.amplitudes[agree]).astype(np.float64))


def test_march_through_digital_silence_under_a_voiced_contour():
    """Pulses, then exact zeros while the contour stays voiced: every lag
    scores 0 there (the energy guard), so the first lag wins on both sides."""
    x = np.concatenate([_pulsed(0.7, 125), np.zeros(int(SR * 0.6), np.float32)])
    nf = len(x) // HOP
    contour = np.full(nf, 125.0, np.float32)
    got = port_jitter.mark_periods_batch(x[None], SR, contour[None], [len(x)], [nf],
                                         device="cpu")[0]
    ref = port_jitter.mark_periods(x.astype(np.float64), SR, contour)
    jax_got = jax_jitter.mark_periods_batch(x[None], SR, contour[None], [len(x)], [nf])[0]
    assert _same_share(got, ref) >= 0.97
    assert _same_share(got, jax_got) >= 0.97
    silent = got.starts >= int(SR * 0.7) + 200
    assert silent.sum() > 50
    lo = int(SR / 125.0 * 0.75)
    assert (got.lengths[silent] == lo).all()  # the first lag of an all-zero score


@pytest.mark.parametrize("tail", ["voiced-last-frame", "unvoiced-last-frame"])
def test_long_pauses_land_where_the_oracle_crawls(tail):
    """Voiced, a 0.9 s pause, voiced again, and a contour shorter than the
    audio (frames past its end read its last frame): the jumps land on the
    oracle's half-hop positions and the periods after them are the same."""
    x = _pulsed(2.0, 150)
    nf = len(x) // HOP - 25
    contour = np.full(nf, 150.0, np.float32)
    contour[30:120] = 0.0
    contour[-1] = 150.0 if tail == "voiced-last-frame" else 0.0
    got = port_jitter.mark_periods_batch(x[None], SR, contour[None], [len(x)], [nf],
                                         device="cpu")[0]
    ref = port_jitter.mark_periods(x.astype(np.float64), SR, contour)
    np.testing.assert_array_equal(got.starts, ref.starts)
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    after = got.starts[got.starts >= 120 * HOP]
    assert len(after) > 20 and after[0] < 121 * HOP


def test_cap_and_broken_lane_counts_equal_jax():
    """A lane capped at p_max periods and a lane whose last voiced period
    runs past its end give JAX's counts and starts."""
    hi_f0 = _pulsed(0.25, 1500.0)  # ~10-sample periods: the cap binds
    mid = _pulsed(0.5, 130.0)  # voiced to its end: the lane breaks
    waves = [hi_f0, mid]
    stack = _stack(waves)
    nf = [len(x) // HOP for x in waves]
    f0 = _pad_f0([np.full(nf[0], 1500.0), np.full(nf[1], 130.0)])
    ns = [len(x) for x in waves]
    p_max = 200
    port = march_ops.march_periods(
        torch.from_numpy(stack), torch.from_numpy(f0), torch.tensor(ns, dtype=torch.int32),
        torch.tensor(nf, dtype=torch.int32), float(SR), HOP, 0.25, 40.0, p_max)
    ref = jax_jitter._march_periods_device(
        jnp.asarray(stack), jnp.asarray(f0), jnp.asarray(np.int32(ns)),
        jnp.asarray(np.int32(nf)), float(SR), HOP, 0.25, 40.0, p_max)
    counts = port[4].numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref[4]))
    assert counts[0] == p_max
    oracle = port_jitter.mark_periods(mid.astype(np.float64), SR, f0[1, : nf[1]])
    assert counts[1] == len(oracle.starts) < p_max
    last = oracle.starts[-1] + oracle.lengths[-1]
    assert last + 2 * (int(SR / 130.0 * 1.25) + 1) >= len(mid)  # the next band runs past
    for i, k in enumerate(counts):
        np.testing.assert_array_equal(port[0].numpy()[i, :k], np.asarray(ref[0])[i, :k])
        assert not port[0].numpy()[i, k:].any() and not port[2].numpy()[i, k:].any()


def test_lane_in_a_mixed_batch_equals_the_file_alone(speech, speech_marches):
    waves, _, f0, nf = speech
    batch, _ = speech_marches
    for i, x in enumerate(waves):
        alone = port_jitter.mark_periods_batch(x[None], SR, f0[i : i + 1, : nf[i]],
                                               [len(x)], [nf[i]], device="cpu")[0]
        for a, b in zip(alone, batch[i]):
            np.testing.assert_array_equal(a, b)


def test_march_wrapper_checks_its_inputs():
    x = torch.zeros(2, 400)
    f0 = torch.zeros(2, 3)
    n = torch.tensor([400, 400], dtype=torch.int32)
    args = (float(SR), HOP, 0.25, 40.0, 25)
    with pytest.raises(TypeError):
        march_ops.march_periods(x.double(), f0, n, n, *args)
    with pytest.raises(ValueError):
        march_ops.march_periods(x, f0[:1], n, n, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        march_ops.march_periods(x.to("meta"), f0.to("meta"), n.to("meta"), n.to("meta"), *args)
    with pytest.raises(ValueError, match="frames"):
        port_jitter.mark_periods_batch(x, SR, f0, [400, 400], [3, 0])
    starts, lengths, amps, corrs, counts = march_ops.march_periods(x, f0, n, n, *args)
    assert counts.tolist() == [0, 0] and starts.shape == (2, 25) and not amps.any()


# ---- periods → LLDs ------------------------------------------------------------------


def test_periods_to_llds_batch_matches_jax(speech, speech_marches):
    """Both packages' device conversions fed the port's march buffers."""
    waves, stack, f0, nf = speech
    d = port_jitter.mark_periods_batch(torch.from_numpy(stack), SR, torch.from_numpy(f0),
                                       [len(x) for x in waves], nf, defer=True)
    ours = port_jitter.periods_to_llds_batch(d.arrays, torch.from_numpy(f0), SR).numpy()
    ref = np.asarray(jax_jitter.periods_to_llds_batch(
        tuple(jnp.asarray(a.numpy()) for a in d.arrays), f0, SR))
    assert ours.shape == ref.shape == f0.shape + (4,) and ours.dtype == np.float32
    tracks = d.result()
    for i in range(len(waves)):
        host = port_jitter.periods_to_llds(tracks[i], f0[i, : nf[i]], SR)
        assert (host[:, 3] != 0).mean() > 0.3  # mostly voiced frames with a logHNR
        for other in (ref[i, : nf[i]], host):
            rel = np.abs(ours[i, : nf[i]] - other) / np.maximum(np.abs(other), 1e-3)
            assert np.nanmedian(rel) < 1e-4
            assert np.mean(np.nan_to_num(rel) > 1e-2) < 0.02


# ---- the chain in the extractor -------------------------------------------------------


def test_extractor_chain_equals_its_parts(speech):
    """``_llds``' voice-quality columns are periods_to_llds_batch of the
    march on the pitch chain's F0, with no host march in between."""
    waves, stack, f0, nf = speech
    ex = port_os.OpenSmileExtractor(device="cpu")
    lld = ex._llds(torch.from_numpy(stack), [len(x) for x in waves], nf)
    np.testing.assert_array_equal(lld[..., 14].numpy(), f0)
    arrays = march_ops.march_periods(
        torch.from_numpy(stack), torch.from_numpy(f0),
        torch.tensor([len(x) for x in waves], dtype=torch.int32),
        torch.tensor(nf, dtype=torch.int32), float(SR), HOP, 0.25, 40.0,
        max(stack.shape[1] // 16, 4))
    vq = port_jitter.periods_to_llds_batch(arrays, torch.from_numpy(f0), SR)
    cols = [port_os.LLD_NAMES.index(n) for n in ("jitterLocal", "jitterDDP", "shimmerLocal",
                                                 "logHNR")]
    np.testing.assert_array_equal(lld[..., cols].numpy(), vq.numpy())
    assert jax_os.LLD_NAMES == port_os.LLD_NAMES
