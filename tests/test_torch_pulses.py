"""Port's glottal-pulse march and interval segmentation vs the JAX package, on the CPU.

The same seeded speech-like 16-bit PCM files and the same cc pitch tracks
(the JAX package's, so both marches follow one track) go through both
packages. Tolerances, each with its reason:

* ``point_process_cc_batch`` against the JAX package's batched march: at
  least 99 % of each track's JAX pulse times found identically (both march
  in float32; XLA fuses multiply-adds that PyTorch rounds twice, so a
  window end can move by a sample), counts within 1 % + 1;
* against the port's host march ``point_process_cc`` (float64): at least
  97 % identical, the JAX package's own bound for its batched march;
* the host march, ``vuv_intervals``, ``silence_intervals`` and
  ``label_at_time`` (numpy copies): equal to the JAX package's;
* a waveform whose |x| ties exactly inside every search window: every
  march takes the first maximum, so all three agree pulse for pulse.
"""

import numpy as np
import pytest

from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu.ops import intensity as jax_int
from robust_speech_analysis_framework_tpu.ops import pitch as jax_pitch
from robust_speech_analysis_framework_tpu.ops import pulses as jax_pulses
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing
from robust_speech_analysis_framework_tpu_torch.ops import intensity as port_int
from robust_speech_analysis_framework_tpu_torch.ops import pitch as port_pitch
from robust_speech_analysis_framework_tpu_torch.ops import pulses as port_pulses

SR = 16000
JAX_SHARE, HOST_SHARE = 0.99, 0.97


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


def _port_track(tr):
    return None if tr is None else port_pitch.PitchTrack(*tr)


@pytest.fixture(scope="module")
def corpus():
    """Files in both range groups, one shorter than every window; their cc
    tracks (group (60, 250)) and main-pass tracks from the JAX package."""
    xs = [_speech(2.0, 100, 0), _speech(3.1, 200, 1), _speech(0.005, 150, 2),
          _speech(1.5, 130, 3)]
    jbuf = jax_framing.corpus_buffer(xs, pad=4096, align=8)
    cc = jax_pitch.pitch_track_batch(None, SR, jax_pitch.PitchParams(
        time_step=0.005, floor=60, ceiling=250, method="cc"), buf=jbuf)
    main = jax_pitch.pitch_track_batch(None, SR, jax_pitch.PitchParams(
        time_step=0.005, floor=60, ceiling=250, voicing_threshold=0.3), buf=jbuf)
    return xs, jbuf, port_framing.corpus_buffer(xs, pad=4096, align=8, device="cpu"), \
        list(cc) + list(main)


def _share(ours, ref):
    return np.isin(np.round(ref, 9), np.round(ours, 9)).mean() if len(ref) else 1.0


def test_batch_march_matches_jax_and_host(corpus):
    xs, jbuf, pbuf, tracks = corpus
    ref = jax_pulses.point_process_cc_batch(None, SR, tracks, buf=jbuf)
    ours = port_pulses.point_process_cc_batch(None, SR, [_port_track(t) for t in tracks],
                                              buf=pbuf)
    assert len(ours) == len(tracks) == 8
    assert port_pulses._march_lanes.steps > 0
    assert port_pulses._march_lanes.syncs <= port_pulses._march_lanes.steps // 16 + 2
    total = 0
    for k, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == np.float64 and np.all(np.diff(a) > 0)
        assert abs(len(a) - len(b)) <= len(b) // 100 + 1
        assert _share(a, b) >= JAX_SHARE
        host = port_pulses.point_process_cc(xs[k % 4], SR, _port_track(tracks[k]))
        assert _share(a, host) >= HOST_SHARE
        total += len(a)
    assert total > 1000
    assert len(ours[2]) == 0 and len(ours[6]) == 0  # the file shorter than a window


def test_upload_form_and_deferred_equal_the_buffer_form(corpus):
    xs, _, pbuf, tracks = corpus
    port_tracks = [_port_track(t) for t in tracks[:4]]
    from_buf = port_pulses.point_process_cc_batch(None, SR, port_tracks, buf=pbuf)
    d = port_pulses.point_process_cc_batch(xs, SR, port_tracks, defer=True, device="cpu")
    for a, b in zip(port_framing.collect([d])[0], from_buf):
        np.testing.assert_array_equal(a, b)


def test_host_march_equals_jax(corpus):
    xs, _, _, tracks = corpus
    for k in (0, 1, 3, 5):
        np.testing.assert_array_equal(
            port_pulses.point_process_cc(xs[k % 4], SR, _port_track(tracks[k])),
            jax_pulses.point_process_cc(xs[k % 4], SR, tracks[k]))


def test_exact_ties_take_the_first_maximum():
    """Each glottal pulse is two samples of equal magnitude (+0.5, then
    −0.5 three samples later): every search window holds an exact tie, and
    every march must take its first sample (np.argmax, jnp.argmax and
    torch.argmax all return the first maximum)."""
    period, n = 128, int(2.2 * SR)  # 125 Hz
    x = np.zeros(n)
    first = np.concatenate([np.arange(200, int(0.9 * SR), period),
                            np.arange(int(1.2 * SR), n - 200, period)])  # two stretches
    x[first], x[first + 3] = 0.5, -0.5
    times = np.arange(0.02, 2.18, 0.005)
    voiced = ((times > 0.02) & (times < 0.88)) | ((times > 1.22) & (times < 2.15))
    f0 = np.where(voiced, SR / period, 0.0)
    track = port_pitch.PitchTrack(times, f0, np.ones_like(times))
    host = port_pulses.point_process_cc(x, SR, track)
    buf = port_framing.corpus_buffer([x], pad=4096, device="cpu")
    ours = port_pulses.point_process_cc_batch(None, SR, [track], buf=buf)[0]
    ref = jax_pulses.point_process_cc_batch(
        None, SR, [jax_pitch.PitchTrack(times, f0, np.ones_like(times))],
        buf=jax_framing.corpus_buffer([x], pad=4096))[0]
    assert len(host) > 150
    np.testing.assert_array_equal(ours, host)
    np.testing.assert_array_equal(ours, ref)
    samples = np.round(ours * SR).astype(int)
    assert np.isin(samples, first).all()  # never the tie's second sample


def test_batch_march_rejects_what_it_cannot_march(corpus):
    xs, _, pbuf, tracks = corpus
    port_tracks = [_port_track(t) for t in tracks[:4]]
    with pytest.raises(ValueError, match="not a multiple"):
        port_pulses.point_process_cc_batch(None, SR, port_tracks[:3], buf=pbuf)
    coarse = port_pitch.PitchTrack(np.arange(0.0, 1.0, 0.01), np.full(100, 120.0), np.ones(100))
    with pytest.raises(ValueError, match="mixed pitch-track time steps"):
        port_pulses.point_process_cc_batch(None, SR, [port_tracks[0], coarse, None, None],
                                           buf=pbuf)
    with pytest.raises(ValueError, match="seed window"):
        port_pulses.point_process_cc_batch(
            None, SR, port_tracks, buf=port_framing.corpus_buffer(xs, pad=512, device="cpu"))
    low = port_pitch.PitchTrack(np.arange(0.0, 1.0, 0.005), np.full(200, 20.0), np.ones(200))
    with pytest.raises(ValueError, match="gather windows"):
        port_pulses.point_process_cc_batch([np.zeros(SR)], SR, [low], device="cpu")
    assert port_pulses.point_process_cc_batch([np.zeros(10)], SR, [None], device="cpu")[0].size == 0


@pytest.mark.parametrize("case", range(4))
def test_vuv_intervals_equal_jax(case):
    rng = np.random.default_rng(case)
    pulses = np.sort(np.concatenate([
        np.array([0.30, 0.31, 0.32, 0.40, 0.41]), np.cumsum(rng.uniform(0.004, 0.03, 40)) + 0.5]))
    pulses = pulses[: [0, 5, 20, 45][case]]
    for max_period, mean_period in ((0.02, 0.01), (0.02, 0.1)):
        ours = port_pulses.vuv_intervals(pulses, 2.0, max_period, mean_period)
        assert ours == jax_pulses.vuv_intervals(pulses, 2.0, max_period, mean_period)
        assert ours[0][0] == 0.0 and ours[-1][1] == 2.0
        for t in (0.0, 0.31, 0.36, 0.9, 2.0, 5.0):
            assert port_pulses.label_at_time(ours, t) == jax_pulses.label_at_time(ours, t)
    assert port_pulses.label_at_time([], 0.5) == jax_pulses.label_at_time([], 0.5) == ""


@pytest.mark.parametrize("total", [None, 2.0, 2.5])
def test_silence_intervals_equal_jax(total):
    t = np.arange(2 * SR) / SR
    x = np.sin(2 * np.pi * 300 * t) * np.where((t > 0.7) & (t < 1.4), 0.001, 0.5)
    x[int(0.2 * SR) : int(0.3 * SR)] *= 0.001  # a pause shorter than min_silent_duration
    ours = port_int.intensity_contour(x, SR, minimum_pitch=50, time_step=0.016, device="cpu")
    ref = jax_int.intensity_contour(x, SR, minimum_pitch=50, time_step=0.016)
    contour = jax_int.IntensityContour(ref.times, ref.values_db)
    port_contour = port_int.IntensityContour(ref.times, ref.values_db)
    for thresh in (-25.0, -10.0):
        iv = port_pulses.silence_intervals(port_contour, thresh, 0.3, 0.1, total_duration=total)
        assert iv == jax_pulses.silence_intervals(contour, thresh, 0.3, 0.1,
                                                  total_duration=total)
    iv = port_pulses.silence_intervals(ours, -25.0, 0.3, 0.1, total_duration=2.0)
    sil = [(a, b) for a, b, lab in iv if lab == "silent"]
    a, b = max(sil, key=lambda ab: ab[1] - ab[0])
    assert 0.55 < a < 0.9 and 1.2 < b < 1.55
    assert iv[0][0] == 0.0 and iv[-1][1] == pytest.approx(2.0)
    empty = port_int.IntensityContour(np.zeros(0), np.zeros(0))
    assert port_pulses.silence_intervals(empty, -25.0) == []
