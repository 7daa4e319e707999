"""Port's batched Praat pitch (ac and cc) vs the JAX package, on the CPU.

The same seeded speech-like 16-bit PCM files (2–3.1 s in both MSHDS range
groups, plus one file shorter than any analysis window) go through both
packages' corpus buffers. Tolerances, each with its reason:

* ``_normalized_autocorr`` / ``_forward_crosscorr``: atol 2e-5 on r(τ)
  (XLA's CPU FFT and pocketfft round differently; r ≤ 1);
* ``_find_candidates`` on the same r: frequencies and strengths rtol 1e-5
  (float32 division and log2), the empty slots (−1e30) at the same places;
* ``_select_tracks``: the port's path (K7's plain version) equals
  ``viterbi_path_pallas(interpret=True)`` fed the JAX package's own
  candidate stacks, so the winning f0 and strength are bit-equal;
* whole tracks: on the CPU the JAX package takes its associative-scan path
  finder, which differences log2 f in another order (near-ties may flip),
  so tracks are held by the frame-agreement rule: a frame agrees when both
  voicing decisions match and a voiced f0 is within 1e-4 relative; at least
  99 % of each file's frames agree, ``mean_hz`` within 1e-5 relative and
  ``std_semitones`` within 1e-4 semitones;
* batch against serial (a batch of one per file): bit-equal;
* the accuracy oracles of ``tests/test_ops_pitch.py``, with their bounds.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from robust_speech_analysis_framework_tpu.ops import framing as jax_framing
from robust_speech_analysis_framework_tpu.ops import pitch as jax_pitch
from robust_speech_analysis_framework_tpu.ops.pallas.viterbi import viterbi_path_pallas
from robust_speech_analysis_framework_tpu_torch.ops import framing as port_framing
from robust_speech_analysis_framework_tpu_torch.ops import pitch as port_pitch
from robust_speech_analysis_framework_tpu_torch.ops.cuda import viterbi as port_viterbi

SR = 16000
R_TOL = 2e-5
FRAME_SHARE, F0_REL, MEAN_REL, STD_ABS = 0.99, 1e-4, 1e-5, 1e-4

# the MSHDS passes: wide, speech-rate, a main pass per range group, cc
PASSES = {
    "wide": dict(time_step=0.005, floor=50, ceiling=600),
    "speechrate": dict(time_step=0.02, floor=30, ceiling=450, max_candidates=4,
                       silence_threshold=0.03, voicing_threshold=0.25, octave_cost=0.01,
                       octave_jump_cost=0.35, voiced_unvoiced_cost=0.25),
    "main-low": dict(time_step=0.005, floor=60, ceiling=250),
    "main-high": dict(time_step=0.005, floor=100, ceiling=500),
    "cc-low": dict(time_step=0.005, floor=60, ceiling=250, method="cc"),
    "cc-high": dict(time_step=0.005, floor=100, ceiling=500, method="cc"),
}


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
    xs = [_speech(2.0, 100, 0), _speech(3.1, 200, 1), _speech(0.005, 150, 2),
          _speech(1.5, 130, 3)]
    return (xs, jax_framing.corpus_buffer(xs, pad=4096, align=8),
            port_framing.corpus_buffer(xs, pad=4096, align=8, device="cpu"))


def _params(name):
    return jax_pitch.PitchParams(**PASSES[name]), port_pitch.PitchParams(**PASSES[name])


def _assert_tracks_agree(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.times, b.times)
        if not len(b.f0):
            assert not len(a.f0)
            continue
        voiced = b.f0 > 0
        agree = ((a.f0 > 0) == voiced) & (~voiced | (np.abs(a.f0 - b.f0) <= F0_REL * b.f0))
        assert agree.mean() >= FRAME_SHARE, agree.mean()
        if voiced.sum() > 1:
            assert a.mean_hz() == pytest.approx(b.mean_hz(), rel=MEAN_REL)
            assert a.std_semitones() == pytest.approx(b.std_semitones(), abs=STD_ABS)


def _frames(x, n, win):
    starts = np.linspace(0, len(x) - win, n).astype(int)
    return x[starts[:, None] + np.arange(win)].astype(np.float32)


def test_normalized_autocorr_matches_jax(buffers):
    frames = _frames(buffers[0][1], 40, 960)
    for kind in ("hanning", "gaussian"):
        r_ref, peak_ref = jax_pitch._normalized_autocorr(jnp.asarray(frames), 2048, 322, kind)
        r, peak = port_pitch._normalized_autocorr(torch.from_numpy(frames), 2048, 322, kind)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0, atol=R_TOL)
        np.testing.assert_allclose(peak.numpy(), np.asarray(peak_ref), rtol=1e-6)


def test_forward_crosscorr_matches_jax(buffers):
    frames = _frames(buffers[0][1], 40, 267 + 269)
    r_ref, peak_ref = jax_pitch._forward_crosscorr(jnp.asarray(frames), 267, 269)
    r, peak = port_pitch._forward_crosscorr(torch.from_numpy(frames), 267, 269)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=0, atol=R_TOL)
    np.testing.assert_allclose(peak.numpy(), np.asarray(peak_ref), rtol=1e-6)


@pytest.mark.parametrize("name", ["wide", "speechrate", "cc-low"])
def test_find_candidates_matches_jax(buffers, name):
    params, _ = _params(name)
    win_len = int(round(params.periods_per_window / params.floor * SR))
    max_lag = int(np.ceil(SR / params.floor)) + 2
    x = buffers[0][1]
    if params.method == "cc":
        r, peak = jax_pitch._forward_crosscorr(
            jnp.asarray(_frames(x, 64, win_len + max_lag)), win_len, max_lag)
    else:
        n_fft = 1 << int(np.ceil(np.log2(win_len + max_lag + 1)))
        r, peak = jax_pitch._normalized_autocorr(
            jnp.asarray(_frames(x, 64, win_len)), n_fft, max_lag, "hanning")
    gp = np.full(64, np.abs(x - x.mean()).max(), np.float32)
    args = (float(SR), (float(params.floor), float(params.ceiling),
                        float(params.silence_threshold), float(params.voicing_threshold),
                        float(params.octave_cost)), params.max_candidates)
    ref = [np.asarray(a) for a in jax_pitch._find_candidates(r, peak, jnp.asarray(gp), *args)]
    ours = [a.numpy() for a in port_pitch._find_candidates(
        torch.tensor(np.asarray(r)), torch.tensor(np.asarray(peak)),
        torch.from_numpy(gp), *args)]
    assert all(a.shape == (64, params.max_candidates) for a in ours)
    empty = ref[1] == np.float32(-1e30)
    np.testing.assert_array_equal(ours[1] == np.float32(-1e30), empty)
    assert (~empty[:, 1:]).any()
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a[~empty], b[~empty], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["wide", "main-low", "cc-high", "speechrate"])
def test_select_tracks_equals_pallas_kernel_on_jax_stacks(buffers, name, monkeypatch):
    """The port's _select_tracks, given the JAX package's candidate stacks,
    equals the JAX package's Pallas branch (viterbi_path_pallas in interpret
    mode, fed as ops/pitch.py:526-535 feeds it) bit for bit."""
    calls = []
    real = jax_pitch._select_tracks

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(jax_pitch, "_select_tracks", spy)
    params, _ = _params(name)
    jax_pitch.pitch_track_batch(None, SR, params, buf=buffers[1])
    assert calls
    for freqs, strengths, rvals, gather_idx, lengths, trans_scale, costs, _ in calls:
        fp, sp, rp = freqs[gather_idx], strengths[gather_idx], rvals[gather_idx]
        sp = jnp.where(jnp.arange(fp.shape[1])[None, :, None] < lengths[:, None, None], sp, 0.0)
        voiced = fp > 0
        path = viterbi_path_pallas(
            jnp.log2(jnp.where(voiced, fp, 1.0)).astype(jnp.float32),
            voiced.astype(jnp.float32), (-sp).astype(jnp.float32),
            costs[0] * trans_scale, 0.0, costs[1] * trans_scale, True)
        ref = np.stack([np.take_along_axis(np.asarray(a), np.asarray(path)[..., None], 2)[..., 0]
                        for a in (fp, rp)])
        t = [torch.tensor(np.asarray(a)) for a in (freqs, strengths, rvals, gather_idx,
                                                        lengths)]
        ours = port_pitch._select_tracks(t[0], t[1], t[2], t[3].long(), t[4].long(),
                                         trans_scale, costs)
        np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("name", sorted(PASSES))
def test_pitch_track_batch_matches_jax(buffers, name):
    jax_params, port_params = _params(name)
    ref = jax_pitch.pitch_track_batch(None, SR, jax_params, buf=buffers[1])
    before = port_viterbi.viterbi_path.launches
    ours = port_pitch.pitch_track_batch(None, SR, port_params, buf=buffers[2])
    assert port_viterbi.viterbi_path.launches == before  # the plain path finder on the CPU
    assert not len(ours[2].f0)  # shorter than a window
    assert sum((t.f0 > 0).sum() for t in ours) > 100
    _assert_tracks_agree(ours, ref)


@pytest.mark.parametrize("group", ["low", "high"])
def test_pitch_track_batch_shared_matches_jax(buffers, group):
    """The main (voicing 0.45) and CPP (voicing 0.3) passes sharing one
    autocorrelation, on a subset of the files (``indices``), deferred."""
    base = PASSES[f"main-{group}"]
    variants = [dict(base), dict(base, voicing_threshold=0.3)]
    idx = [0, 3] if group == "low" else [1, 2]
    ref = jax_pitch.pitch_track_batch_shared(
        None, SR, [jax_pitch.PitchParams(**v) for v in variants], buf=buffers[1], indices=idx)
    deferred = port_pitch.pitch_track_batch_shared(
        None, SR, [port_pitch.PitchParams(**v) for v in variants], buf=buffers[2], indices=idx,
        defer=True)
    assert isinstance(deferred, port_framing.Deferred)
    ours = port_framing.collect([deferred])[0]
    assert len(ours) == 2
    for a, b in zip(ours, ref):
        _assert_tracks_agree(a, b)


@pytest.mark.parametrize("name", ["main-low", "cc-high"])
def test_batch_equals_serial(buffers, name):
    _, params = _params(name)
    batch = port_pitch.pitch_track_batch(None, SR, params, buf=buffers[2])
    for x, tr in zip(buffers[0], batch):
        serial = port_pitch.pitch_track_batch([x], SR, params, device="cpu")[0]
        for a, b in zip(serial, tr):
            np.testing.assert_array_equal(a, b)
    one = (port_pitch.pitch_track_cc if params.method == "cc" else port_pitch.pitch_track_ac)(
        buffers[0][1], SR, time_step=params.time_step, floor=params.floor,
        ceiling=params.ceiling, device="cpu")
    np.testing.assert_array_equal(one.f0, batch[1].f0)


def test_variants_must_share_the_frame_geometry(buffers):
    with pytest.raises(ValueError, match="agree"):
        port_pitch.pitch_track_batch_shared(
            None, SR, [port_pitch.PitchParams(floor=60), port_pitch.PitchParams(floor=100)],
            buf=buffers[2])


def test_buffer_pad_below_the_window_raises(buffers):
    buf = port_framing.corpus_buffer(buffers[0], pad=512, device="cpu")
    with pytest.raises(ValueError, match="pad 512"):
        port_pitch.pitch_track_batch(None, SR, port_pitch.PitchParams(floor=60), buf=buf)


def test_empty_and_short_inputs():
    short = port_pitch.pitch_track_batch([np.zeros(100), np.zeros(0)], SR,
                                         port_pitch.PitchParams(), device="cpu")
    assert [len(t.f0) for t in short] == [0, 0]
    d = port_pitch.pitch_track_batch([np.zeros(100)], SR, port_pitch.PitchParams(), defer=True,
                                     device="cpu")
    assert len(d.result()[0].f0) == 0


def _harmonic(f0, seconds=0.8, n_harm=9):
    t = np.arange(int(seconds * SR)) / SR
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, n_harm))
    return x / np.abs(x).max()


@pytest.mark.parametrize("f0", [100.0, 150.0, 220.0, 330.0])
def test_ac_pitch_accuracy(f0):
    pt = port_pitch.pitch_track_ac(_harmonic(f0), SR, time_step=0.01, floor=75, ceiling=500,
                                   device="cpu")
    v = pt.f0[pt.f0 > 0]
    assert len(v) > 0.9 * len(pt.f0)
    assert abs(np.median(v) - f0) / f0 < 0.01


def test_cc_pitch_accuracy():
    pt = port_pitch.pitch_track_cc(_harmonic(180.0), SR, time_step=0.01, floor=75, ceiling=500,
                                   device="cpu")
    v = pt.f0[pt.f0 > 0]
    assert abs(np.median(v) - 180.0) / 180.0 < 0.01


def test_noise_is_unvoiced():
    noise = np.random.default_rng(0).normal(size=SR)
    pt = port_pitch.pitch_track_ac(noise, SR, time_step=0.01, floor=75, ceiling=500, device="cpu")
    assert (pt.f0 > 0).mean() < 0.1


def test_silence_tone_boundary_and_summary_stats():
    x = np.concatenate([np.zeros(SR // 2), 0.5 * _harmonic(150, 0.5)])
    pt = port_pitch.pitch_track_ac(x, SR, time_step=0.01, floor=75, ceiling=500, device="cpu")
    assert (pt.f0[pt.times < 0.45] > 0).mean() < 0.1
    assert (pt.f0[pt.times > 0.55] > 0).mean() > 0.8
    pt = port_pitch.pitch_track_ac(_harmonic(150), SR, time_step=0.01, floor=75, ceiling=500,
                                   device="cpu")
    assert pt.mean_hz() == pytest.approx(150.0, rel=0.01)
    assert pt.std_semitones() < 0.2
    assert pt.value_at_time(0.4) == pytest.approx(150.0, rel=0.02)
    assert np.isnan(pt.value_at_time(-1.0))


def test_value_at_time_and_params_match_jax():
    args = (np.array([0.0, 0.005, 0.010, 0.015, 0.020]),
            np.array([100.0, 110.0, 120.0, 130.0, 0.0]), np.ones(5))
    ours, ref = port_pitch.PitchTrack(*args), jax_pitch.PitchTrack(*args)
    for t in (0.015, 0.016, 0.019, -0.002, -0.004, 0.0075, np.array([0.001, 0.012])):
        np.testing.assert_array_equal(ours.value_at_time(t), ref.value_at_time(t))
    for kw in (dict(floor=75.0), dict(floor=75.0, method="cc"),
               dict(floor=75.0, very_accurate=True), dict(time_step=0.005)):
        assert port_pitch.PitchParams(**kw).dt == jax_pitch.PitchParams(**kw).dt
    for n, window, dt in ((16000, 0.04, 0.01), (100, 0.04, 0.01), (48213, 0.06, 0.005)):
        assert port_pitch.praat_frame_grid(n, SR, window, dt) == \
            jax_pitch.praat_frame_grid(n, SR, window, dt)
