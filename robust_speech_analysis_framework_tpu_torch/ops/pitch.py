"""Fundamental frequency: Boersma's autocorrelation method, corpus-batched.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/pitch.py``
(Praat's ``Sound: To Pitch (ac)...`` / ``To Pitch (cc)...``):

1. frames on Praat's symmetric grid, gathered from a corpus buffer, local
   mean subtracted;
2. the normalized autocorrelation of the windowed frame divided by the
   window's own (ac), or the normalized forward cross-correlation (cc),
   every frame of every file at once on ``torch.fft``;
3. per frame up to ``max_candidates − 1`` local maxima of r(τ) in the
   [1/ceiling, 1/floor] lag band, parabolically interpolated and ranked by
   ``r − octave_cost·log2(floor·τ)``, plus the unvoiced candidate;
4. the path over frames per file with Praat's costs (octave jump and
   voiced/unvoiced transition, scaled by 0.01/time_step, local cost
   −strength): the path finder K7 (``ops/cuda/viterbi.py``), a hand-written
   kernel on CUDA tensors and its plain version on CPU tensors.

The JAX package's associative-scan path finder (``_viterbi``) has no
counterpart: the port has one path finder, fed as the JAX package feeds its
Pallas kernel. Single-file calls run as a batch of one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..audio.frontend import table
from ..device import DeviceLike, resolve_device
from .bucketing import pad_frames
from .cuda.viterbi import viterbi_path
from .dft import autocorr, cross_corr
from .framing import Deferred, gather_frames
from .prefix_sum import cumsum


@dataclasses.dataclass(frozen=True)
class PitchParams:
    time_step: float = 0.0  # 0 → Praat default 0.75/floor
    floor: float = 75.0
    ceiling: float = 600.0
    max_candidates: int = 15
    very_accurate: bool = False
    silence_threshold: float = 0.03
    voicing_threshold: float = 0.45
    octave_cost: float = 0.01
    octave_jump_cost: float = 0.35
    voiced_unvoiced_cost: float = 0.14
    method: str = "ac"  # 'ac' | 'cc'

    @property
    def periods_per_window(self) -> float:
        base = 3.0 if self.method == "ac" else 1.0
        return base * (2.0 if self.very_accurate else 1.0)

    @property
    def dt(self) -> float:
        # Praat default: periodsPerWindow / (4 · floor)
        if self.time_step > 0:
            return self.time_step
        return self.periods_per_window / (4.0 * self.floor)


class PitchTrack(NamedTuple):
    times: np.ndarray  # (N,) frame centers in seconds
    f0: np.ndarray  # (N,) Hz; 0 where unvoiced
    strength: np.ndarray  # (N,) winning candidate strength (r value)

    @property
    def voiced(self) -> np.ndarray:
        return self.f0 > 0

    def value_at_time(self, t) -> np.ndarray:
        """Praat ``Pitch: Get value at time (linear)``: interpolation between
        the NEAR and FAR frames around ``t``, constant from the near frame
        when the far one is unvoiced or off the grid; NaN only when the near
        frame itself is unvoiced or off the grid."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        f0 = np.where(self.f0 > 0, self.f0, np.nan)
        n = len(f0)
        dt = self.times[1] - self.times[0] if n > 1 else 1.0
        ireal = (t - self.times[0]) / dt
        ileft = np.floor(ireal).astype(int)
        phase = ireal - ileft
        lo = phase < 0.5
        inear = np.where(lo, ileft, ileft + 1)
        ifar = np.where(lo, ileft + 1, ileft)
        ph = np.where(lo, phase, 1.0 - phase)
        near_in = (inear >= 0) & (inear < n)
        far_in = (ifar >= 0) & (ifar < n)
        fnear = f0[np.clip(inear, 0, n - 1)]
        ffar = f0[np.clip(ifar, 0, n - 1)]
        vals = np.where(
            ~near_in,
            np.nan,
            np.where(~far_in | np.isnan(ffar), fnear, fnear + ph * (ffar - fnear)),
        )
        return vals if vals.shape != (1,) else vals[0]

    def mean_hz(self) -> float:
        v = self.f0[self.f0 > 0]
        return float(v.mean()) if v.size else float("nan")

    def std_semitones(self) -> float:
        """Std of the track on a 12·log2 scale (Praat 'semitones' units)."""
        v = self.f0[self.f0 > 0]
        if v.size < 2:
            return float("nan")
        st = 12.0 * np.log2(v / 100.0)
        return float(st.std(ddof=1))


def praat_frame_grid(n_samples: int, sr: float, window_s: float, dt: float) -> Tuple[int, float]:
    """Praat's symmetric short-term analysis grid: (n_frames,
    first_center_time) of ``window_s`` frames every ``dt``, the leftover
    duration split equally at both ends."""
    duration = n_samples / sr
    n = int(math.floor((duration - window_s) / dt)) + 1
    if n < 1:
        return 0, duration / 2
    mid = duration / 2
    first = mid - ((n - 1) * dt) / 2
    return n, first


def _analysis_window(n: int, kind: str) -> np.ndarray:
    """Praat's Hanning window, or the Gaussian of very-accurate mode (float64)."""
    if kind == "hanning":
        k = np.arange(n)
        return 0.5 - 0.5 * np.cos(2 * np.pi * (k + 1) / (n + 1))
    k = np.arange(n) - (n - 1) / 2
    return np.exp(-48.0 * (k / n) ** 2)


def _window_and_norm_ac(win: np.ndarray, n_fft: int) -> np.ndarray:
    spec = np.fft.rfft(win, n_fft)
    ac = np.fft.irfft(spec * np.conj(spec), n_fft)
    return ac / ac[0]


def _normalized_autocorr(frames: torch.Tensor, n_fft: int, max_lag: int,
                         window_kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boersma step: r(τ) of windowed, mean-subtracted frames, divided by the
    window's own autocorrelation. Returns (r (N, max_lag+1), local_peak (N,))."""
    frames = frames - frames.mean(dim=-1, keepdim=True)
    local_peak = frames.abs().amax(dim=-1)
    win = _analysis_window(frames.shape[-1], window_kind)
    ac = autocorr(frames * table(win, frames), n_fft, max_lag + 1)
    r = ac / torch.clamp(ac[..., :1], min=1e-30)
    r_w = table(_window_and_norm_ac(win, n_fft)[: max_lag + 1], frames)
    return r / torch.clamp(r_w, min=1e-12), local_peak


def _forward_crosscorr(frames_ext: torch.Tensor, win_len: int,
                       max_lag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized forward cross-correlation (Praat cc method): the leading
    ``win_len`` samples of each (N, win_len + max_lag) row against the row
    shifted by τ, normalized by both segments' energies."""
    frames_ext = frames_ext - frames_ext[:, :win_len].mean(dim=-1, keepdim=True)
    base = frames_ext[:, :win_len]
    local_peak = base.abs().amax(dim=-1)
    n_fft = 1 << int(np.ceil(np.log2(2 * frames_ext.shape[-1])))
    corr = cross_corr(base, frames_ext, n_fft, max_lag + 1)
    e_base = (base * base).sum(dim=-1, keepdim=True)
    csum = torch.nn.functional.pad(cumsum(frames_ext * frames_ext, dim=-1), (1, 0))
    lags = torch.arange(max_lag + 1, device=frames_ext.device)
    e_lag = csum[:, lags + win_len] - csum[:, lags]
    return corr / torch.sqrt(torch.clamp(e_base * e_lag, min=1e-30)), local_peak


def _find_candidates(r: torch.Tensor, local_peak: torch.Tensor, global_peak: torch.Tensor,
                     sr: float, params_tuple: tuple, max_cands: int = 15):
    """Top pitch candidates per frame: (freqs, strengths, rvals), each
    (N, max_cands); slot 0 is the unvoiced candidate (frequency 0)."""
    floor, ceiling, silence_t, voicing_t, octave_c = params_tuple
    n_frames, n_lags = r.shape
    lag_min = int(math.floor(sr / ceiling))
    lag_max = min(int(math.ceil(sr / floor)), n_lags - 2)

    lags = torch.arange(n_lags, device=r.device)
    prev_r = torch.cat([r[:, :1], r[:, :-1]], dim=1)
    next_r = torch.cat([r[:, 1:], r[:, -1:]], dim=1)
    is_max = (r > prev_r) & (r >= next_r)
    in_band = (lags >= max(lag_min, 2)) & (lags <= lag_max)
    valid = is_max & in_band[None, :] & (r > 0.0)

    # parabolic interpolation of each local maximum
    dr = 0.5 * (next_r - prev_r)
    d2 = torch.clamp(2.0 * r - prev_r - next_r, min=1e-12)
    delta = torch.clamp(dr / d2, -0.5, 0.5)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python-scalar
    # divisor where the CPU divides
    tau = (lags[None, :] + delta) / r.new_tensor(sr)
    r_peak = torch.clamp(r + 0.5 * dr * delta, max=1.0)
    freq = 1.0 / torch.clamp(tau, min=1e-9)
    # the floor-referenced score ranks candidates within a frame; the path
    # strength is Praat's r − octave_cost·log2(ceiling/f)
    sel_strength = r_peak - octave_c * torch.log2(torch.clamp(floor * tau, min=1e-12))
    sel_strength = torch.where(valid, sel_strength, float("-inf"))

    top_sel, top_idx = torch.topk(sel_strength, max_cands - 1, dim=1, sorted=True)
    top_freq = torch.gather(freq, 1, top_idx)
    top_r = torch.gather(r_peak, 1, top_idx)
    keep = torch.isfinite(top_sel)
    top_freq = torch.where(keep, top_freq, 0.0)
    top_strength = top_r - octave_c * torch.log2(ceiling / torch.clamp(top_freq, min=1e-12))
    top_strength = torch.where(keep, top_strength, -1e30)
    top_r = torch.where(keep, top_r, 0.0)

    # unvoiced candidate (Boersma eq. 23)
    peak_ratio = local_peak / torch.clamp(global_peak, min=1e-30)
    unvoiced_strength = voicing_t + torch.clamp(
        2.0 - peak_ratio / r.new_tensor(silence_t / (1.0 + voicing_t)), min=0.0)
    zeros = r.new_zeros(n_frames, 1)
    freqs = torch.cat([zeros, top_freq], dim=1)
    strengths = torch.cat([unvoiced_strength[:, None], top_strength], dim=1)
    rvals = torch.cat([zeros, top_r], dim=1)
    return freqs, strengths, rvals


def _gathered_autocorr(x_cat, starts, win_len, n_fft, max_lag, window_kind="hanning"):
    """Frames gathered on the device + normalized autocorrelation."""
    return _normalized_autocorr(gather_frames(x_cat, starts, win_len), n_fft, max_lag,
                                window_kind)


def _gathered_crosscorr(x_cat, starts, ext, win_len_max_lag):
    win_len, max_lag = win_len_max_lag
    return _forward_crosscorr(gather_frames(x_cat, starts, ext), win_len, max_lag)


def _select_tracks(freqs, strengths, rvals, gather_idx, lengths, trans_scale: float,
                   costs: tuple) -> torch.Tensor:
    """Corpus-wide candidate rows → per-file (f0, strength) tracks on the
    device: each file's rows gathered into a padded (B, T, C) stack (padding
    frames edge-replicate the file's last frame, with their strengths
    zeroed so they cannot move the path through real frames), the path
    finder K7 with Praat's weights (w_same = 0, local = −strength), the
    winning candidate per frame. Returns one stacked (2, B, T) tensor."""
    fp, sp, rp = freqs[gather_idx], strengths[gather_idx], rvals[gather_idx]
    frame = torch.arange(fp.shape[1], device=fp.device)
    sp = torch.where(frame[None, :, None] < lengths[:, None, None], sp, 0.0)
    jump_c, vuv_c = costs
    voiced = fp > 0
    lf = torch.log2(torch.where(voiced, fp, 1.0))
    paths = viterbi_path(lf, voiced.to(torch.float32), -sp,
                         jump_c * trans_scale, 0.0, vuv_c * trans_scale)
    f0 = torch.gather(fp, 2, paths[..., None])[..., 0]
    st = torch.gather(rp, 2, paths[..., None])[..., 0]
    return torch.stack([f0, st])


def pitch_track_batch(xs, sr: float, params: PitchParams, buf=None, indices=None,
                      defer: bool = False, device: DeviceLike = "cuda"):
    """Pitch tracks of many waveforms at once (one list of PitchTrack, or a
    ``Deferred`` of it): see :func:`pitch_track_batch_shared`."""
    r = pitch_track_batch_shared(xs, sr, [params], buf, indices, defer=defer, device=device)
    if defer:
        return Deferred(r.arrays, lambda h: r.finalize(h)[0])
    return r[0]


def pitch_track_batch_shared(xs, sr: float, params_list: List[PitchParams], buf=None,
                             indices=None, defer: bool = False, device: DeviceLike = "cuda"):
    """Batched pitch analysis sharing one correlation pass across parameter
    variants; returns one track list per entry of ``params_list``.

    The variants must agree on the frame geometry and the method (method,
    floor, time step, periods per window); they may differ in thresholds,
    ceiling and transition costs. Frames come from ``buf`` (a
    ``CorpusBuffer``, files ``indices``) on its device, or from ``xs``
    uploaded to ``device``. The correlation and candidate work runs over
    every frame of every file at once; K7 runs once per variant over all
    files (the JAX package cut the files into slabs of 8 only to bound its
    associative scan's memory; the path of each file is independent of the
    others').
    """
    params = params_list[0]
    for p in params_list[1:]:
        if (p.method, p.floor, p.dt, p.periods_per_window) != (
                params.method, params.floor, params.dt, params.periods_per_window):
            raise ValueError("pitch variants sharing one correlation pass must agree on "
                             "method, floor, time step and periods per window")

    if buf is not None:
        idxs = list(indices) if indices is not None else list(range(len(buf.xs)))
        xs = [buf.xs[i] for i in idxs]
        dev = buf.x_cat.device
    else:
        xs = [np.asarray(x, dtype=np.float64).reshape(-1) for x in xs]
        dev = resolve_device(device)
    dt = params.dt
    window_s = params.periods_per_window / params.floor
    win_len = int(round(window_s * sr))
    max_lag = int(math.ceil(sr / params.floor)) + 2
    n_fft = 1 << int(np.ceil(np.log2(win_len + max_lag + 1)))

    ext = win_len + max_lag
    if buf is not None and ext > buf.pad:
        raise ValueError(f"corpus buffer pad {buf.pad} < required ext {ext}")
    metas = []  # (n_frames, centers, global_peak)
    start_blocks, cat_pieces = [], []
    offset = 0
    for k, x in enumerate(xs):
        n_frames, t0 = praat_frame_grid(len(x), sr, window_s, dt)
        centers = t0 + np.arange(n_frames) * dt
        global_peak = float(np.max(np.abs(x - x.mean()))) if len(x) else 1e-30
        metas.append((n_frames, centers, global_peak or 1e-30))
        if n_frames < 1:
            continue
        if buf is None:
            # each file padded so every window and extension stays in its region
            base = offset
            cat_pieces.append(np.pad(x, (0, ext)).astype(np.float32))
            offset += len(x) + ext
        else:
            base = int(buf.offsets[idxs[k]])
        # cc: trailing frames shift left so the whole win+lag extension reads
        # real samples
        last = len(x) - (ext if params.method == "cc" else win_len)
        starts = np.clip(np.round(centers * sr - win_len / 2).astype(int), 0, max(last, 0))
        start_blocks.append(starts + base)

    if not start_blocks:
        empty = [PitchTrack(m[1], np.zeros(m[0]), np.zeros(m[0])) for m in metas]
        empties = [empty for _ in params_list]
        return Deferred.ready(empties) if defer else empties

    x_cat = buf.x_cat if buf is not None else torch.from_numpy(np.concatenate(cat_pieces)).to(dev)
    # bucket the frame count; pad_frames edge-replicates the last start
    starts_padded, _ = pad_frames(np.concatenate(start_blocks).astype(np.int64)[:, None])
    starts_t = torch.from_numpy(starts_padded[:, 0]).to(dev)
    if params.method == "cc":
        r_all, peak_all = _gathered_crosscorr(x_cat, starts_t, ext, (win_len, max_lag))
    else:
        kind = "gaussian" if params.very_accurate else "hanning"
        r_all, peak_all = _gathered_autocorr(x_cat, starts_t, win_len, n_fft, max_lag, kind)

    live = [i for i, m in enumerate(metas) if m[0] >= 1]
    lengths = [metas[i][0] for i in live]
    gp_rows = np.concatenate([np.full(metas[i][0], metas[i][2], np.float32) for i in live])
    gp_padded, _ = pad_frames(gp_rows[:, None])
    gp_t = torch.from_numpy(gp_padded[:, 0]).to(dev)

    t_max = pad_frames(np.zeros((max(lengths), 1)))[0].shape[0]
    gather_idx = np.zeros((len(live), t_max), np.int64)
    offset = 0
    for j, n_i in enumerate(lengths):
        gather_idx[j] = offset + np.minimum(np.arange(t_max), n_i - 1)
        offset += n_i
    gather_t = torch.from_numpy(gather_idx).to(dev)
    lengths_t = torch.as_tensor(lengths, dtype=torch.int64).to(dev)
    trans_scale = float(0.01 / dt)  # Praat: costs *= 0.01/dx

    f0_st = []
    for p in params_list:
        freqs, strengths, rvals = _find_candidates(
            r_all, peak_all, gp_t, float(sr),
            (float(p.floor), float(p.ceiling), float(p.silence_threshold),
             float(p.voicing_threshold), float(p.octave_cost)),
            p.max_candidates,
        )
        strengths = torch.where(freqs > p.ceiling, -1e30, strengths)
        f0_st.append(_select_tracks(
            freqs, strengths, rvals, gather_t, lengths_t, trans_scale,
            (float(p.octave_jump_cost), float(p.voiced_unvoiced_cost))))

    def _finalize(f0_st_host):
        results = []
        for stacked in f0_st_host:
            tracks, k = [], 0
            for n_frames, centers, _ in metas:
                if n_frames < 1:
                    tracks.append(PitchTrack(centers, np.zeros(n_frames), np.zeros(n_frames)))
                    continue
                tracks.append(PitchTrack(centers, stacked[0, k, :n_frames].astype(np.float64),
                                         stacked[1, k, :n_frames].astype(np.float64)))
                k += 1
            results.append(tracks)
        return results

    d = Deferred(f0_st, _finalize)
    return d if defer else d.result()


def pitch_track_ac(x: np.ndarray, sr: float, time_step: float = 0.0, floor: float = 75.0,
                   ceiling: float = 600.0, max_candidates: int = 15,
                   very_accurate: bool = False, silence_threshold: float = 0.03,
                   voicing_threshold: float = 0.45, octave_cost: float = 0.01,
                   octave_jump_cost: float = 0.35, voiced_unvoiced_cost: float = 0.14,
                   device: DeviceLike = "cuda") -> PitchTrack:
    """Praat ``To Pitch (ac)...`` of one waveform (a batch of one)."""
    params = PitchParams(
        time_step=time_step, floor=floor, ceiling=ceiling, max_candidates=max_candidates,
        very_accurate=very_accurate, silence_threshold=silence_threshold,
        voicing_threshold=voicing_threshold, octave_cost=octave_cost,
        octave_jump_cost=octave_jump_cost, voiced_unvoiced_cost=voiced_unvoiced_cost,
        method="ac",
    )
    return pitch_track_batch([x], sr, params, device=device)[0]


def pitch_track_cc(x: np.ndarray, sr: float, time_step: float = 0.0, floor: float = 75.0,
                   ceiling: float = 600.0, device: DeviceLike = "cuda",
                   **kwargs) -> PitchTrack:
    """Praat ``To Pitch (cc)...`` of one waveform (a batch of one)."""
    params = PitchParams(time_step=time_step, floor=floor, ceiling=ceiling, method="cc", **kwargs)
    return pitch_track_batch([x], sr, params, device=device)[0]
