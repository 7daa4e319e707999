"""Power cepstrogram and smoothed cepstral peak prominence (CPPS),
corpus-batched.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/cepstrum.py``
(Praat ``To PowerCepstrogram: 60, 0.002, 5000, 50`` then ``Get CPPS`` with
the peak searched in 60–330 Hz and a robust straight trend):

* the waveform resampled to 2·max_frequency and preemphasized from 50 Hz
  (for a corpus: ``ops.framing.resample_buffer``);
* Gaussian windows of 2/pitch_floor seconds every ``time_step``;
* per frame: power spectrum → ln power → the square of its real symmetric
  inverse transform (Praat's power cepstrum; ``|FFT(·)|²`` would add a
  spurious Im² term);
* smoothing in the power domain, over time (0.01 s) within a voiced
  segment, then over quefrency (0.001 s), with a truncated Gaussian;
* per frame the parabolic peak in the quefrency band [1/f_max, 1/f_min]
  minus a Tukey-reweighted straight-line trend over quefrency.

:func:`power_cepstrogram`, :func:`cpps` and :func:`cepstrum_preprocess` are
host oracles; :func:`cpps_segments_batch` runs every frame of every voiced
segment of a corpus in one device pass and returns one value a file.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..audio.resample import resample_poly_np
from ..device import DeviceLike, resolve_device
from .bucketing import pad_frames
from .dft import autocorr_via_power, rfft_power
from .framing import Deferred, gather_frames
from .pitch import praat_frame_grid


class PowerCepstrogram(NamedTuple):
    times: np.ndarray  # (N,)
    quefrencies: np.ndarray  # (Q,) seconds
    cepstrum_db: np.ndarray  # (N, Q)


def _cepstrum_frames(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Power cepstrum of each frame: (real symmetric inverse DFT of ln|X|²)².

    The log power spectrum is real and even, so its inverse transform is
    the autocorrelation basis applied to it. Constant factors (ln against
    log10, 1/n_fft) shift every frame's dB alike and cancel in the
    peak-minus-trend prominence.
    """
    log_power = torch.log(torch.clamp(rfft_power(frames, n_fft), min=1e-30))
    c = autocorr_via_power(log_power, n_fft, n_fft // 2 + 1)
    return c * c


def _gauss_kernel(n_window: int) -> np.ndarray:
    """Truncated Gaussian over offsets [−n//2, n//2], σ = n/4."""
    half = n_window // 2
    k = np.arange(-half, half + 1, dtype=np.float64)
    sigma = max(n_window / 4.0, 1e-6)
    return np.exp(-0.5 * (k / sigma) ** 2)


def _smooth_cepstrogram_power(power: np.ndarray, n_t: int, n_q: int) -> np.ndarray:
    """Host twin of the device smoothing: a moving Gaussian average in the
    power domain over time then quefrency, renormalized at the edges."""
    out = np.asarray(power, np.float64)
    for axis, n_win in ((0, n_t), (1, n_q)):
        if n_win <= 1 or out.shape[axis] == 0:
            continue
        w = _gauss_kernel(n_win)
        half = len(w) // 2
        acc = np.zeros_like(out)
        den = np.zeros_like(out)
        for off, wk in zip(range(-half, half + 1), w):
            sl = np.roll(out, off, axis=axis)
            valid = np.ones(out.shape[axis], bool)
            if off > 0:
                valid[:off] = False
            elif off < 0:
                valid[off:] = False
            shape = [1, 1]
            shape[axis] = -1
            m = valid.reshape(shape)
            acc += wk * sl * m
            den += wk * m
        out = acc / np.maximum(den, 1e-30)
    return out


def cepstrum_preprocess(x: np.ndarray, sr: float, max_frequency: float = 5000.0,
                        preemphasis_from: float = 50.0) -> Tuple[np.ndarray, float]:
    """Host preprocessing of the cepstrogram and formant passes: resample to
    2·max_frequency and preemphasize from ``preemphasis_from`` Hz. Returns
    (x_preprocessed, new_sr). The extractor does this on the device
    (``ops.framing.resample_buffer``); this is its oracle."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    target_sr = 2.0 * max_frequency
    if sr != target_sr:
        g = math.gcd(int(round(target_sr)), int(round(sr)))
        x = resample_poly_np(x, int(round(target_sr)) // g, int(round(sr)) // g)
    if preemphasis_from > 0 and len(x):
        pre = math.exp(-2.0 * math.pi * preemphasis_from / target_sr)
        x = np.concatenate([[x[0] * (1 - pre)], x[1:] - pre * x[:-1]])
    return x, target_sr


def power_cepstrogram(x: np.ndarray, sr: float, pitch_floor: float = 60.0,
                      time_step: float = 0.002, max_frequency: float = 5000.0,
                      preemphasis_from: float = 50.0) -> PowerCepstrogram:
    """One file's power cepstrogram on the host (float64)."""
    x, sr = cepstrum_preprocess(x, sr, max_frequency, preemphasis_from)
    window_s = 2.0 / pitch_floor
    n_frames, t0 = praat_frame_grid(len(x), sr, window_s, time_step)
    if n_frames < 1:
        return PowerCepstrogram(np.zeros(0), np.zeros(0), np.zeros((0, 0)))
    win_len = int(round(window_s * sr))
    k = np.arange(win_len) - (win_len - 1) / 2
    window = np.exp(-0.5 * (6.0 * k / win_len) ** 2)  # Gaussian, σ = L/6
    centers = t0 + np.arange(n_frames) * time_step
    starts = np.clip(np.round(centers * sr - win_len / 2).astype(int), 0,
                     max(len(x) - win_len, 0))
    frames = x[starts[:, None] + np.arange(win_len)[None, :]] * window
    n_fft = 1 << int(np.ceil(np.log2(win_len)))
    ceps_pow = _cepstrum_frames(torch.from_numpy(frames), n_fft).numpy()
    # bin q of the inverse transform sits at quefrency q/sr exactly
    quefrency = np.arange(ceps_pow.shape[1]) * (1.0 / sr)
    ceps_db = 10.0 * np.log10(np.maximum(ceps_pow, 1e-30))
    return PowerCepstrogram(centers, quefrency, ceps_db)


def _shift_rows(a: torch.Tensor, k: int) -> torch.Tensor:
    """Shift along dim 0 by k (row i reads a[i − k]), zero-filled; not a
    roll, which would let a segment's tail smooth into its own head."""
    if k == 0:
        return a
    pad = a.new_zeros((abs(k),) + tuple(a.shape[1:]))
    if k > 0:
        return torch.cat([pad, a[:-k]], dim=0)
    return torch.cat([a[-k:], pad], dim=0)


def _median_rows(a: torch.Tensor) -> torch.Tensor:
    """Median of each row, (N, 1), as ``jnp.median`` defines it: the mean of
    the two middle values of an even count (``torch.median`` takes the
    lower one)."""
    s = torch.sort(a, dim=1).values
    n = s.shape[1]
    if n % 2:
        return s[:, n // 2 : n // 2 + 1]
    return 0.5 * s[:, n // 2 - 1 : n // 2] + 0.5 * s[:, n // 2 : n // 2 + 1]


def _gathered_cpps_prominence(x_cat: torch.Tensor, starts: torch.Tensor, window: torch.Tensor,
                              seg_ids: torch.Tensor, win_len: int, n_fft: int, dq: float,
                              trend_lo: int, trend_hi: int, band_lo: int, band_hi: int,
                              n_t_smooth: int = 5, n_q_smooth: int = 10) -> torch.Tensor:
    """Every frame's CPPS prominence, (N,): power cepstrum → Gaussian
    smoothing over time within a segment (``seg_ids``; −1 marks padding),
    then over quefrency, in power → dB → a Tukey-reweighted 5-iteration line
    fit over quefrency bins [trend_lo, trend_hi) → the parabolic peak in
    [band_lo, band_hi) minus the line there."""
    frames = gather_frames(x_cat, starts, win_len) * window[None, :]
    ceps_pow = _cepstrum_frames(frames, n_fft)

    if n_t_smooth > 1:
        w = _gauss_kernel(n_t_smooth)
        half = len(w) // 2
        acc = torch.zeros_like(ceps_pow)
        den = ceps_pow.new_zeros(ceps_pow.shape[0], 1)
        for off, wk in zip(range(-half, half + 1), w):
            same = (_shift_rows(seg_ids, off) == seg_ids) & (seg_ids >= 0)
            m = same[:, None].to(ceps_pow.dtype)
            acc = acc + float(wk) * _shift_rows(ceps_pow, off) * m
            den = den + float(wk) * m
        ceps_pow = acc / torch.clamp(den, min=1e-30)
    if n_q_smooth > 1:
        w = _gauss_kernel(n_q_smooth)
        half = len(w) // 2
        q_dim = ceps_pow.shape[1]
        acc = torch.zeros_like(ceps_pow)
        den = ceps_pow.new_zeros(1, q_dim)
        ones = ceps_pow.new_ones(1, q_dim)
        for off, wk in zip(range(-half, half + 1), w):
            acc = acc + float(wk) * _shift_rows(ceps_pow.T, off).T
            den = den + float(wk) * _shift_rows(ones.T, off).T
        ceps_pow = acc / torch.clamp(den, min=1e-30)

    v = 10.0 * torch.log10(torch.clamp(ceps_pow, min=1e-30))
    n, q_len = v.shape
    qs = torch.arange(q_len, dtype=v.dtype, device=v.device) * dq

    qt = qs[trend_lo:trend_hi][None, :]
    vt = v[:, trend_lo:trend_hi]
    w = torch.ones_like(vt)
    for _ in range(5):
        sw = w.sum(dim=1)
        sq = (w * qt).sum(dim=1)
        sv = (w * vt).sum(dim=1)
        sqq = (w * qt**2).sum(dim=1)
        sqv = (w * qt * vt).sum(dim=1)
        denom = torch.clamp(sw * sqq - sq**2, min=1e-30)
        slope = (sw * sqv - sq * sv) / denom
        inter = (sv - slope * sq) / sw
        resid = vt - (slope[:, None] * qt + inter[:, None])
        c = 4.685 * torch.clamp(_median_rows(torch.abs(resid)), min=1e-12) / 0.6745
        u = resid / c
        w = torch.clamp(torch.where(torch.abs(u) < 1.0, (1 - u**2) ** 2, 0.0), min=1e-6)

    idxp = torch.argmax(v[:, band_lo:band_hi], dim=1) + band_lo
    rows = torch.arange(n, device=v.device)
    peak = v[rows, idxp]
    dl = peak - v[rows, torch.clamp(idxp - 1, 0, q_len - 1)]
    dr = peak - v[rows, torch.clamp(idxp + 1, 0, q_len - 1)]
    denom = dl + dr
    ok = denom > 0
    safe = torch.clamp(denom, min=1e-12)
    peak_ref = peak + torch.where(ok, 0.125 * (dl - dr) ** 2 / safe, 0.0)
    q_peak = qs[idxp] + torch.where(ok, 0.5 * (dl - dr) / safe, 0.0) * dq
    return peak_ref - (slope * q_peak + inter)


def cpps_segments_batch(items, sr: float, pitch_floor: float = 60.0, time_step: float = 0.002,
                        pitch_min: float = 60.0, pitch_max: float = 330.0,
                        keep_above: float = 4.0, trend_q_start: float = 0.001, buf=None,
                        defer: bool = False, device: DeviceLike = "cuda"):
    """CPPS per file over its voiced segments (a list of floats, or a
    ``Deferred`` of it): every segment of every file is framed on Praat's
    grid, all frames go through one device pass, and each file's value is
    the mean of its segments' mean prominences above ``keep_above``.

    ``items`` is one (x_preprocessed, [(a_sec, b_sec), ...]) a file, the
    waveform already at 2·max_frequency and preemphasized; with ``buf`` (the
    corpus buffer of those waveforms) frames are read from it on its device,
    else the waveforms are uploaded to ``device``. A segment is clamped into
    its own file, so it never reads the next file's samples.
    """
    window_s = 2.0 / pitch_floor
    win_len = int(round(window_s * sr))
    k = np.arange(win_len) - (win_len - 1) / 2
    window = np.exp(-0.5 * (6.0 * k / win_len) ** 2)
    n_fft = 1 << int(np.ceil(np.log2(win_len)))
    dq = 1.0 / sr
    qs = np.arange(n_fft // 2 + 1) * dq
    band_idx = np.flatnonzero((qs >= 1.0 / pitch_max) & (qs <= 1.0 / pitch_min))
    trend_idx = np.flatnonzero(qs >= trend_q_start)
    if band_idx.size == 0 or trend_idx.size == 0:
        empty = [float("nan")] * len(items)
        return Deferred.ready(empty) if defer else empty
    band_lo, band_hi = int(band_idx[0]), int(band_idx[-1]) + 1
    trend_lo, trend_hi = int(trend_idx[0]), int(trend_idx[-1]) + 1

    if buf is not None:
        if win_len > buf.pad:
            raise ValueError(f"corpus buffer pad {buf.pad} < window {win_len}")
        dev = buf.x_cat.device
    else:
        dev = resolve_device(device)
    seg_meta = []  # (file index, n_frames)
    start_blocks, pieces = [], []
    offset = 0
    for fi, (x, segments) in enumerate(items):
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        file_offset = None
        for (a, b) in segments:
            sa = min(int(a * sr), len(x))
            sb = min(int(b * sr), len(x))
            seg_len = max(sb - sa, 0)
            n_frames, t0 = praat_frame_grid(seg_len, sr, window_s, time_step)
            if n_frames < 1:
                continue
            if buf is not None:
                file_offset = int(buf.offsets[fi])
            elif file_offset is None:
                piece = np.pad(x, (0, win_len)).astype(np.float32)
                pieces.append(piece)
                file_offset = offset
                offset += len(piece)
            centers = t0 + np.arange(n_frames) * time_step
            starts = np.clip(np.round(centers * sr - win_len / 2).astype(int),
                             0, max(seg_len - win_len, 0))
            start_blocks.append(starts + sa + file_offset)
            seg_meta.append((fi, n_frames))

    n_items = len(items)
    if not start_blocks:
        empty = [float("nan")] * n_items
        return Deferred.ready(empty) if defer else empty

    x_cat = buf.x_cat if buf is not None else torch.from_numpy(np.concatenate(pieces)).to(dev)
    seg_ids = np.concatenate([np.full(nf, si, np.int64) for si, (_, nf) in enumerate(seg_meta)])
    starts_padded, _ = pad_frames(np.concatenate(start_blocks).astype(np.int64)[:, None])
    ids_padded = np.full(starts_padded.shape[0], -1, np.int64)
    ids_padded[: len(seg_ids)] = seg_ids
    prom_dev = _gathered_cpps_prominence(
        x_cat, torch.from_numpy(starts_padded[:, 0]).to(dev),
        torch.from_numpy(window.astype(np.float32)).to(dev), torch.from_numpy(ids_padded).to(dev),
        win_len, n_fft, dq, trend_lo, trend_hi, band_lo, band_hi,
        max(int(0.01 / time_step), 1),  # Get CPPS's time window
        max(int(0.001 / dq), 1))  # and its quefrency window

    def _finalize(prom):
        prom = np.asarray(prom).astype(np.float64)
        per_file = [[] for _ in range(n_items)]
        cursor = 0
        for fi, n_frames in seg_meta:
            seg_mean = float(np.mean(prom[cursor : cursor + n_frames]))
            cursor += n_frames
            if np.isfinite(seg_mean) and seg_mean > keep_above:
                per_file[fi].append(seg_mean)
        return [float(np.mean(vals)) if vals else float("nan") for vals in per_file]

    d = Deferred(prom_dev, _finalize)
    return d if defer else d.result()


def _robust_line_fit(q: np.ndarray, v: np.ndarray, iters: int = 5
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row straight-line fit of v (N, Q) over q (Q,) with Tukey
    reweighting on the host: (slope (N,), intercept (N,))."""
    n, _ = v.shape
    w = np.ones_like(v)
    slope = np.zeros(n)
    inter = np.zeros(n)
    for _ in range(iters):
        sw = w.sum(axis=1)
        sq = (w * q[None, :]).sum(axis=1)
        sv = (w * v).sum(axis=1)
        sqq = (w * q[None, :] ** 2).sum(axis=1)
        sqv = (w * q[None, :] * v).sum(axis=1)
        denom = np.maximum(sw * sqq - sq**2, 1e-30)
        slope = (sw * sqv - sq * sv) / denom
        inter = (sv - slope * sq) / sw
        resid = v - (slope[:, None] * q[None, :] + inter[:, None])
        mad = np.median(np.abs(resid), axis=1, keepdims=True)
        c = 4.685 * np.maximum(mad, 1e-12) / 0.6745
        u = resid / c
        w = np.where(np.abs(u) < 1.0, (1 - u**2) ** 2, 0.0)
        w = np.maximum(w, 1e-6)
    return slope, inter


def cpps(cg: PowerCepstrogram, pitch_min: float = 60.0, pitch_max: float = 330.0,
         trend_q_start: float = 0.001, trend_q_end: float = 0.0) -> Tuple[float, np.ndarray]:
    """Mean smoothed cepstral peak prominence over the frames of a
    cepstrogram, on the host: (mean, per-frame prominence). The trend is
    fitted robustly over [trend_q_start, trend_q_end or the last quefrency]."""
    if len(cg.times) == 0:
        return float("nan"), np.zeros(0)
    q = cg.quefrencies
    # Get CPPS smooths the cepstrogram (time 0.01 s, quefrency 0.001 s) in
    # power; the cepstrogram stores dB
    dt_frames = cg.times[1] - cg.times[0] if len(cg.times) > 1 else 0.002
    dq_bins = q[1] - q[0] if len(q) > 1 else 1e-4
    power = np.power(10.0, np.asarray(cg.cepstrum_db, np.float64) / 10.0)
    power = _smooth_cepstrogram_power(power, max(int(0.01 / dt_frames), 1),
                                      max(int(0.001 / dq_bins), 1))
    v = 10.0 * np.log10(np.maximum(power, 1e-300))
    band = (q >= 1.0 / pitch_max) & (q <= 1.0 / pitch_min)
    if not band.any():
        return float("nan"), np.zeros(0)
    trend_end = trend_q_end if trend_q_end > 0 else q[-1]
    trend_mask = (q >= trend_q_start) & (q <= trend_end)
    slope, inter = _robust_line_fit(q[trend_mask], v[:, trend_mask])

    band_idx = np.flatnonzero(band)
    idx = band_idx[v[:, band_idx].argmax(axis=1)]
    rows = np.arange(v.shape[0])
    peak = v[rows, idx]
    dl = peak - v[rows, np.clip(idx - 1, 0, v.shape[1] - 1)]
    dr = peak - v[rows, np.clip(idx + 1, 0, v.shape[1] - 1)]
    denom = dl + dr
    ok = denom > 0
    peak_ref = peak + np.where(ok, 0.125 * (dl - dr) ** 2 / np.maximum(denom, 1e-12), 0.0)
    q_peak = q[idx] + np.where(ok, 0.5 * (dl - dr) / np.maximum(denom, 1e-12), 0.0) * (q[1] - q[0])
    prominence = peak_ref - (slope * q_peak + inter)
    return float(np.mean(prominence)), prominence
