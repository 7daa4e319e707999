"""Spectrogram and spectral moments (Praat semantics), corpus-batched.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/spectral.py``: a
Gaussian-window spectrogram (the physical window twice the nominal length,
as Praat documents), each frame's power spectrum, and the first four
moments of the power distribution (Praat's power = 2): centre of gravity,
standard deviation, skewness and kurtosis. :func:`spectrogram`,
:func:`spectral_moments` and :func:`voiced_mean_moments` are numpy oracles
on the host; :func:`voiced_mean_moments_batch` gathers every frame of every
file from a corpus buffer and returns only the (frames, 4) moment matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bucketing import pad_frames
from .dft import rfft_power
from .framing import Deferred, gather_frames
from .pitch import praat_frame_grid


class SpectrogramFrames(NamedTuple):
    times: np.ndarray  # (N,)
    freqs: np.ndarray  # (F,)
    power: np.ndarray  # (N, F)


def praat_gaussian_window(win_len: int) -> np.ndarray:
    """Praat's Gaussian-like analysis window (float64):
    (exp(−48(k/L)²) − e⁻¹²) / (1 − e⁻¹²), k centred on the window."""
    k = np.arange(win_len) - (win_len - 1) / 2
    return (np.exp(-48.0 * (k / win_len) ** 2) - math.exp(-12.0)) / (1.0 - math.exp(-12.0))


def spectrogram(x: np.ndarray, sr: float, window_length: float = 0.025,
                time_step: float = 0.005, max_frequency: float = None) -> SpectrogramFrames:
    """Gaussian-window spectrogram on the Praat grid (numpy float64)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    phys = 2.0 * window_length
    n_frames, t0 = praat_frame_grid(len(x), sr, phys, time_step)
    win_len = int(round(phys * sr))
    if n_frames < 1:
        return SpectrogramFrames(np.zeros(0), np.zeros(0), np.zeros((0, 0)))
    window = praat_gaussian_window(win_len)
    centers = t0 + np.arange(n_frames) * time_step
    starts = np.clip(np.round(centers * sr - win_len / 2).astype(int), 0, max(len(x) - win_len, 0))
    frames = x[starts[:, None] + np.arange(win_len)[None, :]] * window
    n_fft = 1 << int(np.ceil(np.log2(win_len)))
    power = np.abs(np.fft.rfft(frames, n_fft, axis=1)) ** 2
    freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    if max_frequency:
        keep = freqs <= max_frequency
        freqs, power = freqs[keep], power[:, keep]
    return SpectrogramFrames(centers, freqs, power)


def spectral_moments(power: np.ndarray, freqs: np.ndarray, power_exponent: float = 2.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame (gravity, std, skewness, kurtosis) of |S|^power_exponent.

    ``power`` is already |S|²; Praat's ``power=2`` option takes the moments
    over |S|², this array used as the weighting directly.
    """
    w = power if power_exponent == 2.0 else np.power(np.maximum(power, 0.0),
                                                      power_exponent / 2.0)
    total = w.sum(axis=1)
    total = np.where(total > 0, total, np.nan)
    g = (w * freqs[None, :]).sum(axis=1) / total
    d = freqs[None, :] - g[:, None]
    var = (w * d**2).sum(axis=1) / total
    std = np.sqrt(var)
    with np.errstate(invalid="ignore", divide="ignore"):
        skew = (w * d**3).sum(axis=1) / (total * std**3)
        kurt = (w * d**4).sum(axis=1) / (total * var**2) - 3.0
    return g, std, skew, kurt


def voiced_mean_moments(x: np.ndarray, sr: float, voiced_at, window_length: float = 0.025,
                        time_step: float = 0.005) -> Tuple[float, float, float, float]:
    """Mean of the per-frame spectral moments over voiced frames only;
    ``voiced_at`` maps frame times to a boolean array."""
    sg = spectrogram(x, sr, window_length, time_step)
    if len(sg.times) == 0:
        return (float("nan"),) * 4
    g, s, sk, ku = spectral_moments(sg.power, sg.freqs)
    voiced = np.asarray(voiced_at(sg.times), dtype=bool)
    out = []
    for v in (g, s, sk, ku):
        vv = v[voiced & np.isfinite(v)]
        out.append(float(vv.mean()) if vv.size else float("nan"))
    return tuple(out)


def _gathered_frame_moments(x_cat: torch.Tensor, starts: torch.Tensor, window: torch.Tensor,
                            win_len: int, n_fft: int) -> torch.Tensor:
    """Frames gathered on the device, their power spectra and the first four
    moments of each, in FFT-bin units: (N, 4). The (N, F) power matrix never
    leaves the device."""
    w = rfft_power(gather_frames(x_cat, starts, win_len) * window[None, :], n_fft)
    freqs = torch.arange(n_fft // 2 + 1, dtype=w.dtype, device=w.device)
    total = w.sum(dim=1)
    total = torch.where(total > 0, total, float("nan"))
    g = (w * freqs[None, :]).sum(dim=1) / total
    d = freqs[None, :] - g[:, None]
    var = (w * d * d).sum(dim=1) / total
    std = torch.sqrt(var)
    skew = (w * d * d * d).sum(dim=1) / (total * std * var)
    kurt = (w * d * d * d * d).sum(dim=1) / (total * var * var) - 3.0
    return torch.stack([g, std, skew, kurt], dim=1)


def voiced_mean_moments_batch(xs, sr: float, voiced_fns, window_length: float = 0.025,
                              time_step: float = 0.005, buf=None, indices=None,
                              defer: bool = False, device: DeviceLike = "cuda"):
    """:func:`voiced_mean_moments` of many files at once (a list of 4-tuples,
    or a ``Deferred`` of it): every file's frames go through one pass on the
    device, in FFT-bin units rescaled to Hz on the host, and only (frames, 4)
    floats come back. Frames come from ``buf`` (files ``indices``) on its
    device, or from ``xs`` uploaded to ``device``.

    ``voiced_fns`` is one voiced predicate (frame times → bool array) per
    file, or a zero-argument callable returning that list: it is called at
    finalize time, so the device pass can be queued before the pitch tracks
    that define voicing are final.
    """
    phys = 2.0 * window_length
    win_len = int(round(phys * sr))
    window = praat_gaussian_window(win_len)
    n_fft = 1 << int(np.ceil(np.log2(win_len)))
    df = sr / n_fft  # Hz per FFT bin

    if buf is not None:
        idxs = list(indices) if indices is not None else list(range(len(buf.xs)))
        xs = [buf.xs[i] for i in idxs]
        if win_len > buf.pad:
            raise ValueError(f"corpus buffer pad {buf.pad} < window {win_len}")
        dev = buf.x_cat.device
    else:
        dev = resolve_device(device)

    metas, start_blocks, pieces = [], [], []
    offset = 0
    for k, x in enumerate(xs):
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        n_frames, t0 = praat_frame_grid(len(x), sr, phys, time_step)
        centers = t0 + np.arange(max(n_frames, 0)) * time_step
        metas.append((n_frames, centers))
        if n_frames < 1:
            continue
        if buf is None:
            base = offset
            pieces.append(np.pad(x, (0, win_len)).astype(np.float32))
            offset += len(x) + win_len
        else:
            base = int(buf.offsets[idxs[k]])
        starts = np.clip(np.round(centers * sr - win_len / 2).astype(int),
                         0, max(len(x) - win_len, 0))
        start_blocks.append(starts + base)

    if not start_blocks:
        empty = [(float("nan"),) * 4 for _ in metas]
        return Deferred.ready(empty) if defer else empty

    x_cat = buf.x_cat if buf is not None else torch.from_numpy(np.concatenate(pieces)).to(dev)
    starts_padded, _ = pad_frames(np.concatenate(start_blocks).astype(np.int64)[:, None])
    m_dev = _gathered_frame_moments(
        x_cat, torch.from_numpy(starts_padded[:, 0]).to(dev),
        torch.from_numpy(window.astype(np.float32)).to(dev), win_len, n_fft)

    def _finalize(m):
        fns = voiced_fns() if callable(voiced_fns) else voiced_fns
        m = np.asarray(m).astype(np.float64)
        m[:, 0] *= df  # gravity and spread scale with the bin width;
        m[:, 1] *= df  # skewness and kurtosis are scale-free
        out, cursor = [], 0
        for (n_frames, centers), voiced_at in zip(metas, fns):
            if n_frames < 1:
                out.append((float("nan"),) * 4)
                continue
            mm = m[cursor : cursor + n_frames]
            cursor += n_frames
            voiced = np.asarray(voiced_at(centers), dtype=bool)
            vals = []
            for c in range(4):
                v = mm[voiced & np.isfinite(mm[:, c]), c]
                vals.append(float(v.mean()) if v.size else float("nan"))
            out.append(tuple(vals))
        return out

    d = Deferred(m_dev, _finalize)
    return d if defer else d.result()
