"""Intensity contours (Praat ``Sound: To Intensity...``), corpus-batched.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/intensity.py``:
frames on Praat's symmetric grid, Kaiser-windowed (β = 2π² + 0.5) power in
dB re (2·10⁻⁵ Pa)², every frame of every file at once on the device, with
the contour statistics the MSHDS extractor reads (energy mean, parabolic
extrema, quantiles, values at times) on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..audio.frontend import table
from ..device import DeviceLike, resolve_device
from .bucketing import pad_frames
from .framing import Deferred, gather_frames
from .pitch import praat_frame_grid

_REF_POWER = 4.0e-10  # (2e-5 Pa)^2


class IntensityContour(NamedTuple):
    times: np.ndarray
    values_db: np.ndarray  # (N,) dB SPL-like

    def mean_energy_db(self) -> float:
        """Praat 'Get mean ... energy': dB of the time-averaged power."""
        p = np.power(10.0, self.values_db / 10.0)
        return float(10.0 * np.log10(np.mean(p)))

    def mean_db(self) -> float:
        return float(np.mean(self.values_db))

    def _parabolic_extremum(self, idx: int) -> float:
        v = self.values_db
        if 0 < idx < len(v) - 1:
            dl = v[idx] - v[idx - 1]
            dr = v[idx] - v[idx + 1]
            denom = dl + dr
            if denom > 0:
                return float(v[idx] + 0.125 * (dl - dr) ** 2 / denom)
        return float(v[idx])

    def min_db(self, parabolic: bool = True) -> float:
        idx = int(np.argmin(self.values_db))
        if not parabolic:
            return float(self.values_db[idx])
        return -IntensityContour(self.times, -self.values_db)._parabolic_extremum(idx)

    def max_db(self, parabolic: bool = True) -> float:
        idx = int(np.argmax(self.values_db))
        if not parabolic:
            return float(self.values_db[idx])
        return self._parabolic_extremum(idx)

    def quantile(self, q: float) -> float:
        """Praat 'Get quantile': NUMquantile's interpolated order statistic
        at 1-based place q·(n+1) + 0.25, left index clipped to [1, n-1]."""
        v = np.sort(self.values_db)
        n = len(v)
        if n == 0:
            return float("nan")
        if n == 1:
            return float(v[0])
        place = q * (n + 1) + 0.25
        left = min(max(int(math.floor(place)), 1), n - 1)
        return float(v[left - 1] + (place - left) * (v[left] - v[left - 1]))

    def value_at_time(self, t) -> float:
        """Contour value at time t (linear interpolation; Praat's cubic
        differs by O(dt²))."""
        t = np.asarray(t, dtype=np.float64)
        dt = self.times[1] - self.times[0] if len(self.times) > 1 else 1.0
        pos = (t - self.times[0]) / dt
        i0 = np.clip(np.floor(pos).astype(int), 0, len(self.values_db) - 1)
        i1 = np.clip(i0 + 1, 0, len(self.values_db) - 1)
        w = np.clip(pos - i0, 0.0, 1.0)
        return float((1 - w) * self.values_db[i0] + w * self.values_db[i1])

    def min_in_range(self, t1: float, t2: float) -> float:
        mask = (self.times >= t1) & (self.times <= t2)
        if not mask.any():
            return float("nan")
        return float(self.values_db[mask].min())


def _frame_power(frames: torch.Tensor, window: torch.Tensor, subtract_mean: bool = True):
    """Windowed mean power of each frame (the window normalised to sum 1)."""
    w = window / window.sum()
    if subtract_mean:
        frames = frames - (frames * w).sum(dim=-1, keepdim=True)
    return (frames * frames * w).sum(dim=-1)


def intensity_contour_batch(xs, sr: float, minimum_pitch: float = 100.0, time_step: float = 0.0,
                            subtract_mean: bool = True, buf=None, indices=None,
                            defer: bool = False, device: DeviceLike = "cuda"):
    """Intensity contours of many waveforms (a list of IntensityContour, or
    a ``Deferred`` of it): window 6.4/minimum_pitch s, default step a
    quarter window; frames from ``buf`` (files ``indices``) on its device,
    or from ``xs`` uploaded to ``device``."""
    window_s = 6.4 / minimum_pitch
    dt = time_step if time_step > 0 else window_s / 4.0
    win_len = int(round(window_s * sr))
    # Praat's Kaiser window, β = 2π² + 0.5; np.kaiser's I0(β) scale cancels in w/Σw
    window = np.kaiser(win_len, 2.0 * np.pi**2 + 0.5)

    if buf is not None:
        idxs = list(indices) if indices is not None else list(range(len(buf.xs)))
        xs = [buf.xs[i] for i in idxs]
        dev = buf.x_cat.device
        if win_len > buf.pad:
            raise ValueError(f"corpus buffer pad {buf.pad} < window {win_len}")
    else:
        dev = resolve_device(device)

    metas, start_blocks, pieces = [], [], []
    offset = 0
    for k, x in enumerate(xs):
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        n_frames, t0 = praat_frame_grid(len(x), sr, window_s, dt)
        centers = t0 + np.arange(n_frames) * dt
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
        empty = [IntensityContour(m[1], np.zeros(m[0])) for m in metas]
        return Deferred.ready(empty) if defer else empty

    x_cat = buf.x_cat if buf is not None else torch.from_numpy(np.concatenate(pieces)).to(dev)
    starts_padded, _ = pad_frames(np.concatenate(start_blocks).astype(np.int64)[:, None])
    frames = gather_frames(x_cat, torch.from_numpy(starts_padded[:, 0]).to(dev), win_len)
    power_dev = _frame_power(frames, table(window, x_cat), subtract_mean)

    def _finalize(power):
        out, cursor = [], 0
        for n_frames, centers in metas:
            if n_frames < 1:
                out.append(IntensityContour(centers, np.zeros(0)))
                continue
            p = power[cursor : cursor + n_frames]
            cursor += n_frames
            out.append(IntensityContour(centers, 10.0 * np.log10(np.maximum(p, 1e-30) / _REF_POWER)))
        return out

    d = Deferred(power_dev, _finalize)
    return d if defer else d.result()


def intensity_contour(x: np.ndarray, sr: float, minimum_pitch: float = 100.0,
                      time_step: float = 0.0, subtract_mean: bool = True,
                      device: DeviceLike = "cuda") -> IntensityContour:
    """Praat ``To Intensity...`` of one waveform (a batch of one)."""
    return intensity_contour_batch([x], sr, minimum_pitch, time_step, subtract_mean,
                                   device=device)[0]
