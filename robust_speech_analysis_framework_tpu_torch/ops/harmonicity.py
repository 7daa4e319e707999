"""Harmonics-to-noise ratio (Praat ``Sound: To Harmonicity (cc)...``), corpus-batched.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/harmonicity.py``.
Boersma (1993): per frame, the largest r of the normalized forward
cross-correlation within the pitch band estimates the periodic share of the
energy; HNR (dB) = 10·log10(r/(1−r)). Frames whose local peak falls below
``silence_threshold`` × the file's global peak, or with no positive
correlation peak, are undefined (NaN) and left out of the statistics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bucketing import pad_frames
from .framing import Deferred, gather_frames
from .pitch import _forward_crosscorr, praat_frame_grid


class HarmonicityContour(NamedTuple):
    times: np.ndarray
    hnr_db: np.ndarray  # NaN where undefined

    def mean_db(self) -> float:
        v = self.hnr_db[np.isfinite(self.hnr_db)]
        return float(v.mean()) if v.size else float("nan")


def _gathered_hnr(x_cat, starts, global_peak, ext: int, win_len: int, max_lag: int,
                  lag_min: int, silence_threshold: float) -> torch.Tensor:
    """Frames gathered on the device → forward cross-correlation → the band
    peak with its parabolic bump → 10·log10(r/(1−r)), NaN where silent or
    unvoiced. The lag floor sr/(10·minimum_pitch) stands in for Praat's
    candidate search and path finder inside To Harmonicity (cc), as in the
    JAX package."""
    r, local_peak = _forward_crosscorr(gather_frames(x_cat, starts, ext), win_len, max_lag)
    band = r[:, lag_min : max_lag + 1]
    r_best, idx = band.max(dim=1)  # the first maximum, as jnp.argmax
    idx = idx + lag_min
    valid_idx = (idx > 0) & (idx < r.shape[1] - 1)
    rows = torch.arange(r.shape[0], device=r.device)
    il = torch.clamp(idx - 1, 0, r.shape[1] - 1)
    ir = torch.clamp(idx + 1, 0, r.shape[1] - 1)
    dl = r[rows, idx] - r[rows, il]
    dr_ = r[rows, idx] - r[rows, ir]
    denom = dl + dr_
    bump = torch.where((denom > 0) & valid_idx,
                       0.125 * (dl - dr_) ** 2 / torch.clamp(denom, min=1e-12), 0.0)
    # saturated frames: the 90 dB cap lives in the denominator floor (a < 1
    # ceiling on r_best is a no-op in float32)
    r_best = torch.clamp(r_best + bump, max=1.0)
    undefined = (local_peak < silence_threshold * global_peak) | (r_best <= 0)
    hnr = 10.0 * torch.log10(torch.clamp(r_best, min=1e-12) / torch.clamp(1.0 - r_best, min=1e-9))
    return torch.where(undefined, float("nan"), hnr)


def harmonicity_cc_batch(xs, sr: float, time_step: float = 0.01, minimum_pitch: float = 75.0,
                         silence_threshold: float = 0.1, periods_per_window: float = 4.5,
                         buf=None, indices=None, defer: bool = False,
                         device: DeviceLike = "cuda"):
    """HNR contours of many waveforms (a list of HarmonicityContour, or a
    ``Deferred`` of it): frames from ``buf`` (files ``indices``) on its
    device, or from ``xs`` uploaded to ``device``; only the (N,) HNR values
    come back to the host."""
    window_s = periods_per_window / minimum_pitch
    win_len = int(round(window_s * sr))
    max_lag = int(math.ceil(sr / minimum_pitch)) + 2
    ext = win_len + max_lag

    if buf is not None:
        idxs = list(indices) if indices is not None else list(range(len(buf.xs)))
        xs = [buf.xs[i] for i in idxs]
        dev = buf.x_cat.device
        if ext > buf.pad:
            raise ValueError(f"corpus buffer pad {buf.pad} < required ext {ext}")
    else:
        dev = resolve_device(device)

    metas, start_blocks, pieces, gp_blocks = [], [], [], []
    offset = 0
    for k, x in enumerate(xs):
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        n_frames, t0 = praat_frame_grid(len(x), sr, window_s, time_step)
        centers = t0 + np.arange(n_frames) * time_step
        metas.append((n_frames, centers))
        if n_frames < 1:
            continue
        if buf is None:
            base = offset
            pieces.append(np.pad(x, (0, ext)).astype(np.float32))
            offset += len(x) + ext
        else:
            base = int(buf.offsets[idxs[k]])
        # trailing frames shift left so the whole win+lag extension reads real samples
        starts = np.clip(np.round(centers * sr - win_len / 2).astype(int), 0, max(len(x) - ext, 0))
        start_blocks.append(starts + base)
        gp = float(np.max(np.abs(x - x.mean()))) or 1e-30
        gp_blocks.append(np.full(n_frames, gp, np.float32))

    if not start_blocks:
        empty = [HarmonicityContour(m[1], np.zeros(m[0])) for m in metas]
        return Deferred.ready(empty) if defer else empty

    x_cat = buf.x_cat if buf is not None else torch.from_numpy(np.concatenate(pieces)).to(dev)
    starts_padded, _ = pad_frames(np.concatenate(start_blocks).astype(np.int64)[:, None])
    gp_padded, _ = pad_frames(np.concatenate(gp_blocks)[:, None])
    lag_min = max(2, int(math.floor(sr / (minimum_pitch * 10))))
    hnr_dev = _gathered_hnr(x_cat, torch.from_numpy(starts_padded[:, 0]).to(dev),
                            torch.from_numpy(gp_padded[:, 0]).to(dev), ext, win_len, max_lag,
                            lag_min, float(silence_threshold))

    def _finalize(hnr_all):
        hnr_all = hnr_all.astype(np.float64)
        out, cursor = [], 0
        for n_frames, centers in metas:
            if n_frames < 1:
                out.append(HarmonicityContour(centers, np.zeros(0)))
                continue
            out.append(HarmonicityContour(centers, hnr_all[cursor : cursor + n_frames]))
            cursor += n_frames
        return out

    d = Deferred(hnr_dev, _finalize)
    return d if defer else d.result()


def harmonicity_cc(x: np.ndarray, sr: float, time_step: float = 0.01, minimum_pitch: float = 75.0,
                   silence_threshold: float = 0.1, periods_per_window: float = 4.5,
                   device: DeviceLike = "cuda") -> HarmonicityContour:
    """Praat ``To Harmonicity (cc)...`` of one waveform (a batch of one)."""
    return harmonicity_cc_batch([x], sr, time_step, minimum_pitch, silence_threshold,
                                periods_per_window, device=device)[0]
