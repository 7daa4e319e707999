"""Waveform-domain jitter, shimmer and log-HNR (openSMILE ``cPitchJitter``), numpy.

The voice-quality LLDs of the Androids configuration (Androids.conf:231-255):
guided by the frame-level F0 contour, exact pitch periods are located on the
raw waveform by maximising the normalised cross-correlation of adjacent
candidate periods within ±searchRangeRel (0.25) of the expected length. Per
output frame:

* jitterLocal — mean |T_i − T_{i−1}| / mean T over periods in the frame;
* jitterDDP — mean |(T_i−T_{i−1}) − (T_{i−1}−T_{i−2})| / mean T;
* shimmerLocal — mean |A_i − A_{i−1}| / mean A of per-period peak amplitudes;
* logHNR — ln(ρ/(1−ρ)) from the correlation ρ of adjacent periods.

Unvoiced frames emit 0. The march is sequential through the waveform, one
period per step, so the port runs it on the host in float64: these are the
JAX package's own reference versions (``mark_periods``,
``periods_to_llds``), copied. A device march is a later kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class PeriodTrack(NamedTuple):
    starts: np.ndarray  # (P,) sample index of each period start
    lengths: np.ndarray  # (P,) samples
    amplitudes: np.ndarray  # (P,) peak absolute amplitude within the period
    correlations: np.ndarray  # (P,) correlation with the previous period


def mark_periods(
    x: np.ndarray,
    sr: float,
    f0_frames: np.ndarray,
    hop_s: float = 0.010,
    search_range_rel: float = 0.25,
) -> PeriodTrack:
    """March period boundaries through voiced regions.

    For each voiced stretch of the frame-level F0 contour, successive period
    lengths are chosen to maximise the normalised cross-correlation between
    the current period and the next one, searched within
    (1 ± search_range_rel)·T_expected. Unvoiced stretches are crossed half a
    hop at a time.
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    starts: List[int] = []
    lengths: List[int] = []
    amps: List[float] = []
    corrs: List[float] = []

    n_frames = len(f0_frames)
    hop_samples = max(int(round(hop_s * sr)), 1)

    pos = 0
    n = len(x)
    while pos < n - 16:
        fi = min(pos // hop_samples, n_frames - 1)
        f0 = f0_frames[fi]
        if f0 <= 0:
            pos += max(int(hop_s * sr) // 2, 1)
            continue
        t0 = sr / f0
        lo = max(int(t0 * (1 - search_range_rel)), 8)
        hi = int(t0 * (1 + search_range_rel)) + 1
        if pos + hi * 2 >= n:
            break
        # one normalised cross-correlation over the whole lag band: template
        # = one expected period, searched against the next
        w0 = int(round(t0))
        a = x[pos : pos + w0]
        seg = x[pos + lo : pos + hi + w0]
        corr = np.correlate(seg, a, mode="valid")  # corr[j] ↔ lag lo+j
        sq = np.concatenate([[0.0], np.cumsum(seg * seg)])
        e_b = sq[w0:] - sq[: len(sq) - w0]
        e_b = e_b[: len(corr)]
        e_a = float(np.dot(a, a))
        denom = np.sqrt(np.maximum(e_a * e_b, 1e-30))
        ncc = np.where(denom > 0, corr / denom, -2.0)
        j = int(np.argmax(ncc))
        best_len = lo + j
        starts.append(pos)
        lengths.append(best_len)
        amps.append(float(np.max(np.abs(x[pos : pos + best_len]))))
        corrs.append(float(ncc[j]))
        pos += best_len

    return PeriodTrack(
        np.asarray(starts, dtype=np.int64),
        np.asarray(lengths, dtype=np.int64),
        np.asarray(amps),
        np.asarray(corrs),
    )


def periods_to_llds(
    periods: PeriodTrack,
    f0_frames: np.ndarray,
    sr: float,
    hop_s: float = 0.010,
    frame_s: float = 0.025,
) -> np.ndarray:
    """Period track → frame-level [jitterLocal, jitterDDP, shimmerLocal,
    logHNR] (T, 4). Period centres are sorted, so each frame's periods are a
    contiguous [i0, i1] range found by searchsorted, and every per-range mean
    comes from prefix sums."""
    n_frames = len(f0_frames)
    out = np.zeros((n_frames, 4))
    if len(periods.starts) < 3:
        return out

    centers = (periods.starts + periods.lengths / 2) / sr
    T = periods.lengths.astype(np.float64) / sr
    A = periods.amplitudes
    dT = np.abs(np.diff(T))
    ddT = np.abs(np.diff(T, n=2))
    dA = np.abs(np.diff(A))
    rho = np.clip(periods.correlations, 0.0, 0.999999)

    half = frame_s / 2
    t_c = np.arange(n_frames) * hop_s + half
    i0 = np.searchsorted(centers, t_c - half, side="left")
    i1 = np.searchsorted(centers, t_c + half, side="right") - 1
    count = i1 - i0 + 1
    ok = (count >= 2) & (np.asarray(f0_frames[:n_frames]) > 0)
    i0c = np.clip(i0, 0, len(T) - 1)
    i1c = np.clip(i1, 0, len(T) - 1)

    def _cum(v):
        return np.concatenate([[0.0], np.cumsum(v)])

    cT, cA, cR = _cum(T), _cum(A), _cum(rho)
    cdT, cddT, cdA = _cum(dT), _cum(ddT), _cum(dA)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_t = (cT[i1c + 1] - cT[i0c]) / count
        mean_a = np.maximum((cA[i1c + 1] - cA[i0c]) / count, 1e-12)
        n_d = i1c - i0c
        has_d = ok & (n_d > 0) & (mean_t > 0)
        j0 = np.minimum(i0c, len(cdT) - 1)
        j1 = np.minimum(i1c, len(cdT) - 1)
        out[:, 0] = np.where(
            has_d, (cdT[j1] - cdT[j0]) / np.maximum(n_d, 1) / mean_t, 0.0
        )
        out[:, 2] = np.where(
            has_d, (cdA[j1] - cdA[j0]) / np.maximum(n_d, 1) / mean_a, 0.0
        )
        n_dd = i1c - 1 - i0c
        has_dd = ok & (n_dd > 0) & (mean_t > 0)
        k0 = np.minimum(i0c, len(cddT) - 1)
        k1 = np.clip(i1c - 1, 0, len(cddT) - 1)
        out[:, 1] = np.where(
            has_dd,
            (cddT[k1] - cddT[k0]) / np.maximum(n_dd, 1) / mean_t,
            0.0,
        )
        r = (cR[i1c + 1] - cR[i0c]) / count
        out[:, 3] = np.where(
            ok & (r > 0), np.log(r / np.maximum(1.0 - r, 1e-9)), 0.0
        )
    out[~ok] = 0.0
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


def jitter_shimmer_llds(
    x: np.ndarray,
    sr: float,
    f0_frames: np.ndarray,
    hop_s: float = 0.010,
    frame_s: float = 0.025,
    search_range_rel: float = 0.25,
) -> np.ndarray:
    """Frame-level [jitterLocal, jitterDDP, shimmerLocal, logHNR] (T, 4)."""
    periods = mark_periods(x, sr, f0_frames, hop_s, search_range_rel)
    return periods_to_llds(periods, f0_frames, sr, hop_s, frame_s)
