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

Unvoiced frames emit 0. The march is sequential through each file's cursor
alone, so a batch of files marches together:

* :func:`mark_periods_batch`: a (B, N) stack and its (B, T) F0 (both may
  already be on the card: the pitch chain's F0 is never downloaded) →
  padded period buffers, one launch of the march kernel on the card
  (``ops/cuda/jitter.py``), scoring lags in float64;
* :func:`periods_to_llds_batch`: those buffers → (B, T, 4) LLDs as float32
  torch ops, on the buffers' device.

``mark_periods``, ``periods_to_llds`` and ``jitter_shimmer_llds`` are the
JAX package's float64 numpy reference versions, copied, and stay as the
oracle.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .cuda.jitter import march_periods
from .framing import Deferred, upload
from .prefix_sum import cumsum


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


def mark_periods_batch(
    stack,
    sr: float,
    f0_pad,
    ns: Sequence[int],
    n_frames: Sequence[int],
    hop_s: float = 0.010,
    search_range_rel: float = 0.25,
    f0_min: float = 40.0,
    defer: bool = False,
    device: DeviceLike = "cuda",
):
    """Batched period marching over a bucket of files.

    ``stack`` (B, N) zero-padded float32 waveforms and ``f0_pad`` (B, T)
    float32 F0 contours, tensors (the F0 may be the pitch chain's, left on
    the card) or arrays (placed on the other argument's device, or on
    ``device`` when neither is a tensor); ``ns``/``n_frames`` the true sample and frame counts per file.
    The buffers hold at most P = max(N // 16, 4) periods a file. Returns a
    list of :class:`PeriodTrack`, or with ``defer=True`` a
    :class:`~.framing.Deferred` whose ``arrays`` (starts, lengths, amps,
    corrs, counts) stay on the device for :func:`periods_to_llds_batch`.
    """
    dev = next((a.device for a in (stack, f0_pad) if isinstance(a, torch.Tensor)), None)
    dev = dev if dev is not None else resolve_device(device)
    x = stack if isinstance(stack, torch.Tensor) else upload(np.asarray(stack, np.float32), dev)
    f0 = f0_pad if isinstance(f0_pad, torch.Tensor) else upload(np.asarray(f0_pad, np.float32), dev)
    b, n = x.shape
    ns, n_frames = np.asarray(ns, np.int32), np.asarray(n_frames, np.int32)
    if ns.shape != (b,) or n_frames.shape != (b,) or (n_frames < 1).any() \
            or (n_frames > f0.shape[1]).any():
        raise ValueError(f"need one sample count and 1..{f0.shape[1]} frames per file of {b}, "
                         f"got {ns.tolist()} and {n_frames.tolist()}")
    hop = max(int(round(hop_s * sr)), 1)
    arrays = march_periods(x, f0, upload(ns, dev), upload(n_frames, dev), float(sr), hop,
                           float(search_range_rel), float(f0_min), max(n // 16, 4))

    def _finalize(host):
        starts, lengths, amps, corrs, counts = host
        return [PeriodTrack(starts[i, :k].astype(np.int64), lengths[i, :k].astype(np.int64),
                            amps[i, :k].astype(np.float64), corrs[i, :k].astype(np.float64))
                for i, k in enumerate(counts.tolist())]

    d = Deferred(arrays, _finalize)
    return d if defer else d.result()


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


def periods_to_llds_batch(march_arrays, f0_pad: torch.Tensor, sr: float,
                          hop_s: float = 0.010, frame_s: float = 0.025) -> torch.Tensor:
    """(starts, lengths, amps, corrs, counts) period buffers (B, P) and (B,)
    and the (B, T) F0 → (B, T, 4) float32 [jitterLocal, jitterDDP,
    shimmerLocal, logHNR] on their device: :func:`periods_to_llds` over the
    padded buffers in float32, every per-frame mean a difference of prefix
    sums (the JAX package's device version, ``ops/jitter.py:434-522``)."""
    starts, lengths, amps, corrs, counts = march_arrays
    dev = starts.device
    f0 = f0_pad.to(dev)
    b, p = starts.shape
    n_frames = f0.shape[1]
    k = counts.to(torch.int64)[:, None]
    idx = torch.arange(p, device=dev)
    valid = idx < k
    srt = torch.full((), float(sr), dtype=torch.float32, device=dev)
    lens = lengths.to(torch.float32)
    centers = torch.where(valid, (starts.to(torch.float32) + lens / 2.0) / srt, float("inf"))
    per = torch.where(valid, lens / srt, 0.0)
    amp = torch.where(valid, amps, 0.0)
    rho = torch.clamp(torch.where(valid, corrs, 0.0), 0.0, 0.999999)
    diff = per[:, 1:] - per[:, :-1]
    d_t = torch.where(idx[:-1] < k - 1, diff.abs(), 0.0)
    dd_t = torch.where(idx[:-2] < k - 2, (diff[:, 1:] - diff[:, :-1]).abs(), 0.0)
    d_a = torch.where(idx[:-1] < k - 1, (amp[:, 1:] - amp[:, :-1]).abs(), 0.0)

    half = frame_s / 2
    t_c = torch.arange(n_frames, device=dev, dtype=torch.float32) * hop_s + half
    t_c = t_c.expand(b, n_frames).contiguous()
    i0 = torch.searchsorted(centers, t_c - half, side="left")
    i1 = torch.searchsorted(centers, t_c + half, side="right") - 1
    cnt = i1 - i0 + 1
    ok = (cnt >= 2) & (f0 > 0)
    last = torch.clamp(k - 1, min=0)
    i0c = torch.minimum(torch.clamp(i0, min=0), last)
    i1c = torch.minimum(torch.clamp(i1, min=0), last)

    # one prefix sum over the six sequences, each zero-padded to P; the
    # rho − 1 accumulation keeps the (1 − rho) that ln(rho/(1 − rho)) needs,
    # which a float32 sum of values near 1 would lose
    seqs = torch.stack([per, amp, torch.where(valid, rho - 1.0, 0.0),
                        torch.nn.functional.pad(d_t, (0, 1)),
                        torch.nn.functional.pad(dd_t, (0, 2)),
                        torch.nn.functional.pad(d_a, (0, 1))], dim=1)
    cums = torch.nn.functional.pad(cumsum(seqs, dim=-1), (1, 0))
    c_t, c_a, c_rm, c_dt, c_ddt, c_da = cums.unbind(1)

    def seg(c, hi_idx, lo_idx):
        return c.gather(1, hi_idx) - c.gather(1, lo_idx)

    cntf = torch.clamp(cnt, min=1).to(torch.float32)
    mean_t = seg(c_t, i1c + 1, i0c) / cntf
    mean_a = torch.clamp(seg(c_a, i1c + 1, i0c) / cntf, min=1e-12)
    n_d = i1c - i0c
    has_d = ok & (n_d > 0) & (mean_t > 0)
    j0 = torch.minimum(i0c, last)
    j1 = torch.minimum(i1c, last)
    nd = torch.clamp(n_d, min=1).to(torch.float32)
    out0 = torch.where(has_d, seg(c_dt, j1, j0) / nd / mean_t, 0.0)
    out2 = torch.where(has_d, seg(c_da, j1, j0) / nd / mean_a, 0.0)
    n_dd = i1c - 1 - i0c
    has_dd = ok & (n_dd > 0) & (mean_t > 0)
    last2 = torch.clamp(k - 2, min=0)
    k0 = torch.minimum(i0c, last2)
    k1 = torch.minimum(torch.clamp(i1c - 1, min=0), last2)
    ndd = torch.clamp(n_dd, min=1).to(torch.float32)
    out1 = torch.where(has_dd, seg(c_ddt, k1, k0) / ndd / mean_t, 0.0)
    one_minus_r = -seg(c_rm, i1c + 1, i0c) / cntf
    r = 1.0 - one_minus_r
    out3 = torch.where(ok & (r > 0), torch.log(r / torch.clamp(one_minus_r, min=1e-9)), 0.0)
    out = torch.stack([out0, out1, out2, out3], dim=-1)
    out = torch.where((ok & (k >= 3))[..., None], out, 0.0)
    return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


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
