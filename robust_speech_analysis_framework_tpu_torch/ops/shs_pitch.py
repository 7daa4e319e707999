"""Subharmonic-summation pitch with Viterbi smoothing (openSMILE chain).

The Androids pitch chain (Androids.conf:142-227), batched over files:

* ``cSpecScale`` — the magnitude spectrum on an octave (log2) frequency grid
  from minF = 25 Hz by natural cubic spline (one matrix product), with
  3-point smoothing and peak enhancement (:142-159);
* ``cPitchShs`` — subharmonic summation: on the octave grid a harmonic is a
  constant shift, so H(s) = Σ_h c^{h−1}·S(s + log2 h) is a sum of shifted
  copies; greedy peak picking gives up to 6 candidates in [52, 620] Hz with
  normalised scores, and a voicing measure from the autocorrelation
  (:161-186);
* ``cPitchSmootherViterbi`` — candidate-level Viterbi with the configured
  weights (:190-213): the path finder K7 (``ops/cuda/viterbi.py``), a
  hand-written kernel on the card;
* ``cValbasedSelector`` — F0 and voicing zeroed where the frame's RMS
  energy is under 0.001 (:216-227).

Tensors are (B, T, F) on any device; the host tables (spline matrix,
voicing divisor) are float64 numpy, cast to the spectrum's dtype when used.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..audio.frontend import hamming_window, table
from .cuda.viterbi import viterbi_path
from .dft import autocorr_via_power
from .prefix_sum import cumsum


class ShsParams(NamedTuple):
    min_pitch: float = 52.0
    max_pitch: float = 620.0
    n_candidates: int = 6
    n_harmonics: int = 15
    compression: float = 0.85
    voicing_cutoff: float = 0.70
    min_f_scale: float = 25.0
    # Viterbi weights (cPitchSmootherViterbi defaults from Androids.conf)
    w_tvv: float = 10.0
    w_tvvd: float = 5.0
    w_tvuv: float = 10.0
    w_thr: float = 4.0
    w_tuu: float = 0.0
    w_local: float = 2.0
    w_range: float = 1.0


def octave_grid(sr: float, min_f: float, n_points: int) -> Tuple[float, float]:
    """(log2_min, dlog) of the octave-scale grid spanning [min_f, sr/2]."""
    log_min = math.log2(min_f)
    log_max = math.log2(sr / 2.0)
    return log_min, (log_max - log_min) / (n_points - 1)


@lru_cache(maxsize=16)
def _spline_interp_matrix(n_bins: int, pos_key: Tuple[float, ...]) -> np.ndarray:
    """Natural-cubic-spline interpolation matrix S from a uniform source grid
    (bin coordinates 0..n_bins−1) to the points ``pos_key``: spline(y)(pos)
    = S @ y (Androids.conf:153 ``interpMethod = spline``)."""
    n = n_bins
    pos = np.asarray(pos_key, dtype=np.float64)
    # second derivatives with natural ends (m_0 = m_{n-1} = 0); interior rows
    # solve m_{j-1} + 4 m_j + m_{j+1} = 6·Δ²y (unit spacing)
    a = np.zeros((n - 2, n - 2))
    np.fill_diagonal(a, 4.0)
    np.fill_diagonal(a[1:], 1.0)
    np.fill_diagonal(a[:, 1:], 1.0)
    d2 = np.zeros((n - 2, n))
    rows = np.arange(n - 2)
    d2[rows, rows] = 6.0
    d2[rows, rows + 1] = -12.0
    d2[rows, rows + 2] = 6.0
    m_full = np.zeros((n, n))
    m_full[1:-1] = np.linalg.solve(a, d2)
    j = np.clip(pos.astype(int), 0, n - 2)
    u = pos - j
    s = np.zeros((len(pos), n))
    rows = np.arange(len(pos))
    s[rows, j] += 1.0 - u
    s[rows, j + 1] += u
    cu = ((1.0 - u) ** 3 - (1.0 - u)) / 6.0
    cl = (u**3 - u) / 6.0
    s += cu[:, None] * m_full[j] + cl[:, None] * m_full[j + 1]
    return s.astype(np.float32)


def octave_scale_spectrum(mag: torch.Tensor, sr: float, min_f: float, n_points: int) -> torch.Tensor:
    """(..., F) magnitude → (..., n_points) on the log2 grid of
    :func:`octave_grid`: spline interpolation, 3-point smoothing, then peak
    enhancement (minus the 9-bin local average, clipped at 0)."""
    n_bins = mag.shape[-1]
    freqs = np.arange(n_bins) * (sr / 2.0) / (n_bins - 1)
    log_min, dlog = octave_grid(sr, min_f, n_points)
    grid_f = 2.0 ** (log_min + np.arange(n_points) * dlog)
    pos = np.interp(grid_f, freqs, np.arange(n_bins))
    s_mat = _spline_interp_matrix(n_bins, tuple(pos.tolist()))
    s = torch.clamp(mag @ table(s_mat, mag).T, min=0.0)
    sm = (torch.cat([s[..., :1], s[..., :-1]], dim=-1) + s
          + torch.cat([s[..., 1:], s[..., -1:]], dim=-1)) / 3.0
    k = 9
    pad = k // 2
    padded = torch.cat([sm[..., :1].expand(*sm.shape[:-1], pad), sm,
                        sm[..., -1:].expand(*sm.shape[:-1], pad)], dim=-1)
    csum = torch.nn.functional.pad(cumsum(padded, dim=-1), (1, 0))
    local_avg = (csum[..., k:] - csum[..., :-k]) / k
    return torch.clamp(sm - local_avg, min=0.0)


def shs_candidates(
    s_oct: torch.Tensor,
    log_min: float,
    dlog: float,
    n_harmonics: int,
    compression: float,
    n_candidates: int,
    bounds: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Subharmonic summation and greedy peak picking: (..., N) octave
    spectrum → (freqs, scores), each (..., n_candidates); scores in [0, 1],
    0 Hz for a missing candidate."""
    n = s_oct.shape[-1]
    h_sum = torch.zeros_like(s_oct)
    for h in range(1, n_harmonics + 1):
        shift = int(round(math.log2(h) / dlog))
        shifted = torch.nn.functional.pad(s_oct, (0, shift))[..., shift : shift + n]
        h_sum = h_sum + (compression ** (h - 1)) * shifted

    lo, hi = bounds
    grid_log = log_min + torch.arange(n, device=s_oct.device, dtype=s_oct.dtype) * dlog
    in_band = (grid_log >= math.log2(lo)) & (grid_log <= math.log2(hi))

    prev = torch.cat([h_sum[..., :1], h_sum[..., :-1]], dim=-1)
    nxt = torch.cat([h_sum[..., 1:], h_sum[..., -1:]], dim=-1)
    is_peak = (h_sum > prev) & (h_sum >= nxt) & in_band
    peak_vals = torch.where(is_peak, h_sum, float("-inf"))

    top_vals, top_idx = torch.topk(peak_vals, n_candidates, dim=-1)
    # parabolic refinement in grid coordinates
    i_l = torch.clamp(top_idx - 1, 0, n - 1)
    i_r = torch.clamp(top_idx + 1, 0, n - 1)
    dl = top_vals - torch.gather(h_sum, -1, i_l)
    dr = top_vals - torch.gather(h_sum, -1, i_r)
    denom = torch.clamp(dl + dr, min=1e-12)
    delta = torch.clamp(0.5 * (dl - dr) / denom, -0.5, 0.5)
    log_f = log_min + (top_idx.to(s_oct.dtype) + delta) * dlog
    valid = torch.isfinite(top_vals) & (top_vals > 0)
    freqs = torch.where(valid, 2.0**log_f, 0.0)

    best = torch.clamp(top_vals[..., :1], min=1e-30)
    scores = torch.where(valid, top_vals / best, 0.0)
    return freqs, scores


def _voicing_from_power(power: torch.Tensor, sr: float, min_pitch: float, win_len: int = 0) -> torch.Tensor:
    """Voicing probability per frame from the normalised autocorrelation of
    a power spectrum (Wiener–Khinchin). ``power`` should come from a
    transform with n_fft ≥ win_len + sr/min_pitch, so that the circular
    autocorrelation is alias-free up to the lowest pitch. r(τ)/r(0) of a
    windowed frame is divided by the window's own autocorrelation ratio
    (Boersma), floored at its value at half the window."""
    n_fft = 2 * (power.shape[-1] - 1)
    max_lag = int(sr / min_pitch)
    r = autocorr_via_power(power, n_fft, max_lag + 1)
    r0 = torch.clamp(r[..., :1], min=1e-30)
    band = r[..., 2:] / r0
    W = win_len if win_len else int(round(0.025 * sr))
    w = hamming_window(W)
    rw = np.correlate(w, w, "full")[W - 1:]
    rw_ratio = rw / rw[0]
    lags = np.minimum(np.arange(2, max_lag + 1), W - 1)
    div = np.maximum(rw_ratio[lags], rw_ratio[W // 2]).astype(np.float32)
    band = band / table(div, band)
    return torch.clamp(band.amax(dim=-1), 0.0, 1.0)


def _viterbi_state_inputs(freqs: torch.Tensor, scores: torch.Tensor, voicing: torch.Tensor,
                          params: ShsParams):
    """Candidate-state costs for the path finder, per file of (B, T, C).

    States: the C voiced candidates and one unvoiced state. Local cost:
    wLocal·(1−score) plus wRange·|log2(f/centre)| for voiced states (1e6
    for a missing candidate), wThr·(voicing−cutoff) for the unvoiced one.
    The range centre is the geometric-mean top candidate over each file's
    confidently voiced frames; with no such frame the range cost is off.
    Returns (local, states_f, is_voiced), each (B, T, C+1).
    """
    top = freqs[..., 0]
    confident = ((voicing > params.voicing_cutoff) & (top > 0)).to(freqs.dtype)
    n_confident = confident.sum(-1, keepdim=True)
    center = torch.exp(
        torch.sum(torch.log(torch.clamp(top, min=1.0)) * confident, dim=-1, keepdim=True)
        / torch.clamp(n_confident, min=1)
    )[..., None]

    voiced_local = params.w_local * (1.0 - scores)
    range_cost = params.w_range * torch.abs(
        torch.log2(torch.clamp(freqs, min=1.0) / torch.clamp(center, min=1.0)))
    range_cost = torch.where(n_confident[..., None] > 0, range_cost, 0.0)
    voiced_local = voiced_local + torch.where(freqs > 0, range_cost, 1e6)
    unvoiced_local = params.w_thr * (voicing - params.voicing_cutoff)

    local = torch.cat([voiced_local, unvoiced_local[..., None]], dim=-1)
    safe_f = torch.where(freqs > 0, freqs, 1.0)
    states_f = torch.cat([safe_f, torch.ones_like(safe_f[..., :1])], dim=-1)
    is_voiced = torch.cat([freqs > 0, torch.zeros_like(freqs[..., :1], dtype=torch.bool)], dim=-1)
    return local, states_f, is_voiced


def shs_pitch_batch(
    mag: torch.Tensor,
    sr: float,
    frame_rms: torch.Tensor,
    params: ShsParams = ShsParams(),
    energy_threshold: float = 0.001,
    win_len: int = 0,
    voicing_power: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole chain on (B, T, F) magnitude spectra and (B, T) frame RMS:
    octave scale → SHS candidates → state costs → path (K7 on CUDA tensors)
    → energy gate. ``voicing_power`` is an optional (B, T, F') power
    spectrum from a wide transform for alias-free voicing (defaults to
    mag²). Returns (F0final, voicingFinalUnclipped), each (B, T), on
    ``mag``'s device."""
    n_points = mag.shape[-1]
    log_min, dlog = octave_grid(float(sr), float(params.min_f_scale), n_points)
    s_oct = octave_scale_spectrum(mag, float(sr), float(params.min_f_scale), n_points)
    freqs, scores = shs_candidates(
        s_oct, log_min, dlog, params.n_harmonics, params.compression,
        params.n_candidates, (params.min_pitch, params.max_pitch),
    )
    vp = mag * mag if voicing_power is None else voicing_power
    voicing = _voicing_from_power(vp, float(sr), float(params.min_pitch), win_len)
    local, states_f, is_voiced = _viterbi_state_inputs(freqs, scores, voicing, params)

    c = freqs.shape[-1]  # voiced candidate count
    if local.shape[1] == 1:
        path = torch.argmin(local[:, 0], dim=-1)[:, None]
    else:
        path = viterbi_path(
            torch.log2(states_f), is_voiced.to(torch.float32), local.to(torch.float32),
            float(params.w_tvv), float(params.w_tuu), float(params.w_tvuv),
        )
    picked = torch.gather(states_f, -1, torch.clamp(path, 0, c - 1)[..., None])[..., 0]
    f0 = torch.where(path < c, picked, 0.0)
    # cValbasedSelector zeroVec=1: the gate zeroes voicing too
    gate = frame_rms >= energy_threshold
    return torch.where(gate, f0, 0.0), torch.where(gate, voicing, 0.0)
