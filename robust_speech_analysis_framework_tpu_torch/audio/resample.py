"""Rational-ratio polyphase resampling: on any device, and on the host.

Counterpart of ``robust_speech_analysis_framework_tpu/audio/resample.py``'s
polyphase half: a Kaiser-windowed sinc low-pass (``design_lowpass``,
aligned by ``_aligned_filter`` like ``scipy.signal.resample_poly``), applied
by :func:`resample_poly` as one strided ``conv1d`` over the zero-stuffed
signal on the tensor's device, and by :func:`resample_poly_np` in numpy
float64 on the host.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..device import fp32_convs


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db > 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


@lru_cache(maxsize=64)
def design_lowpass(up: int, down: int, half_width: int = 10, atten_db: float = 70.0):
    """Kaiser-windowed sinc low-pass for a rational resampler.

    Cutoff at ``min(1/up, 1/down)`` of the intermediate Nyquist; the filter is
    scaled by ``up`` so passband gain is unity after zero-stuffing. Returns a
    float64 NumPy array of odd length ``2*half_width*max(up,down)+1``.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    max_rate = max(up, down)
    cutoff = 1.0 / (2.0 * max_rate)  # in units of the intermediate rate
    n_half = half_width * max_rate
    n = np.arange(-n_half, n_half + 1, dtype=np.float64)
    kernel = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    beta = _kaiser_beta(atten_db)
    window = np.kaiser(len(n), beta)
    h = kernel * window
    return (h * up).astype(np.float64)


def _aligned_filter(up: int, down: int, half_width: int):
    """Low-pass filter pre-padded so the group delay is a multiple of `down`.

    Prepending zeros shifts the filter's center onto a down-sampling phase
    boundary, so output sample k of the strided conv sits exactly at time
    k*down/up of the input grid (same alignment trick as scipy's
    resample_poly).
    """
    h = design_lowpass(up, down, half_width)
    half_len = (len(h) - 1) // 2
    n_pre_pad = (-half_len) % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    return h, n_pre_remove


def _upfirdn_conv(x: torch.Tensor, h: np.ndarray, up: int, down: int) -> torch.Tensor:
    """upfirdn(h, x, up, down) of ``x`` (..., T) as one convolution: the
    zero-stuffed signal correlated with the flipped filter at stride
    ``down``, zero-padded by len(h) − 1 on both sides (the full
    convolution, sampled from phase 0)."""
    batch_shape, t = x.shape[:-1], x.shape[-1]
    stuffed = x.new_zeros(int(np.prod(batch_shape, dtype=np.int64)), 1, (t - 1) * up + 1)
    stuffed[:, 0, ::up] = x.reshape(-1, t)
    rhs = torch.from_numpy(np.ascontiguousarray(h[::-1])).to(x).reshape(1, 1, -1)
    with fp32_convs():
        out = torch.nn.functional.conv1d(stuffed, rhs, stride=down, padding=len(h) - 1)
    n_keep = -(-((t - 1) * up + len(h)) // down)
    return out[..., :n_keep].reshape(*batch_shape, -1)


def resample_poly(x: torch.Tensor, up: int, down: int, half_width: int = 10) -> torch.Tensor:
    """Polyphase resample ``x`` (..., T) by rational factor up/down on its
    device; output length ``ceil(T * up / down)``."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    h, n_pre_remove = _aligned_filter(up, down, half_width)
    n_out = -(-x.shape[-1] * up // down)
    full = _upfirdn_conv(x, h, up, down)
    pad_needed = n_pre_remove + n_out - full.shape[-1]
    if pad_needed > 0:
        full = torch.nn.functional.pad(full, (0, pad_needed))
    return full[..., n_pre_remove : n_pre_remove + n_out]


def resample_poly_np(x: np.ndarray, up: int, down: int, half_width: int = 10) -> np.ndarray:
    """Polyphase resample ``x`` (..., T) by rational factor up/down.

    Output length is ``ceil(T * up / down)``.
    """
    x = np.asarray(x)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return x
    h, n_pre_remove = _aligned_filter(up, down, half_width)
    t = x.shape[-1]
    stuffed = np.zeros(x.shape[:-1] + (t * up,), dtype=np.float64)
    stuffed[..., ::up] = x
    full = np.apply_along_axis(lambda v: np.convolve(v, h, mode="full"), -1, stuffed)
    n_out = -(-t * up // down)
    picked = full[..., ::down][..., n_pre_remove : n_pre_remove + n_out]
    if picked.shape[-1] < n_out:
        picked = np.pad(picked, [(0, 0)] * (picked.ndim - 1) + [(0, n_out - picked.shape[-1])])
    dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    return picked.astype(dtype)
