"""Spectral transforms on ``torch.fft`` (cuFFT on the card).

The JAX package also ran these as matrix products over a cos/sin basis,
for TPUs without an FFT operation; the port needs no such path.
"""

from __future__ import annotations

from typing import Optional

import torch


def rfft_power(x: torch.Tensor, n_fft: Optional[int] = None) -> torch.Tensor:
    """|rfft(x, n_fft)|² along the last axis."""
    spec = torch.fft.rfft(x, n_fft or x.shape[-1])
    return spec.real * spec.real + spec.imag * spec.imag


def rfft_mag(x: torch.Tensor, n_fft: Optional[int] = None) -> torch.Tensor:
    """|rfft(x, n_fft)| along the last axis."""
    return torch.fft.rfft(x, n_fft or x.shape[-1]).abs()


def autocorr_via_power(power: torch.Tensor, n_fft: int, n_lags: int) -> torch.Tensor:
    """Circular autocorrelation r(τ), τ ∈ [0, n_lags), from an rfft power
    spectrum of length n_fft//2+1 (Wiener–Khinchin)."""
    return torch.fft.irfft(power, n_fft)[..., :n_lags]
