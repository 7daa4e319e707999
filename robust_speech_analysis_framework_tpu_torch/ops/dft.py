"""Spectral transforms on ``torch.fft`` (cuFFT on the card): power and
magnitude spectra, autocorrelation (Wiener–Khinchin) and cross-correlation.

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


def autocorr(x: torch.Tensor, n_fft: int, n_lags: int) -> torch.Tensor:
    """r(τ), τ ∈ [0, n_lags), of the (zero-padded) signal along the last axis."""
    return autocorr_via_power(rfft_power(x, n_fft), n_fft, n_lags)


def cross_corr(base: torch.Tensor, ext: torch.Tensor, n_fft: int, n_lags: int) -> torch.Tensor:
    """corr(τ) = Σ_t base[t]·ext[t+τ] for τ ∈ [0, n_lags) along the last axis
    (both zero-padded to n_fft ≥ len(ext) + len(base), so no lag in the band
    wraps around)."""
    fb = torch.fft.rfft(base, n_fft)
    fe = torch.fft.rfft(ext, n_fft)
    return torch.fft.irfft(fb.conj() * fe, n_fft)[..., :n_lags]
