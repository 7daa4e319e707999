"""Framed STFT → mel → MFCC front end of the openSMILE extractor.

Androids.conf:71-113: cFramer 25 ms / 10 ms, per-frame preemphasis k=0.97,
Hamming window, FFT magnitude, HTK mel filterbank (26 bands, 20-8000 Hz),
MFCC 1-12. Every stage is a batched torch op over ``(..., N)`` signals:
framing is ``Tensor.unfold``, the filterbank and the DCT are matrix
products. The tables (windows, filterbank, DCT, lifter) are computed on the
host in float64, as in the JAX package, and cast to the signal's dtype when
they are applied, so the card computes in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..ops.framing import upload


def num_frames(n_samples: int, frame_len: int, hop: int) -> int:
    """Number of complete frames in a signal of ``n_samples``."""
    if n_samples < frame_len:
        return 0
    return 1 + (n_samples - frame_len) // hop


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """(..., N) → overlapping frames (..., n_frames, frame_len); frame i
    covers samples [i·hop, i·hop + frame_len), the tail that fills no frame
    is dropped (openSMILE/HTK convention). A view of ``x``."""
    return x.unfold(-1, frame_len, hop)


def table(array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host table on ``like``'s device, in ``like``'s dtype (never float64
    on the card), uploaded without waiting for the kernels queued there
    (:func:`..ops.framing.upload`)."""
    return upload(torch.as_tensor(array).to(dtype=like.dtype), like.device)


@lru_cache(maxsize=32)
def hamming_window(n: int, periodic: bool = False) -> np.ndarray:
    m = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / m)


def preemphasize(frames: torch.Tensor, k: float = 0.97) -> torch.Tensor:
    """Per-frame preemphasis y[t] = x[t] − k·x[t−1], the first sample
    differenced against itself (cVectorPreemphasis, Androids.conf:78-81)."""
    shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    return frames - k * shifted


def stft_magnitude(frames: torch.Tensor, n_fft: Optional[int] = None) -> torch.Tensor:
    """Magnitude spectrum of windowed frames (..., n_frames, n_fft//2+1);
    ``n_fft`` defaults to the next power of two of the frame length."""
    from ..ops.dft import rfft_mag

    return rfft_mag(frames, n_fft or _next_pow2(frames.shape[-1]))


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@lru_cache(maxsize=16)
def mel_filterbank(
    n_mels: int, n_fft: int, sr: int, fmin: float = 20.0, fmax: float = 8000.0
) -> np.ndarray:
    """HTK triangular mel filterbank (n_fft//2+1, n_mels): centres equally
    spaced in mel, weights linear in mel, each filter peaking at 1
    (Androids.conf:99-105)."""
    n_bins = n_fft // 2 + 1
    fft_mels = hz_to_mel(np.arange(n_bins, dtype=np.float64) * sr / n_fft)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (fft_mels - lo) / max(ctr - lo, 1e-12)
        down = (hi - fft_mels) / max(hi - ctr, 1e-12)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@lru_cache(maxsize=16)
def _dct_matrix(n_out: int, n_in: int, first: int = 1) -> np.ndarray:
    """HTK DCT-II rows ``first..first+n_out-1``, shape (n_in, n_out)."""
    j = np.arange(n_in, dtype=np.float64)
    rows = [np.cos(np.pi * i / n_in * (j + 0.5)) for i in range(first, first + n_out)]
    return np.stack(rows, axis=1) * math.sqrt(2.0 / n_in)


@lru_cache(maxsize=16)
def _lifter(n_ceps: int, l: int = 22, first: int = 1) -> np.ndarray:
    i = np.arange(first, first + n_ceps, dtype=np.float64)
    return 1.0 + (l / 2.0) * np.sin(np.pi * i / l)


def mfcc_from_power(
    power: torch.Tensor,
    filterbank: np.ndarray,
    n_ceps: int = 12,
    first_cep: int = 1,
    cep_lifter: int = 22,
    floor: float = 1e-10,
    use_power: bool = False,
    spec_is_power: bool = True,
) -> torch.Tensor:
    """MFCCs from a power (or, with ``spec_is_power=False``, magnitude)
    spectrum. ``use_power=False`` feeds the filterbank the magnitude
    (cMelspec usePower=0); log energies, then HTK DCT-II rows
    ``first_cep..first_cep+n_ceps-1`` with sinusoidal liftering L=22."""
    if use_power == spec_is_power:
        spec = power
    elif use_power:
        spec = power * power
    else:
        spec = torch.sqrt(torch.clamp(power, min=0.0))
    mel_e = torch.clamp(spec @ table(filterbank, spec), min=floor)
    ceps = torch.log(mel_e) @ table(_dct_matrix(n_ceps, filterbank.shape[1], first_cep), spec)
    if cep_lifter:
        ceps = ceps * table(_lifter(n_ceps, cep_lifter, first_cep), spec)
    return ceps


@dataclass(frozen=True)
class FrontendConfig:
    """Frame geometry and spectral settings."""

    sample_rate: int = 16000
    frame_seconds: float = 0.025
    hop_seconds: float = 0.010
    preemphasis: float = 0.97
    n_fft: Optional[int] = None
    n_mels: int = 26
    fmin: float = 20.0
    fmax: float = 8000.0

    @property
    def frame_len(self) -> int:
        return int(round(self.frame_seconds * self.sample_rate))

    @property
    def hop(self) -> int:
        return int(round(self.hop_seconds * self.sample_rate))

    @property
    def fft_size(self) -> int:
        return self.n_fft or _next_pow2(self.frame_len)
