"""Frame-level LLDs: the 16 spectral descriptors (openSMILE ``cSpectral``),
zero-crossing rate, RMS energy, intensity and loudness.

The spectral bank of the Androids configuration (Androids.conf:258-280):
relative band energies 250-650 / 1000-4000 Hz, roll-off points at
25/50/75/90 %, flux, centroid, entropy, variance, skewness, kurtosis, slope,
sharpness, harmonicity, flatness, all from the framed magnitude spectrum and
batched over every leading axis. Energy quantities use the squared
magnitude; the moments treat the normalised power spectrum as a
distribution over Hz; sharpness is the Bark-weighted centroid; harmonicity
is the mean peak-to-valley contrast of the magnitude; flatness is the
geometric over the arithmetic mean of the power.
"""

from __future__ import annotations

from typing import List

import torch

from .prefix_sum import cumsum

SPECTRAL_NAMES: List[str] = [
    "fftMag_spectralEnergyInBand250-650",
    "fftMag_spectralEnergyInBand1000-4000",
    "fftMag_spectralRollOff25.0",
    "fftMag_spectralRollOff50.0",
    "fftMag_spectralRollOff75.0",
    "fftMag_spectralRollOff90.0",
    "fftMag_spectralFlux",
    "fftMag_spectralCentroid",
    "fftMag_spectralEntropy",
    "fftMag_spectralVariance",
    "fftMag_spectralSkewness",
    "fftMag_spectralKurtosis",
    "fftMag_spectralSlope",
    "fftMag_spectralSharpness",
    "fftMag_spectralHarmonicity",
    "fftMag_spectralFlatness",
]


def _hz_to_bark(f: torch.Tensor) -> torch.Tensor:
    return 13.0 * torch.atan(0.00076 * f) + 3.5 * torch.atan((f / 7500.0) ** 2)


def spectral_llds(mag: torch.Tensor, sr: float) -> torch.Tensor:
    """All 16 descriptors: mag (..., T, F) magnitude spectrum → (..., T, 16)."""
    n_bins = mag.shape[-1]
    freqs = torch.arange(n_bins, device=mag.device, dtype=mag.dtype) * (sr / 2.0) / (n_bins - 1)
    power = mag * mag
    total_p = torch.clamp(power.sum(-1, keepdim=True), min=1e-30)

    def band_energy(lo, hi):
        m = ((freqs >= lo) & (freqs < hi)).to(mag.dtype)
        return (power * m).sum(-1) / total_p[..., 0]

    band1 = band_energy(250.0, 650.0)
    band2 = band_energy(1000.0, 4000.0)

    csum = cumsum(power, dim=-1) / total_p
    # the first bin whose cumulative share reaches q (bin 0 if none does)
    roll = [freqs[torch.argmax((csum >= q).to(torch.uint8), dim=-1)]
            for q in (0.25, 0.50, 0.75, 0.90)]

    # flux: L2 difference of energy-normalised magnitude spectra, 0 at frame 0
    norm_mag = mag / torch.clamp(torch.sqrt((mag * mag).sum(-1, keepdim=True)), min=1e-30)
    diff = norm_mag[..., 1:, :] - norm_mag[..., :-1, :]
    flux_tail = torch.sqrt((diff * diff).sum(-1))
    flux = torch.cat([flux_tail[..., :1] * 0.0, flux_tail], dim=-1)

    p_norm = power / total_p
    centroid = (p_norm * freqs).sum(-1)
    entropy = -(p_norm * torch.log(torch.clamp(p_norm, min=1e-30))).sum(-1)
    d = freqs - centroid[..., None]
    variance = (p_norm * d * d).sum(-1)
    # the 1e-6 floor keeps std³ and variance² normal in float32, so exactly
    # silent frames give moments 0 rather than 0/0
    var_f = torch.clamp(variance, min=1e-6)
    std = torch.sqrt(var_f)
    skew = (p_norm * d**3).sum(-1) / (var_f * std)
    kurt = (p_norm * d**4).sum(-1) / (var_f * var_f)

    f_mean = freqs.mean()
    f_var = torch.mean((freqs - f_mean) ** 2)
    slope = ((mag - mag.mean(-1, keepdim=True)) * (freqs - f_mean)).mean(-1) / torch.clamp(
        f_var, min=1e-30)

    bark = _hz_to_bark(freqs)
    g = torch.where(bark < 15.8, torch.ones_like(bark), 0.15 * torch.exp(0.42 * (bark - 15.8)) + 0.85)
    sharp_num = (p_norm * g * bark).sum(-1)
    sharp_den = torch.clamp(p_norm.sum(-1), min=1e-30)
    sharpness = 0.11 * sharp_num / sharp_den

    prev = torch.cat([mag[..., :1], mag[..., :-1]], dim=-1)
    nxt = torch.cat([mag[..., 1:], mag[..., -1:]], dim=-1)
    is_peak = ((mag > prev) & (mag > nxt)).to(mag.dtype)
    is_valley = ((mag < prev) & (mag < nxt)).to(mag.dtype)
    peak_mean = (mag * is_peak).sum(-1) / torch.clamp(is_peak.sum(-1), min=1)
    valley_mean = (mag * is_valley).sum(-1) / torch.clamp(is_valley.sum(-1), min=1)
    harmonicity = peak_mean - valley_mean

    log_p = torch.log(torch.clamp(power, min=1e-30))
    flatness = torch.exp(log_p.mean(-1)) / torch.clamp(power.mean(-1), min=1e-30)

    return torch.stack(
        [band1, band2, *roll, flux, centroid, entropy, variance, skew, kurt,
         slope, sharpness, harmonicity, flatness],
        dim=-1,
    )


def zero_crossing_rate(frames: torch.Tensor) -> torch.Tensor:
    """cMZcr: sign changes per frame over the frame length, on the raw
    pre-window frames (Androids.conf:125-132)."""
    s = torch.sign(frames)
    changes = (s[..., 1:] * s[..., :-1] < 0).sum(-1)
    # times the reciprocal, as XLA compiles the JAX package's division by
    # the constant frame length: 18 · (1/400) is 0.044999998, not 0.045,
    # and the zcr contour's ties (its minPos/maxPos) must fall alike
    return changes.to(frames.dtype) * (1.0 / frames.shape[-1])


def rms_energy(win_frames: torch.Tensor) -> torch.Tensor:
    """cEnergy rms=1 log=0 on windowed frames."""
    return torch.sqrt(torch.mean(win_frames * win_frames, dim=-1))


def intensity_loudness(win_frames: torch.Tensor) -> torch.Tensor:
    """cIntensity: frame power I and loudness (I/I0)^0.3, I0 = 1e-6."""
    intensity = torch.mean(win_frames * win_frames, dim=-1)
    loudness = (intensity / 1.0e-6) ** 0.3
    return torch.stack([intensity, loudness], dim=-1)
