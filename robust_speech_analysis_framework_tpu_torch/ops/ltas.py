"""Long-term average spectrum, pitch-corrected (Praat ``To Ltas
(pitch-corrected)...``), with the slope and tilt statistics the MSHDS
extractor reads from it.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/ltas.py``. For
every interior pulse whose left and right periods both lie within
[shortest, longest] and whose ratio is at most max_period_factor, the
stretch [t − left/2, t + right/2] is Fourier-analyzed; each spectrum bin's
energy |X|²·2·df goes to band ceil(f/bandwidth) (f = 0 and bins above the
maximum frequency are dropped), and the band's count of contributing bins
goes up by one. A band's level is 10·log10(energy / count · duration /
4e-10). As in the JAX package, each period's spectrum is sampled on a
zero-padded power-of-two grid (not its exact-length DFT grid), so one FFT
size serves a group of periods.

On a corpus buffer each FFT-size group is one device pass: gather, power
spectrum, a product with the 0/1 band matrix, and a per-file sum, queued
without a synchronisation and fetched once for all groups. The per-file sum
is a product with a one-hot file matrix (files are few), which adds in the
same order on every run, where ``index_add_`` on CUDA adds atomically in
an order that changes from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bucketing import pad_frames
from .cepstrum import _robust_line_fit
from .dft import rfft_power
from .framing import Deferred, gather_frames


def _ltas_group_device(x_cat: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                       file_ids: torch.Tensor, bin_mat: torch.Tensor, l_max: int, n_fft: int,
                       n_files: int) -> torch.Tensor:
    """One FFT-size group on the device: each period's samples (zero beyond
    its own length), power spectra, the band product (``bin_mat`` carries
    the 2/(n_fft·sr) energy scale and the in-band selection), and the sum
    per file: (n_files, n_bins)."""
    fr = gather_frames(x_cat, starts, l_max)
    fr = fr * (torch.arange(l_max, device=fr.device)[None, :] < lens[:, None])
    binned = torch.matmul(rfft_power(fr, n_fft), bin_mat)
    one_hot = (file_ids[None, :] == torch.arange(n_files, device=fr.device)[:, None])
    return torch.matmul(one_hot.to(binned.dtype), binned)


def _praat_bands(f_bins: np.ndarray, bandwidth: float, n_bins: int):
    """(band index, in range) of each spectrum bin frequency. Praat's band
    is ceil(f / bandwidth) (1-based): f = 0 is dropped, and bins above the
    top band are dropped, not clipped onto it (that would fold 5–8 kHz into
    the 4950 Hz band). Dropped bins get index 0 and ``in_range`` False."""
    bin_raw = np.ceil(f_bins / bandwidth).astype(int) - 1  # 0-based
    in_range = (bin_raw >= 0) & (bin_raw < n_bins)
    return np.clip(bin_raw, 0, n_bins - 1), in_range


class Ltas(NamedTuple):
    freqs: np.ndarray  # band centres (Hz)
    power_db: np.ndarray

    def band_energy_db(self, f1: float, f2: float) -> float:
        mask = (self.freqs >= f1) & (self.freqs < f2) & np.isfinite(self.power_db)
        if not mask.any():
            return float("nan")
        p = np.power(10.0, self.power_db[mask] / 10.0)
        return float(10.0 * np.log10(np.mean(p)))

    def slope_db(self, lo1: float, hi1: float, lo2: float, hi2: float) -> float:
        """Praat 'Get slope: lo1, hi1, lo2, hi2, dB': low-band energy minus
        high-band energy, in dB."""
        return self.band_energy_db(lo1, hi1) - self.band_energy_db(lo2, hi2)

    def spectral_tilt(self, fmin: float, fmax: float) -> float:
        """Robust straight-line fit of dB over [fmin, fmax]: the slope in
        dB/Hz ('Report spectral tilt ... Robust')."""
        mask = (self.freqs >= fmin) & (self.freqs <= fmax) & np.isfinite(self.power_db)
        if mask.sum() < 3:
            return float("nan")
        slope, _ = _robust_line_fit(self.freqs[mask], self.power_db[None, mask])
        return float(slope[0])


def ltas_pitch_corrected(x: np.ndarray, sr: float, pulses: np.ndarray,
                         max_frequency: float = 5000.0, bandwidth: float = 100.0,
                         shortest_period: float = 1e-4, longest_period: float = 0.02,
                         max_period_factor: float = 1.3) -> Ltas:
    """One file's pitch-corrected LTAS on the host."""
    return ltas_pitch_corrected_batch([x], sr, [pulses], max_frequency, bandwidth,
                                      shortest_period, longest_period, max_period_factor)[0]


def ltas_pitch_corrected_batch(xs, sr: float, pulses_list, max_frequency: float = 5000.0,
                               bandwidth: float = 100.0, shortest_period: float = 1e-4,
                               longest_period: float = 0.02, max_period_factor: float = 1.3,
                               buf=None, defer: bool = False):
    """Pitch-corrected LTAS of many files (a list of Ltas, or a ``Deferred``
    of it). The periods are chosen per file on the host and grouped by FFT
    size; each group runs on ``buf``'s device when a corpus buffer is given,
    and in numpy float64 on the host without one (the oracle)."""
    n_bins = int(round(max_frequency / bandwidth))
    freqs_out = (np.arange(n_bins) + 0.5) * bandwidth

    file_ids, seg_a, seg_len = [], [], []
    if buf is not None:
        xs = buf.xs
    xs = [np.asarray(x, dtype=np.float64).reshape(-1) for x in xs]
    for fi, (x, pulses) in enumerate(zip(xs, pulses_list)):
        pulses = np.asarray(pulses, dtype=np.float64).reshape(-1)
        if len(pulses) < 3:
            continue
        # interior pulses: [t − left/2, t + right/2] when both periods are in
        # range and their ratio is small (Praat PointProcess_Sound_to_Ltas)
        t_mid = pulses[1:-1]
        left = pulses[1:-1] - pulses[:-2]
        right = pulses[2:] - pulses[1:-1]
        with np.errstate(invalid="ignore", divide="ignore"):
            factor = np.maximum(left / right, right / left)
        ok = ((left >= shortest_period) & (left <= longest_period)
              & (right >= shortest_period) & (right <= longest_period)
              & (factor <= max_period_factor))
        a = np.round((t_mid - 0.5 * left) * sr).astype(int)
        b = np.round((t_mid + 0.5 * right) * sr).astype(int)
        ok &= (a >= 0) & (b > a + 2) & (b <= len(x))
        if not ok.any():
            continue
        file_ids.append(np.full(int(ok.sum()), fi))
        seg_a.append(a[ok])
        seg_len.append((b - a)[ok])

    accum = np.zeros((len(xs), n_bins))
    counts = np.zeros((len(xs), n_bins))  # contributing bins per band
    device_parts = []
    if file_ids:
        file_ids = np.concatenate(file_ids)
        seg_a = np.concatenate(seg_a)
        seg_len = np.concatenate(seg_len)
        n_ffts = np.power(2, np.ceil(np.log2(np.maximum(seg_len * 4, 64))).astype(int))
        for n_fft in np.unique(n_ffts):
            sel = n_ffts == n_fft
            fids, aa, ll = file_ids[sel], seg_a[sel], seg_len[sel]
            f_bins = np.arange(int(n_fft) // 2 + 1) * sr / n_fft
            bin_idx, in_range = _praat_bands(f_bins, bandwidth, n_bins)
            # energy per bin = |X·dt|²·2·df: scale 2/(n_fft·sr)
            scale = 2.0 / (int(n_fft) * sr)
            colsum = np.zeros(n_bins)
            np.add.at(colsum, bin_idx[in_range], 1.0)
            np.add.at(counts, fids, colsum[None, :])
            if buf is not None:
                dev = buf.x_cat.device
                l_max = int(n_fft) // 4  # pow2ceil(4·len) ⇒ len ≤ n_fft/4
                if l_max > buf.pad:
                    raise ValueError(f"corpus buffer pad {buf.pad} < period window {l_max}")
                starts_p, n_real = pad_frames((aa + buf.offsets[fids]).astype(np.int64)[:, None])
                lens_p, _ = pad_frames(ll.astype(np.int64)[:, None])
                fids_p, _ = pad_frames(fids.astype(np.int64)[:, None])
                lens_p = lens_p.copy()
                lens_p[n_real:] = 0  # padded rows contribute zero spectra
                bin_mat = np.zeros((len(f_bins), n_bins), np.float32)
                bin_mat[np.arange(len(f_bins))[in_range], bin_idx[in_range]] = scale
                device_parts.append(_ltas_group_device(
                    buf.x_cat, torch.from_numpy(starts_p[:, 0]).to(dev),
                    torch.from_numpy(lens_p[:, 0]).to(dev), torch.from_numpy(fids_p[:, 0]).to(dev),
                    torch.from_numpy(bin_mat).to(dev), l_max, int(n_fft), len(xs)))
                continue
            l_max = int(ll.max())
            gat = np.arange(l_max)[None, :]
            mat = np.zeros((len(aa), l_max))
            for fi in np.unique(fids):
                rows = fids == fi
                mat[rows] = np.take(xs[fi], np.minimum(aa[rows, None] + gat, len(xs[fi]) - 1))
            mat *= gat < ll[:, None]
            spec = np.abs(np.fft.rfft(mat, int(n_fft), axis=1)) ** 2 * scale
            spec *= in_range[None, :]
            flat_idx = (fids[:, None] * n_bins + bin_idx[None, :]).ravel()
            np.add.at(accum.ravel(), flat_idx, spec.ravel())

    total = None
    for part in device_parts:
        total = part if total is None else total + part
    n_files_out = len(xs)
    durations = np.asarray([len(x) / sr for x in xs])

    def _finalize(total_host):
        acc = accum if total_host is None else accum + np.asarray(total_host, dtype=np.float64)
        out = []
        for fi in range(n_files_out):
            with np.errstate(divide="ignore", invalid="ignore"):
                # Praat: 10·log10(energy / count · duration / 4e-10); bands no
                # period touched are undefined (NaN)
                level = acc[fi] / counts[fi] * durations[fi] / 4.0e-10
            power_db = np.where(counts[fi] > 0, 10.0 * np.log10(np.maximum(level, 1e-300)),
                                np.nan)
            out.append(Ltas(freqs_out, power_db))
        return out

    d = Deferred(total, _finalize)
    return d if defer else d.result()
