"""Formant estimation by Burg's method (Praat ``To Formant (burg)...``),
corpus-batched.

Counterpart of ``robust_speech_analysis_framework_tpu/ops/formants.py``
(step 5 ms, 5 formants up to 5 kHz, window 25 ms, preemphasis from 50 Hz):

1. resample to 2·max_formant and preemphasize (on the device, for a corpus:
   ``ops.framing.resample_buffer``);
2. Praat's Gaussian-like windows of twice the nominal length on its grid;
3. Burg AR(2·n_formants) coefficients of every frame at once
   (:func:`burg_coeffs`, a loop over the model order);
4. the polynomial's roots by Durand–Kerner iteration in complex64
   (:func:`durand_kerner_roots`), every frame at once. Not
   ``torch.linalg.eigvals``: it returns other roots in another order and
   rounding, and on CUDA it waits for the host;
5. roots → (frequency, bandwidth), kept inside (50 Hz, max_formant − 50),
   sorted, on the device, so only (2, frames, n_formants) floats come back.

:class:`FormantTrack` interpolates a track at arbitrary times, as the MSHDS
extractor samples it at glottal pulses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..audio.resample import resample_poly_np
from ..device import DeviceLike, resolve_device
from .bucketing import pad_frames
from .framing import Deferred, gather_frames
from .pitch import praat_frame_grid
from .spectral import praat_gaussian_window


def burg_coeffs(frames: torch.Tensor, order: int) -> torch.Tensor:
    """Burg AR coefficients of every row: (N, L) → (N, order), for the
    model x[t] ≈ −Σ a[k]·x[t−1−k] (the polynomial 1 + Σ a_k z^-k). Runs in
    the frames' dtype."""
    n, length = frames.shape
    ef = eb = frames
    a = frames.new_zeros(n, order)
    idx = torch.arange(length, device=frames.device)
    for m in range(order):
        # forward errors valid at t ∈ [m+1, L), backward at [m, L−1);
        # the roll wraps around as the JAX package's does, masked here
        mask = (idx >= m + 1).to(ef.dtype)
        ef_s = ef * mask
        eb_roll = torch.roll(eb, 1, dims=1)  # eb[t−1] aligned to t
        eb_prev = eb_roll * mask
        num = -2.0 * (ef_s * eb_prev).sum(dim=1)
        den = (ef_s * ef_s).sum(dim=1) + (eb_prev * eb_prev).sum(dim=1)
        k = num / torch.clamp(den, min=1e-30)
        ef, eb = ef + k[:, None] * eb_roll, eb_roll + k[:, None] * ef
        # Levinson: a_new[j] = a[j] + k·a[m−1−j] for j < m; a_new[m] = k
        a_new = a.clone()
        a_new[:, :m] = a[:, :m] + k[:, None] * a[:, :m].flip(1)
        a_new[:, m] = k
        a = a_new
    return a


def durand_kerner_roots(coeffs: torch.Tensor, iters: int = 60):
    """Roots of the monic polynomials z^m + c1 z^(m−1) + … + cm, one a row.

    ``coeffs`` (N, m) in descending powers without the leading 1. Returns
    (real, imag), each (N, m): ``iters`` Durand–Kerner steps in complex64
    from a ring of radius 0.9 at angles 2π(k + 0.35)/m, Horner's rule for
    p(z), and a 1e-20 floor on the product of differences.
    """
    n, m = coeffs.shape
    dev = coeffs.device
    angles = 2.0 * np.pi * (np.arange(m) + 0.35) / m
    z0 = torch.from_numpy((0.9 * np.exp(1j * angles)).astype(np.complex64)).to(dev)
    z = z0[None, :].expand(n, m)
    full = torch.cat([torch.ones(n, 1, dtype=torch.complex64, device=dev),
                      coeffs.to(torch.complex64)], dim=1)  # (N, m+1)
    eye = torch.eye(m, dtype=torch.bool, device=dev)[None]
    one = torch.ones((), dtype=torch.complex64, device=dev)
    floor = torch.full((), 1e-20, dtype=torch.complex64, device=dev)
    for _ in range(iters):
        p = torch.zeros_like(z)
        for j in range(m + 1):
            p = p * z + full[:, j : j + 1]
        denom = torch.where(eye, one, z[:, :, None] - z[:, None, :]).prod(dim=2)
        z = z - p / torch.where(denom.abs() < 1e-20, floor, denom)
    return z.real, z.imag


class FormantTrack(NamedTuple):
    times: np.ndarray  # (N,)
    freqs: np.ndarray  # (N, n_formants) Hz, NaN where absent
    bands: np.ndarray  # (N, n_formants) Hz bandwidths, NaN where absent

    def _interp(self, grid: np.ndarray, t) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        dt = self.times[1] - self.times[0] if len(self.times) > 1 else 1.0
        pos = (t - self.times[0]) / dt
        i0 = np.clip(np.floor(pos).astype(int), 0, len(self.times) - 1)
        i1 = np.clip(i0 + 1, 0, len(self.times) - 1)
        w = np.clip(pos - i0, 0.0, 1.0)[:, None]
        vals = (1 - w) * grid[i0] + w * grid[i1]
        out = (t < self.times[0] - dt / 2) | (t > self.times[-1] + dt / 2)
        vals[out] = np.nan
        return vals

    def value_at(self, formant_number: int, t) -> np.ndarray:
        v = self._interp(self.freqs, t)[:, formant_number - 1]
        return v if v.shape != (1,) else float(v[0])

    def bandwidth_at(self, formant_number: int, t) -> np.ndarray:
        v = self._interp(self.bands, t)[:, formant_number - 1]
        return v if v.shape != (1,) else float(v[0])


def _roots_to_formants(roots_re: np.ndarray, roots_im: np.ndarray, sr: float,
                       max_formant_hz: float, n_keep: int):
    """Roots → (formant frequency, bandwidth) on the host: valid
    upper-half-plane roots inside (50 Hz, max − 50 Hz), sorted ascending per
    frame, the first ``n_keep`` kept, NaN elsewhere."""
    freq = np.abs(np.arctan2(roots_im, roots_re)) * sr / (2 * np.pi)
    mag_r = np.hypot(roots_re, roots_im)
    bw = -np.log(np.maximum(mag_r, 1e-12)) * sr / np.pi
    valid = (freq > 50.0) & (freq < max_formant_hz - 50.0) & (roots_im > 0)
    f_key = np.where(valid, freq, np.inf)
    order = np.argsort(f_key, axis=1, kind="stable")
    f_sorted = np.take_along_axis(f_key, order, axis=1)[:, :n_keep]
    b_sorted = np.take_along_axis(np.where(valid, bw, np.nan), order, axis=1)[:, :n_keep]
    out_f = np.where(np.isfinite(f_sorted), f_sorted, np.nan)
    out_b = np.where(np.isfinite(f_sorted), b_sorted, np.nan)
    return out_f, out_b


def _preprocess(x: np.ndarray, sr: float, target_sr: float, preemphasis_from: float) -> np.ndarray:
    """Host resample to ``target_sr`` and preemphasis (x[0]·(1 − k) first)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    if sr != target_sr:
        g = math.gcd(int(round(target_sr)), int(round(sr)))
        x = resample_poly_np(x, int(round(target_sr)) // g, int(round(sr)) // g)
    if len(x):
        pre = math.exp(-2.0 * math.pi * preemphasis_from / target_sr)
        x = np.concatenate([[x[0] * (1 - pre)], x[1:] - pre * x[:-1]])
    return x


def formant_track_burg(x: np.ndarray, sr: float, time_step: float = 0.005,
                       max_formants: float = 5.0, max_formant_hz: float = 5000.0,
                       window_length: float = 0.025, preemphasis_from: float = 50.0
                       ) -> FormantTrack:
    """One file's Burg formant track on the host (float64 Burg, complex64
    roots), the oracle of :func:`formant_track_burg_batch`."""
    sr_t = 2.0 * max_formant_hz
    x = _preprocess(x, sr, sr_t, preemphasis_from)
    phys_window = 2.0 * window_length
    n_frames, t0 = praat_frame_grid(len(x), sr_t, phys_window, time_step)
    n_keep = int(max_formants)
    if n_frames < 1:
        empty = np.zeros((0, n_keep))
        return FormantTrack(np.zeros(0), empty, empty)
    win_len = int(round(phys_window * sr_t))
    centers = t0 + np.arange(n_frames) * time_step
    starts = np.clip(np.round(centers * sr_t - win_len / 2).astype(int), 0,
                     max(len(x) - win_len, 0))
    frames = x[starts[:, None] + np.arange(win_len)[None, :]] * praat_gaussian_window(win_len)
    a = burg_coeffs(torch.from_numpy(frames), int(2 * max_formants))
    re, im = durand_kerner_roots(a)
    out_f, out_b = _roots_to_formants(re.numpy(), im.numpy(), sr_t, max_formant_hz, n_keep)
    return FormantTrack(centers, out_f, out_b)


def _gathered_burg_formants(x_cat: torch.Tensor, starts: torch.Tensor, window: torch.Tensor,
                            win_len: int, order: int, sr: float, max_formant_hz: float,
                            n_keep: int) -> torch.Tensor:
    """Frames gathered on the device, windowed, Burg, Durand–Kerner and the
    roots → (frequency, bandwidth) conversion of :func:`_roots_to_formants`
    in float32: one (2, frames, n_keep) tensor."""
    frames = gather_frames(x_cat, starts, win_len) * window[None, :]
    re, im = durand_kerner_roots(burg_coeffs(frames, order))
    freq = torch.abs(torch.atan2(im, re)) * sr / (2 * math.pi)
    bw = -torch.log(torch.clamp(torch.hypot(re, im), min=1e-12)) * sr / math.pi
    valid = (freq > 50.0) & (freq < max_formant_hz - 50.0) & (im > 0)
    f_key = torch.where(valid, freq, float("inf"))
    f_sorted, idx = torch.sort(f_key, dim=1, stable=True)
    f_sorted = f_sorted[:, :n_keep]
    b_sorted = torch.gather(torch.where(valid, bw, float("nan")), 1, idx)[:, :n_keep]
    finite = torch.isfinite(f_sorted)
    return torch.stack([torch.where(finite, f_sorted, float("nan")),
                        torch.where(finite, b_sorted, float("nan"))])


def formant_track_burg_batch(xs, sr: float, time_step: float = 0.005, max_formants: float = 5.0,
                             max_formant_hz: float = 5000.0, window_length: float = 0.025,
                             preemphasis_from: float = 50.0, preprocessed: bool = False,
                             buf=None, defer: bool = False, device: DeviceLike = "cuda"):
    """Burg formant tracks of many files (a list of FormantTrack, or a
    ``Deferred`` of it): every file's frames through one device pass and
    one transfer back.

    ``buf`` is a corpus buffer already at 2·max_formant_hz and
    preemphasized (the MSHDS extractor's 10 kHz buffer, shared with the
    CPPS pass); without it ``xs`` are resampled and preemphasized on the
    host (unless ``preprocessed``) and uploaded to ``device``.
    """
    target_sr = 2.0 * max_formant_hz
    if buf is not None:
        prepped = buf.xs
        dev = buf.x_cat.device
    else:
        prepped = [np.asarray(x, dtype=np.float64).reshape(-1) if preprocessed
                   else _preprocess(x, sr, target_sr, preemphasis_from) for x in xs]
        dev = resolve_device(device)
    sr = target_sr

    phys_window = 2.0 * window_length
    win_len = int(round(phys_window * sr))
    if buf is not None and win_len > buf.pad:
        raise ValueError(f"corpus buffer pad {buf.pad} < window {win_len}")
    window = praat_gaussian_window(win_len)

    metas, start_blocks, pieces = [], [], []
    offset = 0
    for fi, x in enumerate(prepped):
        n_frames, t0 = praat_frame_grid(len(x), sr, phys_window, time_step)
        centers = t0 + np.arange(max(n_frames, 0)) * time_step
        metas.append((n_frames, centers))
        if n_frames < 1:
            continue
        if buf is None:
            base = offset
            pieces.append(np.pad(x, (0, win_len)).astype(np.float32))
            offset += len(x) + win_len
        else:
            base = int(buf.offsets[fi])
        starts = np.clip(np.round(centers * sr - win_len / 2).astype(int),
                         0, max(len(x) - win_len, 0))
        start_blocks.append(starts + base)

    n_keep = int(max_formants)
    if not start_blocks:
        empty = [FormantTrack(c, np.full((max(n, 0), n_keep), np.nan),
                              np.full((max(n, 0), n_keep), np.nan)) for n, c in metas]
        return Deferred.ready(empty) if defer else empty

    x_cat = buf.x_cat if buf is not None else torch.from_numpy(np.concatenate(pieces)).to(dev)
    starts_padded, _ = pad_frames(np.concatenate(start_blocks).astype(np.int64)[:, None])
    fb_dev = _gathered_burg_formants(
        x_cat, torch.from_numpy(starts_padded[:, 0]).to(dev),
        torch.from_numpy(window.astype(np.float32)).to(dev), win_len, int(2 * max_formants),
        float(sr), float(max_formant_hz), n_keep)

    def _finalize(fb):
        fb = np.asarray(fb, np.float64)
        out, cursor = [], 0
        for n_frames, centers in metas:
            if n_frames < 1:
                out.append(FormantTrack(centers, np.full((0, n_keep), np.nan),
                                        np.full((0, n_keep), np.nan)))
                continue
            out.append(FormantTrack(centers, fb[0, cursor : cursor + n_frames],
                                    fb[1, cursor : cursor + n_frames]))
            cursor += n_frames
        return out

    d = Deferred(fb_dev, _finalize)
    return d if defer else d.result()
