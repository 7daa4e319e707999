"""MSHDS: 25 handcrafted acoustic features per recording, corpus-staged.

Counterpart of ``robust_speech_analysis_framework_tpu/features/mshds.py``:
speech-rate features (de Jong & Wempe's syllable nuclei), speaker-adaptive
pitch statistics, intensity, HNR, LTAS slope and tilt, CPPS over voiced
segments, Burg formants sampled at glottal pulses and spectral moments over
voiced frames, all from the port's ops.

Every device analysis runs once over the frames of every file of the
corpus, in levels whose results are fetched behind one synchronisation
each (``ops.framing.collect``):

* L0: the 16 kHz corpus buffer (one upload) and its 10 kHz resample (on the
  device), the wide pitch pass and the speech-rate intensity and pitch;
* L1: per pitch range group, the main and CPP passes (one shared
  autocorrelation), the cc pass, intensity and HNR;
* pulses: the glottal-pulse march over the cc and CPP tracks, on the device
  for real corpora (:data:`DEVICE_MARCH_MIN_VOICED_S`) when its windows fit
  the sample rate, on the host otherwise;
* tail: spectral moments and formants, queued after the pulses; LTAS and
  CPPS, queued once the host has chosen their periods and segments; one
  collect.

Failure semantics: a file that cannot be read, and a host decision that
fails on one file's data (speech-rate logic, vuv segments, LTAS
statistics, formant sampling), give NaN for the features concerned; an
error of a device stage propagates. There is no retry and no host fallback
for a device stage.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..device import DeviceLike, resolve_device
from ..ops.cepstrum import cpps_segments_batch
from ..ops.formants import formant_track_burg_batch
from ..ops.framing import collect, corpus_buffer, resample_buffer
from ..ops.harmonicity import harmonicity_cc_batch
from ..ops.intensity import IntensityContour, intensity_contour_batch
from ..ops.ltas import ltas_pitch_corrected_batch
from ..parallel.mesh import in_threads
from ..ops.pitch import (
    PitchParams,
    PitchTrack,
    pitch_track_batch,
    pitch_track_batch_shared,
    praat_frame_grid,
)
from ..ops.pulses import (
    label_at_time,
    march_windows_fit,
    point_process_cc,
    point_process_cc_batch,
    silence_intervals,
    vuv_intervals,
)
from ..ops.spectral import voiced_mean_moments_batch

FEATURE_NAMES = [
    "Speaking_Rate", "Articulation_Rate", "Phonation_Ratio", "Pause_Rate",
    "Mean_Pause_Duration",
    "mean_F0", "stdev_F0_Semitone", "mean_dB", "range_ratio_dB", "HNR_dB",
    "Spectral_Slope", "Spectral_Tilt", "Cepstral_Peak_Prominence",
    "mean_F1_Loc", "std_F1_Loc", "mean_B1_Loc", "std_B1_Loc",
    "mean_F2_Loc", "std_F2_Loc", "mean_B2_Loc", "std_B2_Loc",
    "Spectral_Gravity", "Spectral_Std_Dev", "Spectral_Skewness",
    "Spectral_Kurtosis",
]

_TEMPORAL = ["Speaking_Rate", "Articulation_Rate", "Phonation_Ratio",
             "Pause_Rate", "Mean_Pause_Duration"]

# The device march when the cc and CPP tracks hold more voiced seconds than
# this (and its windows fit the sample rate), the host march below it: the
# host march costs ~9 ms a voiced second a pass, the device march a nearly
# flat ~0.2 s a corpus (the JAX package's measurement and rule).
DEVICE_MARCH_MIN_VOICED_S = 25.0

# A host decision's failure on one file's data: the file's features
# concerned become NaN. Anything else propagates.
_HOST_ERRORS = (ArithmeticError, IndexError, ValueError)

_WIDE = PitchParams(time_step=0.005, floor=50, ceiling=600)
_SPEECHRATE = PitchParams(time_step=0.02, floor=30, ceiling=450, max_candidates=4,
                          silence_threshold=0.03, voicing_threshold=0.25, octave_cost=0.01,
                          octave_jump_cost=0.35, voiced_unvoiced_cost=0.25)
_SR10K = 10000.0  # formants and CPPS: 2 × their 5 kHz maximum


def _range_from_track(track: PitchTrack):
    """The adaptive pitch floor and ceiling from the wide 50–600 Hz pass:
    |z| ≤ 2 outlier filter, mean < 170 Hz → (60, 250), else (100, 500);
    (75, 500) when nothing is voiced."""
    v = track.f0[track.f0 > 0]
    if v.size == 0:
        return 75, 500
    z = (v - v.mean()) / max(v.std(), 1e-12)
    v = v[np.abs(z) <= 2]
    if v.size == 0:
        return 75, 500
    return (60, 250) if v.mean() < 170 else (100, 500)


def speaker_pitch_range(x: np.ndarray, sr: float, device: DeviceLike = "cuda"):
    """The adaptive pitch floor and ceiling of one file."""
    wide = pitch_track_batch([np.asarray(x, dtype=np.float64).reshape(-1)], sr, _WIDE,
                             device=device)[0]
    return _range_from_track(wide)


def speechrate_features(x: np.ndarray, sr: float, pitch: "PitchTrack | None" = None,
                        intensity: "IntensityContour | None" = None,
                        device: DeviceLike = "cuda") -> Dict[str, float]:
    """de Jong & Wempe's syllable-nuclei speech rate: intensity peaks above
    a quantile-based silence threshold, each followed by a dip of at least
    2 dB, counted where the pitch track is voiced and the silence grid says
    sounding. ``pitch`` and ``intensity`` are computed on ``device`` when
    not given; NaN features when the host logic fails on this file."""
    nan5 = dict.fromkeys(_TEMPORAL, float("nan"))
    if intensity is None:
        intensity = intensity_contour_batch([x], sr, minimum_pitch=50, time_step=0.016,
                                            subtract_mean=True, device=device)[0]
    if len(intensity.times) < 3:
        return nan5
    if pitch is None:
        pitch = pitch_track_batch([x], sr, _SPEECHRATE, device=device)[0]
    try:
        return _speechrate(x, sr, pitch, intensity) or nan5
    except _HOST_ERRORS:
        return nan5


def _speechrate(x, sr, pitch: PitchTrack, intensity: IntensityContour):
    silencedb, mindip, minpause = -25.0, 2.0, 0.3
    min_int = intensity.min_db()
    max_int = intensity.max_db()
    q99 = intensity.quantile(0.99)
    thresh_abs = max(q99 + silencedb, min_int)  # peak floor, absolute dB
    thresh_rel = silencedb - (max_int - q99)  # silence cut, relative to the maximum

    intervals = silence_intervals(intensity, thresh_rel, minpause, 0.1,
                                  total_duration=len(x) / sr)
    sounding = [(a, b) for a, b, lab in intervals if lab == "sounding"]
    if not sounding:
        return None
    phonation_time = sum(b - a for a, b in sounding)
    begin_speak, end_speak = sounding[0][0], sounding[-1][1]

    v, t = intensity.values_db, intensity.times
    is_peak = np.zeros(len(v), bool)
    is_peak[1:-1] = (v[1:-1] > v[:-2]) & (v[1:-1] > v[2:])
    peak_idx = np.flatnonzero(is_peak & (v > thresh_abs))
    timepeaks, intensities = t[peak_idx], v[peak_idx]

    # peaks with a dip of at least mindip before the next peak
    validtime = []
    if len(timepeaks) > 1:
        current_t, current_i = timepeaks[0], intensities[0]
        for p in range(len(timepeaks) - 1):
            dip = intensity.min_in_range(current_t, timepeaks[p + 1])
            if abs(current_i - dip) > mindip:
                validtime.append(timepeaks[p])
            current_t = timepeaks[p + 1]
            current_i = intensity.value_at_time(timepeaks[p + 1])

    n_syll = sum(1 for time in validtime
                 if np.isfinite(pitch.value_at_time(time))
                 and label_at_time(intervals, time) == "sounding")
    duration = end_speak - begin_speak
    n_pauses = len(sounding) - 1
    pause_time = duration - phonation_time
    return {
        "Speaking_Rate": n_syll / duration if duration > 0 else 0.0,
        "Articulation_Rate": n_syll / phonation_time if phonation_time > 0 else 0.0,
        "Phonation_Ratio": phonation_time / duration if duration > 0 else 0.0,
        "Pause_Rate": n_pauses / duration if duration > 0 else 0.0,
        "Mean_Pause_Duration": pause_time / n_pauses if n_pauses > 0 else 0.0,
    }


def _voiced_fn(track: PitchTrack):
    """Frame times → voiced, by the main pitch track (Praat's linear
    interpolation is NaN where the near frame is unvoiced)."""
    return lambda t: np.isfinite(np.atleast_1d(track.value_at_time(t)))


def _cpps_segments(pulses: np.ndarray, duration: float, n10k: int):
    """A file's voiced segments for CPPS: the vuv intervals of its CPP
    pulses (50 ms pads a side). A segment too short for one cepstrogram
    window on the 10 kHz grid empties the list, which NaNs the file's CPP
    (the reference's outer try)."""
    segs = []
    for a, b, lab in vuv_intervals(pulses, duration, max_period=0.02, mean_period=0.1):
        if lab != "V" or b <= a:
            continue
        seg_len = min(int(b * _SR10K), n10k) - min(int(a * _SR10K), n10k)
        if praat_frame_grid(max(seg_len, 0), _SR10K, 2.0 / 60.0, 0.002)[0] < 1:
            return []
        segs.append((a, b))
    return segs


def _formant_stats(ft, pulses: np.ndarray) -> Dict[str, float]:
    """F1, F2 and their bandwidths sampled at the glottal pulses: mean and
    sample standard deviation of the finite values."""
    out = {}
    for fi, (fkey, bkey) in enumerate([("F1", "B1"), ("F2", "B2")], 1):
        for key, sample in ((fkey, ft.value_at), (bkey, ft.bandwidth_at)):
            v = np.atleast_1d(sample(fi, pulses)) if len(pulses) else np.zeros(0)
            v = v[np.isfinite(v)]
            out[f"mean_{key}_Loc"] = float(v.mean()) if v.size else float("nan")
            out[f"std_{key}_Loc"] = float(v.std(ddof=1)) if v.size > 1 else float("nan")
    return out


def _note(verbose: bool, i: int, what: str, err: Exception) -> None:
    if verbose:
        print(f"MSHDS file {i}: {what} failed ({type(err).__name__}: {err}); NaN-filling")


def _extract_corpus(xs: "List[np.ndarray]", sr: float, verbose: bool = True,
                    device: DeviceLike = "cuda") -> "List[Dict[str, float]]":
    """All 25 MSHDS features of every waveform, corpus-staged (see the
    module docstring). Returns one feature dict per input."""
    n = len(xs)
    xs = [np.asarray(x, dtype=np.float64).reshape(-1) for x in xs]
    rows = [dict.fromkeys(FEATURE_NAMES, float("nan")) for _ in range(n)]
    if n == 0:
        return rows
    dev = resolve_device(device)

    # One upload for every 16 kHz stage. The pad covers the largest window
    # plus lag used below, which scales with sr (the range-adapted intensity
    # window is 6.4/50·sr, harmonicity's extension (4.5 + 1)/60·sr). File
    # offsets are aligned to the 10 kHz resample's down factor, so the
    # formant/CPPS buffer is this one resampled on the device.
    g = math.gcd(int(_SR10K), int(round(sr)))
    up, down = int(_SR10K) // g, int(round(sr)) // g
    buf16 = corpus_buffer(xs, pad=max(4096, int(0.14 * sr) + 64), align=down, device=dev)

    # --- L0 ----------------------------------------------------------------
    buf10k = resample_buffer(buf16, up, down, preemphasis=math.exp(-2.0 * math.pi * 50.0 / _SR10K))
    wide, sr_intensity, sr_pitch = collect([
        pitch_track_batch(None, sr, _WIDE, buf=buf16, defer=True),
        intensity_contour_batch(None, sr, minimum_pitch=50, time_step=0.016,
                                subtract_mean=True, buf=buf16, defer=True),
        pitch_track_batch(None, sr, _SPEECHRATE, buf=buf16, defer=True),
    ])

    # --- L1: the range-adapted passes, per (floor, ceiling) group ----------
    groups: Dict[tuple, list] = {}
    for i, track in enumerate(wide):
        groups.setdefault(_range_from_track(track), []).append(i)
    stages = []
    for (floor, ceiling), idxs in groups.items():
        stages += [
            # main (voicing 0.45) and CPP (voicing 0.3) share one autocorrelation
            pitch_track_batch_shared(
                None, sr, [PitchParams(time_step=0.005, floor=floor, ceiling=ceiling),
                           PitchParams(time_step=0.005, floor=floor, ceiling=ceiling,
                                       voicing_threshold=0.3)],
                buf=buf16, indices=idxs, defer=True),
            pitch_track_batch(None, sr, PitchParams(time_step=0.005, floor=floor,
                                                    ceiling=ceiling, method="cc"),
                              buf=buf16, indices=idxs, defer=True),
            intensity_contour_batch(None, sr, minimum_pitch=floor, time_step=0.005,
                                    subtract_mean=True, buf=buf16, indices=idxs, defer=True),
            harmonicity_cc_batch(None, sr, time_step=0.005, minimum_pitch=floor,
                                 silence_threshold=0.1, periods_per_window=4.5, buf=buf16,
                                 indices=idxs, defer=True),
        ]
    # the host's speech-rate logic overlaps the queued L1 passes
    for i in range(n):
        rows[i].update(speechrate_features(xs[i], sr, pitch=sr_pitch[i],
                                           intensity=sr_intensity[i]))
    l1 = collect(stages)

    main_tracks: List[PitchTrack] = [None] * n
    cpp_tracks: List[PitchTrack] = [None] * n
    cc_tracks: List[PitchTrack] = [None] * n
    for g_i, idxs in enumerate(groups.values()):
        (main, cpp), cc, intens, hnr = l1[4 * g_i : 4 * g_i + 4]
        for j, i in enumerate(idxs):
            main_tracks[i], cpp_tracks[i], cc_tracks[i] = main[j], cpp[j], cc[j]
            rows[i]["mean_F0"] = main[j].mean_hz()
            rows[i]["stdev_F0_Semitone"] = main[j].std_semitones()
            if len(intens[j].times):
                rows[i]["mean_dB"] = intens[j].mean_energy_db()
                mn, mx = intens[j].min_db(), intens[j].max_db()
                rows[i]["range_ratio_dB"] = mx / mn if mn != 0 else float("nan")
            rows[i]["HNR_dB"] = hnr[j].mean_db()

    # --- glottal pulses ----------------------------------------------------
    tracks = cc_tracks + cpp_tracks
    voiced_s = sum(float((t.f0 > 0).sum()) * 0.005 for t in tracks)
    if voiced_s > DEVICE_MARCH_MIN_VOICED_S and march_windows_fit(sr, tracks):
        both = point_process_cc_batch(None, sr, tracks, buf=buf16)
    else:
        both = [point_process_cc(xs[k % n], sr, t) for k, t in enumerate(tracks)]
    cc_pulses, cpp_pulses = both[:n], both[n:]

    # --- tail --------------------------------------------------------------
    # moments and formants depend on no host decision: queued now, they run
    # on the device while the host picks the LTAS periods and CPPS segments
    tail = [
        voiced_mean_moments_batch(None, sr, [_voiced_fn(t) for t in main_tracks], 0.025, 0.005,
                                  buf=buf16, defer=True),
        formant_track_burg_batch(None, _SR10K, time_step=0.005, max_formants=5,
                                 max_formant_hz=5000, window_length=0.025, preemphasis_from=50,
                                 preprocessed=True, buf=buf10k, defer=True),
        ltas_pitch_corrected_batch(xs, sr, cc_pulses, buf=buf16, defer=True),
    ]
    items = []
    for i in range(n):
        try:
            segs = _cpps_segments(cpp_pulses[i], len(xs[i]) / sr, len(buf10k.xs[i]))
        except _HOST_ERRORS as e:
            _note(verbose, i, "vuv segments", e)
            segs = []
        items.append((buf10k.xs[i], segs))
    tail.append(cpps_segments_batch(items, _SR10K, pitch_floor=60, time_step=0.002, pitch_min=60,
                                    pitch_max=330, buf=buf10k, defer=True))
    moments, formant_tracks, ltas_list, cpp_vals = collect(tail)

    for i in range(n):
        try:
            rows[i]["Spectral_Slope"] = ltas_list[i].slope_db(50, 1000, 1000, 4000)
            rows[i]["Spectral_Tilt"] = ltas_list[i].spectral_tilt(100, 5000)
        except _HOST_ERRORS as e:
            _note(verbose, i, "LTAS statistics", e)
        try:
            rows[i].update(_formant_stats(formant_tracks[i], cc_pulses[i]))
        except _HOST_ERRORS as e:
            _note(verbose, i, "formant sampling", e)
        rows[i]["Cepstral_Peak_Prominence"] = cpp_vals[i]
        g_, s_, sk, ku = moments[i]
        rows[i]["Spectral_Gravity"], rows[i]["Spectral_Std_Dev"] = g_, s_
        rows[i]["Spectral_Skewness"], rows[i]["Spectral_Kurtosis"] = sk, ku
    return rows


def _extract_on(xs: "List[np.ndarray]", sr: float, verbose: bool, device: DeviceLike,
                devices: Optional[Sequence[DeviceLike]]) -> "List[Dict[str, float]]":
    """:func:`_extract_corpus` of ``xs``; with two or more ``devices``, the
    files go round-robin into one sub-corpus a device (JAX ``:698-712``),
    each run on its device from its own host thread, and the rows come back
    in ``xs``'s order. A sub-corpus is its own corpus buffer and its own
    levels, so a row equals the single-device row where the per-file
    programs agree; the choice of pulse march counts the sub-corpus's
    voiced seconds (:data:`DEVICE_MARCH_MIN_VOICED_S`), as JAX's counts its
    partition's."""
    if devices is None or len(devices) < 2 or len(xs) < 2:
        return _extract_corpus(xs, sr, verbose=verbose,
                               device=device if not devices else devices[0])
    n_groups = min(len(devices), len(xs))
    group_idx = [list(range(g, len(xs), n_groups)) for g in range(n_groups)]
    parts = in_threads(lambda g: _extract_corpus([xs[i] for i in group_idx[g]], sr,
                                                 verbose=False, device=devices[g]), n_groups)
    rows: "List[Optional[Dict[str, float]]]" = [None] * len(xs)
    for idx, part in zip(group_idx, parts):
        for i, r in zip(idx, part):
            rows[i] = r
    return rows


def extract_mshds_arrays(xs, sr: float = 16000, device: DeviceLike = "cuda",
                         devices: Optional[Sequence[DeviceLike]] = None) -> np.ndarray:
    """The pandas-free core: (N, 25) float64 features of the waveforms
    ``xs``, columns in :data:`FEATURE_NAMES` order, NaN where a feature
    could not be computed. ``devices`` (two or more) splits the corpus over
    them (:func:`_extract_on`)."""
    rows = _extract_on(list(xs), sr, False, device, devices)
    return np.asarray([[r[k] for k in FEATURE_NAMES] for r in rows],
                      np.float64).reshape(len(rows), len(FEATURE_NAMES))


def extract_mshds_single(x: np.ndarray, sr: float = 16000, device: DeviceLike = "cuda"
                         ) -> Dict[str, float]:
    """All 25 MSHDS features of one mono waveform (a corpus of one, so
    serial equals batch by construction)."""
    return _extract_corpus([np.asarray(x)], sr, verbose=False, device=device)[0]


def extract_mshds_features(input_df, audio_file_column: str = "filepath", verbose: bool = True,
                           waveforms: Optional[Mapping[str, np.ndarray]] = None,
                           device: DeviceLike = "cuda"):
    """DataFrame front door with the reference extractor's API shape: one
    row per file, 'filename' and the 25 features; a file that cannot be
    read gives a NaN row. ``waveforms`` may supply decoded 16 kHz mono audio
    by filename (no disk read)."""
    import pandas as pd

    from ..audio.io import load_mono_16k

    if input_df.empty:
        return pd.DataFrame(columns=["filename"] + FEATURE_NAMES)
    names = [os.path.basename(p) for p in input_df[audio_file_column]]
    xs, ok = [], []
    for name, path in zip(names, input_df[audio_file_column]):
        try:
            if waveforms is not None and name in waveforms:
                xs.append(np.asarray(waveforms[name], dtype=np.float64))
            else:
                xs.append(load_mono_16k(path).astype(np.float64))
            ok.append(True)
        except (OSError, ValueError, struct.error) as e:
            if verbose:
                print(f"ERROR processing '{name}': {e}. Appending NaNs.")
            xs.append(np.zeros(0))
            ok.append(False)
    feats = _extract_corpus(xs, 16000, verbose=verbose, device=device)
    return pd.DataFrame([
        {"filename": name, **(feats[i] if ok[i] else dict.fromkeys(FEATURE_NAMES, float("nan")))}
        for i, name in enumerate(names)
    ], columns=["filename"] + FEATURE_NAMES)


def extract_mshds_batch(waveforms: Mapping[str, np.ndarray], sr: float = 16000,
                        verbose: bool = True, device: DeviceLike = "cuda",
                        devices: Optional[Sequence[DeviceLike]] = None):
    """Corpus-batched MSHDS over decoded waveforms ({filename: waveform}) →
    DataFrame of 'filename' and the 25 features, in the mapping's order.
    ``devices`` (two or more) partitions the corpus over them, one
    sub-corpus a device (:func:`_extract_on`)."""
    import pandas as pd

    names = list(waveforms.keys())
    if not names:
        return pd.DataFrame(columns=["filename"] + FEATURE_NAMES)
    feats = _extract_on([waveforms[k] for k in names], sr, verbose, device, devices)
    return pd.DataFrame([{"filename": name, **feats[i]} for i, name in enumerate(names)],
                        columns=["filename"] + FEATURE_NAMES)
