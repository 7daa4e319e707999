"""openSMILE-equivalent 912-feature summary extractor (Androids config).

The ``Androids.conf`` DAG without the SMILExtract binary:

framing 25 ms/10 ms → per-frame preemphasis k=0.97 → Hamming → |FFT| →
{HTK mel 26 → MFCC 1-12 · RMS energy · ZCR (pre-window frames) · intensity
and loudness · SHS pitch + Viterbi → F0final/voicingFinalUnclipped
(energy-gated) · waveform jitter/shimmer/logHNR · 16 spectral LLDs} →
moving-average smoothing (``_sma``) → delta regression (``_de``) → 12
functionals per contour.

38 LLDs × 2 (sma, de) × 12 functionals = 912 columns; ``reference_compat``
emits the reference's observed 911 (its loader drops the first feature,
taking it for the instance-name column).

On the card, per sub-batch of same-bucket files, one chain with no host
read between its upload and its fetch: the (B, N) waveform stack goes up
once (as int16 for 16-bit PCM, ``ops/framing.upload_pcm_f32``); the frame
stage, the pitch chain (with the Viterbi kernel K7), the period march (its
own kernel, fed the pitch chain's F0 on the card), the period→LLD prefix
sums and the masked summary stage run there; the (B, 12, 38) × 2
functionals come down once. :meth:`OpenSmileExtractor.extract_arrays`
keeps up to ``_MAX_INFLIGHT`` (3) such chains queued, reading the oldest
while the card runs the others. A card error propagates: there is no host
march to fall back on and no retry. The single-file paths are a batch of
one, with the same march. No module here imports pandas: the DataFrame
front doors import it when called, over the numpy core
:meth:`OpenSmileExtractor.extract_arrays`.
"""

from __future__ import annotations

import collections
import contextlib
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..audio.frontend import (
    FrontendConfig,
    frame_signal,
    hamming_window,
    mel_filterbank,
    mfcc_from_power,
    num_frames,
    preemphasize,
    stft_magnitude,
    table,
)
from ..device import DeviceLike, resolve_device
from ..ops.bucketing import bucket_size, pad_frames
from ..ops.dft import rfft_power
from ..ops.functionals import (
    FUNCTIONAL_NAMES,
    apply_functionals_masked,
    delta_regression_masked,
    smooth_sma_masked,
)
from ..ops.framing import Deferred, queue_fetch, upload, upload_pcm_f32
from ..parallel.mesh import DeviceGrid
from ..ops.jitter import mark_periods_batch, periods_to_llds_batch
from ..ops.lld_spectral import (
    SPECTRAL_NAMES,
    intensity_loudness,
    rms_energy,
    spectral_llds,
    zero_crossing_rate,
)
from ..ops.shs_pitch import ShsParams, shs_pitch_batch

# sub-batch chains queued before the oldest is read
_MAX_INFLIGHT = 3

LLD_NAMES: List[str] = (
    ["pcm_RMSenergy"]
    + [f"mfcc[{i}]" for i in range(1, 13)]
    + ["pcm_zcr", "F0final", "voicingFinalUnclipped"]
    + ["pcm_intensity", "pcm_loudness",
       "jitterLocal", "jitterDDP", "shimmerLocal", "logHNR"]
    + SPECTRAL_NAMES
)  # 16 + 6 + 16 = 38

# contour-smoother levels lld / lld2 / lld3 (Androids.conf:284-314) as slices
# of LLD_NAMES; cFunctionals reads lld;lld_de;lld2;lld_de2;lld3;lld_de3
# (:350), so each group's sma block is followed by its de block
_GROUP_SLICES = ((0, 16), (16, 22), (22, 38))


def _emission_order() -> List[Tuple[int, int, str]]:
    """(start, stop, suffix) blocks in the conf's cFunctionals reader order."""
    return [(a, b, suffix) for a, b in _GROUP_SLICES for suffix in ("_sma", "_sma_de")]


def _functional_vec(f_sma: np.ndarray, f_de: np.ndarray) -> np.ndarray:
    """(12, 38) sma/de functionals → the 912 vector in emission order
    (matches :func:`feature_columns`)."""
    sma_t, de_t = np.asarray(f_sma).T, np.asarray(f_de).T  # (38, 12)
    parts = []
    for a, b, suffix in _emission_order():
        src = sma_t if suffix == "_sma" else de_t
        parts.append(src[a:b].reshape(-1))
    return np.concatenate(parts)


def feature_columns(reference_compat: bool = False) -> List[str]:
    """Column names in openSMILE emission order: per smoother group, its sma
    functionals then its delta functionals; within a block, per LLD, the 12
    functionals. ``reference_compat`` drops the first (911 columns)."""
    cols = [
        f"{lld}{suffix}_{fn}"
        for a, b, suffix in _emission_order()
        for lld in LLD_NAMES[a:b]
        for fn in FUNCTIONAL_NAMES
    ]
    return cols[1:] if reference_compat else cols


@dataclass(frozen=True)
class OpenSmileConfig:
    frontend: FrontendConfig = FrontendConfig(
        sample_rate=16000, frame_seconds=0.025, hop_seconds=0.010,
        preemphasis=0.97, n_mels=26, fmin=20.0, fmax=8000.0,
    )
    n_mfcc: int = 12
    shs: ShsParams = ShsParams()
    energy_gate: float = 0.001
    sma_window: int = 3
    deltawin: int = 2
    jitter_search_range: float = 0.25
    # the reference's observed 911-column schema (first feature dropped)
    reference_compat: bool = False


class OpenSmileExtractor:
    """The 912-feature extractor on one device (``"cuda"`` unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, config: OpenSmileConfig = OpenSmileConfig(),
                 pipeline_rows: int = 4, device: DeviceLike = "cuda"):
        self.config = config
        # files per sub-batch of one bucket; <= 0: the whole bucket at once
        self.pipeline_rows = pipeline_rows
        self.device = resolve_device(device)
        cfg = config.frontend
        self._window = hamming_window(cfg.frame_len)
        self._melfb = mel_filterbank(cfg.n_mels, cfg.fft_size, cfg.sample_rate, cfg.fmin, cfg.fmax)
        # voicing needs an alias-free autocorrelation up to sr/min_pitch
        # lags, beyond the fft_size − frame_len of the shared STFT: a wider
        # power spectrum (1024 points at the defaults) feeds it
        max_lag = int(cfg.sample_rate / config.shs.min_pitch)
        self._voicing_nfft = 1 << (cfg.frame_len + max_lag).bit_length()

    # ---- stages ------------------------------------------------------------

    def frame_stage(self, x: torch.Tensor):
        """Waveforms (..., N) → (mag, mfcc, energy, zcr, intensity/loudness,
        spectral LLDs, wide voicing power spectrum), per frame."""
        cfg = self.config.frontend
        raw = frame_signal(x, cfg.frame_len, cfg.hop)
        pre = preemphasize(raw, cfg.preemphasis)
        win = pre * table(self._window, pre)
        mag = stft_magnitude(win, cfg.fft_size)
        mfcc = mfcc_from_power(mag, self._melfb, n_ceps=self.config.n_mfcc, first_cep=1,
                               spec_is_power=False)
        energy = rms_energy(win)
        zcr = zero_crossing_rate(raw)
        inten = intensity_loudness(win)
        spect = spectral_llds(mag, float(cfg.sample_rate))
        vpow = rfft_power(win, self._voicing_nfft)
        return mag, mfcc, energy, zcr, inten, spect, vpow

    def summary_stage(self, lld: torch.Tensor, lengths):
        """(…, T, 38) LLDs, valid for rows < lengths → (f_sma, f_de), each
        (…, 12, 38); rows ≥ length never contribute."""
        sma = smooth_sma_masked(lld, lengths, self.config.sma_window)
        de = delta_regression_masked(sma, lengths, self.config.deltawin)
        return apply_functionals_masked(sma, lengths), apply_functionals_masked(de, lengths)

    def _llds(self, x: torch.Tensor, ns: Sequence[int], n_frames: Sequence[int]) -> torch.Tensor:
        """(B, N) zero-padded waveforms on the device → (B, T, 38) LLDs
        there, with no host read: the period march takes the pitch chain's
        F0 where it lies."""
        cfg = self.config.frontend
        mag, mfcc, energy, zcr, inten, spect, vpow = self.frame_stage(x)
        f0, voicing = shs_pitch_batch(
            mag, cfg.sample_rate, energy, self.config.shs, self.config.energy_gate,
            win_len=cfg.frame_len, voicing_power=vpow,
        )
        march = mark_periods_batch(
            x, cfg.sample_rate, f0, ns, n_frames, hop_s=cfg.hop_seconds,
            search_range_rel=self.config.jitter_search_range, defer=True,
        )
        vq = periods_to_llds_batch(march.arrays, f0, cfg.sample_rate,
                                   hop_s=cfg.hop_seconds, frame_s=cfg.frame_seconds)
        return torch.cat(
            [energy[..., None], mfcc, zcr[..., None], f0[..., None], voicing[..., None],
             inten, vq, spect],
            dim=-1,
        )

    def _stack(self, bucket: int, waves: Sequence[np.ndarray]) -> np.ndarray:
        stack = np.zeros((len(waves), bucket), np.float32)
        for i, x in enumerate(waves):
            stack[i, : len(x)] = x
        return stack

    def _dispatch(self, bucket: int, waves: Sequence[np.ndarray],
                  device: Optional[torch.device] = None) -> Deferred:
        """Queue one sub-batch of a bucket through every stage on ``device``
        (the extractor's by default), on its current stream: a Deferred of
        its (f_sma, f_de), each (B, 12, 38), whose copies to the host are
        queued behind it."""
        dev = self.device if device is None else device
        cfg = self.config.frontend
        nts = [num_frames(len(x), cfg.frame_len, cfg.hop) for x in waves]
        x = upload_pcm_f32(self._stack(bucket, waves), dev)
        lld = self._llds(x, [len(w) for w in waves], nts)
        lengths = upload(np.asarray(nts, np.int64), dev)
        return queue_fetch(self.summary_stage(lld, lengths), tuple)

    # ---- public API ----------------------------------------------------------

    def _bucket_of(self, n_samples: int) -> int:
        return bucket_size(n_samples, min_bucket=self.config.frontend.sample_rate // 2)

    def _usable(self, waveforms: Mapping[str, np.ndarray], verbose: bool):
        """(name, float32 waveform) of each file with at least one analysis
        frame; a shorter clip is dropped with a logged error (its masked
        functionals would be ±inf)."""
        cfg = self.config.frontend
        for name, x in waveforms.items():
            x = np.asarray(x, np.float32).reshape(-1)
            if num_frames(len(x), cfg.frame_len, cfg.hop) >= 1:
                yield name, x
            elif verbose:
                print(f"ERROR: '{name}' shorter than one analysis frame "
                      f"({len(x)} samples); row dropped.")

    def extract_llds(self, x: np.ndarray) -> np.ndarray:
        """(N,) 16 kHz mono → (T_frames, 38) raw LLD matrix. The waveform is
        zero-padded to its bucket, as in a batch; the padded frames are cut."""
        cfg = self.config.frontend
        x = np.asarray(x, np.float32).reshape(-1)
        n_true = num_frames(len(x), cfg.frame_len, cfg.hop)
        if n_true < 1:
            raise ValueError(f"{len(x)} samples is shorter than one analysis frame")
        x_dev = upload_pcm_f32(self._stack(self._bucket_of(len(x)), [x]), self.device)
        return self._llds(x_dev, [len(x)], [n_true])[0, :n_true].cpu().numpy()

    def extract_single(self, x: np.ndarray) -> np.ndarray:
        """One waveform → the 912-dim summary vector."""
        lld_pad, n_true = pad_frames(self.extract_llds(x))
        f_sma, f_de = self.summary_stage(torch.from_numpy(lld_pad).to(self.device), n_true)
        return _functional_vec(f_sma.cpu().numpy(), f_de.cpu().numpy())

    def extract_arrays(self, waveforms: Mapping[str, np.ndarray], verbose: bool = True,
                       mesh: Optional[DeviceGrid] = None) -> Tuple[List[str], np.ndarray]:
        """Batched extraction, the numpy core: files grouped by length bucket,
        each group split into sub-batches of ``pipeline_rows`` stacked files,
        up to ``_MAX_INFLIGHT`` sub-batch chains queued at a time and read in
        order. Returns (names, features (N, 912) float32; 911 columns with
        ``reference_compat``), rows in bucket order. A clip shorter than one
        analysis frame is dropped with a logged error.

        With ``mesh``, a bucket's sub-batches are dealt in turn to the dp
        rows' lead devices, each running its chains on a CUDA stream of its
        own with up to ``_MAX_INFLIGHT`` queued there; the rows come back in
        the single-device order. Every sub-batch holds the files it holds
        without a mesh, so each row equals the single-device row bit for bit
        (the JAX package pads a sharded stack to a dp multiple with silent
        rows; nothing is padded here)."""
        groups: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        for name, x in self._usable(waveforms, verbose):
            groups.setdefault(self._bucket_of(len(x)), []).append((name, x))

        rows = self.pipeline_rows if self.pipeline_rows > 0 else 1 << 30
        devices = [self.device] if mesh is None else mesh.row_leads()
        streams = [torch.cuda.Stream(d) if d.type == "cuda" and mesh is not None else None
                   for d in devices]
        names: List[str] = []
        vecs: List[np.ndarray] = []
        queued = [0] * len(devices)
        pending: collections.deque = collections.deque()

        def read() -> None:
            part, slot, chain = pending.popleft()
            queued[slot] -= 1
            f_sma, f_de = chain.result()
            for i, (name, _) in enumerate(part):
                names.append(name)
                vecs.append(_functional_vec(f_sma[i], f_de[i]))

        n_sub = 0
        for bucket, items in sorted(groups.items()):
            for s in range(0, len(items), rows):
                part = items[s : s + rows]
                slot = n_sub % len(devices)
                n_sub += 1
                args = (bucket, [x for _, x in part])
                with _on_stream(streams[slot]):
                    chain = self._dispatch(*args) if mesh is None else \
                        self._dispatch(*args, devices[slot])
                pending.append((part, slot, chain))
                queued[slot] += 1
                while queued[slot] >= _MAX_INFLIGHT:  # oldest first, whichever device
                    read()
        while pending:
            read()
        n_cols = len(feature_columns(self.config.reference_compat))
        feats = np.zeros((0, n_cols), np.float32)
        if vecs:
            feats = np.stack(vecs).astype(np.float32)[:, -n_cols:]
        return names, feats

    def extract_batch(self, waveforms: Mapping[str, np.ndarray], verbose: bool = True,
                      mesh: Optional[DeviceGrid] = None):
        """{filename: waveform} → DataFrame[feature columns + 'filename'],
        batched by length bucket (see :meth:`extract_arrays`)."""
        names, feats = self.extract_arrays(waveforms, verbose=verbose, mesh=mesh)
        return _frame(names, feats, self.config.reference_compat)

    def extract(self, waveforms: Mapping[str, np.ndarray], verbose: bool = True,
                batched: bool = True, mesh: Optional[DeviceGrid] = None):
        """{filename: waveform} → DataFrame[feature columns + 'filename'];
        ``batched=False`` extracts one file at a time, dropping a file that
        is too short with a logged error (a ``mesh`` is for the batched
        path and raises there)."""
        if batched:
            return self.extract_batch(waveforms, verbose=verbose, mesh=mesh)
        if mesh is not None:
            raise ValueError("mesh= splits the batched extraction; batched=False runs one file "
                             "at a time on the extractor's device")
        n_cols = len(feature_columns(self.config.reference_compat))
        names, vecs = [], []
        for name, x in self._usable(waveforms, verbose):
            names.append(name)
            vecs.append(self.extract_single(x)[-n_cols:])
        feats = np.stack(vecs).astype(np.float32) if vecs else np.zeros((0, n_cols), np.float32)
        return _frame(names, feats, self.config.reference_compat)


def _on_stream(stream):
    """``torch.cuda.stream(stream)``, or nothing for None."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _frame(names: List[str], feats: np.ndarray, reference_compat: bool):
    """(names, features) → DataFrame with the feature columns and 'filename'
    (an empty frame when no row survived)."""
    import pandas as pd

    if not names:
        return pd.DataFrame()
    df = pd.DataFrame(feats.astype(np.float64), columns=feature_columns(reference_compat))
    df["filename"] = names
    return df


def extract_opensmile_features(
    input_df,
    config: OpenSmileConfig = OpenSmileConfig(),
    audio_file_column: str = "filepath",
    verbose: bool = True,
    waveforms: Optional[Mapping[str, np.ndarray]] = None,
    extractor: Optional[OpenSmileExtractor] = None,
    device: DeviceLike = "cuda",
    mesh: Optional[DeviceGrid] = None,
):
    """DataFrame front door with the reference extractor's API shape: one
    row per file, the feature columns and 'filename'. A file that cannot be
    read, or whose basename repeats an earlier one, is dropped with a logged
    error. ``extractor`` defaults to a new one for ``config`` on ``device``
    (the grid's lead device with ``mesh``, over which the batches split)."""
    import struct

    import pandas as pd

    from ..audio.io import load_mono_16k

    if extractor is None:
        extractor = OpenSmileExtractor(config, device=device if mesh is None else mesh.lead)
    ex = extractor
    if input_df.empty:
        return pd.DataFrame(columns=["filename"] + feature_columns(config.reference_compat))

    wavs: Dict[str, np.ndarray] = {}
    for path in input_df[audio_file_column]:
        name = os.path.basename(path)
        if name in wavs:
            if verbose:
                print(f"ERROR: duplicate basename '{name}' (from '{path}'); row dropped — "
                      "filenames must be unique (reference keys rows by basename).")
            continue
        if waveforms is not None and name in waveforms:
            wavs[name] = np.asarray(waveforms[name])
            continue
        try:
            wavs[name] = load_mono_16k(path)
        except (OSError, ValueError, struct.error) as e:
            if verbose:
                print(f"ERROR: could not read '{name}': {e}")
    return ex.extract(wavs, verbose=verbose, mesh=mesh)
