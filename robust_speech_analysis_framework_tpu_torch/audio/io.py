"""WAV decode/encode without external audio libraries (numpy).

Copy of ``robust_speech_analysis_framework_tpu/audio/io.py:25-138``: a RIFF
parser for PCM 8/16/24/32-bit and IEEE float32/float64, mono or
multi-channel, tolerating extra chunks. :func:`load_files_mono_16k` is the
batch front door the serving path decodes files with.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Decode a WAV file.

    Returns ``(samples, sample_rate)`` where ``samples`` has shape
    ``(n_frames, n_channels)`` and integer PCM is scaled to [-1, 1) floats.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is not None and payload is not None:
            break
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", fmt, 0
    )
    if audio_format == _EXTENSIBLE:
        # WAVE_FORMAT_EXTENSIBLE: true format is the first 2 bytes of the GUID
        # in the extension (offset 24 in the fmt body).
        if len(fmt) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt, 24)

    if audio_format == _PCM:
        if bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float64) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float64) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float64) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(payload, "<f4").astype(np.float64)
        elif bits == 64:
            x = np.frombuffer(payload, "<f8")
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    if n_channels < 1:
        raise ValueError(f"{path}: invalid channel count {n_channels}")
    x = x[: (len(x) // n_channels) * n_channels].reshape(-1, n_channels)
    return x.astype(dtype), int(sample_rate)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Encode float samples in [-1, 1] as 16-bit PCM WAV."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    n_channels = pcm.shape[1]
    byte_rate = sample_rate * n_channels * 2
    data = pcm.tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF")
        fh.write(struct.pack("<I", 36 + len(data)))
        fh.write(b"WAVEfmt ")
        fh.write(
            struct.pack(
                "<IHHIIHH", 16, _PCM, n_channels, sample_rate, byte_rate, n_channels * 2, 16
            )
        )
        fh.write(b"data")
        fh.write(struct.pack("<I", len(data)))
        fh.write(data)


def load_mono_16k(path: str, target_sr: int = 16000) -> np.ndarray:
    """Decode, mixdown to mono, resample to ``target_sr``."""
    x, sr = read_wav(path)
    mono = x.mean(axis=1)
    if sr != target_sr:
        from .resample import resample_poly_np

        mono = resample_poly_np(mono, target_sr, sr)
    return mono.astype(np.float32)


def unique_basenames(paths: Sequence[str]) -> List[str]:
    """The basename of each path; raises on duplicates, since decoded audio
    is keyed by bare filename and a silent overwrite would give one file's
    audio to another."""
    names = [os.path.basename(p) for p in paths]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(
            f"duplicate basenames across input paths: {sorted(dupes)[:5]} — "
            "results are keyed by basename; disambiguate the filenames"
        )
    return names


def load_files_mono_16k(
    paths: Sequence[str], target_sr: int = 16000
) -> Dict[str, np.ndarray]:
    """Decode a list of files → {basename: mono ``target_sr`` waveform}.

    Files that cannot be read or decoded are absent from the result (the
    caller reports them). Raises on duplicate basenames
    (:func:`unique_basenames`).
    """
    out: Dict[str, np.ndarray] = {}
    for name, path in zip(unique_basenames(paths), paths):
        try:
            out[name] = load_mono_16k(path, target_sr)
        except (OSError, ValueError, struct.error):
            continue
    return out
