"""ctypes bindings for the port's native batch WAV decoder (``native/audio_io.cc``).

Counterpart of ``robust_speech_analysis_framework_tpu/audio/native_io.py``:
:func:`decode_mono`, :func:`decode_batch_mono` (a pool of C++ threads) and
:func:`load_corpus_mono_16k` (decode, then resample to 16 kHz on the host).

The library is built at first use with ``g++`` into
``build/native/libraf_audio_<hash>.so`` beside the package (git-ignored);
the hash covers the source and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded. A failed build raises with the
compiler's message: unlike the JAX package, nothing falls back quietly to
the Python codec (``audio/io.py``), which stays for callers that choose it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .io import unique_basenames
from .resample import resample_poly_np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "audio_io.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path() -> str:
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libraf_audio_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {CXX!r} to build "
                           f"{os.path.basename(SOURCE)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {os.path.basename(SOURCE)} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never sees half a file


def load_library() -> ctypes.CDLL:
    """The loaded decoder library, built first if needed; raises if the
    build fails."""
    global _lib
    with _lock:
        if _lib is None:
            out = _library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            lib.raf_version.restype = ctypes.c_char_p
            lib.raf_decode_mono.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.raf_decode_mono.restype = ctypes.c_int
            lib.raf_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.raf_free.restype = None
            lib.raf_decode_batch_mono.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
            lib.raf_decode_batch_mono.restype = None
            _lib = lib
        return _lib


def decode_mono(path: str) -> Tuple[np.ndarray, int]:
    """Decode one WAV → (mono float32 array, sample rate); raises
    ValueError if the file cannot be read or decoded."""
    lib = load_library()
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.raf_decode_mono(os.fsencode(path), ctypes.byref(buf), ctypes.byref(n),
                             ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native decode failed for {path} (code {rc})")
    try:
        out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    finally:
        lib.raf_free(buf)
    return out, sr.value


def decode_batch_mono(
    paths: Sequence[str], n_threads: int = 8
) -> List[Optional[Tuple[np.ndarray, int]]]:
    """Decode many WAVs concurrently: per file (mono float32, sample rate),
    or None for a file that could not be read or decoded."""
    lib = load_library()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    bufs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    srs = (ctypes.c_int * n)()
    status = (ctypes.c_int * n)()
    lib.raf_decode_batch_mono(c_paths, n, bufs, lens, srs, status, n_threads)
    results: List[Optional[Tuple[np.ndarray, int]]] = []
    for i in range(n):
        if status[i] != 0 or not bufs[i]:
            results.append(None)
            continue
        try:
            arr = np.ctypeslib.as_array(bufs[i], shape=(lens[i],)).copy()
        finally:
            lib.raf_free(bufs[i])
        results.append((arr, srs[i]))
    return results


def load_corpus_mono_16k(
    paths: Sequence[str], target_sr: int = 16000, n_threads: int = 8
) -> Dict[str, np.ndarray]:
    """Batch decode + resample a list of files → {basename: mono ``target_sr``
    float32}.

    Files that fail to decode are absent from the result (callers report
    them). Raises on duplicate basenames (``audio.io.unique_basenames``).
    """
    names = unique_basenames(paths)
    out: Dict[str, np.ndarray] = {}
    for name, item in zip(names, decode_batch_mono(list(paths), n_threads)):
        if item is None:
            continue
        x, sr = item
        if sr != target_sr:
            x = resample_poly_np(x.astype(np.float64), target_sr, sr)
        out[name] = x.astype(np.float32)
    return out
