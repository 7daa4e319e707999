"""Shared pieces of the harness: precision settings, seeded generators of
inputs, and the comparison arithmetic that decides ``correct``.

Imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Mapping, Sequence

import numpy as np
import torch

SEED_MOD = 2**31 - 1  # numpy's RandomState and the program's epoch shuffles take 32-bit seeds


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A host generator for stream ``stream`` of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(
        (int(seed) * 1_000_003 + stream) % 2**63)


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """float32 matmuls and cuDNN convolutions in IEEE float32, or in TF32
    with ``tf32``; the previous settings restored on exit (torch's
    ``fp32_precision`` API only: the legacy ``allow_tf32`` flags are never
    read)."""
    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = (mm.fp32_precision, conv.fp32_precision)
    mm.fp32_precision = conv.fp32_precision = "tf32" if tf32 else "ieee"
    try:
        yield
    finally:
        mm.fp32_precision, conv.fp32_precision = saved


def fixed_lengths(spec: Mapping, seed: int, stream: int) -> List[float]:
    """Lengths in seconds of a mix: ``count`` values evenly spaced over
    ``[lo, hi]`` for each group of ``spec`` ({group: [count, lo, hi]}),
    in an order drawn from the seed. Every seed gets the same set."""
    values = []
    for count, lo, hi in spec.values():
        values += list(np.linspace(lo, hi, int(count)))
    order = rng(seed, stream).permutation(len(values))
    return [float(values[i]) for i in order]


def speech(seconds: Sequence[float], seed: int, device, sample_rate: int = 16000) -> List[np.ndarray]:
    """Speech-like 16-bit PCM waveforms of the given lengths, made on
    ``device`` in one pass and returned as float32 host arrays: 11
    harmonics of an f0 drawn from 95–230 Hz with a 3 Hz vibrato of ±1 %,
    syllables gated at 0.42 s of every 0.6 s, a little noise (the recipe of
    the framework's smoke test, ``chip_smoke._speech``)."""
    device = torch.device(device)
    n = [int(s * sample_rate) for s in seconds]
    f0 = torch.from_numpy(rng(seed, 7).uniform(95.0, 230.0, len(n))).to(device)
    file_id = torch.repeat_interleave(torch.arange(len(n), device=device),
                                      torch.tensor(n, device=device))
    starts = torch.tensor(np.cumsum([0] + n[:-1]), device=device)
    t = (torch.arange(sum(n), device=device, dtype=torch.float64) - starts[file_id]) / sample_rate
    phase = f0[file_id] * (t + 0.01 * (1 - torch.cos(2 * math.pi * 3 * t)) / (2 * math.pi * 3))
    v = sum(torch.sin(2 * math.pi * k * phase) / k for k in range(1, 12))
    peak = torch.zeros(len(n), dtype=v.dtype, device=device).scatter_reduce(
        0, file_id, v.abs(), reduce="amax")
    gate = torch.where(torch.remainder(t, 0.6) < 0.42, 1.0, 0.02)
    noise = torch.randn(sum(n), generator=device_generator(seed, 8, device), device=device,
                        dtype=torch.float64)
    x = 0.3 * gate * v / peak[file_id] + 0.002 * noise
    x = (torch.clamp(torch.round(x * 32768.0), -32768, 32767) / 32768.0).to(torch.float32).cpu()
    return [a.numpy() for a in torch.split(x, n)]


# --- comparisons -----------------------------------------------------------------


def max_rel_err(program: np.ndarray, reference: np.ndarray) -> float:
    """Largest absolute difference over the largest reference magnitude."""
    program, reference = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if program.shape != reference.shape:
        return math.inf
    scale = max(float(np.abs(reference).max(initial=0.0)), 1e-30)
    return float(np.abs(program - reference).max(initial=0.0)) / scale


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float]) -> Dict[str, float]:
    """The gap of norms of each leaf: |‖p‖ − ‖r‖| over the larger of ‖r‖
    and the median leaf's ‖r‖."""
    median = float(np.median(list(reference.values())))
    return {k: abs(program[k] - r) / max(r, median, 1e-30) for k, r in reference.items()}


def worst_leaf_gap(program: Mapping[str, float], reference: Mapping[str, float]) -> float:
    """The worst leaf's gap of norms (:func:`leaf_gaps`)."""
    gaps = leaf_gaps(program, reference)
    return max(gaps.values()) if gaps else math.inf

