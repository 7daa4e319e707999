"""Throughput counters, stage timers, named spans and device traces.

Counterpart of ``robust_speech_analysis_framework_tpu/utils/profiling.py``:

* :class:`ThroughputMeter`: seconds, audio seconds and items per pipeline
  stage (audio-seconds per second is the extraction headline);
* :func:`stage_timer`: a block timed into a meter; ``sync`` (a tensor, or
  lists/tuples/dicts of them) waits for the CUDA devices those tensors lie
  on before the clock stops, and for nothing on the CPU;
* :func:`span` / :func:`span_report`: cumulative wall per labelled region;
* :func:`trace_to`: a ``torch.profiler`` trace of a block, written as a
  Chrome trace into a directory (the JAX package's ``jax.profiler`` XPlane).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Set

import torch


@dataclass
class StageStats:
    seconds: float = 0.0
    audio_seconds: float = 0.0
    items: int = 0

    @property
    def audio_sec_per_sec(self) -> float:
        return self.audio_seconds / self.seconds if self.seconds > 0 else 0.0


@dataclass
class ThroughputMeter:
    stages: Dict[str, StageStats] = field(default_factory=dict)

    def add(self, stage: str, seconds: float, audio_seconds: float = 0.0,
            items: int = 0) -> None:
        s = self.stages.setdefault(stage, StageStats())
        s.seconds += seconds
        s.audio_seconds += audio_seconds
        s.items += items

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stages.items()):
            rate = f"{s.audio_sec_per_sec:.1f} audio-s/s" if s.audio_seconds else ""
            lines.append(f"{name:30s} {s.seconds:8.2f}s  {s.items:6d} items  {rate}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "seconds": v.seconds,
                "audio_seconds": v.audio_seconds,
                "items": v.items,
                "audio_sec_per_sec": v.audio_sec_per_sec,
            }
            for k, v in self.stages.items()
        }


def _cuda_devices_of(tree: Any, out: Set[torch.device]) -> Set[torch.device]:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices_of(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices_of(v, out)
    return out


def synchronize(tree: Any) -> None:
    """Wait for every CUDA device that a tensor of ``tree`` lies on."""
    for dev in sorted(_cuda_devices_of(tree, set()), key=str):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage_timer(
    meter: Optional[ThroughputMeter],
    stage: str,
    audio_seconds: float = 0.0,
    items: int = 0,
    sync: Any = None,
) -> Iterator[None]:
    """Time a block into ``meter``; ``sync`` is waited for (its devices'
    queued work) before the clock stops."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            synchronize(sync)
        if meter is not None:
            meter.add(stage, time.perf_counter() - t0, audio_seconds, items)


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write ``trace.json`` (Chrome/Perfetto
    format) into ``log_dir``. Yields the profiler, whose ``key_averages()``
    the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Cumulative wall per labelled region: two perf_counter calls a span.
_SPANS: Dict[str, float] = {}
_SPAN_COUNTS: Dict[str, int] = {}


@contextlib.contextmanager
def span(label: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _SPANS[label] = _SPANS.get(label, 0.0) + dt
        _SPAN_COUNTS[label] = _SPAN_COUNTS.get(label, 0) + 1


def span_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """{label: {seconds, calls}} accumulated since the process started (or
    the last reset), largest first."""
    out = {
        k: {"seconds": v, "calls": _SPAN_COUNTS.get(k, 0)}
        for k, v in sorted(_SPANS.items(), key=lambda kv: -kv[1])
    }
    if reset:
        _SPANS.clear()
        _SPAN_COUNTS.clear()
    return out
