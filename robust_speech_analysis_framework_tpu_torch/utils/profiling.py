"""Throughput counters, stage timers, and the port's spans and counters.

Counterpart of ``robust_speech_analysis_framework_tpu/utils/profiling.py``:

* :class:`ThroughputMeter`: seconds, audio seconds and items per pipeline
  stage (audio-seconds per second is the extraction headline);
* :func:`stage_timer`: a block timed into a meter; ``sync`` (a tensor, or
  lists/tuples/dicts of them) waits for the CUDA devices those tensors lie
  on before the clock stops, and for nothing on the CPU;
* :func:`span` / :func:`count`: a named region and a named counter at a
  layer boundary of the program (extraction, training, fetches, serving);
  :func:`spanned` makes every call of a function a span.
  They record only while tracing is on: inside a :func:`tracing` block, or
  while a ``torch.profiler`` records. Off, a span is one shared no-op
  context manager (two flag reads, no clock, no allocation) and a count
  adds nothing. On, a span adds its wall time to its name and to its
  parent's children (a stack per thread, so spans opened in worker threads
  are roots of their own thread); while the profiler records it also opens
  ``record_function(name)``, so its interval lies in the profiler's trace,
  on the kernels' clock, where the benchmark's ``port_bench/spans.py``
  reads it;
* :func:`span_report` / :func:`counters`: what the spans and counters
  recorded, for an operator who wraps a run in :func:`tracing`.

The JAX package's ``span`` is always on and has no parents; this one is
off unless asked for, so the program's hot loops may carry it.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Callable, Dict, Iterator, List, Optional, Set

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


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
    t0 = perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            synchronize(sync)
        if meter is not None:
            meter.add(stage, perf_counter() - t0, audio_seconds, items)


# --- spans and counters ---------------------------------------------------------

_tracing = 0  # open tracing() blocks
_lock = threading.Lock()  # guards _tracing and the tables below
_local = threading.local()  # .stack: this thread's open spans
_spans: Dict[str, List[float]] = {}  # name -> [calls, seconds, self seconds]
_counts: Dict[str, int] = {}
_OFF = contextlib.nullcontext()  # every span while tracing is off


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans and counters inside the block (blocks may nest, and
    may be open in several threads)."""
    global _tracing
    with _lock:
        _tracing += 1
    try:
        yield
    finally:
        with _lock:
            _tracing -= 1


class _Span:
    __slots__ = ("name", "start", "children", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.children = 0.0
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.start = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        wall = perf_counter() - self.start
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children += wall
        with _lock:
            row = _spans.get(self.name)
            if row is None:
                row = _spans[self.name] = [0, 0.0, 0.0]
            row[0] += 1
            row[1] += wall
            row[2] += wall - self.children


def span(name: str):
    """A context manager that times the block as ``name`` while tracing is
    on (see the module's docstring), and the shared no-op otherwise."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: every call of the function is the span ``name``."""

    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return decorate


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def span_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """{name: {calls, seconds, self_seconds}} of the spans recorded since
    the process started (or the last reset), largest first; a span's self
    seconds are its wall less that of the spans opened directly inside it
    on its thread."""
    with _lock:
        out = {name: {"calls": int(c), "seconds": s, "self_seconds": own}
               for name, (c, s, own) in sorted(_spans.items(), key=lambda kv: -kv[1][1])}
        if reset:
            _spans.clear()
    return out


def counters(reset: bool = False) -> Dict[str, int]:
    """{name: total} of the counters recorded since the process started (or
    the last reset)."""
    with _lock:
        out = dict(_counts)
        if reset:
            _counts.clear()
    return out
