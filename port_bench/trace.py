"""The traced run: one ``torch.profiler`` trace of the whole measured window,
reduced to what the per-layer readers and the result's ``breakdown`` need.

The device's busy time is the union of its kernel and copy intervals inside
the window (a copy of the smoke test's ``_union_us``); kernel sums by name
follow its ``_device_rows``. An idle gap is a stretch of the window with
nothing on the device, named by the innermost host op under way at its
middle (``python`` where no op was).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

WINDOW = "port_bench:window"
NAME_CHARS = 160  # a breakdown entry's name, cut to this many characters


def union_us(intervals, lo, hi) -> float:
    """Microseconds of [lo, hi] covered by the union of the intervals."""
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if cur_b is None or a > cur_b:
            busy += 0.0 if cur_b is None else cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return busy + (0.0 if cur_b is None else cur_b - cur_a)


def gaps_us(intervals, lo, hi) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def device_us(e) -> float:
    """An event's device time in its subtree (the attribute's name moved
    between torch releases)."""
    value = getattr(e, "device_time_total", None)
    return value if value is not None else getattr(e, "cuda_time_total", 0.0)


@dataclass
class Trace:
    """The window's reduction. Times in microseconds from the window's start."""

    lo: float
    hi: float
    kernels: List[Tuple[str, float, float]]  # device kernels and copies
    host_ops: List[Tuple[str, int, float, float]]  # (name, thread, start, end), sorted by start
    launchers: List[Optional[Tuple[int, float]]] = field(repr=False, default_factory=list)
    """each kernel's launch: the (thread, time) of the host call that queued it, if seen"""

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(a, b) for _, a, b in self.kernels], self.lo, self.hi) / 1e6

    def kernel_s(self, match) -> float:
        """Seconds of the kernels whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.kernels if match(n)) / 1e6

    def kernel_count(self) -> int:
        return sum(1 for n, _, _ in self.kernels if not n.startswith(("Memcpy", "Memset")))

    def op_device_s(self, names: Sequence[str]) -> Optional[float]:
        """Device seconds of the kernels queued from inside the host ops named
        ``names`` (the profiler's attribution of a kernel to the ops under way
        on the thread that launched it); None where no such op ran."""
        wanted = set(names)
        outer: Dict[int, List[List[float]]] = {}
        for _, thread, a, b in sorted((s for s in self.host_ops if s[0] in wanted),
                                      key=lambda s: (s[1], s[2])):
            spans = outer.setdefault(thread, [])
            if spans and a <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], b)
            else:
                spans.append([a, b])
        if not outer:
            return None
        starts = {t: [a for a, _ in spans] for t, spans in outer.items()}
        total = 0.0
        for (_, a, b), launch in zip(self.kernels, self.launchers):
            if launch is None or launch[0] not in outer:
                continue
            thread, t = launch
            i = bisect.bisect_right(starts[thread], t) - 1
            if i >= 0 and t <= outer[thread][i][1]:
                total += b - a
        return total / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_kernel: Dict[str, float] = collections.defaultdict(float)
        for n, a, b in self.kernels:
            by_kernel[n[:NAME_CHARS]] += (min(b, self.hi) - max(a, self.lo)) / 1e6
        starts = [a for _, _, a, _ in self.host_ops]
        by_host: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps_us([(x, y) for _, x, y in self.kernels], self.lo, self.hi):
            by_host[self._host_op_at(starts, (a + b) / 2)[:NAME_CHARS]] += (b - a) / 1e6
        return {"device_ops": _top(by_kernel, top), "idle_gaps": _top(by_host, top)}

    def _host_op_at(self, starts: List[float], t: float, reach: int = 4000) -> str:
        """The innermost host op under way at ``t``: of the ops that cover it,
        the one that started last (looking back ``reach`` ops at most)."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            name, _, a, b = self.host_ops[j]
            if a <= t <= b:
                return name
        return "python"


def _top(sums: Dict[str, float], top: int) -> list:
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def profiled() -> Iterator[dict]:
    """Profile the block (CPU and CUDA activity); on exit the yielded dict
    holds ``trace``, the reduction of the block marked as the window. The
    profiler's raw events are read as they are: building its event tree
    costs minutes for a window of some hundred thousand kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
    out["trace"] = reduce(prof)


def reduce(prof) -> Trace:
    """The window of a finished ``torch.profiler.profile``, from its raw events."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU)
    base = window.start_ns()
    device, host, launch_at = [], [], {}
    for e in events:
        name = e.name()
        if name == WINDOW or e.is_user_annotation() and e.device_type() != DeviceType.CPU:
            continue
        if e.device_type() == DeviceType.CPU:
            a, b = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
            host.append((name, e.start_thread_id(), a, b))
            if name.startswith("cu"):  # a CUDA runtime or driver call, which queues device work
                launch_at[e.correlation_id()] = (e.start_thread_id(), a)
        elif e.device_type() == DeviceType.CUDA:
            device.append(e)
    kernels = [(e.name(), (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3) for e in device]
    launchers = [launch_at.get(e.correlation_id()) for e in device]
    host.sort(key=lambda s: s[2])
    return Trace(0.0, (window.end_ns() - base) / 1e3, kernels, host, launchers)
