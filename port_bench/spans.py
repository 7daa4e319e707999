"""The program's own spans in a traced window, and what the device did
under them.

The program opens a ``torch.profiler.record_function`` of each span's name
while the profiler records (``utils/profiling.span``), so its spans lie
among the trace's host ops, on the kernels' clock, with their thread. Of
those ops, the program's spans are the names with the prefixes below. A
span's self intervals are its interval less those of the program's spans
opened inside it on the same thread. The idle time under a set of names is
the window's idle gaps (nothing on the device, ``trace.gaps_us``)
intersected with the union of those names' self intervals: the time the
card waited while the host was there and in no span below it.

A program without the spans (an older commit) leaves nothing to read: the
functions then return None.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import Trace, gaps_us

PREFIXES = ("w2v2.", "train.", "fetch.", "serve.")

Span = Tuple[str, int, float, float]  # (name, thread, start, end), microseconds


def program_spans(trace: Trace) -> List[Span]:
    return [s for s in trace.host_ops if s[0].startswith(PREFIXES)]


def durations_us(trace: Trace, name: str) -> List[float]:
    """The wall of each span called ``name``."""
    return [b - a for n, _, a, b in program_spans(trace) if n == name]


def self_intervals(spans: Sequence[Span]) -> Dict[str, List[Tuple[float, float]]]:
    """{name: the self intervals of its spans}: each span's interval less
    those of the spans nested in it on its thread."""
    out: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    by_thread: Dict[int, List[Span]] = collections.defaultdict(list)
    for s in spans:
        by_thread[s[1]].append(s)
    for rows in by_thread.values():
        stack: List[list] = []  # open spans: [name, end, cursor]

        def close(top):
            if top[2] < top[1]:
                out[top[0]].append((top[2], top[1]))

        for name, _, a, b in sorted(rows, key=lambda s: (s[2], -s[3])):
            while stack and stack[-1][1] <= a:
                close(stack.pop())
            if stack:
                parent = stack[-1]
                if a > parent[2]:
                    out[parent[0]].append((parent[2], a))
                parent[2] = max(parent[2], b)
            stack.append([name, b, a])
        while stack:
            close(stack.pop())
    return out


def _overlap_us(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Microseconds in both unions, ``xs`` disjoint and sorted."""
    merged: List[List[float]] = []
    for a, b in sorted(ys):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            total += min(b, merged[k][1]) - max(a, merged[k][0])
            k += 1
    return total


def idle_s(trace: Optional[Trace], names: Sequence[str]) -> Optional[float]:
    """Seconds of the window's idle gaps under the self intervals of the
    spans ``names``; None where none of them ran."""
    if trace is None:
        return None
    own = self_intervals(program_spans(trace))
    pieces = [p for n in names for p in own.get(n, ())]
    if not pieces:
        return None
    gaps = gaps_us([(a, b) for _, a, b in trace.kernels], trace.lo, trace.hi)
    return _overlap_us(gaps, pieces) / 1e6


def idle_pct(trace: Optional[Trace], names: Sequence[str]) -> Optional[float]:
    """:func:`idle_s` as a share of the window."""
    seconds = idle_s(trace, names)
    if seconds is None or trace.window_s <= 0:
        return None
    return 100.0 * seconds / trace.window_s
