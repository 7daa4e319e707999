"""Instrumentation, logging and reliability helpers."""

from .logging import get_logger
from .profiling import ThroughputMeter, count, counters, span, span_report, spanned, stage_timer, tracing
from .reliability import deterministic_check, with_oom_downshift

__all__ = [
    "ThroughputMeter",
    "stage_timer",
    "span",
    "span_report",
    "spanned",
    "count",
    "counters",
    "tracing",
    "get_logger",
    "deterministic_check",
    "with_oom_downshift",
]
