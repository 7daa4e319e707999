"""Instrumentation, logging and reliability helpers."""

from .logging import get_logger
from .profiling import ThroughputMeter, span, span_report, stage_timer, trace_to
from .reliability import deterministic_check, with_oom_downshift

__all__ = [
    "ThroughputMeter",
    "stage_timer",
    "span",
    "span_report",
    "trace_to",
    "get_logger",
    "deterministic_check",
    "with_oom_downshift",
]
