"""Utilities of the port: tracing and throughput (:mod:`.profiling`)."""

from .profiling import ThroughputMeter, annotate, capture_trace  # noqa: F401

__all__ = [
    "ThroughputMeter",
    "annotate",
    "capture_trace",
]
