"""Tracing and profiling helpers: the port of
``molann_tpu/utils/profiling.py`` over ``torch.profiler``.

``annotate`` names a region in the profiler's timeline (and, with a CUDA
card, in NVTX for external tools); ``capture_trace`` records a Chrome
trace of the host and the card into a directory (open it in Perfetto or
``chrome://tracing``); ``ThroughputMeter`` counts frames per second.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["annotate", "capture_trace", "ThroughputMeter"]


@contextlib.contextmanager
def annotate(label: str):
    """Named trace region::

        with annotate("train_step"):
            model, opt, loss = step(model, opt, batch)
    """
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(label)
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Record the host's and, where there is one, the card's activity into
    ``<log_dir>/trace.json`` (Chrome trace format)::

        with capture_trace("traces"):
            run_steps()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """Running frames/sec counter.

    ``update(n_frames)`` after each synchronised step; ``rate`` is the
    exponentially smoothed frames/sec, ``mean_rate`` the lifetime mean.
    """

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.rate = 0.0
        self._total_frames = 0
        self._t_start = None
        self._t_last = None

    def update(self, n_frames: int):
        now = time.perf_counter()
        if self._t_start is None:
            self._t_start = self._t_last = now
            return
        dt = now - self._t_last
        self._t_last = now
        self._total_frames += n_frames
        if dt > 0:
            inst = n_frames / dt
            self.rate = (
                inst
                if self.rate == 0.0
                else self.smoothing * self.rate + (1 - self.smoothing) * inst
            )

    @property
    def mean_rate(self) -> float:
        if self._t_start is None or self._t_last == self._t_start:
            return 0.0
        return self._total_frames / (self._t_last - self._t_start)
