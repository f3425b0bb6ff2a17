"""Timing and trace capture (counterpart of ``image_denoising_tpu/utils/profiling.py``).

``StepTimer`` is a wall-clock step timer with an exponential moving
average. ``with trace(dir):`` records a ``torch.profiler`` trace of the block, with
CPU and, where a card is present, CUDA activity, and writes it into ``dir``
as a TensorBoard / Chrome trace file (``*.pt.trace.json``).
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["StepTimer", "trace"]


class StepTimer:
    """Wall-clock step timer with an exponential moving average.

    Kernels run asynchronously: a ``step()`` interval measures the host's
    launch time unless the caller synchronises (``torch.cuda.synchronize``
    or a fetched value) before it; :func:`trace` gives the device's times.
    """

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg = None
        self.last = None
        self._t0 = time.perf_counter()

    def step(self) -> float:
        """Seconds since the last step (or construction); updates ``avg``."""
        now = time.perf_counter()
        self.last = now - self._t0
        self._t0 = now
        self.avg = (self.last if self.avg is None
                    else self.ema * self.avg + (1 - self.ema) * self.last)
        return self.last

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else float("nan")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()  # the block's kernels end inside the trace
