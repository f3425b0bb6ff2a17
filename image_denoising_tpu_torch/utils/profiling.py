"""Trace capture (counterpart of ``image_denoising_tpu/utils/profiling.py::trace``).

``with trace(dir):`` records a ``torch.profiler`` trace of the block, with
CPU and, where a card is present, CUDA activity, and writes it into ``dir``
as a TensorBoard / Chrome trace file (``*.pt.trace.json``).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["trace"]


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
