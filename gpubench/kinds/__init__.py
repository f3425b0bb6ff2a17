"""Drivers, one per traffic ``kind``, and what they share.

``UnitClock`` keeps the window: set-up ends, and the window starts, at
the completion of the last warm-up unit; every later completion is in the
window; the first completion at least ``seconds`` after the start ends
it. No rate is taken from anything but completions.
"""
from __future__ import annotations

import time

import torch

from ..reference.net import make_weights


class UnitClock:
    def __init__(self, warmup: int, seconds: float, t_start: float):
        if warmup < 1:
            raise ValueError("a traffic mix warms up at least one unit")
        self.warmup, self.seconds, self.t_start = warmup, seconds, t_start
        self.done = []
        self.t_first = self.setup_s = None

    def complete(self) -> bool:
        """Record a completion; False once the window is over."""
        t = time.perf_counter()
        self.done.append(t)
        if len(self.done) == self.warmup:
            self.t_first = t
            self.setup_s = time.time() - self.t_start
        return not (self.t_first is not None and t - self.t_first >= self.seconds)

    @property
    def units(self) -> range:
        """Indices of the units completed in the window."""
        return range(self.warmup, len(self.done))

    @property
    def window_s(self) -> float:
        return self.done[-1] - self.t_first


def build_module(model_cls, cfg, seed: int, device):
    """The program's module with the benchmark's seeded weights, made on
    ``device`` without a host-side init."""
    with torch.device("meta"):
        net = model_cls(in_nc=cfg["n_channel"], out_nc=cfg["n_channel"],
                        n_feature=cfg["n_feature"], depth=cfg["depth"],
                        noise=cfg["noise"])
    net = net.to_empty(device=device)
    net.load_state_dict(make_weights(cfg, seed, device))
    return net


def event_pair(cuda: bool):
    if not cuda:
        return None
    pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    pair[0].record()
    return pair


def device_ms(pairs):
    """Each unit's device time from its CUDA event pair (None on the CPU)."""
    return [a.elapsed_time(b) if a is not None else None
            for a, b in ((p or (None, None)) for p in pairs)]


def quartiles(values):
    import statistics

    vals = [v for v in values if v is not None]
    return statistics.quantiles(vals, n=4) if len(vals) >= 2 else None


def memory_peak(cuda: bool, device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if cuda else 0


def free(cuda: bool):
    import gc

    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
