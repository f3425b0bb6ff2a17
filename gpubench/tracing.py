"""Host spans, the profiler capture of a traced stretch, and its reduction.

The harness marks its own calls into the program with spans (serving:
``frames``, ``submit``, ``fetch``; training: ``batch``, ``step``,
``fetch``). A unit (a burst or a step) completes when its ``fetch`` span
ends, so the traced window runs from the first profiled completion to the
last, as the timed window does. The trace is written by
``torch.profiler`` as a Chrome trace, read back and deleted.
"""
from __future__ import annotations

import contextlib
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_CATS = ("gpu_memcpy", "gpu_memset")


def spans(on: bool):
    """``span(name)``: a profiler range when ``on``, else nothing."""
    if not on:
        return lambda name: contextlib.nullcontext()
    return torch.profiler.record_function


class Capture:
    """A profiler over a stretch of the window, stepped at each completion.

    Started before a completion, it warms up over ``warmup`` completions
    (the profiler's own start-up stalls the host there) and then records
    ``skip + units + 1`` completions; ``summary()`` opens the window at
    the ``skip``-th recorded completion, since work queued before the
    recording began is not in the trace.
    """

    def __init__(self, path, host_spans, cuda: bool, skip: int, units: int,
                 warmup: int = 2):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=warmup, active=skip + units + 1,
                                        repeat=1)
        self.prof = torch.profiler.profile(activities=acts, schedule=sched,
                                           on_trace_ready=lambda prof: None)
        self.path, self.host_spans, self.cuda = str(path), tuple(host_spans), cuda
        self.skip, self.running = skip, False

    def start(self):
        self.prof.start()
        self.running = True

    def step(self):
        """Call after each completion while the capture runs."""
        if self.running:
            self.prof.step()

    def stop(self):
        if not self.running:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.running = False

    def summary(self):
        """The reduction of the recorded stretch (``summarize``)."""
        self.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return summarize(events, self.host_spans, self.skip)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, host_spans, skip: int = 0):
    """Reduce Chrome-trace events to what the per-layer readers take.

    The window runs from the end of the ``skip``-th ``fetch`` span to the
    end of the last. Returns None when it holds no unit. Times in
    seconds: ``window_s``, ``busy_s`` (union of device operations inside
    the window), ``n_units`` (completions after the first), ``ops``
    ({name: seconds}, kernels), ``copy_s`` (memcpy and memset),
    ``kernel_counts`` ({name: launches}) and ``gaps`` (idle stretches of
    the device, each named by the innermost host span running at its
    start, or ``loop`` outside them), longest first.
    """
    dev, host = [], []
    for e in events:
        if "dur" not in e or e.get("ph") != "X":
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["name"], e["cat"], t0, t1))
        elif e.get("cat") == "user_annotation" and e["name"] in host_spans:
            host.append((e["name"], t0, t1))
    ends = sorted(t1 for name, _, t1 in host if name == "fetch")[skip:]
    if len(ends) < 2:
        return None
    w0, w1 = ends[0], ends[-1]
    ops, counts, copy, clipped = {}, {}, 0.0, []
    for name, cat, t0, t1 in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        if cat in COPY_CATS:
            copy += (b - a) * 1e-6
        else:
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
            counts[name] = counts.get(name, 0) + 1
    busy = _union(clipped)
    gaps, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((_host_at(host, edge), (a - edge) * 1e-6))
        edge = max(edge, b)
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "n_units": len(ends) - 1, "ops": ops, "copy_s": copy,
            "kernel_counts": counts, "gaps": gaps}


def _host_at(host, t):
    inside = [(t1 - t0, name) for name, t0, t1 in host if t0 <= t < t1]
    return min(inside)[1] if inside else "loop"


def breakdown(summary):
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[name, s] for name, s in summary["gaps"][:10]]}


def idle_share(summary):
    """Percent of the window with no operation on the device; None where
    the trace holds no device operation."""
    if not summary["busy_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
