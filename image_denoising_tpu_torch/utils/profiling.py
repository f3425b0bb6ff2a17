"""Timing, trace capture, and the program's own spans and counters
(counterpart of ``image_denoising_tpu/utils/profiling.py``).

``StepTimer`` is a wall-clock step timer with an exponential moving
average. ``with trace(dir):`` records a ``torch.profiler`` trace of the block, with
CPU and, where a card is present, CUDA activity, and writes it into ``dir``
as a TensorBoard / Chrome trace file (``*.pt.trace.json``).

**Spans and counters.** ``span(name, device=None, unit=None)`` marks a phase
of the work and ``count(name, n=1)`` adds to a counter; ``record()`` returns
what they recorded and ``reset()`` empties it. The gate: both do nothing
unless a ``torch.profiler`` is recording (``_profiler_enabled()``, true only
in a profiler's active phase). There is no flag and no environment
variable. Off, ``span`` is that one check and returns a shared no-op
context: it allocates nothing and makes no CUDA call. On, a span enters
``torch.profiler.record_function(name)``, so it sits in the profiler's trace
on the trace's clock, and appends an entry to the in-memory record: its
name, its parent entry, its unit (a burst's or a step's index, set by the
outermost span of the loop and inherited by the spans inside it) and its
host start and end (``time.perf_counter_ns``). Given a CUDA ``device``, it
also records a pair of timing events on that device's current stream; its
device time is read by ``record()`` once the events have completed, so
only after the caller synchronises, and is None before that and on the CPU.
The record keeps the last ``KEEP`` entries, and ``trace()`` empties it when
it starts, so a long profiled run holds a bounded record.

Host times are wall times: they include any time the host waits for the
device inside the span (a full launch queue, a pageable copy that waits
for the stream), so they are not the host's own work alone.

The spans (``*``: device-timed) and counters of the program:

- ``cli/common.py::iter_bursts``: ``burst`` (unit: the burst's index in
  the stream), inside it ``burst.load`` (frames read, stacked, padded) and
  ``burst.submit`` (the runner call). Counters ``burst.queued`` and
  ``burst.sampled`` (``Backlog``): at each submit, the recorded bursts
  still queued on the device, past the record's first ``max_inflight − 1``.
- ``eval/tiled.py::_run_frames`` and ``_run_hann_frames``: ``tiled.frames``*
  (to the device and to float), ``tiled.gather``*, ``tiled.retrieve``
  (``pre_tile_fn``, Hann only), ``tiled.forward`` (the chunked forward with
  its pad and cat), ``tiled.l1``* (the predictions cast to float32 and the
  tiles' L1; pyramid only), ``tiled.blend``*, ``tiled.quantize``*.
- ``models/fused_forward.py::_res_tail``: counter ``forward.gn_tail``, 1 for
  each ResBlock tail whose GroupNorm runs on the kernel pair
  (``ops/group_norm.py``, CUDA only): 9 an ImprovedUNet forward, 81 an E2
  burst of 9 chunks.
- ``models/restormer.py::Restormer.forward``: ``restormer.enc1``*,
  ``restormer.enc2``*, ``restormer.enc3``*, ``restormer.latent``*,
  ``restormer.dec3``*, ``restormer.dec2``*, ``restormer.dec1``*,
  ``restormer.refine``*, one around each stage's transformer blocks (the
  embed, the samplers, the reduce convs, the concatenations and the output
  conv fall outside them): 72 an E2 burst of 9 chunks. Counter
  ``restormer.tiles``: the tiles each forward carries.
- ``ops/layer_norm.py::add_ln``: counter ``restormer.add_ln``, 1 at
  each launch of the residual add and norm kernel (CUDA only), which
  Restormer's blocks run without autograd
  (``models/restormer.py::BiasFreeLayerNorm.add_forward``): 88 a forward
  (44 blocks, two norms each), 792 an E2 burst.
- ``train/steps.py::make_structure_train_step`` and
  ``make_n2n_train_step``: ``train.step``* (unit: the step's index for
  this step function), inside it ``train.step.input``,
  ``train.step.forward``, ``train.step.loss``, ``train.step.backward``,
  ``train.step.optimizer``. Counters ``train.step.queued`` and
  ``train.step.sampled``: at each step's start, the recorded steps still
  queued on the device, past the record's first.

A burst's end on the device is the last device-timed span inside its
``burst.submit``; a step's is the ``train.step`` span's own end event.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

__all__ = ["Backlog", "StepTimer", "count", "record", "reset", "span", "trace"]


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
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``,
    the program's spans included; empties their record first."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()  # the block's kernels end inside the trace


_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
KEEP = 1024
# the record: the last KEEP entries in the order they opened, the open
# ones, the counters
_spans: collections.deque = collections.deque(maxlen=KEEP)
_open: list = []
_counters: dict = {}


class _Span:
    """One entry of the record, and the context that fills it in."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "events", "last_end",
                 "_device", "_range")

    def __init__(self, name, device, unit):
        parent = _open[-1] if _open else None
        self.name, self.parent = name, parent
        self.unit = unit if unit is not None or parent is None else parent.unit
        self.start_ns = self.end_ns = None
        self.events = self.last_end = None
        self._device = device if getattr(device, "type", None) == "cuda" else None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _spans.append(self)
        _open.append(self)
        if self._device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self._device))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            end = self.events[1]
            end.record(torch.cuda.current_stream(self._device))
            for entry in _open:  # this span and every span it ran inside
                entry.last_end = end
        _open.pop()
        self._range.__exit__(*exc)
        return False

    def device_ms(self):
        """Device milliseconds between the span's events once both have
        completed; None before that and without events."""
        if self.events is None or not self.events[1].query():
            return None
        return self.events[0].elapsed_time(self.events[1])


def span(name: str, device=None, unit=None):
    """Context manager of one phase, recorded only while a profiler records.

    ``device``: the ``torch.device`` the phase's work runs on; a CUDA device
    times it with events on its current stream. ``unit``: the burst or step
    index, given by the loop's outermost span. Yields the record's entry, or
    None while nothing records.
    """
    if not _recording():
        return _OFF
    return _Span(name, device, unit)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _counters[name] = _counters.get(name, 0) + n


def record() -> dict:
    """What was recorded since the last ``reset()``: ``spans``, a list of
    the last ``KEEP`` entries, each {name, parent (index in the list, or
    None where the parent is not in it), unit, start_ns, end_ns,
    device_ms}, and ``counters`` {name: total}."""
    index = {id(s): i for i, s in enumerate(_spans)}
    spans = [{"name": s.name, "parent": index.get(id(s.parent)), "unit": s.unit,
              "start_ns": s.start_ns, "end_ns": s.end_ns, "device_ms": s.device_ms()}
             for s in _spans]
    return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Empty the record and the counters."""
    _spans.clear()
    _counters.clear()


class Backlog:
    """How deep the device queue behind a loop of units really is.

    ``sample()`` at a unit's start adds, while a profiler records, to
    ``<name>.queued`` the earlier recorded units whose work has not yet
    completed on the device (``Event.query()`` on each one's last end event)
    and 1 to ``<name>.sampled``, past the record's first ``skip`` units
    (and its first one), which have fewer recorded units before them than
    a full queue. ``add(entry)`` after the unit's span has closed.
    """

    def __init__(self, name: str, skip: int = 0):
        self.queued, self.sampled = f"{name}.queued", f"{name}.sampled"
        self.skip = max(skip, 1)
        self.pending, self.seen = [], 0

    def sample(self) -> None:
        if self.seen < self.skip or not _recording():
            return
        self.pending = [e for e in self.pending if not e.query()]
        count(self.queued, len(self.pending))
        count(self.sampled)

    def add(self, entry) -> None:
        if entry is not None and entry.last_end is not None:
            self.pending.append(entry.last_end)
            self.seen += 1
