"""The readers of the program's own spans and counters: a tiny traced run
on the CPU reports the wall-timed ones and leaves out the device-timed
ones, each reader reduces a record as its docstring says, and a program
that keeps no record gives nothing and raises nothing."""
import time

import pytest

from gpubench import harness
from image_denoising_tpu_torch.utils import profiling

from ._tiny import tiny_cell

HOST_TIMED = {"e2_f32_burst8": "submit_wall_ms.serve",
              "train_structure_f32_b4": "step_wall_ms.train"}
DEVICE_TIMED = {"e2_f32_burst8": ("engine_ms.serve", "queued_at_submit.serve"),
                "train_structure_f32_b4": ("queued_at_step.train",)}
READERS = ("engine_ms.serve", "queued_at_submit.serve", "submit_wall_ms.serve",
           "queued_at_step.train", "step_wall_ms.train")


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("workload", sorted(HOST_TIMED))
def test_traced_cpu_run_reports_host_times_and_no_device_times(workload):
    cell = tiny_cell(workload, warmup_units=1, trace_skip=0, trace_units=1)
    r = harness.run_cell(cell, 2 ** 31 + 7, 6.0, True, "cpu", time.time())
    assert r["correct"] is True and "breakdown" in r
    assert r["metrics"][HOST_TIMED[workload]]["value"] > 0
    for name in DEVICE_TIMED[workload]:
        assert name not in r["metrics"], name


def _span(name, unit, host_ms, device_ms):
    return {"name": name, "parent": None, "unit": unit, "start_ns": 0,
            "end_ns": int(host_ms * 1e6), "device_ms": device_ms}


def test_readers_reduce_a_record(monkeypatch):
    engine = ("tiled.frames", "tiled.gather", "tiled.l1", "tiled.blend", "tiled.quantize")
    spans = [_span(n, u, 1.0, 0.5 + u) for u in (0, 1) for n in engine]
    spans += [_span("tiled.forward", 0, 9.0, 90.0)]
    spans += [_span("tiled.frames", 2, 1.0, None)]       # burst 2: not fully recorded
    spans += [_span("burst.load", u, 2.0, None) for u in (0, 1)]
    spans += [_span("burst.submit", u, 3.0 + u, None) for u in (0, 1)]
    spans += [_span("train.step", u, 40.0 + 10 * u, 100.0) for u in (0, 1, 2)]
    counters = {"burst.queued": 3, "burst.sampled": 4, "train.step.queued": 0,
                "train.step.sampled": 2}
    monkeypatch.setattr(profiling, "record", lambda: {"spans": spans, "counters": counters})
    got = {m: harness.reader(m)(None, {}) for m in READERS}
    assert got == {"engine_ms.serve": pytest.approx(5 * 1.0),
                   "queued_at_submit.serve": 0.75,
                   "submit_wall_ms.serve": pytest.approx(5.5),
                   "queued_at_step.train": 0.0,
                   "step_wall_ms.train": pytest.approx(50.0)}


def test_readers_give_none_without_a_program_record(monkeypatch):
    monkeypatch.delattr(profiling, "record")
    assert all(harness.reader(m)(None, {}) is None for m in READERS)


def test_readers_give_none_on_an_empty_record():
    assert all(harness.reader(m)(None, {}) is None for m in READERS)
