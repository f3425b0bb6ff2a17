"""A whole run on the CPU at a tiny size: the result line's keys, the
window's bookkeeping, and a run with the timed path broken underneath
coming out not correct, once for each fault the cell can have."""
import time

import pytest
import torch

from gpubench import harness
from gpubench.kinds import structure_step, tiled_burst

from ._tiny import tiny_cell

CELLS = ("e2_bf16_burst8", "e2_f32_burst8", "train_structure_f32_b4")


def _run(workload, trace=False, seconds=1.0):
    return harness.run_cell(tiny_cell(workload), 2 ** 31 + 5, seconds, trace, "cpu",
                            time.time())


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_result_line(workload):
    r = _run(workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    cell = harness.load_cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(cell.limits)
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("workload", ["e2_f32_burst8", "train_structure_f32_b4"])
def test_traced_result_line(workload):
    r = _run(workload, trace=True, seconds=4.0)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _answer_altered(monkeypatch):
    real = tiled_burst.make_tiled_pyramid_runner_frames

    def factory(*a, **k):
        run = real(*a, **k)

        def swapped(frames):
            out, l1 = run(frames)
            return out.roll(1, dims=0), l1
        return swapped
    monkeypatch.setattr(tiled_burst, "make_tiled_pyramid_runner_frames", factory)


def _one_tile_altered(monkeypatch):
    """Each forward call's first tile raised by 8 levels: a fault in one
    tile of a chunk, too small a share of the window to move its means."""
    real = tiled_burst.make_forward

    def factory(*a, **k):
        fwd = real(*a, **k)

        def altered(tiles):
            out = fwd(tiles)
            return torch.cat([out[:1] + 8 / 255, out[1:]])
        return altered
    monkeypatch.setattr(tiled_burst, "make_forward", factory)


def _state_unchanged(monkeypatch):
    real = structure_step.make_structure_train_step

    def factory(net, state, **k):
        state.optimizer.step = lambda *a, **kw: None
        return real(net, state, **k)
    monkeypatch.setattr(structure_step, "make_structure_train_step", factory)


def _half_batch(monkeypatch):
    real = structure_step.make_structure_train_step

    def factory(net, state, **k):
        step = real(net, state, **k)
        return lambda clean, noisy: step(clean[: len(clean) // 2], noisy[: len(noisy) // 2])
    monkeypatch.setattr(structure_step, "make_structure_train_step", factory)


@pytest.mark.parametrize("workload,fault,fails", [
    ("e2_bf16_burst8", _answer_altered, None), ("e2_f32_burst8", _answer_altered, None),
    ("e2_bf16_burst8", _one_tile_altered, "tile_mean_levels_max"),
    ("e2_f32_burst8", _one_tile_altered, "tile_off1_max"),
    ("train_structure_f32_b4", _state_unchanged, None),
    ("train_structure_f32_b4", _half_batch, None)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault, fails):
    """``fails``: the number that has to catch the fault, where one does."""
    fault(monkeypatch)
    r = _run(workload)
    assert r["correct"] is False
    failed = {name for name, c in r["checks"].items() if c["value"] > c["limit"]}
    assert failed and (fails is None or fails in failed)


def test_window_opens_and_closes_at_completions():
    from gpubench.kinds import UnitClock

    clock = UnitClock(3, 0.05, time.time())
    going = [clock.complete() for _ in range(3)]
    assert going == [True, True, True] and clock.setup_s is not None
    while clock.complete():
        time.sleep(0.01)
    assert clock.window_s >= 0.05 and clock.units == range(3, len(clock.done))
    assert clock.window_s == clock.done[-1] - clock.done[2]


def test_nearest_rank_percentile():
    vals = list(range(1, 201))
    assert harness.nearest_rank(vals, 95) == 190
    assert harness.nearest_rank([5.0], 95) == 5.0


def test_judge_fails_missing_and_nan():
    ok, checks = harness.judge({"a": 1.0, "b": 2.0}, {"a": 0.5})
    assert not ok and list(checks) == ["a", "b"]
    assert not harness.judge({"a": 1.0}, {"a": float("nan")})[0]
    assert harness.judge({"a": 1.0}, {"a": 1.0})[0]

