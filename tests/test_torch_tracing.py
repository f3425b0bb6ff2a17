"""The port's own spans and counters (``utils/profiling.py``): nothing is
recorded unless a profiler records, the outputs are the same either way,
and under a profiler every span of the burst loop, the tiled engines and
the structure step is recorded once per burst or step, under its parent,
with its unit, and in the profiler's trace on the trace's clock."""
import glob
import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from image_denoising_tpu_torch.cli.common import iter_bursts
from image_denoising_tpu_torch.eval.tiled import (make_tiled_hann_runner_frames,
                                                  make_tiled_pyramid_runner_frames)
from image_denoising_tpu_torch.models.improved_unet import ImprovedUNet
from image_denoising_tpu_torch.train.state import create_train_state
from image_denoising_tpu_torch.ops import AugmentNoise
from image_denoising_tpu_torch.train.steps import make_n2n_train_step, make_structure_train_step
from image_denoising_tpu_torch.utils import profiling

# span: its parent's name
BURST_SPANS = {"burst": None, "burst.load": "burst", "burst.submit": "burst",
               "tiled.frames": "burst.submit", "tiled.gather": "burst.submit",
               "tiled.forward": "burst.submit", "tiled.l1": "burst.submit",
               "tiled.blend": "burst.submit", "tiled.quantize": "burst.submit"}
HANN_SPANS = ("tiled.frames", "tiled.gather", "tiled.retrieve", "tiled.forward",
              "tiled.blend", "tiled.quantize")
STEP_SPANS = {"train.step": None, **{f"train.step.{p}": "train.step" for p in
                                     ("input", "forward", "loss", "backward", "optimizer")}}
N_BURSTS, FB, HW = 3, 2, 64
N_STEPS = 2


@pytest.fixture(autouse=True)
def fresh_record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _net(seed=0):
    torch.manual_seed(seed)
    return ImprovedUNet(in_nc=1, out_nc=1, n_feature=8)


def _frames():
    return np.random.default_rng(7).integers(0, 256, (N_BURSTS * FB, HW, HW), np.uint8)


def _serve():
    """Three bursts of two 64² frames through ``iter_bursts`` and the
    pyramid runner in 32² tiles, chunks of 4: [(frames, L1)] on the host."""
    net = _net().eval()
    frames = _frames()

    def make_runner(h, w):
        return make_tiled_pyramid_runner_frames(lambda t: net(t), FB, h, w, 32, 16, batch=-4,
                                                out_dtype="uint8_floor", device="cpu")

    stream = iter_bursts({(HW, HW): range(len(frames))}, lambda j: frames[j], FB,
                         make_runner, max_inflight=3)
    return [(out.numpy(), l1.numpy()) for _, (out, l1), _ in stream]


def _train():
    """Two structure steps at batch 2 of 32² pairs: (losses, parameters)."""
    net = _net(1)
    state = create_train_state(net, lr=3e-4)
    step = make_structure_train_step(net, state)
    rng = np.random.default_rng(3)
    losses = []
    for _ in range(N_STEPS):
        clean = rng.integers(0, 256, (2, 32, 32, 1), np.uint8)
        noisy = rng.integers(0, 256, (2, 32, 32, 1), np.uint8)
        losses.append(step(clean, noisy)["loss"].item())
    return losses, {k: p.detach().clone() for k, p in net.named_parameters()}


def _train_n2n():
    """Two N2N steps at batch 2 of 32² frames, noise drawn in the step:
    (losses, parameters)."""
    net = _net(4)
    state = create_train_state(net, lr=3e-4)
    step = make_n2n_train_step(net, state, noise_fn=AugmentNoise("gauss25").add_train_noise)
    rng = np.random.default_rng(5)
    losses = []
    for i in range(N_STEPS):
        clean = rng.integers(0, 256, (2, 32, 32, 1), np.uint8)
        losses.append(step(clean, None, 1000 + i, 1)["loss"].item())
    return losses, {k: p.detach().clone() for k, p in net.named_parameters()}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _by_unit(rec, names):
    """{unit: {name: [parent name, ...]}} of the spans named in ``names``."""
    spans = rec["spans"]
    out = {}
    for s in spans:
        if s["name"] in names:
            parent = spans[s["parent"]]["name"] if s["parent"] is not None else None
            out.setdefault(s["unit"], {}).setdefault(s["name"], []).append(parent)
    return out


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    _serve()
    _train()
    profiling.count("burst.queued", 3)
    assert profiling.record() == {"spans": [], "counters": {}}
    off = profiling.span("x")
    assert off is profiling.span("y", torch.device("cpu"), unit=4)
    with off as entry:
        assert entry is None


def test_bursts_identical_with_the_profiler_on_and_off():
    off = _serve()
    on = _profiled(_serve)
    assert len(off) == len(on) == N_BURSTS
    for (a, la), (b, lb) in zip(off, on):
        assert a.dtype == np.uint8 and np.array_equal(a, b) and np.array_equal(la, lb)
    assert profiling.record()["spans"]


def test_steps_identical_with_the_profiler_on_and_off():
    losses_off, params_off = _train()
    losses_on, params_on = _profiled(_train)
    assert losses_off == losses_on
    assert all(torch.equal(params_off[k], params_on[k]) for k in params_off)
    assert profiling.record()["spans"]


def test_every_burst_span_once_per_burst_under_its_parent():
    _profiled(_serve)
    got = _by_unit(profiling.record(), BURST_SPANS)
    assert sorted(got) == list(range(N_BURSTS))
    for unit, names in got.items():
        assert names == {name: [parent] for name, parent in BURST_SPANS.items()}, unit


def test_every_step_span_once_per_step_under_its_parent():
    _profiled(_train)
    got = _by_unit(profiling.record(), STEP_SPANS)
    assert sorted(got) == list(range(N_STEPS))
    for unit, names in got.items():
        assert names == {name: [parent] for name, parent in STEP_SPANS.items()}, unit


def test_n2n_steps_identical_with_the_profiler_on_and_off():
    losses_off, params_off = _train_n2n()
    losses_on, params_on = _profiled(_train_n2n)
    assert losses_off == losses_on
    assert all(torch.equal(params_off[k], params_on[k]) for k in params_off)


def test_every_n2n_step_span_once_per_step_under_its_parent():
    _profiled(_train_n2n)
    got = _by_unit(profiling.record(), STEP_SPANS)
    assert sorted(got) == list(range(N_STEPS))
    for unit, names in got.items():
        assert names == {name: [parent] for name, parent in STEP_SPANS.items()}, unit


def test_hann_engine_spans_with_its_retrieval():
    net = _net(2).eval()
    run = make_tiled_hann_runner_frames(lambda t: net(t[:, :1]), 2, 48, 48, 32, 16,
                                        batch=-3, out_dtype="uint8_round",
                                        pre_tile_fn=lambda t: torch.cat([t, t], 1),
                                        device="cpu")
    frames = _frames()[:2, :48, :48]
    off = run(frames)
    on = _profiled(lambda: run(frames))
    assert torch.equal(off, on)
    spans = profiling.record()["spans"]
    assert [s["name"] for s in spans] == list(HANN_SPANS)
    assert all(s["parent"] is None and s["unit"] is None for s in spans)


def test_program_spans_sit_in_the_trace_on_its_clock(tmp_path):
    """Every program span is a ``user_annotation`` of the Chrome trace,
    inside the outer range that encloses the run, as often as recorded."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            _serve()
            _train()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (outer,) = [e for e in events if e["name"] == "outer"]
    t0, t1 = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    recorded = [s["name"] for s in profiling.record()["spans"]]
    for name in {**BURST_SPANS, **STEP_SPANS}:
        mine = [e for e in events if e["name"] == name]
        assert len(mine) == recorded.count(name) > 0, name
        assert all(t0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= t1
                   for e in mine), name


def test_host_times_nest_and_device_times_are_none_on_the_cpu():
    _profiled(lambda: (_serve(), _train()))
    rec = profiling.record()
    spans = rec["spans"]
    assert rec["counters"] == {}  # no device events, no queue to sample
    for s in spans:
        assert s["device_ms"] is None
        assert 0 < s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]


def test_reset_empties_the_record():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            profiling.count("c", 2)
    assert len(profiling.record()["spans"]) == 1
    assert profiling.record()["counters"] == {"c": 2}
    profiling.reset()
    assert profiling.record() == {"spans": [], "counters": {}}


def test_the_record_keeps_its_last_entries(monkeypatch):
    """Past ``KEEP`` entries the oldest go; a parent that went reads None."""
    monkeypatch.setattr(profiling, "_spans", profiling.collections.deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", unit=0):
            for i in range(5):
                with profiling.span(f"inner{i}"):
                    pass
    spans = profiling.record()["spans"]
    assert [s["name"] for s in spans] == ["inner1", "inner2", "inner3", "inner4"]
    assert all(s["parent"] is None and s["unit"] == 0 for s in spans)


def test_trace_starts_with_an_empty_record(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            profiling.count("c")
    with profiling.trace(str(tmp_path)):
        with profiling.span("inside"):
            pass
    rec = profiling.record()
    assert rec["counters"] == {}
    assert [s["name"] for s in rec["spans"]] == ["inside"]


def test_the_gate_is_the_profilers_active_phase():
    sched = schedule(wait=1, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU], schedule=sched) as prof:
        for phase in ("wait", "warmup", "active", "done"):
            with profiling.span(phase):
                pass
            prof.step()
    assert [s["name"] for s in profiling.record()["spans"]] == ["active"]


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


@pytest.mark.parametrize("skip,queued,sampled", [(2, 1 + 2, 2), (1, 1 + 1 + 2, 3)])
def test_backlog_counts_units_still_queued(skip, queued, sampled):
    """Four units: the first completes before the third starts, the others
    stay queued. Past the first ``skip`` units, each start counts the
    earlier ones still queued."""
    events = [_Event(False) for _ in range(4)]
    backlog = profiling.Backlog("burst", skip=skip)
    with profile(activities=[ProfilerActivity.CPU]):
        for i, ev in enumerate(events):
            if i == 2:
                events[0].done = True
            backlog.sample()
            backlog.add(types.SimpleNamespace(last_end=ev))
        backlog.add(None)
    assert profiling.record()["counters"] == {"burst.queued": queued,
                                              "burst.sampled": sampled}


def test_train_cli_trace_carries_the_step_spans(tmp_path):
    """``cli/train.py --profile_dir``: the written trace holds the
    structure step's spans."""
    from PIL import Image

    from image_denoising_tpu_torch.cli import train

    rng = np.random.default_rng(5)
    for sub in ("clean", "noise"):
        (tmp_path / "d" / sub).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (32, 32), np.uint8)).save(
                tmp_path / "d" / sub / f"f{i}.png")
    train.main(["--device", "cpu", "--arch", "UNetImproved", "--n_feature", "8",
                "--batchsize", "2", "--n_epoch", "1", "--max_steps_per_epoch", "1",
                "--data_dir", str(tmp_path / "d"), "--save_model_path", str(tmp_path / "o"),
                "--profile_dir", str(tmp_path / "trace")])
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    names = {e["name"] for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(STEP_SPANS) <= names
