"""The Restormer cell at a tiny size on the CPU: a sound run is correct and
reports its end-to-end metrics, each control of ``reference/restormer.py``
and a broken timed path come out not correct, a program without the arch
fails at once, the readers of the stage spans and the tile counter reduce a
record as their docstrings say, and ``work_restormer`` counts what the
reference computes."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from gpubench import harness
from gpubench.kinds import tiled_burst, tiled_burst_arch
from gpubench.reference import restormer as ref
from gpubench.work import roofline_s
from gpubench.work_restormer import forward_flops, stage_work
from image_denoising_tpu_torch.utils import profiling

from ._tiny_cells import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "e2_restormer_bf16_burst8"
CFG = json.loads((ROOT / "gpubench/configs/restormer_gray_bf16.json").read_text())
SEED = 2 ** 31 + 5
READERS = ("mfu_restormer.serve", "restormer_blocks_ms.serve", "restormer_roofline.serve")


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def test_sound_run_is_correct():
    r = harness.run_cell(tiny_cell(CELL), SEED, 1.0, False, "cpu", time.time())
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["metrics"]) == {"serve_mps", "burst_ms_p95", "setup_s"}
    assert set(r["checks"]) == {"mean_levels", "tile_mean_levels_max"}


@pytest.mark.parametrize("control", sorted(ref.CONTROLS))
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_each_control_is_not_correct(control, seed):
    cell = tiny_cell(CELL)
    readings = tiled_burst_arch.control_readings(cell, seed, control, "cpu")
    assert not harness.judge(cell.limits, readings)[0]


def test_one_tile_altered_is_not_correct(monkeypatch):
    real = tiled_burst.make_forward

    def factory(*a, **k):
        fwd = real(*a, **k)
        return lambda tiles: torch.cat([fwd(tiles)[:1] + 8 / 255, fwd(tiles)[1:]])
    monkeypatch.setattr(tiled_burst, "make_forward", factory)
    r = harness.run_cell(tiny_cell(CELL), SEED, 1.0, False, "cpu", time.time())
    assert r["correct"] is False
    c = r["checks"]["tile_mean_levels_max"]
    assert c["value"] > c["limit"]


def test_a_program_without_the_arch_fails_at_once(monkeypatch):
    monkeypatch.setattr(tiled_burst_arch, "ARCHS", ("UNet", "RESNET", "UNetImproved"))
    t = time.time()
    with pytest.raises(SystemExit, match="no arch 'Restormer'"):
        tiled_burst_arch.run(tiny_cell(CELL), SEED, 1.0, False, "cpu", time.time())
    assert time.time() - t < 1.0


def _span(name, unit, device_ms):
    return {"name": name, "parent": None, "unit": unit, "start_ns": 0, "end_ns": 1,
            "device_ms": device_ms}


def test_readers_reduce_a_record(monkeypatch):
    stages = [f"restormer.{s}" for s in ("enc1", "enc2", "enc3", "latent", "dec3",
                                         "dec2", "dec1", "refine")]
    spans = [_span("burst", u, None) for u in (0, 1, 2)]
    spans += [_span(n, u, 1.0 + u) for u in (0, 1) for _ in range(2) for n in stages]
    spans += [_span(n, 2, 5.0) for n in stages[:3]]        # burst 2: not wholly recorded
    counters = {"restormer.tiles": 3 * 16}
    monkeypatch.setattr(profiling, "record", lambda: {"spans": spans, "counters": counters})
    cell = harness.load_cell(CELL)
    summary = {"busy_s": 1.0, "window_s": 2.0, "n_units": 4}
    got = {m: harness.reader(m)(cell, summary) for m in READERS}
    assert got["restormer_blocks_ms.serve"] == pytest.approx((16 * 1.0 + 16 * 2.0) / 2)
    assert got["mfu_restormer.serve"] == pytest.approx(
        100 * forward_flops(CFG, 16, 352) * 4 / 2.0 / 989e12)
    bound = 9 * sum(roofline_s(*stage_work(CFG, s[len("restormer."):], 352, 8, "bfloat16"),
                               "bfloat16") for s in stages)
    assert got["restormer_roofline.serve"] == pytest.approx(100 * bound / 24e-3)


def test_readers_give_none_without_a_program_record(monkeypatch):
    cell = harness.load_cell(CELL)
    summary = {"busy_s": 1.0, "window_s": 2.0, "n_units": 4}
    assert all(harness.reader(m)(cell, summary) is None for m in READERS)
    monkeypatch.delattr(profiling, "record")
    assert all(harness.reader(m)(cell, summary) is None for m in READERS)


def _hooked_macs(cfg, hw, monkeypatch):
    """Multiply-adds of every conv the reference runs, counted as it runs,
    and of its attention products from their shapes."""
    total = []
    real = F.conv2d

    def conv(x, w, b=None, padding=0, groups=1):
        y = real(x, w, b, padding=padding, groups=groups)
        total.append(y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y
    monkeypatch.setattr(F, "conv2d", conv)
    with torch.no_grad():
        ref.forward(ref.make_weights(cfg, 0, "cpu"), torch.rand(1, 1, hw, hw), cfg)
    attn = sum(n * 2 * c * c // h * (hw >> lvl) ** 2
               for _, _, c, h, n, lvl in ref.stages(cfg))
    return sum(total) + attn


def test_forward_flops_count_every_conv_the_reference_runs(monkeypatch):
    cfg = dict(CFG, dim=8, num_blocks=[1, 2, 1, 1], num_refinement_blocks=1)
    assert forward_flops(cfg, 1, 32) == 2 * _hooked_macs(cfg, 32, monkeypatch)


def test_published_work_by_hand():
    assert forward_flops(CFG, 1, 352) == pytest.approx(5.85005363712e11, rel=1e-12)
    # enc1: 4 blocks at C = 48, one head, hid 127, 352^2 pixels a tile
    c, hid, px = 48, 127, 352 * 352
    macs = 3 * c * c + 27 * c + 2 * c * c + c * c + 2 * hid * c + 18 * hid + hid * c
    flops, nbytes = stage_work(CFG, "enc1", 352, 8, "bfloat16")
    assert flops == 2 * 8 * px * 4 * macs
    # a block's LayerNorm weights and temperature in float32, its convs in bf16
    weights = 4 * (4 * (2 * c + 1) + 2 * (macs - 2 * c * c))
    assert nbytes == 2 * 8 * px * c * 2 + weights
    blocks = sum(stage_work(CFG, s[0], 352, 1, "bfloat16")[0] for s in ref.stages(CFG))
    assert 0.92 < blocks / forward_flops(CFG, 1, 352) < 0.94


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card and refuses the CPU")
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", CELL,
                          "--seed", str(2 ** 31 + 29), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
