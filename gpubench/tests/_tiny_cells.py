"""The cells of the ``tiled_burst_arch`` and ``n2n_step`` kinds cut to a size
the CPU runs in seconds: Restormer at dim 8 (its published blocks and
heads) on 96² frames in bursts of 2 through 64² tiles; the N2N step at
n_feature 8 on 32² frames. Every other setting is the cell's own.

The N2N step's cell, ``n2n_f32_b4``, is held back from ``BENCHMARK.json``
(``kinds/n2n_step.py``); ``held_cell`` builds it from its configuration,
traffic and limits files as ``harness.load_cell`` would."""
from __future__ import annotations

import json

from gpubench import harness

HELD = {"n2n_f32_b4": {"config": "improved_unet48_f32_tf32", "traffic": "n2n_b4_352",
                       "end_to_end": ("train_step_ms", "setup_s")}}


def held_cell(workload: str) -> harness.Cell:
    """A held-back cell of ``HELD``, on one chip, with no per-layer metric."""
    held = HELD[workload]
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in spec["configs"]}[held["config"]]
    return harness.Cell(
        name=workload, chips=1,
        cfg=json.loads((harness.ROOT / conf["file"]).read_text()),
        traffic=json.loads((harness.HERE / "traffic" / f"{held['traffic']}.json").read_text()),
        limits=json.loads((harness.HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if m["name"] in held["end_to_end"]],
        per_layer=[])


def tiny_cell(workload: str, **traffic) -> harness.Cell:
    cell = held_cell(workload) if workload in HELD else harness.load_cell(workload)
    tr = dict(cell.traffic)
    if tr["kind"] == "tiled_burst_arch":
        cell.cfg = dict(cell.cfg, dim=8)
        tr.update(frames=dict(tr["frames"], hw=96, pool=6), burst=2, tile=64, overlap=16,
                  warmup_units=2, trace_skip=1, trace_units=2)
    else:
        cell.cfg = dict(cell.cfg, n_feature=8)
        tr.update(pairs=dict(tr["pairs"], hw=32, pool=12), warmup_units=4, trace_skip=1,
                  trace_units=2)
    tr.update(traffic)
    cell.traffic = tr
    return cell
