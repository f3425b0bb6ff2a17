"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
n_feature 8, 96² frames in bursts of 2 through 64² tiles, 32² training
pairs. Every other setting is the cell's own."""
from __future__ import annotations

from gpubench import harness


def tiny_cell(workload: str, **traffic) -> harness.Cell:
    cell = harness.load_cell(workload)
    cell.cfg = dict(cell.cfg, n_feature=8)
    tr = dict(cell.traffic)
    if tr["kind"] == "tiled_burst":
        tr.update(frames=dict(tr["frames"], hw=96, pool=6), burst=2, tile=64, overlap=16,
                  warmup_units=2, trace_skip=1, trace_units=2)
    else:
        tr.update(pairs=dict(tr["pairs"], hw=32, pool=12), warmup_units=4, trace_skip=1,
                  trace_units=2)
    tr.update(traffic)
    cell.traffic = tr
    return cell
