"""The two readings a limit is set from, for a cell whose driver names its
controls (``controls(cell)`` and ``control_readings(cell, seed, name,
device)``: ``tiled_burst_arch``, and ``n2n_step`` once its held-back cell
is in ``BENCHMARK.json``), read on the card.

``python3 -m gpubench.calibrate_controls --workload <name> --seeds 1,2,...
--control-seeds 3 --seconds 2`` runs the cell's timed path and its
comparison on every seed (the lower reading is the largest a sound run
gives), then each control on the first ``--control-seeds`` seeds (the upper
reading is the smallest it gives). One JSON line per run, then the
summary; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import harness


def calibrate(cell, seeds, control_seeds: int, seconds: float, device, out=sys.stdout):
    driver = importlib.import_module(f"gpubench.kinds.{cell.traffic['kind']}")
    program, controls = [], {}
    for seed in seeds:
        o = driver.run(cell, seed, seconds, False, device, time.time())
        program.append(o.readings)
        print(json.dumps({"seed": seed, "program": o.readings, "end_to_end": o.end_to_end,
                          "memory_peak_bytes": o.memory_peak_bytes}), file=out, flush=True)
    for seed in seeds[:control_seeds]:
        got = {name: driver.control_readings(cell, seed, name, device)
               for name in driver.controls(cell)}
        for name, readings in got.items():
            controls.setdefault(name, []).append(readings)
        print(json.dumps({"seed": seed, "controls": got}), file=out, flush=True)
    names = sorted(program[0])
    summary = {"lower": {n: max(r[n] for r in program) for n in names},
               "upper": {c: {n: min(r[n] for r in rs) for n in names}
                         for c, rs in controls.items()}}
    print(json.dumps({"summary": summary}), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.calibrate_controls reads the card's numbers: no CUDA card",
              file=sys.stderr)
        return 2
    calibrate(harness.load_cell(args.workload), [int(s) for s in args.seeds.split(",")],
              args.control_seeds, args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
