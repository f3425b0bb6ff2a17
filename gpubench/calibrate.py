"""The two readings a limit is set from, read on the card at the cell's size.

``python3 -m gpubench.calibrate --workload <name> --seeds 1,2,... --control
<precision> --control-seeds 3 --seconds 2`` runs the cell's timed path and
its comparison on every seed (the lower reading is the largest a sound run
gives), then the control on the first ``--control-seeds`` seeds: the
reference in ``--control`` precision put in the program's place (the upper
reading is the smallest it gives). A training cell also reads the fault
that leaves half of each batch out. One JSON line per run, then the
summary; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import check, harness
from .reference.precision import PRECISIONS


def serving_control(cell, seed: int, precision: str, device) -> dict:
    from .kinds.tiled_burst import reference_frames
    from .reference.tiling import tile_grid
    from .traffic import frame_pool

    pool = frame_pool(seed, cell.traffic["frames"])
    ref = reference_frames(cell, seed, pool, device)
    ctl = reference_frames(cell, seed, pool, device, precision)
    tr = cell.traffic
    fb, hw = tr["burst"], tr["frames"]["hw"]
    outs = [(b, ctl[b * fb:(b + 1) * fb]) for b in range(len(pool) // fb)]
    return check.frame_readings(outs, ref, fb, len(pool),
                                tile_grid(hw, hw, tr["tile"], tr["overlap"]))


def training_controls(cell, seed: int, precision: str, device) -> dict:
    from .kinds.structure_step import first_batches, reference
    from .traffic import pair_pool

    clean, noisy = pair_pool(seed, cell.traffic["pairs"])
    batches = first_batches(cell, seed, clean, noisy)
    ref = reference(cell, seed, batches, device)
    half = [(c[: len(c) // 2], n[: len(n) // 2]) for c, n in batches]
    return {precision: check.train_readings(reference(cell, seed, batches, device, precision), ref),
            "half_batch": check.train_readings(reference(cell, seed, half, device), ref)}


def calibrate(cell, seeds, precision: str, control_seeds: int, seconds: float, device,
              out=sys.stdout):
    driver = importlib.import_module(f"gpubench.kinds.{cell.traffic['kind']}")
    program, controls = [], {}
    for seed in seeds:
        o = driver.run(cell, seed, seconds, False, device, time.time())
        program.append(o.readings)
        print(json.dumps({"seed": seed, "program": o.readings, "end_to_end": o.end_to_end}),
              file=out, flush=True)
    for seed in seeds[:control_seeds]:
        if cell.traffic["kind"] == "tiled_burst":
            got = {precision: serving_control(cell, seed, precision, device)}
        else:
            got = training_controls(cell, seed, precision, device)
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
    p.add_argument("--control", choices=PRECISIONS[1:], required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.calibrate reads the card's numbers: no CUDA card", file=sys.stderr)
        return 2
    calibrate(harness.load_cell(args.workload), [int(s) for s in args.seeds.split(",")],
              args.control, args.control_seeds, args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
