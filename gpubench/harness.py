"""One cell of ``BENCHMARK.json``: load it by name, run its kind's driver,
judge the outputs and assemble the result line.

A driver (``kinds/<kind>.py``, the traffic file's ``kind``) runs set-up,
a fixed warm-up and the timed window, and returns an ``Outcome``. The
window starts and ends at a completion (a burst's frames on the host, a
step's lag-1 fetch); ``--seconds`` only decides when no more work is
taken. Per-layer metrics are read from a traced stretch of the window by
``metrics/<name>.py``, each a ``read(cell, summary)`` that returns None
where it finds nothing.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "gpubench"
# top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "image_denoising_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Outcome:
    """What a driver measured: ``end_to_end`` {metric: value}, the units
    attempted and failed in the window, the memory peak, the trace
    ``summary`` (None untraced), ``readings`` {name: value} for the
    comparison, and the attribution ``record``."""
    end_to_end: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    summary: dict | None
    readings: dict
    record: dict


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(
        name=workload, chips=cell["chips"],
        cfg=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def reader(metric: str):
    """``read(cell, summary)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def nearest_rank(values, pct: float) -> float:
    """The ``pct`` percentile by nearest rank: a value that was measured."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(pct / 100.0 * len(ordered)) - 1)]


def judge(limits: dict, readings: dict):
    """(correct, checks): every number named in ``limits`` at or under its
    limit; a missing or NaN reading fails."""
    checks = {}
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run the cell and return the result line as a dict (keys in order)."""
    driver = importlib.import_module(f"gpubench.kinds.{cell.traffic['kind']}")
    out = driver.run(cell, seed, seconds, trace, device, t_start)
    correct, checks = judge(cell.limits, out.readings)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(cell, out.summary) if out.summary else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    import torch

    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": info}
    if trace and out.summary:
        from .tracing import breakdown

        info["busy_s"] = out.summary["busy_s"]
        info["window_s"] = out.summary["window_s"]
        result["breakdown"] = breakdown(out.summary)
    result["checks"] = checks
    from . import record

    record.write(cell.name, seed, int(trace), dict(out.record, readings=out.readings,
                                                    correct=correct, metrics=metrics))
    return result


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
