"""The per-run attribution record: what a later look at a spread needs.

Each run writes ``build/gpubench/<workload>.seed<seed>.trace<0|1>.json``
in its checkout: the card's clocks, power and temperature before and after
the window, every unit's device time and latency, the set-up phases, and
in a traced run the kernels by name. The same numbers, but the per-unit
lists, go to standard error.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RECORD_DIR = Path(__file__).resolve().parents[1] / "build" / "gpubench"
SMI_FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")


def card_state():
    """The card's SM clock (MHz), power draw and limit (W) and temperature
    (C) from ``nvidia-smi``, or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    values = [v.strip() for v in out.splitlines()[0].split(",")]
    state = {}
    for key, v in zip(SMI_FIELDS, values):
        try:
            state[key] = float(v)
        except ValueError:
            state[key] = v
    return state


def write(workload: str, seed: int, trace: int, record: dict):
    RECORD_DIR.mkdir(parents=True, exist_ok=True)
    path = RECORD_DIR / f"{workload}.seed{seed}.trace{trace}.json"
    path.write_text(json.dumps(record))
    brief = {k: v for k, v in record.items() if not isinstance(v, (list, dict))
             or k in ("card_before", "card_after", "setup_phases", "unit_ms_quartiles")}
    print(f"[gpubench] record {path.name} {json.dumps(brief)}", file=sys.stderr)
    return path
