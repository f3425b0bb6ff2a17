"""BENCHMARK.json against the benchmark contract, and every name in it
against the files the harness finds by that name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _names():
    yield from (c["name"] for c in SPEC["configs"])
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        yield m["name"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "-m", "gpubench.run"]
    assert SPEC["paths"] == ["gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_units_texts_and_uniqueness():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert TEXT.match(entry["why"])
    for m in SPEC["per_layer"]:
        assert TEXT.match(m["layer"])
    for group in (metrics, SPEC["workloads"], SPEC["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entries_have_just_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) == LAYER_KEYS | {"workloads"}


def _reports(workload):
    return {m["name"] for m in SPEC["end_to_end"] if workload in m.get("workloads", [workload])}


def test_every_moves_is_reported_in_each_cell_of_its_metric():
    for m in SPEC["per_layer"]:
        assert m["workloads"]
        for w in m["workloads"]:
            assert m["moves"] in _reports(w), (m["name"], w)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        assert len(_reports(w["name"])) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_every_name_finds_its_files():
    here = ROOT / "gpubench"
    for w in SPEC["workloads"]:
        traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert (here / "kinds" / f"{traffic['kind']}.py").is_file()
        limits = json.loads((here / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
    for m in SPEC["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file()
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []


def test_a_full_check_fits_its_time_with_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
