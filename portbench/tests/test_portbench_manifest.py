"""BENCHMARK.json against the benchmark's contract, and every file a cell or
metric names found by its name."""

from __future__ import annotations

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) + list(E2E) + [
        m["name"] for m in BENCH["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(E2E) | {m["name"] for m in BENCH["per_layer"]}) == \
        len(E2E) + len(BENCH["per_layer"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    path = os.path.join(ROOT, entry["file"])
    cfg = json.load(open(path))
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_files(cell):
    w = CELLS[cell]
    assert w["chips"] in (1, 4)
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    spec = json.load(open(os.path.join(PB, "workloads", f"{cell}.json")))
    traffic = json.load(open(os.path.join(PB, "traffic", f"{w['traffic']}.json")))
    assert spec["name"] == cell and traffic["name"] == w["traffic"]
    assert os.path.exists(os.path.join(PB, "drivers", f"{spec['driver']}.py"))
    assert all(v > 0 for v in spec["limits"].values()), spec["limits"]
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m for m in BENCH["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(_reports(cell, m) for m in BENCH["per_layer"])


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert os.path.exists(os.path.join(PB, "metrics", f"{metric['name']}.py"))
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS and _reports(cell, moved), (metric["name"], cell)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert "device" in by_layer


def test_paths_hold_no_program_file():
    """The command names nothing outside the benchmark's folder."""
    for word in BENCH["command"][1:]:
        assert word.startswith("portbench/") and ".." not in word
