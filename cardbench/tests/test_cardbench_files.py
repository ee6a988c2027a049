"""Every configuration, workload and metric file loads by the name
BENCHMARK.json gives it, each cell holds its entry's numbers to limits
and has its cut to a CPU's size, and BENCHMARK.json keeps to its
format's limits."""
import json
import re

import pytest

import cut
from cardbench import faults, harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    body = harness.config(cfg["name"])
    assert cfg["file"] == f"cardbench/configs/{cfg['name']}.json"
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert {"shape", "dtype", "generator", "assumed"} <= set(body)
    assert 1 <= len(cfg["why"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    wl = harness.workload(cell["name"])
    assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
        cell["config"], cell["traffic"], cell["chips"], cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    ent = harness.entry(wl["entry"])
    for fn in ("prepare", "call", "check", "schedule"):
        assert callable(getattr(ent, fn))
    assert 1 <= len(cell["why"]) <= 200
    assert set(ent.LIMITED) <= set(wl["limits"]) <= set(ent.NUMBERS)
    c = cut.cuts()[cell["name"]]
    assert set(c) == {"shape", "settings", "limits", "faults",
                      "card_faults", "why"}
    for name in c["faults"] + c["card_faults"]:
        assert callable(faults.find(cell["name"], name))


def test_cells_unique_and_reported():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [c["name"] for c in BENCH["workloads"]]
    for cell in names:
        e2e = {m["name"] for m in harness.metrics_of(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(cell, "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(harness.reader(metric["name"]))
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert UNIT.match(metric["unit"]) and metric["better"] == "lower"
