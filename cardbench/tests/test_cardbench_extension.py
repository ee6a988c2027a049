"""A cell that is not a pivoted QR joins the harness with new files only.

The made-up cell ``lowrank256x64.rsvd``, listed nowhere in
BENCHMARK.json, is made of files under ``fixtures/extension/`` laid out
as they would lie under ``cardbench/``: a configuration whose generator
is a maker file returning a tuple, not a tensor; an entry (the port's
``drivers.rsvd_fixed_rank``) whose numbers are a truncated SVD's, held to
a float64 reference of its own; a fault of the entry's own; the cell's
CPU cut. The test points the harness's look-ups at that directory
(``harness.config``, ``harness.workload``, ``harness.entry``,
``inputs.MAKER_DIR``) and changes nothing that they find.

Limits (12 seeds on the CPU, sound, against the fault): triplet residual
4.4e-7 - 6.6e-7 against 0.433, limit 1e-5; orthogonality 1.9e-6 - 3.0e-6,
limit 3e-5 (no fault reads it); spectrum error 3e-8 - 4.2e-7 against 0.5,
limit 1e-5."""
import importlib
import time
from pathlib import Path

import pytest
import torch

import cut
from cardbench import faults, harness, inputs

FIX = Path(__file__).resolve().parent / "fixtures" / "extension"
PACKAGE = "cardbench.tests.fixtures.extension"
CELL = "lowrank256x64.rsvd"
SEED = 2**31 + 1231


@pytest.fixture
def extension(monkeypatch):
    """The harness looking in ``fixtures/extension/`` for configurations,
    cells, entries and makers, and the cell cut by its own file."""
    monkeypatch.setattr(harness, "config", lambda name: harness.load_json(
        FIX / "configs" / f"{name}.json"))
    monkeypatch.setattr(harness, "workload", lambda name: harness.load_json(
        FIX / "workloads" / f"{name}.json"))
    monkeypatch.setattr(harness, "entry", lambda name: importlib.import_module(
        f"{PACKAGE}.entries.{name}"))
    monkeypatch.setattr(inputs, "MAKER_DIR", FIX / "makers")
    cut.cut(monkeypatch.setattr, CELL, FIX / "cells")


def run(seed=SEED):
    return harness.run_cell(CELL, seed, 0.05, False, time.perf_counter(),
                            device="cpu")


def test_extension_cell_keeps_to_the_rules(extension):
    """Listed nowhere, its files new, its limits within its entry's
    numbers, its input made by its own maker file and not a tensor."""
    assert CELL not in {c["name"] for c in harness.benchmark()["workloads"]}
    wl = harness.workload(CELL)
    ent = harness.entry(wl["entry"])
    assert not (harness.HERE / "entries" / f"{wl['entry']}.py").exists()
    kind = harness.config(wl["config"])["generator"]["kind"]
    assert kind not in inputs.MAKERS
    assert not (harness.HERE / "makers" / f"{kind}.py").exists()
    assert set(ent.LIMITED) <= set(wl["limits"]) <= set(ent.NUMBERS)
    assert "permutation" not in ent.NUMBERS
    inp = inputs.make(harness.config(wl["config"]), SEED, "cpu")
    assert isinstance(inp, tuple) and not isinstance(inp, torch.Tensor)


def test_extension_sound_run_is_correct(extension):
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and list(r)[-1] == "checks"
    assert set(r["checks"]) == set(harness.workload(CELL)["limits"])


@pytest.mark.parametrize("fault", cut.cuts(FIX / "cells")[CELL]["faults"])
def test_extension_fault_is_not_correct(extension, monkeypatch, fault):
    assert fault not in faults.FAULTS
    faults.find(CELL, fault)(monkeypatch.setattr, CELL)
    r = run()
    assert not r["correct"], r["checks"]
