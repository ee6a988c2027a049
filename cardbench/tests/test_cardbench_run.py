"""Runs of the harness on the CPU at a small size, the look for a card
skipped: the module set holds neither JAX nor the JAX package, a sound
run is ``correct``, and a run with the timed path broken underneath is
not, for each fault a cell can have (``cardbench/faults.py``, the
entries' own, each cell's ``cells/<cell>.json``; no cell spans chips, so
no exchange between them can be left out)."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

import cut
from cardbench import faults, harness

CUTS = cut.cuts()
SEED = 2**31 + 977


@pytest.fixture
def small(monkeypatch, cell):
    """``harness``'s configuration and cell cut to the cell's CPU size
    (``cut.py``)."""
    cut.cut(monkeypatch.setattr, cell)


def run(cell, seed=SEED, traced=False):
    return harness.run_cell(cell, seed, 0.05, traced, time.perf_counter(),
                            device="cpu")


def test_module_set_has_no_jax():
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "from cardbench import harness, run\n"
        "import cut\n"
        "cut.cut(setattr, 'square16384.hqrrp')\n"
        "r = harness.run_cell('square16384.hqrrp', 5, 0.05, False, "
        "time.perf_counter(), device='cpu')\n"
        "print(json.dumps(dict(banned=run.banned_modules(), "
        "tops=sorted({m.split('.')[0] for m in sys.modules}), "
        "correct=r['correct'])))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["banned"] == []
    assert not {"jax", "jaxlib", "flax", "randlapack_tpu"} & set(res["tops"])
    assert "randlapack_tpu_torch" in res["tops"]


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_sound_run_is_correct(small, cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    json.dumps(r, allow_nan=False)
    assert {"call_ms", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("cell", sorted(CUTS))
def test_check_returns_its_numbers(small, monkeypatch, cell):
    """The entry's ``check`` returns exactly its ``NUMBERS``, on each
    output it judges."""
    ent = harness.entry(harness.workload(cell)["entry"])
    check, seen = ent.check, []

    def spy(inp, out, settings):
        nums = check(inp, out, settings)
        seen.append(set(nums))
        return nums
    monkeypatch.setattr(ent, "check", spy)
    assert run(cell)["correct"]
    assert seen and all(keys == set(ent.NUMBERS) for keys in seen), seen


FAULTS = [(c, f) for c in sorted(CUTS) for f in CUTS[c]["faults"]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_broken_path_is_not_correct(small, monkeypatch, cell, fault):
    faults.find(cell, fault)(monkeypatch.setattr, cell)
    r = run(cell)
    assert not r["correct"], r["checks"]
    json.dumps(r, allow_nan=False)
