"""Runs of the harness on the CPU at a small size, the look for a card
skipped: the module set holds neither JAX nor the JAX package, a sound
run is ``correct``, and a run with the timed path broken underneath is
not, for each fault a cell can have (``cardbench/faults.py``; no cell
spans chips, so no exchange between them can be left out)."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from cardbench import faults, harness

# each cell cut to a CPU's size: its configuration's shape, and the block
# sizes that keep the cell's number of blocks small
SHAPES = {"square16384_f32": [384, 384], "tall131072x2048_f32": [4096, 128]}
SETTINGS = {
    "square16384.hqrrp": {"block_size": 32},
    "square16384.hqrrp_bf16x3": {"block_size": 32},
    "tall131072x2048.cqrrpt_hqrrp": {"bqrrp_block": 32},
}
# ``pivot_gap`` reads higher the fewer columns there are to choose among:
# at 384², b 32, sound runs read 0.112–0.146 and K5 returning the first
# live columns 0.309–0.373 (12 seeds each, CPU), against the cells'
# 0.0745 at 16384²; the tall cell's 4096×128 reads 0.073–0.112 and
# 0.302–0.472, under and over its own limit
LIMITS = {"square16384.hqrrp": {"pivot_gap": 0.22},
          "square16384.hqrrp_bf16x3": {"pivot_gap": 0.22}}
SEED = 2**31 + 977


def small_config(name, _config=harness.config):
    return {**_config(name), "shape": SHAPES[name]}


def small_workload(name, _workload=harness.workload):
    wl = _workload(name)
    return {**wl, "settings": {**wl["settings"], **SETTINGS[name]},
            "limits": {**wl["limits"], **LIMITS.get(name, {})}}


@pytest.fixture
def small(monkeypatch):
    """``harness``'s configurations and cells cut to ``SHAPES`` and
    ``SETTINGS``."""
    monkeypatch.setattr(harness, "config", small_config)
    monkeypatch.setattr(harness, "workload", small_workload)


def run(cell, seed=SEED, traced=False):
    return harness.run_cell(cell, seed, 0.05, traced, time.perf_counter(),
                            device="cpu")


def test_module_set_has_no_jax():
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "from cardbench import harness, run\n"
        "import test_cardbench_run as t\n"
        "harness.config, harness.workload = t.small_config, "
        "t.small_workload\n"
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


@pytest.mark.parametrize("cell", sorted(SETTINGS))
def test_sound_run_is_correct(small, cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    json.dumps(r, allow_nan=False)
    assert {"call_ms", "setup_s"} <= set(r["metrics"])


SQUARE = ["square16384.hqrrp", "square16384.hqrrp_bf16x3"]
TALL = "tall131072x2048.cqrrpt_hqrrp"
FAULTS = (
    [(c, f) for c in SQUARE for f in (
        "answer_altered", "answer_nan", "panel_unchanged", "panel_half",
        "k5_first_live", "k6_unpivoted")]
    + [("square16384.hqrrp_bf16x3", f) for f in ("k2_unchanged", "k2_half")]
    + [(TALL, f) for f in ("answer_altered", "cholqr_unchanged",
                           "gram_half", "k5_first_live")])


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_broken_path_is_not_correct(small, monkeypatch, cell, fault):
    faults.FAULTS[fault](monkeypatch.setattr, cell)
    r = run(cell)
    assert not r["correct"], r["checks"]
    json.dumps(r, allow_nan=False)
