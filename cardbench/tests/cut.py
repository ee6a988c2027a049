"""Each cell cut to a CPU's size, from its own file ``cells/<cell>.json``:
``shape`` (its configuration's, on the CPU), ``settings`` and ``limits``
(laid over the cell's own), ``faults`` (planted in its CPU runs,
``test_cardbench_run.py``), ``card_faults`` (read on the card at the
cell's own size, ``test_cardbench_control.py``) and ``why``. A new cell
brings its file; no test names a cell."""
import json
from pathlib import Path

from cardbench import harness

CELLS = Path(__file__).resolve().parent / "cells"


def cuts(where: Path = CELLS) -> dict:
    """Every cut under ``where``, by cell name."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted(where.glob("*.json"))}


def cut(setattr_, cell: str, where: Path = CELLS) -> None:
    """Cut ``cell`` to its CPU size through ``setattr_(owner, name,
    value)`` (pytest's ``monkeypatch.setattr``, or the builtin): from then
    on ``harness.config`` gives the cell's configuration at the cut's
    shape, and ``harness.workload`` the cell with the cut's settings and
    limits over its own."""
    c = json.loads((where / f"{cell}.json").read_text())
    config, workload = harness.config, harness.workload
    name = workload(cell)["config"]

    def small_config(n):
        cfg = config(n)
        return {**cfg, "shape": c["shape"]} if n == name else cfg

    def small_workload(n):
        wl = workload(n)
        if n != cell:
            return wl
        return {**wl, "settings": {**wl["settings"], **c["settings"]},
                "limits": {**wl["limits"], **c["limits"]}}
    setattr_(harness, "config", small_config)
    setattr_(harness, "workload", small_workload)
