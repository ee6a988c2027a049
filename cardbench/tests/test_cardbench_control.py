"""The controls and the card faults of each cell, on the card at the
cell's own size: the program in its own lower precision (TF32 products
where the cell states fp32), and the program with the mechanism its
limits judge broken (the pivot selection, for the pivoted QRs: each
cell's ``card_faults``, ``cells/<cell>.json``), each have to fail at least
one of the cell's limits, and the program as the cell states it has to
pass them all, on the same seed."""
import pytest

import cut
from cardbench import control, harness

CELLS = [c["name"] for c in harness.benchmark()["workloads"]]
CONTROLS = [(c, k) for c in CELLS for k in harness.workload(c)["controls"]]
CUTS = cut.cuts()
PIVOT_FAULTS = [(c, f) for c in CELLS for f in CUTS[c]["card_faults"]]
SEED = 2**31 + 4099


@pytest.mark.cuda
@pytest.mark.parametrize("cell,name", CONTROLS,
                         ids=[f"{c}-{k}" for c, k in CONTROLS])
def test_control_fails(cuda_device, cell, name):
    ctl = control.readings(cell, SEED, control=name, device=cuda_device)
    assert ctl["fails"], ctl["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", PIVOT_FAULTS,
                         ids=[f"{c}-{f}" for c, f in PIVOT_FAULTS])
def test_pivot_fault_fails(cuda_device, cell, fault):
    r = control.readings(cell, SEED, fault=fault, device=cuda_device)
    assert r["fails"], r["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes(cuda_device, cell):
    prog = control.readings(cell, SEED, device=cuda_device)
    assert prog["fails"] == [], prog["numbers"]
