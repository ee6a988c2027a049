"""Readings for the limits of a cell's check, on the card:

    python3 cardbench/control.py --workload <cell> --seeds <n> ... \
        [--program | --control <name> | --fault <name>]

For each seed, the cell's entry runs on the cell's own input at its own
size: with ``--program`` as the cell states it, with ``--control`` with
one of the cell's ``controls`` (the program's own lower precision: TF32
products where the cell states fp32), or with ``--fault`` with a fault
planted in the program (``faults.find``: ``faults.FAULTS``, or the
entry's own). The second of two calls (the first warms up) is held by
the same reference and numbers as a run and printed beside the cell's
limits. Each control and each fault has to fail at least one of them
on every seed; the program's readings set the lower end of each limit.
The benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def patched():
    """A ``setattr(owner, name, value)`` for ``faults``, whose replaced
    attributes are put back on leaving."""
    saved = []

    def setattr_(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)
    try:
        yield setattr_
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def readings(name: str, seed: int, control: str | None = None,
             fault: str | None = None, device="cuda") -> dict:
    """The cell's numbers for one seed: the program's as the cell states
    it, or with ``control`` the cell's control of that name, or with
    ``fault`` that fault planted."""
    import torch

    from cardbench import faults, harness, inputs
    from randlapack_tpu_torch import RNGState
    wl = harness.workload(name)
    cfg = harness.config(wl["config"])
    settings = {**wl["settings"],
                **(wl["controls"][control] if control else {})}
    with patched() as setattr_:
        if fault:
            faults.find(name, fault)(setattr_, name)
        ent = harness.entry(wl["entry"])
        prep = ent.prepare(settings)
        inp = inputs.make(cfg, seed, device)
        state = RNGState(inputs.derive(seed, 3))
        for _ in range(2):
            out = None   # the first call's factors freed before the second
            t0 = time.perf_counter()
            out, state = ent.call(inp, state, prep)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    nums = ent.check(inp, out, settings)
    del out, inp
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    fails = [k for k, lim in wl["limits"].items()
             if not nums.get(k, float("inf")) <= lim]
    return dict(seed=seed, control=control, fault=fault, seconds=seconds,
                numbers=nums, limits=wl["limits"], fails=fails)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--program", action="store_true")
    which.add_argument("--control")
    which.add_argument("--fault")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("cardbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(args.workload, seed, args.control, args.fault)
        print(json.dumps(dict(workload=args.workload, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
