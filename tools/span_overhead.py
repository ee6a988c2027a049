"""What the spans cost when on: each benchmark cell's entry (``cardbench/``)
for ``--calls`` calls with ``utils.timing.tracing()`` on, then as many
with it off, twice over (on, off, on, off), on the card.

    python tools/span_overhead.py [--calls 20] [--seed N] [CELL ...]

CELL defaults to every cell of ``BENCHMARK.json``. Each call is timed on
the host clock to its return (``host_ms``: what the host spends issuing
the call) and to the ``torch.cuda.synchronize()`` after it (``call_ms``,
the benchmark's closed loop). Prints one JSON line a cell: the card, its
power limit, each mode's mean ``host_ms`` and ``call_ms`` over its calls,
and the spans an on call recorded.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure(cell: str, calls: int, seed: int) -> dict:
    import torch

    from cardbench import harness, inputs
    from randlapack_tpu_torch import RNGState
    from randlapack_tpu_torch.utils import timing

    wl = harness.workload(cell)
    ent = harness.entry(wl["entry"])
    prep = ent.prepare(wl["settings"])
    A = inputs.make(harness.config(wl["config"]), seed, "cuda")
    state = RNGState(inputs.derive(seed, 3))
    for _ in range(2):
        out, state = ent.call(A, state, prep)
    torch.cuda.synchronize()
    del out
    modes: dict = {}
    spans_a_call = None
    for on in (True, False, True, False):
        host, wall = [], []
        for _ in range(calls):
            t0 = time.perf_counter()
            if on:
                with timing.tracing():
                    out, state = ent.call(A, state, prep)
            else:
                out, state = ent.call(A, state, prep)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            del out
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
        if on:
            spans_a_call = len(timing.spans()) / calls
            with timing.span("off"):     # the next on block starts afresh
                pass
        key = "on" if on else "off"
        modes.setdefault(key, dict(host_ms=[], call_ms=[]))
        modes[key]["host_ms"].append(statistics.fmean(host))
        modes[key]["call_ms"].append(statistics.fmean(wall))
    return dict(cell=cell, calls=calls, seed=seed, spans_a_call=spans_a_call,
                **modes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("span_overhead: no CUDA device available", file=sys.stderr)
        return 1
    from cardbench import harness
    cells = args.cells or [w["name"] for w in harness.benchmark()[
        "workloads"]]
    dev = card()
    for cell in cells:
        print(json.dumps(dict(card=dev, **measure(cell, args.calls,
                                                  args.seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
