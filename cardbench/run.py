"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero, printing no result, where there is no CUDA card or fewer
than the cell asks for, where the program is missing, and where JAX or
the JAX package was imported. The numbers that decide ``correct`` end
standard error, each beside its limit, and the result line (``checks``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "randlapack_tpu")


def _env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    one host thread for the CPU side of the library."""
    cache = ROOT / "build" / "cardbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def banned_modules() -> list[str]:
    """The imported top-level modules of ``BANNED``, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path.insert(0, str(ROOT))
    import torch
    from cardbench import harness
    wl = harness.workload(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < wl["chips"]:
        print(f"cardbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T0, log=sys.stderr)
    banned = banned_modules()
    if banned:
        print(f"cardbench: the run imported {', '.join(banned)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
