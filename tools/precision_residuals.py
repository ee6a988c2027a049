"""What the driver-level ``precision=`` costs in accuracy, modelled on the
CPU: the readings that ``chip_smoke.py``'s ``[precision]`` gates are set
from.

    python tools/precision_residuals.py [--half] [driver ...]

Runs ``chip_smoke.precision_cases`` — BQRRP's headline configuration,
RSVD config 1, CQRRPT config 3, ABRIK config 5, KRILL and SPLS config 2
— on the CPU in f32 at the reduced sizes of ``SCALE`` (each size divided
by it; ``--half`` halves each divisor, to read how the readings grow
with the size), in "highest", "high" and "default", with every product
``ops.util.matmul`` computes at "high" or "default" made as the card makes
it: the operands rounded to TF32 (10 mantissa bits, to nearest, ties
away, ``ops.wy._tf32_rna``) or to bf16 (to nearest even), multiplied in
f64, the result rounded to f32. On the CPU the drivers themselves take the
plain product for every precision; this script is how the card's
arithmetic is predicted without it. Prints each run's readings (the
quantities the card gates), then each control's (a wrong answer the gate
must refuse). ``tools/trailing_mode_residuals.py`` does the same for the
trailing-precision modes.
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from randlapack_tpu_torch.ops import util, wy  # noqa: E402

# each driver's sizes divided by this
SCALE = {"bqrrp": 8, "rsvd": 4, "cqrrpt": 4, "abrik": 4, "krill": 8,
         "spls": 5}


def _emulated(round_):
    def mm(X, Y):
        return (round_(X).double() @ round_(Y).double()).float()
    return mm


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _product_form(precision, t):
    p = util.resolve_precision(precision)
    return p if t.dtype == torch.float32 else "highest"


def main(argv):
    scale = dict(SCALE)
    if "--half" in argv:
        argv = [a for a in argv if a != "--half"]
        scale = {k: max(1, v // 2) for k, v in scale.items()}
    util.product_form = _product_form
    sys.modules["randlapack_tpu_torch.sketching.srht"].product_form = \
        _product_form
    util.tf32_mm = _emulated(wy._tf32_rna)
    util.bf16_mm = _emulated(_bf16)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    cases = chip_smoke.precision_cases(torch.device("cpu"), scale)
    print(f"inputs {time.perf_counter() - t0:.1f} s", flush=True)
    for name, case in cases.items():
        if argv and name not in argv:
            continue
        for p in chip_smoke.PRECISIONS:
            t0 = time.perf_counter()
            q = case["quality"](case["run"](p))
            print(f"{case['what']} {p}: {chip_smoke._fmt(q)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        what, q = case["control"](case["run"], "high")
        print(f"{name} control (high), {what}: {chip_smoke._fmt(q)}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
