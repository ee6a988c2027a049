"""K4's least time, K(X, X)·V for the squared-exponential kernel, on the
frozen peaks of ``yardstick``, which has no special-function term.

The work is counted from the shapes alone, whatever implements it (d×n
points, V n×s): per kernel entry 2d operations for the cross term, 6 for
the norms, the clamp, the scale and the sign, and 2s for the product with
V, all n²(2s + 2d + 6) taken at the lesser of their FP32 time and their
time as three TF32 products (so a K4 that puts K·V on the tensor cores
cannot pass 100 %); one exponential an entry, n², at the card's
special-function rate; X and V read once and K·V written once,
(dn + 2ns)·4 bytes. The least time is the largest of the three.
"""
from __future__ import annotations

from .yardstick import PEAK_BYTES, PEAK_FP32, PEAK_TF32

# special-function results a second: 16 per SM and clock (compute
# capability 9.0) × 132 SMs × 1980 MHz, the H100 SXM's maximum SM clock
# (``chip_smoke.py::sfu_rate`` on the card)
SFU_RATE = 4.18e12


def kernel_matmat_work(d: int, n: int, s: int) -> dict:
    """One K4 product's work item (module docstring), in f32."""
    return dict(kind="k4", flops=float(n * n * (2 * s + 2 * d + 6)),
                exps=float(n * n), bytes=float((d * n + 2 * n * s) * 4),
                s=s)


def bound(item: dict) -> float:
    """The least seconds of one work item (module docstring)."""
    t_ops = min(item["flops"] / PEAK_FP32, item["flops"] / (PEAK_TF32 / 3))
    return max(t_ops, item["exps"] / SFU_RATE, item["bytes"] / PEAK_BYTES)


def revd2_schedule(n: int, d: int, k: int, wide: int, narrow: int) -> list:
    """A REVD2 call's K4 products: ``wide`` at s = k (SYPS's passes,
    SYRF's A·Ω, Y = A·Q) and ``narrow`` at s = 1 (the power estimate)."""
    return ([kernel_matmat_work(d, n, k)] * wide
            + [kernel_matmat_work(d, n, 1)] * narrow)
