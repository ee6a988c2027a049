"""What the trailing-precision modes cost in accuracy, modelled on the CPU.

    python tools/trailing_mode_residuals.py [n] [bqrrp] [hqrrp]

Runs the port's bqrrp_factored (bench.py's headline configuration: b 256,
2 pivot candidates, 2 stages, defer 4) and hqrrp (b 128, defer 4) on an
n×n f32 fast_decay_matrix (default n 2048) in each trailing_precision,
with the trailing products computed as the card's K1/K2 forms compute
them: their plain versions (``ops.wy.masked_vt_a_<form>_reference`` and
``a_minus_vz_masked_<form>_reference``, the operands rounded to TF32 or
bf16, fp32 sums) put in place of the kernels. Prints each run's residual
‖QR − A[:, J]‖_F/‖A‖_F, ‖QᵀQ − I‖_F, ``fail`` and the trailing-norm ratios
against LAPACK geqp3 in f64 over the leading half
(docs/pivot_quality_f32.md), the quantities chip_smoke.py's
``[bqrrp-speed]`` and ``[hqrrp-speed]`` gate on the card. On the CPU the
drivers themselves take the "highest" products for "high" and "default";
this script is how the card's arithmetic is predicted without it.
"""
import sys
import time

import numpy as np
import scipy.linalg
import torch

import randlapack_tpu_torch as rt
from randlapack_tpu_torch.ops import wy

FORMS = {"highest": "highest", "high": "tf32", "default": "bf16",
         "bf16_3x_emul": "bf16x3"}


def _form(trailing_precision, t=None):
    return FORMS.get(trailing_precision, "bf16x3")


def _k1(V, A, mask, trailing_precision="highest"):
    form = _form(trailing_precision)
    if form == "highest":
        return wy.masked_vt_a_reference(V, A, mask)
    return getattr(wy, f"masked_vt_a_{form}_reference")(V, A, mask)


def _k2(A, V, Z, mask, trailing_precision="highest"):
    form = _form(trailing_precision)
    ref = (wy.a_minus_vz_masked_reference if form == "highest" else
           getattr(wy, f"a_minus_vz_masked_{form}_reference"))
    return A.copy_(ref(A, V, Z, mask))


def _trailing_norms(R):
    R = np.asarray(R, dtype=np.float64)
    n = min(R.shape)
    sq = np.triu(R[:n, :n]) ** 2
    return np.sqrt(np.diag(np.flip(np.flip(sq, (0, 1)).cumsum(0).cumsum(1),
                                   (0, 1))))


def main(argv):
    n = int(argv[0]) if argv and argv[0].isdigit() else 2048
    which = [a for a in argv if not a.isdigit()] or ["bqrrp", "hqrrp"]
    for name in ("bqrrp", "hqrrp"):
        mod = sys.modules[f"randlapack_tpu_torch.drivers.{name}"]
        mod.masked_vt_a_mixed, mod.a_minus_vz_masked_mixed = _k1, _k2
        mod.trailing_form = _form
    A, st = rt.gen.fast_decay_matrix(n, n, rt.RNGState(0), device="cpu")
    A64 = A.double()
    t0 = time.perf_counter()
    tq = _trailing_norms(scipy.linalg.qr(A64.numpy(), mode="r",
                                         pivoting=True)[0])
    print(f"geqp3 (f64) {time.perf_counter() - t0:.2f} s", flush=True)

    def report(tag, Q, R, J, fail):
        Q, R = Q.double(), R.double()
        res = float(torch.linalg.norm(Q @ R - A64[:, J])
                    / torch.linalg.norm(A64))
        orth = float(torch.linalg.norm(
            Q.T @ Q - torch.eye(Q.shape[1], dtype=torch.float64)))
        ratio = tq[:n // 2] / _trailing_norms(R)[:n // 2]
        print(f"{tag}: residual {res:.3e}, orth {orth:.3e}, fail "
              f"{bool(fail)}, pivot ratios [{ratio.min():.3f}, "
              f"{ratio.max():.3f}]", flush=True)

    for tp in FORMS:
        if "bqrrp" in which:
            fac, _ = rt.drivers.bqrrp_factored(A, rt.drivers.BQRRPConfig(
                block_size=256, pivot_candidates=2, stages=2,
                update_defer=4, trailing_precision=tp), st)
            report(f"bqrrp_factored {n}² {tp}", rt.drivers.bqrrp_q(fac),
                   fac.R, fac.J, fac.fail)
        if "hqrrp" in which:
            Q, R, J, _, fail, _ = rt.drivers.hqrrp(A, rt.drivers.HQRRPConfig(
                block_size=128, update_defer=4, trailing_precision=tp), st)
            report(f"hqrrp {n}² {tp}", Q, R, J, fail)


if __name__ == "__main__":
    main(sys.argv[1:])
