"""``drivers.revd2_fixed_rank`` over ``pdkernels.SquaredExpKernelLinOp``:
the rank-``k`` Nyström eigendecomposition of the unregularized kernel
operator (μ 0) of the maker's points, every product with it K4 on the
card. Settings: ``k``, ``syps_passes`` and ``error_est_passes`` (the
``REVD2Config`` fields, the rest its defaults: PLU stabilization after
every pass, SYRF by CholQR2), ``precision``, and ``pairs``, the leading
pairs ``pair_residual`` reads.

Its input is the maker's ``(X, bandwidth)``; its output ``(V, λ, err,
ν, fail)`` has no permutation, so it names numbers of its own
(``reference_revd2.numbers``) and faults of its own."""
from __future__ import annotations

import dataclasses
import importlib
import math

from .. import reference_revd2, yardstick_sqexp

NUMBERS = ("pair_residual", "lambda_error", "trace_error", "orthogonality",
           "order", "fail")
LIMITED = NUMBERS


def prepare(settings: dict):
    from randlapack_tpu_torch.comps import SYPSConfig, SYRFConfig
    from randlapack_tpu_torch.drivers import REVD2Config
    cfg = REVD2Config(
        syrf=SYRFConfig(syps=SYPSConfig(
            passes_over_data=settings["syps_passes"])),
        error_est_passes=settings["error_est_passes"])
    return cfg, settings["k"], settings["precision"]


def call(inp, state, prep):
    from randlapack_tpu_torch.drivers import revd2_fixed_rank
    from randlapack_tpu_torch.pdkernels import SquaredExpKernelLinOp
    X, bandwidth = inp
    cfg, k, precision = prep
    op = SquaredExpKernelLinOp(X, bandwidth, 0.0, evals_include_reg=False)
    V, lam, err, nu, fail, state = revd2_fixed_rank(op, k, cfg, state,
                                                    precision)
    return (V, lam, err, nu, fail), state


def check(inp, out, settings: dict) -> dict:
    X, bandwidth = inp
    V, lam, _, _, fail = out
    return reference_revd2.numbers(X, bandwidth, V, lam, fail,
                                   settings["pairs"])


def schedule(shape, settings: dict) -> list[dict]:
    """K4's products: SYPS's passes, SYRF's A·Ω and Y = A·Q at s = k, and
    the power estimate's passes at s = 1."""
    n, d = shape
    return yardstick_sqexp.revd2_schedule(
        n, d, settings["k"], settings["syps_passes"] + 2,
        settings["error_est_passes"])


def lambda_altered(setattr, cell):
    """An answer altered where it is produced: the SVD's first singular
    value scaled so that λ₁ grows by 1 %, inside the driver."""
    mod = importlib.import_module("randlapack_tpu_torch.drivers.revd2")
    orig = mod.svd_econ

    def svd_econ(B, method, precision):
        U, S, Vt = orig(B, method, precision)
        S = S.clone()
        S[0] *= math.sqrt(1.01)
        return U, S, Vt
    setattr(mod, "svd_econ", svd_econ)


def syps_unpowered(setattr, cell):
    """SYPS returns its Gaussian start unmultiplied: SYRF's basis from one
    product with A in place of four."""
    mod = importlib.import_module("randlapack_tpu_torch.comps.syrf")
    orig = mod.syps

    def syps(A, k, cfg, state, precision, omega=None):
        return orig(A, k, dataclasses.replace(cfg, passes_over_data=0),
                    state, precision, omega)
    setattr(mod, "syps", syps)


def k4_tf32(setattr, cell):
    """Every product with K by a plain blocked K (``BLOCK`` columns at a
    time) whose cross term and product with V are one TF32 product each
    (``ops.util.matmul`` at "high"): the configuration's float32 one
    precision lower, on the card only."""
    import torch

    from randlapack_tpu_torch import pdkernels
    from randlapack_tpu_torch.ops.util import matmul

    def kernel_matmat(X, V, bandwidth):
        n = X.shape[1]
        sq = (X * X).sum(0)
        out = torch.zeros_like(V)
        for j0 in range(0, n, reference_revd2.BLOCK):
            j = slice(j0, min(j0 + reference_revd2.BLOCK, n))
            d2 = sq[:, None] + sq[None, j] - 2.0 * matmul(
                X.T.contiguous(), X[:, j].contiguous(), "high")
            Kb = torch.exp(-d2.clamp_(min=0.0) / (2.0 * bandwidth ** 2))
            out += matmul(Kb, V[j].contiguous(), "high")
        return out
    setattr(pdkernels, "kernel_matmat", kernel_matmat)


FAULTS = {f.__name__: f for f in (lambda_altered, syps_unpowered, k4_tf32)}
