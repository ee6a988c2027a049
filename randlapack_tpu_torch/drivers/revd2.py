"""REVD2 — rank-adaptive Nyström eigendecomposition of a PSD operator
(counterpart of ``randlapack_tpu/drivers/revd2.py``; reference:
RandLAPACK/drivers/rl_revd2.hh: REVD2::call :131/:152; Algorithm E2 of
arXiv:2110.02820): SYRF basis, shifted Cholesky of QᵀY, SVD, eigenvalue
de-regularization; k doubles until the power-iteration error estimate is
≤ 5·max(tol, ν) (:238-244).

A is a dense symmetric tensor or a symmetric linop. Over
``pdkernels.SquaredExpKernelLinOp`` on the card every product with A is
the kernel K4: three SYPS passes, SYRF's A·Ω and Y = A·Q at s = k, then
one a power-estimate pass at s = 1 (15 launches a call at the default
configuration).

The Gaussian draws can be injected: ``omega`` (SYPS's n×k start) and
``v0`` (the power estimate's n×1 start) in ``revd2_fixed_rank``, and a
``draw(shape, k)`` callable in ``revd2`` that makes both for each
doubling round, Ω first. An injected draw advances ``state`` as a drawn
one does.

Spans (``utils.timing``): the root ``revd2`` a fixed-rank call; under it
SYPS's ``syps`` (a ``stabilize`` a pass), SYRF's ``syrf_orth``,
``nystrom_factor`` (the shift, QᵀY, its Cholesky factor, the triangular
solve, the SVD and λ) and ``error_est``; every product with A is an
``apply_a`` span wherever it falls. Counters: ``revd2.applies``,
``revd2.apply_columns`` (the entries n·s of every product, against n·k
once a call: 5 + 10/k at the default configuration) and
``revd2.host_reads`` (4 a call: a swap sequence a SYPS pass and the
CholQR flag).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..comps.rs import _gaussian_start
from ..comps.syps import _apply_sym, _sym_dim
from ..comps.syrf import SYRFConfig, syrf
from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..ops.cholqr import _cholesky
from ..ops.svd import svd_econ
from ..ops.util import matmul
from ..rng import RNGState
from ..utils.timing import count, span


@dataclasses.dataclass(frozen=True)
class REVD2Config:
    syrf: SYRFConfig = SYRFConfig()
    error_est_passes: int = 10    # power-iteration steps for the error est
    svd_method: str = "auto"      # see ops.svd.svd_econ


def _power_error_est(A, V, lam, passes, state: RNGState, precision,
                     v0=None):
    """‖A − V diag(λ) Vᵀ‖₂ estimated by ``passes`` steps of the power
    method from a Gaussian start (rl_revd2.hh:26). Returns
    ``(est, next_state)``."""
    n = V.shape[0]
    v, state = _gaussian_start((n, 1), V.dtype, V.device, state, v0)
    v = v / torch.linalg.norm(v)
    tiny = torch.finfo(V.dtype).tiny
    est = torch.zeros((), dtype=V.dtype, device=V.device)
    for _ in range(passes):
        w = _apply_sym(A, v, precision) - V @ (lam[:, None] * (V.T @ v))
        est = torch.linalg.norm(w)
        v = w / torch.clamp(est, min=tiny)
    return est, state


def revd2_fixed_rank(A, k: int, cfg: REVD2Config, state: RNGState,
                     precision=STABLE_PRECISION, omega=None, v0=None):
    """Rank-k Nyström EVD of a PSD A (dense or a symmetric linop).

    Returns ``(V, lam, err_est, nu, fail, next_state)`` with
    A ≈ V diag(lam) Vᵀ, V (n, k) orthonormal, lam descending, ``err_est``
    the estimated 2-norm residual, ``nu`` the Nyström shift and ``fail``
    True on Cholesky breakdown; V, lam and err_est are then NaN, as in
    the JAX package."""
    require_fp32_matmul()
    precision = resolve_precision(precision)
    with span("revd2", A.device):
        n = _sym_dim(A)
        count("revd2.apply_columns", 0, n * k)
        Q, state = syrf(A, k, cfg.syrf, state, precision, omega)
        Y = _apply_sym(A, Q, precision)
        with span("nystrom_factor"):
            nu = math.sqrt(n) * torch.finfo(Y.dtype).eps * torch.linalg.norm(Y)
            Y = Y + nu * Q
            # symmetrizes, all-NaN on breakdown
            C = _cholesky(matmul(Q.T, Y, precision))
            fail = torch.isnan(C).any()
            # B = Y·C⁻ᵀ: solve B·Cᵀ = Y (Cᵀ upper)
            B = torch.linalg.solve_triangular(C.T, Y, upper=True, left=False)
            # the SVD of a broken-down B (NaN) is NaN without asking the
            # library, which may refuse non-finite input; no host read
            V, S, _ = svd_econ(torch.where(fail, torch.zeros_like(B), B),
                               cfg.svd_method, precision)
            nan = torch.full((), float("nan"), dtype=Y.dtype, device=Y.device)
            V = torch.where(fail, nan, V)
            lam = torch.where(fail, nan, torch.clamp(S * S - nu, min=0.0))
        with span("error_est"):
            err, state = _power_error_est(A, V, lam, cfg.error_est_passes,
                                          state, precision, v0)
    return V, lam, err, nu, fail, state


def revd2(A, k: int, tol: float, cfg: REVD2Config, state: RNGState,
          k_max: int | None = None, precision=STABLE_PRECISION, draw=None):
    """Adaptive REVD2: doubles k until err_est ≤ 5·max(tol, ν)
    (rl_revd2.hh:238-244), or until 2k passes ``min(k_max, n)``.

    Returns ``(V, lam, k_used, err, fail, next_state)``; the doubling
    stops on breakdown (Cholesky NaN or a NaN estimate) with ``fail``
    True. ``draw(shape, k)``, when given, makes each round's injected
    draws: SYPS's start, shape (n, k), then the power estimate's, (n, 1).
    """
    n = _sym_dim(A)
    k_max = k_max or n
    while True:
        omega = v0 = None
        if draw is not None:
            omega, v0 = draw((n, k), k), draw((n, 1), k)
        V, lam, err, nu, fail, state = revd2_fixed_rank(
            A, k, cfg, state, precision, omega, v0)
        err_h = float(err)
        failed = bool(fail) or math.isnan(err_h)
        if (failed or err_h <= 5 * max(tol, float(nu))
                or 2 * k > min(k_max, n)):
            return V, lam, k, err_h, failed, state
        k = 2 * k
