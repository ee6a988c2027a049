"""RSVD — economy randomized SVD through QB (counterpart of
``randlapack_tpu/drivers/rsvd.py``; reference: RandLAPACK/drivers/
rl_rsvd.hh: RSVDalg :16, RSVD::call :114 — QB(A), the dense SVD of the
small factor B, U = Q·Û). Every step is a PyTorch call (the JAX package
runs none of it in Pallas): cuBLAS products, cuSOLVER LU, Cholesky and
QR, ``torch.linalg.svd``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..comps.qb import QBConfig, qb, qb_blocked
from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..ops.svd import svd_econ
from ..ops.util import matmul
from ..rng import RNGState


@dataclasses.dataclass(frozen=True)
class RSVDConfig:
    qb: QBConfig = QBConfig()
    svd_method: str = "auto"      # see ops.svd.svd_econ


def rsvd_fixed_rank(A: torch.Tensor, k: int, cfg: RSVDConfig,
                    state: RNGState, precision=STABLE_PRECISION,
                    omegas=None):
    """Fixed-rank RSVD: A ≈ U diag(S) Vᵀ with k terms.

    Returns ``(U, S, Vt, err, next_state)``; ``err`` is the relative
    Frobenius error of the rank-k QB (an upper bound for the SVD's).
    ``omegas`` injects QB's per-block starts (see ``comps.qb_blocked``).
    Products at ``precision`` (``ops.util.matmul``).
    """
    require_fp32_matmul()
    precision = resolve_precision(precision)
    Q, B, errs, state = qb_blocked(A, k, cfg.qb, state, precision, omegas)
    Ub, S, Vt = svd_econ(B, cfg.svd_method, precision)
    return matmul(Q, Ub, precision), S, Vt, errs[-1], state


def rsvd(A: torch.Tensor, k: int, cfg: RSVDConfig, state: RNGState,
         tol: float = 0.0, precision=STABLE_PRECISION, omegas=None):
    """Adaptive-rank RSVD: QB stops at the first block meeting ``tol``
    and the SVD is of that many rows. Returns
    ``(U, S, Vt, rank, err, next_state)``."""
    require_fp32_matmul()
    precision = resolve_precision(precision)
    m, n = A.shape
    require(0 < k <= min(m, n), "target rank out of range")
    Q, B, rank, err, state = qb(A, k, cfg.qb, state, tol, precision, omegas)
    Ub, S, Vt = svd_econ(B, cfg.svd_method, precision)
    return matmul(Q, Ub, precision), S, Vt, rank, err, state
