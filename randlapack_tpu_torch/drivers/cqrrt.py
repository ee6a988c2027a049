"""CQRRT — unpivoted sketch-then-precondition CholeskyQR (counterpart of
``randlapack_tpu/drivers/cqrrt.py``; reference: RandLAPACK/drivers/
rl_cqrrt.hh: CQRRTalg :21, CQRRT::call :123; algorithm of
arXiv:2111.11148): sketch A, QR the small sketch, and use its R as a
right preconditioner so one CholQR pass orthogonalizes even an
ill-conditioned A. Every step is a PyTorch call (the JAX package computes
them outside any Pallas kernel); the sketches are those of CQRRPT, and
the same draws can be injected (``sketch=``, ``noise=``; see
``drivers/cqrrpt.py``).
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..ops.cholqr import _cholesky, _finite_scaled, preconditioned_cholqr
from ..ops.qr import qr_econ
from ..ops.util import matmul
from ..rng import RNGState
from ..utils.timing import PhaseTimer, device_sync
from .bqrrp import _safe_triu_diag
from .cqrrpt import CQRRPTConfig, _orth_phase, _sketch_phase


class SketchKind(enum.Enum):
    saso = "saso"
    srht = "srht"
    gaussian = "gaussian"


@dataclasses.dataclass(frozen=True)
class CQRRTConfig:
    """The JAX package's configuration, field for field (see
    ``randlapack_tpu/drivers/cqrrt.py`` for each field's story)."""
    d_factor: float = 1.25        # sketch rows = d_factor * n
    sketch: SketchKind = SketchKind.saso
    vec_nnz: int = 2              # SASO nonzeros per column
    compute_q: bool = True
    orthogonalization: bool = False  # general-purpose orthogonalizer
                                     # (rl_cqrrt.hh:113-115): returns
                                     # (Q, R_chol, rank, fail, state)
    eps_rank: float | None = None    # deficiency threshold relative to
                                     # max |diag R_sk| (None → machine eps)


def _sketch(A, cfg: CQRRTConfig, state: RNGState, precision, sketch=None):
    """CQRRPT's sketch phase at CQRRT's d_factor, kind and nnz."""
    return _sketch_phase(A, CQRRPTConfig(d_factor=cfg.d_factor,
                                         vec_nnz=cfg.vec_nnz,
                                         sketch=cfg.sketch.value),
                         state, precision, sketch)


def _sketch_qr(A_sk):
    """R of the sketch with its (near-)zero diagonal entries raised to
    the relative floor max|diag|·eps."""
    return _safe_triu_diag(qr_econ(A_sk)[1])


def _cqrrt_timed(A, cfg: CQRRTConfig, state: RNGState, precision,
                 sketch=None):
    """Phase-split execution mirroring rl_cqrrt.hh's slots: saso, qr,
    precond, gram, potrf, q, finalize."""
    timer = PhaseTimer()
    with timer.phase("saso"):
        A_sk, state = _sketch(A, cfg, state, precision, sketch)
        device_sync(A_sk)
    with timer.phase("qr"):
        R_sk = _sketch_qr(A_sk)
        device_sync(R_sk)
    with timer.phase("precond"):
        A_pre = torch.linalg.solve_triangular(R_sk, A, upper=True,
                                              left=False)
        A_pre, s, nonfin = _finite_scaled(A_pre)
        device_sync(A_pre)
    with timer.phase("gram"):
        G = matmul(A_pre.T, A_pre, precision)
        device_sync(G)
    with timer.phase("potrf"):
        L = _cholesky(G)
        device_sync(L)
    fail = torch.isnan(L).any() | nonfin
    Q = None
    if cfg.compute_q:
        with timer.phase("q"):
            Q = torch.linalg.solve_triangular(L.T, A_pre, upper=True,
                                              left=False)
            device_sync(Q)
    with timer.phase("finalize"):
        R = matmul(L.T * s, R_sk, precision)
        device_sync(R)
    return Q, R, fail, state, timer.report()


def cqrrt(A: torch.Tensor, cfg: CQRRTConfig, state: RNGState,
          precision=STABLE_PRECISION, timing: bool = False, sketch=None,
          noise: torch.Tensor | None = None):
    """Unpivoted QR of tall A. Returns ``(Q, R, fail, next_state)``
    (+ the phase dict when ``timing=True``); Q is None with
    ``compute_q=False`` (R from one Gram pass, no solve for Q). ``fail``
    is the potrf-failure signal: the preconditioned CholQR broke down.

    ``cfg.orthogonalization=True`` (rl_cqrrt.hh:113-115) returns
    ``(Q, R_chol, rank, fail, next_state)`` instead: Q a FULL (m, n)
    orthonormal basis even for rank-deficient A (deficient columns
    completed with projected Gaussians), ``rank`` the columns that came
    from A, R the un-finalized CholQR factor; with ``timing=True`` the
    phase dict holds ``total`` only. ``sketch`` and ``noise`` inject the
    random draws. ``precision`` sets the products the JAX package runs
    at the driver's precision (``ops.util.matmul``).
    """
    require(A.shape[0] >= A.shape[1],
            "cqrrt requires a tall input (m >= n, rl_cqrrt.hh contract) "
            f"— got {tuple(A.shape)}")
    require_fp32_matmul()
    precision = resolve_precision(precision)
    if cfg.orthogonalization:
        if timing:
            timer = PhaseTimer()
            with timer.phase("total"):
                out = _cqrrt_orth(A, cfg, state, precision, sketch, noise)
                device_sync(out[0])
            return (*out, timer.report())
        return _cqrrt_orth(A, cfg, state, precision, sketch, noise)
    if timing:
        return _cqrrt_timed(A, cfg, state, precision, sketch)
    A_sk, state = _sketch(A, cfg, state, precision, sketch)
    R_sk = _sketch_qr(A_sk)
    if not cfg.compute_q:
        # Q-less path (rl_cqrrt.hh:113): Gram + Cholesky only
        A_pre = torch.linalg.solve_triangular(R_sk, A, upper=True,
                                              left=False)
        A_pre, s, nonfin = _finite_scaled(A_pre)
        L = _cholesky(matmul(A_pre.T, A_pre, precision))
        fail = torch.isnan(L).any() | nonfin
        return None, matmul(L.T * s, R_sk, precision), fail, state
    Q, R, fail = preconditioned_cholqr(A, R_sk, precision)
    return Q, R, fail, state


def _cqrrt_orth(A, cfg: CQRRTConfig, state: RNGState, precision, sketch=None,
                noise=None):
    """Orthogonalization mode (rl_cqrrt.hh:113-115): deficient columns
    (small unpivoted sketch-R diagonal, a column-wise mask) are zeroed
    through the preconditioned CholQR, with the identity in the Gram
    there, and completed with BCGS2-projected Gaussians. A second CholQR
    pass (CholQR2) holds eps-level orthogonality when kept columns sit
    just above the cutoff. The R finalize (undoing the preconditioner)
    is skipped, as in the reference (rl_cqrrt.hh:247)."""
    m, n = A.shape
    dt, dev = A.dtype, A.device
    eye = torch.eye(n, dtype=dt, device=dev)
    A_sk, state = _sketch(A, cfg, state, precision, sketch)
    R_sk = qr_econ(A_sk)[1]
    d_sk = torch.diagonal(R_sk)
    mx = d_sk.abs().max()
    eps = cfg.eps_rank or torch.finfo(dt).eps
    tol = torch.where(mx > 0.0, mx * eps, 1.0)
    keep = (d_sk.abs() > tol).to(dt)
    rank = keep.sum().to(torch.int32)
    dsafe = torch.where(keep > 0, d_sk, 1.0)
    R_sk_safe = torch.triu(R_sk) - torch.diag(d_sk) + torch.diag(dsafe)
    A_pre = torch.linalg.solve_triangular(R_sk_safe, A, upper=True,
                                          left=False) * keep[None, :]
    A_pre, s, nonfin = _finite_scaled(A_pre)
    L = _cholesky(matmul(A_pre.T, A_pre, precision) + torch.diag(1.0 - keep))
    fail = torch.isnan(L).any() | nonfin
    L_safe = torch.where(torch.isnan(L), eye, L)
    Q = torch.linalg.solve_triangular(L_safe.T, A_pre, upper=True,
                                      left=False)
    L2 = _cholesky(matmul(Q.T, Q, precision) + torch.diag(1.0 - keep))
    fail = fail | torch.isnan(L2).any()
    L2_safe = torch.where(torch.isnan(L2), eye, L2)
    Q = torch.linalg.solve_triangular(L2_safe.T, Q, upper=True, left=False)
    Q, fail = _orth_phase(Q, keep, state, fail, precision, noise)
    R = matmul(L2_safe.T, L_safe.T, precision) * s
    return Q, R, rank, fail, state.advance()
