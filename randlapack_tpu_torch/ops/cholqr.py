"""CholeskyQR family (counterpart of ``randlapack_tpu/ops/cholqr.py``;
reference: RandLAPACK/comps/rl_orth.hh:69-98, rl_scholqr3_linops.hh:45).

Every function returns an explicit failure flag as a bool tensor on the
input's device instead of raising, like the reference's ``chol_fail``.
A failed Cholesky gives an all-NaN factor, as XLA's does, so the flag
logic is the JAX package's. ``cholqr_auto``'s rescue ladder, ``lax.cond``
in the JAX package, is a pair of host branches (at most two host reads a
call).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import STABLE_PRECISION
from .wy import _require_highest


def _gram(A):
    return A.T @ A


def gram_syrk(A, precision=STABLE_PRECISION, block: int = 512):
    """Symmetric Gram AᵀA from the upper-triangular column blocks only —
    the SYRK flop saving (rl_orth.hh:74 uses ``syrk``): block i gives
    G[i·b:(i+1)·b, i·b:] = A_iᵀ·A[:, i·b:], Σ flops m·n·b·(nb+1)/2 against
    m·n² (5/8 at nb = 4). The strictly-upper blocks are mirrored and the
    diagonal blocks symmetrized, so on this blocked path G is EXACTLY
    symmetric. When n does not split into two or more blocks of
    ``block`` it is one full GEMM, whose G is symmetric only to
    rounding."""
    _require_highest(precision)
    m, n = A.shape
    nb = n // block
    if n % block or nb < 2:
        return _gram(A)
    W = torch.zeros((n, n), dtype=A.dtype, device=A.device)
    for i in range(nb):
        W[i * block:(i + 1) * block, i * block:] = \
            A[:, i * block:(i + 1) * block].T @ A[:, i * block:]
    bidx = torch.arange(n, device=A.device) // block
    above = bidx[None, :] > bidx[:, None]
    on_diag = bidx[None, :] == bidx[:, None]
    W_up = torch.where(above, W, 0.0)
    D = torch.where(on_diag, W, 0.0)
    return W_up + W_up.T + 0.5 * (D + D.T)


def _cholesky(G):
    """Lower Cholesky factor of the symmetrized G; all-NaN when G is not
    numerically positive definite (XLA's cholesky contract, which the
    flag logic below reads). ``cholesky_ex`` does not sync the host."""
    L, info = torch.linalg.cholesky_ex(0.5 * (G + G.T))
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _solve_rt(A, R):
    """A @ R^{-1} for upper-triangular R."""
    return torch.linalg.solve_triangular(R, A, upper=True, left=False)


def _pow2(k, dtype):
    """EXACT 2^k by exponent-bit construction (``torch.ldexp`` and
    ``exp2`` can land one ulp off a power of two, which breaks the
    bitwise scale-equivariance the guards below promise)."""
    k = torch.as_tensor(k)
    if dtype == torch.float64:
        bits = (k.clamp(-1022, 1023).to(torch.int64) + 1023) << 52
        return bits.view(torch.float64)
    if dtype == torch.float32:
        bits = (k.clamp(-126, 127).to(torch.int32) + 127) << 23
        return bits.view(torch.float32)
    return torch.ldexp(torch.ones((), dtype=dtype, device=k.device), k)


def _finite_scaled(A):
    """Sanitize + scale-guard an orthogonalization input: non-finite
    entries → 0 (reported), and a GLOBAL power-of-two rescale so the Gram
    matrix can neither overflow nor underflow toward the denormal floor.
    Healthy inputs pass through bitwise (scale == 1.0). Returns
    ``(A_scaled, scale, nonfinite)``."""
    m, n = A.shape
    finite = torch.isfinite(A)
    nonfin = ~finite.all()
    A = torch.where(finite, A, torch.zeros((), dtype=A.dtype,
                                           device=A.device))
    npdt = np.dtype(str(A.dtype).removeprefix("torch."))
    fi = np.finfo(npdt)
    big = float(np.sqrt(fi.max / (8.0 * m * n)))
    small = float(npdt.type(fi.eps) ** 2)
    mx = A.abs().max()
    in_band = ((mx <= big) & (mx >= small)) | (mx == 0.0)
    k = torch.round(torch.log2(torch.where(mx > 0, mx, 1.0))).to(torch.int32)
    s = torch.where(in_band, torch.ones((), dtype=A.dtype, device=A.device),
                    _pow2(k, A.dtype))
    return A / s, s, nonfin


def cholqr(A: torch.Tensor):
    """One-pass CholeskyQR. Returns ``(Q, R, fail)``."""
    A, s, nonfin = _finite_scaled(A)
    L = _cholesky(_gram(A))
    fail = torch.isnan(L).any() | (torch.diagonal(L) <= 0).any() | nonfin
    R = L.T * s
    Q = _solve_rt(A, L.T)
    return Q, R, fail


def cholqr2(A: torch.Tensor):
    """CholeskyQR2 — two passes. Returns ``(Q, R, fail)``."""
    Q1, R1, f1 = cholqr(A)
    Q, R2, f2 = cholqr(Q1)
    return Q, R2 @ R1, f1 | f2


def shifted_cholqr3(A: torch.Tensor):
    """Shifted CholeskyQR3 (Fukaya et al.; rl_scholqr3_linops.hh:45):
    shift the first Gram by 11·eps·n·‖A‖_F², then two plain CholQR
    passes. Returns ``(Q, R, fail)``."""
    m, n = A.shape
    eps = torch.finfo(A.dtype).eps
    A, sc, nonfin = _finite_scaled(A)
    G = _gram(A)
    s = 11.0 * eps * n * torch.trace(G)
    L1 = _cholesky(G + s * torch.eye(n, dtype=A.dtype, device=A.device))
    f1 = torch.isnan(L1).any() | nonfin
    Q1 = _solve_rt(A, L1.T)
    Q2, R2, f2 = cholqr(Q1)
    Q, R3, f3 = cholqr(Q2)
    R = (R3 @ (R2 @ L1.T)) * sc
    return Q, R, f1 | f2 | f3


def preconditioned_cholqr(A: torch.Tensor, R_pre: torch.Tensor):
    """CholQR of A·R_pre⁻¹ (rl_cqrrt.hh, rl_cqrrpt.hh:287-332).
    Returns ``(Q, R, fail)`` with R = R_chol · R_pre."""
    Q, R_chol, fail = cholqr(_solve_rt(A, R_pre))
    return Q, R_chol @ R_pre, fail


def _clamp_triu_diag(R):
    """Relative floor max|diag R|·eps on a triangular factor's diagonal,
    so the solve in ``preconditioned_cholqr`` stays finite on deficient
    inputs (a local copy of ``drivers.bqrrp._safe_triu_diag``: ops do not
    import drivers)."""
    d = torch.diagonal(R)
    mx = d.abs().max()
    one = torch.ones((), dtype=R.dtype, device=R.device)
    ref = torch.where(mx > 0.0, mx * torch.finfo(R.dtype).eps, one)
    dsafe = torch.where(d.abs() > ref, d, ref)
    return torch.triu(R) - torch.diag(d) + torch.diag(dsafe)


def _kappa_est(R):
    """max|diag R| / min|diag R|: the free condition estimate of a
    Cholesky factor (NaN when the factor is)."""
    d = torch.diagonal(R).abs()
    return d.max() / torch.clamp(d.min(), min=torch.finfo(R.dtype).tiny)


def cholqr_auto(A: torch.Tensor, precision=STABLE_PRECISION):
    """Condition-aware CholQR (the reference's a-posteriori logic,
    rl_cqrrpt.hh:311-332, as a rescue ladder). The first pass's diag(R)
    ratio picks the rung:

      κ_est ≤ 0.1/√eps, finite    → CholeskyQR2
      else                         → shifted CholQR3
      that fails or κ_est > 0.03/eps → CholQR preconditioned by the
                                     Householder R (diagonal floored)

    Each rescue rung runs only when reached: one host read decides the
    first branch, a second (only on the rescue path) the next. Returns
    ``(Q, R, fail)``; ``fail`` means that even the last rung broke down.
    """
    _require_highest(precision)
    eps = torch.finfo(A.dtype).eps
    Q1, R1, f1 = cholqr(A)
    kappa = _kappa_est(R1)
    if not bool(f1 | ~torch.isfinite(kappa) | (kappa > 0.1 / eps ** 0.5)):
        Q, R2, f2 = cholqr(Q1)
        return Q, R2 @ R1, f2
    Qs, Rs, fs = shifted_cholqr3(A)
    ks = _kappa_est(Rs)
    if not bool(fs | ~torch.isfinite(ks) | (ks > 0.03 / eps)):
        return Qs, Rs, fs
    R_h = _clamp_triu_diag(torch.linalg.qr(A, mode="r")[1][:A.shape[1], :])
    Q, R, f = preconditioned_cholqr(A, R_h)
    return Q, R, f | ~torch.isfinite(Q).all()
