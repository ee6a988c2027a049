"""CholeskyQR family (counterpart of ``randlapack_tpu/ops/cholqr.py``;
reference: RandLAPACK/comps/rl_orth.hh:69-98, rl_scholqr3_linops.hh:45).

Every function returns an explicit failure flag as a bool tensor on the
input's device instead of raising, like the reference's ``chol_fail``.
A failed Cholesky gives an all-NaN factor, as XLA's does, so the flag
logic is the JAX package's. ``cholqr_auto``'s rescue ladder, ``lax.cond``
in the JAX package, is a pair of host branches (at most two host reads a
call); under ``torch.func.vmap`` every rung runs and ``torch.where``
selects. ``precision`` sets the Gram and factor products
(``ops.util.matmul``).

``cholqr``, ``cholqr2``, ``preconditioned_cholqr`` and ``shifted_cholqr3``
also take a row shard: with ``mesh`` (a ``parallel.Mesh``) A holds this
rank's rows of a row-sharded matrix, each Gram is all-reduced over the
mesh, the band guard's max and non-finite flag are reduced with one
``pmax``, and Q comes back as this rank's rows, R and the flag
replicated.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import STABLE_PRECISION, resolve_precision
from .util import is_batched, matmul


def _gram(A, precision, mesh=None):
    G = matmul(A.T, A, precision)
    return G if mesh is None else mesh.psum(G)


def gram_syrk(A, precision=STABLE_PRECISION, block: int = 512):
    """Symmetric Gram AᵀA from the upper-triangular column blocks only —
    the SYRK flop saving (rl_orth.hh:74 uses ``syrk``): block i gives
    G[i·b:(i+1)·b, i·b:] = A_iᵀ·A[:, i·b:], Σ flops m·n·b·(nb+1)/2 against
    m·n² (5/8 at nb = 4). The strictly-upper blocks are mirrored and the
    diagonal blocks symmetrized, so on this blocked path G is EXACTLY
    symmetric. When n does not split into two or more blocks of
    ``block`` it is one full GEMM, whose G is symmetric only to
    rounding."""
    precision = resolve_precision(precision)
    m, n = A.shape
    nb = n // block
    if n % block or nb < 2:
        return _gram(A, precision)
    W = torch.zeros((n, n), dtype=A.dtype, device=A.device)
    for i in range(nb):
        W[i * block:(i + 1) * block, i * block:] = matmul(
            A[:, i * block:(i + 1) * block].T, A[:, i * block:], precision)
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


def _finite_scaled(A, mesh=None, rows=None):
    """Sanitize + scale-guard an orthogonalization input: non-finite
    entries → 0 (reported), and a GLOBAL power-of-two rescale so the Gram
    matrix can neither overflow nor underflow toward the denormal floor.
    Healthy inputs pass through bitwise (scale == 1.0). Returns
    ``(A_scaled, scale, nonfinite)``.

    With ``mesh``, A is a row shard: max|A| and the non-finite flag are
    reduced over the mesh in one ``pmax``, so every rank takes the same
    scale. ``rows`` sizes the overflow bound (default A's own row count;
    the sharded drivers pass the global one, as XLA sees the global
    shape)."""
    m, n = A.shape
    m = m if rows is None else rows
    finite = torch.isfinite(A)
    nonfin = ~finite.all()
    A = torch.where(finite, A, torch.zeros((), dtype=A.dtype,
                                           device=A.device))
    npdt = np.dtype(str(A.dtype).removeprefix("torch."))
    fi = np.finfo(npdt)
    big = float(np.sqrt(fi.max / (8.0 * m * n)))
    small = float(npdt.type(fi.eps) ** 2)
    mx = A.abs().max()
    if mesh is not None:
        mx, nf = mesh.pmax(torch.stack([mx, nonfin.to(A.dtype)]))
        nonfin = nf > 0
    in_band = ((mx <= big) & (mx >= small)) | (mx == 0.0)
    k = torch.round(torch.log2(torch.where(mx > 0, mx, 1.0))).to(torch.int32)
    s = torch.where(in_band, torch.ones((), dtype=A.dtype, device=A.device),
                    _pow2(k, A.dtype))
    return A / s, s, nonfin


def cholqr(A: torch.Tensor, precision=STABLE_PRECISION, mesh=None,
           rows=None):
    """One-pass CholeskyQR. Returns ``(Q, R, fail)``; with ``mesh`` on a
    row shard (``rows`` the global row count), as the module says."""
    A, s, nonfin = _finite_scaled(A, mesh, rows)
    L = _cholesky(_gram(A, precision, mesh))
    fail = torch.isnan(L).any() | (torch.diagonal(L) <= 0).any() | nonfin
    R = L.T * s
    Q = _solve_rt(A, L.T)
    return Q, R, fail


def cholqr2(A: torch.Tensor, precision=STABLE_PRECISION, mesh=None,
            rows=None):
    """CholeskyQR2 — two passes. Returns ``(Q, R, fail)``;
    ``mesh``/``rows`` as ``cholqr``."""
    Q1, R1, f1 = cholqr(A, precision, mesh, rows)
    Q, R2, f2 = cholqr(Q1, precision, mesh, rows)
    return Q, matmul(R2, R1, precision), f1 | f2


def shifted_cholqr3(A: torch.Tensor, precision=STABLE_PRECISION, mesh=None,
                    rows=None):
    """Shifted CholeskyQR3 (Fukaya et al.; rl_scholqr3_linops.hh:45):
    shift the first Gram by 11·eps·n·‖A‖_F², then two plain CholQR
    passes. Returns ``(Q, R, fail)``; ``mesh``/``rows`` as ``cholqr``."""
    m, n = A.shape
    eps = torch.finfo(A.dtype).eps
    A, sc, nonfin = _finite_scaled(A, mesh, rows)
    G = _gram(A, precision, mesh)
    s = 11.0 * eps * n * torch.trace(G)
    L1 = _cholesky(G + s * torch.eye(n, dtype=A.dtype, device=A.device))
    f1 = torch.isnan(L1).any() | nonfin
    Q1 = _solve_rt(A, L1.T)
    Q2, R2, f2 = cholqr(Q1, precision, mesh, rows)
    Q, R3, f3 = cholqr(Q2, precision, mesh, rows)
    R = matmul(R3, matmul(R2, L1.T, precision), precision) * sc
    return Q, R, f1 | f2 | f3


def preconditioned_cholqr(A: torch.Tensor, R_pre: torch.Tensor,
                          precision=STABLE_PRECISION, mesh=None, rows=None):
    """CholQR of A·R_pre⁻¹ (rl_cqrrt.hh, rl_cqrrpt.hh:287-332).
    Returns ``(Q, R, fail)`` with R = R_chol · R_pre; ``mesh``/``rows``
    as ``cholqr``."""
    Q, R_chol, fail = cholqr(_solve_rt(A, R_pre), precision, mesh, rows)
    return Q, matmul(R_chol, R_pre, precision), fail


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
    first branch, a second (only on the rescue path) the next. A batched
    A (``torch.func.vmap``) runs every rung and selects with
    ``torch.where``. Returns ``(Q, R, fail)``; ``fail`` means that even
    the last rung broke down.
    """
    precision = resolve_precision(precision)
    eps = torch.finfo(A.dtype).eps
    batched = is_batched(A)
    Q1, R1, f1 = cholqr(A, precision)
    kappa = _kappa_est(R1)
    rescue = f1 | ~torch.isfinite(kappa) | (kappa > 0.1 / eps ** 0.5)
    if batched or not bool(rescue):
        Q, R2, f2 = cholqr(Q1, precision)
        fast = (Q, matmul(R2, R1, precision), f2)
        if not batched:
            return fast
    Qs, Rs, fs = shifted_cholqr3(A, precision)
    ks = _kappa_est(Rs)
    bad = fs | ~torch.isfinite(ks) | (ks > 0.03 / eps)
    if not batched and not bool(bad):
        return Qs, Rs, fs
    R_h = _clamp_triu_diag(torch.linalg.qr(A, mode="r")[1][:A.shape[1], :])
    Q, R, f = preconditioned_cholqr(A, R_h, precision)
    hqr = (Q, R, f | ~torch.isfinite(Q).all())
    if not batched:
        return hqr
    shift = tuple(torch.where(bad, h, s) for h, s in zip(hqr, (Qs, Rs, fs)))
    return tuple(torch.where(rescue, s, f) for s, f in zip(shift, fast))
