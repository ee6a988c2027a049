"""Householder-format reconstruction (counterpart of
``randlapack_tpu/ops/householder.py``; reference: lapack::orhr_col used in
rl_bqrrp.hh:453-510) and Q from packed reflectors: the blocked
``orhr_col`` and the column-by-column ``householder_reconstruct``.
``getrfnp``, the adaptive-sign LU ``orhr_col`` is built on, lives beside
its kernel in ``ops/lu.py`` and is re-exported here."""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from .lu import getrfnp, getrfnp_routed
from .util import matmul

__all__ = ["apply_reflectors", "getrfnp", "householder_reconstruct",
           "orhr_col"]


def householder_reconstruct(Q: torch.Tensor, precision=STABLE_PRECISION):
    """Given orthonormal Q (m, k), return ``(packed, taus, signs)`` such
    that the k reflectors (LAPACK convention: unit heads implicit, tails
    strictly below the diagonal of ``packed``) applied to I reproduce
    Q·diag(signs). Householder QR of an orthonormal Q has R = diag(±1),
    so its reflectors are Q's implicit form: one ``_larfg`` step a column,
    in the JAX package's order; vᵀ·W at ``precision``."""
    from .qr import _larfg
    precision = resolve_precision(precision)
    m, k = Q.shape
    rows = torch.arange(m, device=Q.device)
    cols = torch.arange(k, device=Q.device)
    W = Q.clone()
    V = torch.zeros_like(Q)
    taus = torch.zeros((k,), dtype=Q.dtype, device=Q.device)
    for i in range(k):
        v, tau, alpha = _larfg(W[:, i], i)
        w = torch.where(cols >= i, tau * matmul(v, W, precision), 0.0)
        W = W - torch.outer(v, w)
        coli = torch.where(rows < i, W[:, i], 0.0)
        coli[i] = alpha
        W[:, i] = coli
        V[:, i] = v
        taus[i] = tau
    signs = torch.sign(torch.diagonal(W[:k, :]))
    return torch.tril(V, -1), taus, signs


def orhr_col(Q_panel: torch.Tensor, row0: int, precision=STABLE_PRECISION,
             Q1: torch.Tensor | None = None):
    """Blocked Householder reconstruction (LAPACK ``orhr_col``): given
    Q_panel (m×b) with orthonormal columns and zeros above row ``row0``,
    produce the compact-WY factors of an exactly defined orthogonal
    H = I − V·T·Vᵀ with H·E_blk = Q_panel·diag(s):

        Q1 − S = L1·U1   (adaptive-sign unpivoted LU, |u_ii| ≥ 1)
        V = (Q_panel − S_pad)·U1⁻¹   (unit diagonal at row0+l)
        T = −U1·S·L1⁻ᵀ               (upper triangular — LAPACK layout)

    Returns ``(V, T, s)``. ``precision`` is checked and otherwise unused,
    as in the JAX package: every step is the LU and triangular solves.

    On a row shard, Q_panel holds some rows of the panel and ``row0`` is
    the block's first row counted from the shard's first row (negative,
    or past the shard, where the b×b block lies partly or wholly
    elsewhere); ``Q1`` then passes the whole block, rows [row0, row0+b),
    and V comes back as the shard's rows.
    """
    resolve_precision(precision)
    m, b = Q_panel.shape
    F, s = getrfnp_routed(Q_panel[row0:row0 + b] if Q1 is None else Q1)
    lo = min(b, max(0, -row0))
    hi = max(lo, min(b, m - row0))
    idx = torch.arange(lo, hi, device=Q_panel.device)
    S_pad = torch.zeros_like(Q_panel)
    S_pad[row0 + idx, idx] = s[lo:hi]
    V = torch.linalg.solve_triangular(F, Q_panel - S_pad, upper=True,
                                      left=False)
    # T = −U1·S·L1⁻ᵀ  via  Tᵀ = −L1⁻¹·(U1·S)ᵀ
    U1s = torch.triu(F) * s[None, :]
    T = -torch.linalg.solve_triangular(F, U1s.T, upper=False, left=True,
                                       unitriangular=True).T
    return V, T, s


def apply_reflectors(packed: torch.Tensor, taus: torch.Tensor,
                     X: torch.Tensor | None = None,
                     precision=STABLE_PRECISION):
    """Form Q (or Q·X) from the packed implicit representation (reflector
    tails strictly below the diagonal, unit heads implicit) — the
    gemqrt/ormqr capability, through ``torch.linalg.householder_product``
    (LAPACK orgqr / cuSOLVER, as the JAX package leaves it to XLA); Q·X
    at ``precision``."""
    m, k = packed.shape
    Q = torch.linalg.householder_product(
        packed + torch.eye(m, k, dtype=packed.dtype, device=packed.device),
        taus)
    return Q if X is None else matmul(Q, X, precision)
