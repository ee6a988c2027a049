"""Q-less CholQR family over abstract linear operators (counterpart of
``randlapack_tpu/drivers/cholqr_linops.py``; reference:
RandLAPACK/drivers/rl_cholqr_linops.hh :124, rl_cqrrt_linops.hh,
rl_scholqr3_linops.hh :132/:444).

The Gram matrix is computed through operator calls, optionally
column-blocked to cap peak memory at O(m·b) (rl_cholqr_linops.hh:56-76,
loop :217-231), and factored without ever materializing Q. Further
stabilization passes recompute the Gram of the implicitly preconditioned
operator A·R⁻¹ with fresh operator applies: a cleanup in Gram space
(R⁻ᵀGR⁻¹ in floating point) cannot reduce the eps·κ² error.

Every step is a PyTorch call (the JAX package runs none of it in
Pallas): the operator's products (cuBLAS or cuSPARSE), cuBLAS Grams,
cuSOLVER Cholesky and triangular solves. A failed Cholesky gives an
all-NaN factor (``ops.cholqr._cholesky``, XLA's contract), so ``fail``
is a device flag read by no one here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..linops.base import materialize
from ..ops.cholqr import _cholesky, shifted_cholqr3
from ..ops.util import matmul
from ..rng import RNGState
from ..utils.timing import PhaseTimer, device_sync


def _finite_gram(G):
    """Zero a non-finite accumulated Gram and raise the fail flag (the
    operand is an operator, so there is no cheap global rescale). Kept
    from the JAX package, where it keeps Inf from the TPU Cholesky; it
    changes results (a zero Gram factors to NaN), so the port keeps it."""
    finite = torch.isfinite(G)
    return torch.where(finite, G, torch.zeros((), dtype=G.dtype,
                                              device=G.device)), \
        ~finite.all()


def _gram_blocks(n: int, block: int | None, cols_of, precision):
    """G = YᵀY at ``precision`` (``ops.util.matmul``) for the n columns
    that ``cols_of(start, size)`` makes, in
    column blocks of ``block`` (None → one shot), in the JAX package's
    order: for each block j, the blocks i < j again (recomputed, so the
    peak stays at two blocks), then the diagonal block; a remainder block
    last."""
    if block is None or block >= n:
        Y = cols_of(0, n)
        return matmul(Y.T, Y, precision)
    b = block
    nb, rem = divmod(n, b)
    G = None
    for j in range(nb):
        Yj = cols_of(j * b, b)
        if G is None:
            G = torch.zeros((n, n), dtype=Yj.dtype, device=Yj.device)
        for i in range(j):
            Gij = matmul(cols_of(i * b, b).T, Yj, precision)
            G[i * b:(i + 1) * b, j * b:(j + 1) * b] = Gij
            G[j * b:(j + 1) * b, i * b:(i + 1) * b] = Gij.T
        G[j * b:(j + 1) * b, j * b:(j + 1) * b] = matmul(Yj.T, Yj, precision)
    if rem:
        Yr = cols_of(nb * b, rem)
        if G is None:
            G = torch.zeros((n, n), dtype=Yr.dtype, device=Yr.device)
        for i in range(nb):
            Gir = matmul(cols_of(i * b, b).T, Yr, precision)
            G[i * b:(i + 1) * b, nb * b:] = Gir
            G[nb * b:, i * b:(i + 1) * b] = Gir.T
        G[nb * b:, nb * b:] = matmul(Yr.T, Yr, precision)
    return G


def blocked_gram(A, block: int | None = None, precision=STABLE_PRECISION):
    """G = AᵀA with peak memory O(m·block) (None → one shot), the columns
    from ``A.cols``; an operator without ``cols`` is materialized (one
    shot)."""
    precision = resolve_precision(precision)
    if not hasattr(A, "cols"):
        M = materialize(A)
        return matmul(M.T, M, precision)
    return _gram_blocks(A.n_cols, block,
                        lambda start, size: A.cols(start, size, precision),
                        precision)


def blocked_gram_precond(A, R_chain, block: int | None = None,
                         precision=STABLE_PRECISION):
    """Gram of the implicitly preconditioned operator A·R₁⁻¹·R₂⁻¹·…, with
    fresh operator applies per column block (peak memory O(m·block)).

    ``R_chain`` is the sequence of per-pass triangular factors, applied as
    a chain of solves (the last factor first): one solve against their
    product would bring back A's full conditioning and cap the accuracy
    at eps·κ (the reference's accumulated right factor M = R1⁻¹R2⁻¹…,
    rl_scholqr3_linops.hh:36-42, is the same structure)."""
    precision = resolve_precision(precision)
    n = A.n_cols
    if not isinstance(R_chain, (tuple, list)):
        R_chain = (R_chain,)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    def pre_cols(start, size):
        X = eye[:, start:start + size]
        for Rk in reversed(R_chain):
            X = torch.linalg.solve_triangular(Rk, X, upper=True)
        return A.matmat(X, precision)

    return _gram_blocks(n, block, pre_cols, precision)


@dataclasses.dataclass(frozen=True)
class CholQRLinopsConfig:
    gram_block: int | None = None  # column-block size (None = one shot)
    passes: int = 1                # CholQR passes on the Gram matrix


def _phases(timing: bool):
    """A PhaseTimer's ``phase`` when timing, else a no-op context; with
    the timer (or None)."""
    timer = PhaseTimer() if timing else None

    def phase(name):
        return timer.phase(name) if timing else contextlib.nullcontext()
    return timer, phase


def _sync(t, timing):
    if timing:
        device_sync(t)


def cholqr_linops(A, cfg: CholQRLinopsConfig = CholQRLinopsConfig(),
                  precision=STABLE_PRECISION, timing: bool = False):
    """Q-less CholQR of a linear operator. Returns ``(R, fail, chain)``
    with AᵀA = RᵀR and ``chain`` the per-pass factors; Q = A·R⁻¹ stays
    implicit (``materialize_q`` builds it in test mode, as
    rl_cholqr_linops.hh:259-286 does).

    ``timing=True`` syncs the card between phases and appends the phase
    dict (the reference's 6-slot timing vector): gram_i and potrf_i for
    each pass."""
    require_fp32_matmul()
    timer, phase = _phases(timing)
    with phase("gram_0"):
        G, nf0 = _finite_gram(blocked_gram(A, cfg.gram_block, precision))
        _sync(G, timing)
    with phase("potrf_0"):
        L = _cholesky(G)
        _sync(L, timing)
    fail = torch.isnan(L).any() | nf0
    chain = (L.T,)
    R = L.T
    for p_ in range(cfg.passes - 1):
        # extra pass: fresh Gram of the chain-preconditioned operator
        with phase(f"gram_{p_ + 1}"):
            G2, nf2 = _finite_gram(blocked_gram_precond(
                A, chain, cfg.gram_block, precision))
            _sync(G2, timing)
        with phase(f"potrf_{p_ + 1}"):
            L2 = _cholesky(G2)
            _sync(L2, timing)
        fail = fail | torch.isnan(L2).any() | nf2
        chain = chain + (L2.T,)
        R = matmul(L2.T, R, precision)
    if timing:
        return R, fail, chain, timer.report()
    return R, fail, chain


def scholqr3_linops(A, cfg: CholQRLinopsConfig = CholQRLinopsConfig(),
                    precision=STABLE_PRECISION):
    """Shifted CholQR3 through operator calls only
    (rl_scholqr3_linops.hh): one pass over A shifted by
    s = 11·eps·n·‖A‖_F², then two cleanup passes, each with a fresh Gram
    of the chain-preconditioned operator. Returns ``(R, fail, chain)``."""
    require_fp32_matmul()
    n = A.n_cols
    G, nfg = _finite_gram(blocked_gram(A, cfg.gram_block, precision))
    eps = torch.finfo(G.dtype).eps
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    s = 11.0 * eps * n * torch.trace(G)      # trace(G) = ‖A‖_F²
    L1 = _cholesky(G + s * eye)
    fail = torch.isnan(L1).any() | nfg
    chain = (L1.T,)
    R = L1.T
    for _ in range(2):
        # every cleanup pass may need a shift too: at large m the Gram's
        # accumulation error (~√m·eps) can exceed the preconditioned
        # smallest eigenvalue. Unshifted first (no orthogonality cost);
        # where that breaks down, the trace-relative shift, and the flag
        G2, nfg2 = _finite_gram(blocked_gram_precond(A, chain,
                                                     cfg.gram_block,
                                                     precision))
        fail = fail | nfg2
        G2 = 0.5 * (G2 + G2.T)
        L2u = _cholesky(G2)
        bad = torch.isnan(L2u).any()
        L2s = _cholesky(G2 + 11.0 * eps * torch.trace(G2) * eye)
        L2 = torch.where(bad, L2s, L2u)
        fail = fail | bad
        chain = chain + (L2.T,)
        R = matmul(L2.T, R, precision)
    return R, fail, chain


@dataclasses.dataclass(frozen=True)
class CQRRTLinopsConfig:
    d_factor: float = 1.25
    gram_block: int | None = None


def _floor_diag(R):
    """Relative floor max|diag R|·eps on R's diagonal (the JAX package's
    inline copy of ``bqrrp._safe_triu_diag``)."""
    dg = torch.diagonal(R)
    mxd = dg.abs().max()
    one = torch.ones((), dtype=R.dtype, device=R.device)
    ref = torch.where(mxd > 0.0, mxd * torch.finfo(R.dtype).eps, one)
    return R - torch.diag(dg) + torch.diag(torch.where(dg.abs() > ref, dg,
                                                       ref))


def cqrrt_linops(A, cfg: CQRRTLinopsConfig, state: RNGState,
                 precision=STABLE_PRECISION, timing: bool = False,
                 sketch=None):
    """Q-less CQRRT over an operator (rl_cqrrt_linops.hh): a dense
    Gaussian sketch of the operator through ``tmatmat``, the QR of the
    sketch → R_sk, then one Gram pass of the preconditioned operator with
    fresh applies (a Gram-space solve would cap the accuracy at eps·κ).
    Returns ``(R, fail, chain, next_state)``, with the phase dict
    (rl_cqrrt_linops.hh:45-49) appended when ``timing=True``.

    ``sketch``: the (m, d) standard Gaussian, d = int(d_factor·n), to use
    instead of drawing it from ``state`` (scaled by 1/√d as a drawn one
    is); the state advances either way."""
    require_fp32_matmul()
    precision = resolve_precision(precision)
    timer, phase = _phases(timing)
    m, n = A.n_rows, A.n_cols
    d = int(cfg.d_factor * n)
    with phase("sketch"):
        if sketch is None:
            gen, state = state.spawn(A.device)
            sketch = torch.randn((m, d), generator=gen, dtype=A.dtype,
                                 device=A.device)
        else:
            state = state.advance()
        S_t = sketch.to(A.dtype) / math.sqrt(d)
        A_sk = A.tmatmat(S_t, precision).T          # (d, n) = S·A
        _sync(A_sk, timing)
    with phase("qr"):
        R_sk = _floor_diag(torch.linalg.qr(A_sk, mode="r")[1])
        _sync(R_sk, timing)
    with phase("gram"):
        Gp = blocked_gram_precond(A, (R_sk,), cfg.gram_block, precision)
        _sync(Gp, timing)
    with phase("potrf"):
        L = _cholesky(Gp)
        _sync(L, timing)
    fail = torch.isnan(L).any()
    chain = (R_sk, L.T)
    with phase("recombine"):
        R = matmul(L.T, R_sk, precision)
        _sync(R, timing)
    if timing:
        return R, fail, chain, state, timer.report()
    return R, fail, chain, state


def scholqr3_linops_basic(A, precision=STABLE_PRECISION):
    """Shifted CholQR3 of the materialized operator — the reference's
    ``sCholQR3_linops_basic`` (rl_scholqr3_linops.hh:444). O(m·n) memory
    but eps-grade orthogonality at any cond(A): the Q-less blocked
    variant is limited to ~eps·κ(R₁). Returns ``(Q, R, fail)``."""
    require_fp32_matmul()
    return shifted_cholqr3(materialize(A), precision)


def materialize_q(A, R_or_chain, precision=STABLE_PRECISION):
    """Test-mode Q = A·R₁⁻¹·R₂⁻¹·… (rl_cholqr_linops.hh:259-286). Pass
    the per-pass chain the drivers return: one solve against the
    accumulated R has κ(A) conditioning and caps Q's orthogonality at
    eps·κ."""
    resolve_precision(precision)
    M = materialize(A)
    chain = (R_or_chain if isinstance(R_or_chain, (tuple, list))
             else (R_or_chain,))
    for Rk in chain:
        M = torch.linalg.solve_triangular(Rk, M, upper=True, left=False)
    return M
