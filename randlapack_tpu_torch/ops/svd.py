"""Economy SVD of small/skinny factors (counterpart of
``randlapack_tpu/ops/svd.py``).

Three routes:

* ``"xla"`` — the native routine (the name is kept from the JAX package,
  where it is XLA's lowering): here ``torch.linalg.svd``, accurate to
  working precision. On the CPU that is LAPACK. On the card the factor is
  first reduced by a Householder QR and the small square R goes to
  cuSOLVER's QR-iteration driver (``driver="gesvd"``): PyTorch's default
  card driver (``gesvdj``) loses U's orthogonality on f32 factors of a
  thousand columns (REVD2's V and KRILL's preconditioner basis; the
  numbers, from ``chip_smoke.py``'s ``[krill-phases]`` line, are in
  PERF.md §6).
* ``"gram_eigh"`` — the Gram/eigh route:

      p ≤ q:  eigh(B Bᵀ) → U, σ²;  Vᵀ = diag(1/σ)·UᵀB
      p > q:  eigh(BᵀB) → V, σ²;  U  = B·V·diag(1/σ)

  one GEMM, a small ``eigh`` and one more GEMM, with the Rayleigh
  refinement σᵢ = ‖Bvᵢ‖ (absolute error ~eps·σ₁ instead of the λ-path's
  eps·σ₁²/σᵢ), a stable re-sort of the refined values and vectors for
  σ < √eps·σ₁ zeroed.

``"auto"`` is ``"xla"`` on the CPU and on the card. The JAX package takes
the Gram route on the TPU because XLA's SVD compiles for minutes there;
on an H100 ``torch.linalg.svd`` of a 65536×1024 f32 factor takes about
twice the Gram route's time (PERF.md has both), and the Gram route's
derived vectors lose orthogonality as (σ₁/σᵢ)²·eps, which at that size
makes KRILL's spectral preconditioner indefinite in f32. ``"jacobi"``
is the JAX package's one-sided Jacobi route (high relative accuracy for
small singular values, opt-in): a static round-robin schedule makes each
of the q − 1 rounds of a sweep one vectorized rotation of q/2 disjoint
column pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from .util import matmul

_METHODS = ("auto", "xla", "gram_eigh", "jacobi")


def resolve_svd_method(method: str) -> str:
    """"auto" → "xla" (LAPACK on the CPU, cuSOLVER on the card: accurate
    on both); any other name stands."""
    require(method in _METHODS, f"unknown svd method {method!r}")
    return "xla" if method == "auto" else method


def _stable_descending(s):
    return torch.sort(s, descending=True, stable=True).indices


def _round_robin_schedule(q: int) -> np.ndarray:
    """Static tournament schedule (circle method): q − 1 rounds of q/2
    DISJOINT column pairs covering every pair once a sweep. Disjointness
    makes each round one vectorized rotation. Shape (q − 1, q/2, 2)."""
    idx = list(range(q))
    rounds = []
    for _ in range(q - 1):
        rounds.append([(min(idx[i], idx[q - 1 - i]),
                        max(idx[i], idx[q - 1 - i])) for i in range(q // 2)])
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]
    return np.asarray(rounds, np.int64)


def _svd_jacobi_tall(B: torch.Tensor, sweeps: int = 20):
    """One-sided Jacobi SVD of a TALL (p ≥ q) factor: ``sweeps`` sweeps of
    q − 1 rounds, each a Rutishauser rotation of q/2 disjoint column pairs
    of W, and of V beside it. W's columns and V's are kept as the rows of
    one q×(p+q) tensor, so a round gathers contiguous rows once and sums
    along them. An f32 factor's rotation coefficients (q/2 numbers a
    round) are computed in f64 from its f32 inner products: in f32,
    1/√(1 + t²) for the small angles of the late sweeps costs about ten
    times the accuracy of the singular values the JAX package reaches
    with the same rotations. Odd widths get a zero pad column, which no
    rotation mixes in. No derived-side zeroing: a deep column
    u = B·v/‖B·v‖ keeps the triplet B·vᵢ ≈ σᵢ·uᵢ consistent at any depth.
    """
    p, q0 = B.shape
    dtype, dev = B.dtype, B.device
    cdt = torch.float64 if dtype == torch.float32 else dtype
    q = q0 + (q0 % 2)
    M = torch.zeros((q, p + q), dtype=dtype, device=dev)
    M[:q0, :p] = B.T
    M[:, p:] = torch.eye(q, dtype=dtype, device=dev)
    sched = torch.as_tensor(_round_robin_schedule(q), device=dev)
    tiny = torch.finfo(dtype).tiny
    one = torch.ones((), dtype=cdt, device=dev)
    zero = torch.zeros((), dtype=cdt, device=dev)
    for r in range(sweeps * sched.shape[0]):
        i, j = sched[r % sched.shape[0]].unbind(1)
        Mi, Mj = M.index_select(0, i), M.index_select(0, j)
        Wi, Wj = Mi[:, :p], Mj[:, :p]
        a = torch.sum(Wi * Wi, dim=1).to(cdt)
        b = torch.sum(Wj * Wj, dim=1).to(cdt)
        c = torch.sum(Wi * Wj, dim=1)
        # the rotation annihilating the (i, j) Gram entry; columns already
        # orthogonal rotate by the identity; sign(0) is +1 (an exact
        # a == b tie still takes the 45° rotation)
        skip = c.abs() <= tiny
        c = c.to(cdt)
        tau = (b - a) / torch.where(skip, one, 2.0 * c)
        sgn = torch.where(tau >= 0, one, -one)
        t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        cs = 1.0 / torch.sqrt(1.0 + t * t)
        sn = cs * t
        cs = torch.where(skip, one, cs).to(dtype)[:, None]
        sn = torch.where(skip, zero, sn).to(dtype)[:, None]
        M.index_copy_(0, i, cs * Mi - sn * Mj)
        M.index_copy_(0, j, sn * Mi + cs * Mj)
    W, V = M[:, :p].T, M[:, p:].T
    s = torch.linalg.vector_norm(W, dim=0)
    ordr = _stable_descending(s)
    s, W, V = s[ordr], W[:, ordr], V[:, ordr]
    U = W / torch.where(s > 0, s, torch.ones_like(s))[None, :]
    return U[:, :q0], s[:q0], V.T[:q0, :q0]


def _svd_library(B: torch.Tensor):
    """``torch.linalg.svd`` of B: as it is on the CPU; on the card through
    a Householder QR of the tall side and ``gesvd`` of its R."""
    if B.device.type != "cuda":
        return tuple(torch.linalg.svd(B, full_matrices=False))
    if B.shape[0] < B.shape[1]:
        U, s, Vt = _svd_library(B.T)
        return Vt.T, s, U.T
    Qb, R = torch.linalg.qr(B)
    Ur, s, Vt = torch.linalg.svd(R, driver="gesvd")
    return Qb @ Ur, s, Vt


def svd_econ(B: torch.Tensor, method: str = "auto",
             precision=STABLE_PRECISION):
    """Economy SVD → (U, s, Vt) with s descending.

    ``method``: "auto" or "xla" (``torch.linalg.svd``), "gram_eigh"
    (√eps relative cutoff) or "jacobi" (one-sided Jacobi, wide B through
    its transpose). ``precision`` sets the Gram route's products
    (``ops.util.matmul``); the library and Jacobi routes have none."""
    method = resolve_svd_method(method)
    precision = resolve_precision(precision)
    if method == "xla":
        return _svd_library(B)
    if method == "jacobi":
        if B.shape[0] >= B.shape[1]:
            return _svd_jacobi_tall(B)
        U, s, Vt = _svd_jacobi_tall(B.T)
        return Vt.T, s, U.T

    p, q = B.shape
    sqrt_eps = torch.finfo(B.dtype).eps ** 0.5
    if p <= q:
        G = matmul(B, B.T, precision)
        _, U = torch.linalg.eigh(0.5 * (G + G.T))
        U = U.flip(1)
        # Rayleigh refinement: σᵢ = ‖uᵢᵀB‖, one already-needed GEMM
        W = matmul(U.T, B, precision)
        s = torch.linalg.norm(W, dim=1)
        # refined values can swap order within their error band vs eigh's
        # λ sort — re-sort so downstream S[:k] truncations stay valid
        ordr = _stable_descending(s)
        s, U, W = s[ordr], U[:, ordr], W[ordr, :]
        good = s > s[0] * sqrt_eps
        Vt = W / torch.where(good, s, torch.ones_like(s))[:, None]
        Vt = torch.where(good[:, None], Vt, torch.zeros_like(Vt))
        return U, s, Vt
    G = matmul(B.T, B, precision)
    _, V = torch.linalg.eigh(0.5 * (G + G.T))
    V = V.flip(1)
    W = matmul(B, V, precision)
    s = torch.linalg.norm(W, dim=0)       # Rayleigh-refined σ (see above)
    ordr = _stable_descending(s)
    s, V, W = s[ordr], V[:, ordr], W[:, ordr]
    good = s > s[0] * sqrt_eps
    U = W / torch.where(good, s, torch.ones_like(s))[None, :]
    U = torch.where(good[None, :], U, torch.zeros_like(U))
    return U, s, V.T
