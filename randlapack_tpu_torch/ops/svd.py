"""Economy SVD of small/skinny factors (counterpart of
``randlapack_tpu/ops/svd.py``).

Two routes:

* ``"xla"`` — the native routine (the name is kept from the JAX package,
  where it is XLA's lowering): here ``torch.linalg.svd`` (LAPACK on the
  CPU, cuSOLVER on the card), accurate to working precision.
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
(the JAX package's one-sided Jacobi route) is not ported.
"""
from __future__ import annotations

import torch

from ..errors import require

_METHODS = ("auto", "xla", "gram_eigh", "jacobi")


def resolve_svd_method(method: str) -> str:
    """"auto" → "xla" (LAPACK on the CPU, cuSOLVER on the card: accurate
    on both); any other name stands."""
    require(method in _METHODS, f"unknown svd method {method!r}")
    return "xla" if method == "auto" else method


def _stable_descending(s):
    return torch.sort(s, descending=True, stable=True).indices


def svd_econ(B: torch.Tensor, method: str = "auto"):
    """Economy SVD → (U, s, Vt) with s descending.

    ``method``: "auto" or "xla" (``torch.linalg.svd``), or "gram_eigh"
    (√eps relative cutoff)."""
    method = resolve_svd_method(method)
    if method == "xla":
        return tuple(torch.linalg.svd(B, full_matrices=False))
    if method == "jacobi":
        raise NotImplementedError("svd_econ('jacobi') is not ported")

    p, q = B.shape
    sqrt_eps = torch.finfo(B.dtype).eps ** 0.5
    if p <= q:
        G = B @ B.T
        _, U = torch.linalg.eigh(0.5 * (G + G.T))
        U = U.flip(1)
        # Rayleigh refinement: σᵢ = ‖uᵢᵀB‖, one already-needed GEMM
        W = U.T @ B
        s = torch.linalg.norm(W, dim=1)
        # refined values can swap order within their error band vs eigh's
        # λ sort — re-sort so downstream S[:k] truncations stay valid
        ordr = _stable_descending(s)
        s, U, W = s[ordr], U[:, ordr], W[ordr, :]
        good = s > s[0] * sqrt_eps
        Vt = W / torch.where(good, s, torch.ones_like(s))[:, None]
        Vt = torch.where(good[:, None], Vt, torch.zeros_like(Vt))
        return U, s, Vt
    G = B.T @ B
    _, V = torch.linalg.eigh(0.5 * (G + G.T))
    V = V.flip(1)
    W = B @ V
    s = torch.linalg.norm(W, dim=0)       # Rayleigh-refined σ (see above)
    ordr = _stable_descending(s)
    s, V, W = s[ordr], V[:, ordr], W[:, ordr]
    good = s > s[0] * sqrt_eps
    U = W / torch.where(good, s, torch.ones_like(s))[None, :]
    U = torch.where(good[None, :], U, torch.zeros_like(U))
    return U, s, V.T
