"""Preconditioner constructors (counterpart of
``randlapack_tpu/comps/preconditioners.py``; reference:
RandLAPACK/comps/rl_preconditioners.hh: make_right_orthogonalizer :194,
nystrom_pc_data :283, rpchol_pc_data :348). The sketch-based constructors
of the JAX package (``rpc_data_svd_saso``, ``right_precond_saso``) are
not ported yet.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION
from ..ops.svd import svd_econ
from ..rng import RNGState
from .rpchol import RPCholConfig, rp_cholesky


def make_right_orthogonalizer(V_sk: torch.Tensor, sigma_sk: torch.Tensor,
                              mu, rel_tol: float | None = None):
    """M = V diag(1/√(σ² + μ)) with rank thresholding (reference :194):
    the right preconditioner making (A M) nearly orthonormal (μ=0) or
    (AᵀA + μI) well-conditioned under M·Mᵀ.

    Returns ``(M, rank)``.
    """
    tol = rel_tol if rel_tol is not None else float(
        torch.finfo(V_sk.dtype).eps)
    keep = sigma_sk > sigma_sk[0] * tol
    denom = torch.sqrt(sigma_sk * sigma_sk + mu)
    ones = torch.ones_like(denom)
    scale = torch.where(keep, 1.0 / torch.where(denom > 0, denom, ones),
                        torch.zeros_like(denom))
    return V_sk * scale[None, :], keep.sum().to(torch.int32)


def nystrom_pc_data(A, k: int, state: RNGState, mus, tol: float = 1e-6,
                    precision=STABLE_PRECISION, draw=None):
    """Adaptive Nyström preconditioner data for a PSD operator: REVD2's
    eigenpairs from rank k, doubling (the reference composes
    SYPS→SYRF→REVD2, :293-317). ``mus`` is not read, as in the JAX
    package; ``draw`` goes to ``drivers.revd2``.

    Returns ``(V, lam, k_used, next_state)``.
    """
    from ..drivers.revd2 import REVD2Config, revd2
    V, lam, k_used, _, _, state = revd2(A, k, tol, REVD2Config(), state,
                                        precision=precision, draw=draw)
    return V, lam, k_used, state


def rpchol_pc_data(A, k: int, state: RNGState, block_size: int = 64,
                   svd_method: str = "auto", noise=None):
    """RPCholesky-based preconditioner data (reference :348): rank-k
    pivoted-Cholesky factor F, then thin SVD so A ≈ V diag(λ) Vᵀ with
    λ = σ(F)².

    Returns ``(V, lam, pivots, next_state)``. ``A`` must expose the
    column/diagonal access used by :func:`rp_cholesky` and should evaluate
    the *unregularized* kernel (the reference toggles
    ``set_eval_includes_reg(false)`` first, rl_krill.hh:47). ``noise``
    goes to :func:`rp_cholesky`.
    """
    F, piv, state = rp_cholesky(A, k, RPCholConfig(block_size=block_size),
                                state, noise=noise)
    V, sig, _ = svd_econ(F, svd_method)
    return V, sig * sig, piv, state
