"""Preconditioner constructors (counterpart of
``randlapack_tpu/comps/preconditioners.py``; reference:
RandLAPACK/comps/rl_preconditioners.hh: rpc_data_svd :30,
rpc_data_svd_saso :136, make_right_orthogonalizer :194, nystrom_pc_data
:283, rpchol_pc_data :348).

The SASO sketch of the sketch-based constructors can be injected
(``sketch=``, a ``SparseSkOp``; the tests draw it with JAX); an injected
sketch still advances ``state`` by the two draws it replaces. Without
one, it is drawn on A's device.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from ..ops.svd import svd_econ
from ..ops.util import matmul
from ..rng import RNGState
from ..sketching import SparseDist, SparseSkOp, fill_sparse, saso_left_apply
from .rpchol import RPCholConfig, rp_cholesky


def saso_sketch(A: torch.Tensor, d: int, vec_nnz: int, state: RNGState,
                sketch=None):
    """S·A for a d×m SASO S with ``vec_nnz`` nonzeros a column: ``sketch``
    when given (the state advanced by two), else drawn from ``state``.
    Returns ``(A_sk, next_state)``."""
    m = A.shape[0]
    if sketch is None:
        sketch, state = fill_sparse(SparseDist(d, m, vec_nnz), state,
                                    dtype=A.dtype, device=A.device)
    else:
        require(isinstance(sketch, SparseSkOp)
                and (sketch.n_rows, sketch.n_cols) == (d, m),
                f"sketch must be a {d}x{m} SparseSkOp")
        state = state.advance().advance()
    return saso_left_apply(sketch, A), state


def _sketch_or_self(A, d, vec_nnz, state, sketch):
    if d >= A.shape[0]:
        # near-square: A is its own exact sketch, nothing is drawn
        require(sketch is None, "d >= m: A is its own sketch, none is "
                "drawn, so none can be injected")
        return A, state
    return saso_sketch(A, d, vec_nnz, state, sketch)


def rpc_data_svd_saso(A: torch.Tensor, d: int, state: RNGState,
                      vec_nnz: int = 8, svd_method: str = "auto",
                      precision=STABLE_PRECISION, sketch=None):
    """Sketch A (m×n, m≫n) with a d×m SASO and SVD the sketch: the data
    of a right preconditioner of the normal equations (reference:
    rpc_data_svd_saso :136 → rpc_data_svd :30).

    Returns ``(V_sk, sigma_sk, next_state)``: right singular vectors (n, n)
    and singular values (n,) of the sketch."""
    A_sk, state = _sketch_or_self(A, d, vec_nnz, state, sketch)
    _, sigma, Vt = svd_econ(A_sk, svd_method, precision)
    return Vt.T, sigma, state


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


def right_precond_saso(A: torch.Tensor, d: int, mu, state: RNGState,
                       vec_nnz: int = 8, svd_method: str = "auto",
                       refine: bool = True, precision=STABLE_PRECISION,
                       sketch=None):
    """``rpc_data_svd_saso`` → ``make_right_orthogonalizer``, then with
    ``refine`` one Cholesky pass of M against the sketch Gram:
    Ĝ = Mᵀ(A_skᵀA_sk + μI)M, a unit diagonal where diag(Ĝ) = 0 (the zero
    columns of a rank-deficient M), L = chol(½(Ĝ + Ĝᵀ)) and M ← M·L⁻ᵀ.
    A Cholesky that fails (or gives NaN) leaves M as it was and sets
    ``fail``. The JAX package refines to repair its TPU Gram/eigh SVD; on
    the card the SVD is a QR and ``gesvd``, so the pass changes M by
    rounding there, but it is kept, as it changes M.

    Returns ``(M, rank, fail, next_state)``; ``fail`` a bool tensor.
    Products at ``precision`` (``ops.util.matmul``)."""
    precision = resolve_precision(precision)
    A_sk, state = _sketch_or_self(A, d, vec_nnz, state, sketch)
    _, sigma, Vt = svd_econ(A_sk, svd_method, precision)
    M, rank = make_right_orthogonalizer(Vt.T, sigma, mu)
    if not refine:
        return M, rank, torch.zeros((), dtype=torch.bool,
                                    device=A.device), state
    M, fail = refine_right_precond(A_sk, M, mu, precision)
    return M, rank, fail, state


def refine_right_precond(A_sk: torch.Tensor, M: torch.Tensor, mu,
                         precision=STABLE_PRECISION):
    """``right_precond_saso``'s refinement: M·L⁻ᵀ for the Cholesky factor
    L of Ĝ = Mᵀ(A_skᵀA_sk + μI)M (unit diagonal where diag(Ĝ) = 0).
    Returns ``(M, fail)``; on a failed (or NaN) Cholesky, M unchanged and
    ``fail`` True, with no host sync."""
    n = M.shape[1]
    AskM = matmul(A_sk, M, precision)
    G = matmul(AskM.T, AskM, precision) + mu * matmul(M.T, M, precision)
    dg = torch.diagonal(G)
    G = G + torch.diag(torch.where(dg > 0, torch.zeros_like(dg),
                                   torch.ones_like(dg)))
    L, info = torch.linalg.cholesky_ex(0.5 * (G + G.T))
    fail = (info != 0) | torch.isnan(L).any()
    L = torch.where(fail, torch.eye(n, dtype=M.dtype, device=M.device), L)
    return torch.linalg.solve_triangular(L.T, M, upper=True,
                                         left=False), fail


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
                   svd_method: str = "auto", precision=STABLE_PRECISION,
                   noise=None):
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
                                state, precision, noise=noise)
    V, sig, _ = svd_econ(F, svd_method, precision)
    return V, sig * sig, piv, state
