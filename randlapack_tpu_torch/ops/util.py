"""Matrix utilities (counterpart of ``randlapack_tpu/ops/util.py``;
reference: RandLAPACK/misc/rl_util.hh and RandBLAS's small utilities):
triangles, permutations, norms, rank and condition checks, and the
buffer-layout helpers, which on tensors reduce to views and copies.
Scalar results are 0-d tensors on the input's device (no host sync)."""
from __future__ import annotations

import torch

from ..errors import require


def eye(m: int, n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.eye(m, n, dtype=dtype, device=device)


def get_U(A: torch.Tensor, k: int = 0) -> torch.Tensor:
    """Upper triangle from diagonal ``k`` (rl_util.hh:120)."""
    return torch.triu(A, k)


def get_L(A: torch.Tensor, unit_diag: bool = False) -> torch.Tensor:
    """Lower triangle, optionally with a unit diagonal (rl_util.hh:102)."""
    L = torch.tril(A)
    if unit_diag:
        L.diagonal().fill_(1.0)
    return L


def col_swap(A: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Column permutation A[:, J] — the reference's lapmt-backed col_swap
    (rl_util.hh:152) as a gather."""
    return A.index_select(1, J)


def row_swap(A: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Row permutation A[J, :] as a gather."""
    return A.index_select(0, J)


def compose_pivots(J_outer: torch.Tensor,
                   J_inner: torch.Tensor) -> torch.Tensor:
    """Pivot composition: applying J_inner after J_outer equals
    J_outer[J_inner]."""
    return J_outer.index_select(0, J_inner)


def invert_pivots(J: torch.Tensor) -> torch.Tensor:
    """Inverse permutation."""
    inv = torch.empty_like(J)
    inv[J] = torch.arange(J.shape[0], dtype=J.dtype, device=J.device)
    return inv


def naive_rank_est(diag_R: torch.Tensor, tol) -> torch.Tensor:
    """Largest k such that |R[i,i]| > tol for all i < k
    (reference: rl_cqrrpt.hh:267-272). Returns an int32 scalar tensor on
    diag_R's device (no host sync)."""
    ok = (diag_R.abs() > tol).to(torch.int32)
    return torch.cumprod(ok, 0).sum().to(torch.int32)


def orthogonality_check(Q: torch.Tensor) -> torch.Tensor:
    """‖QᵀQ − I‖_F (rl_util.hh:468), a 0-d tensor on Q's device."""
    k = Q.shape[1]
    G = Q.T @ Q
    return torch.linalg.matrix_norm(
        G - torch.eye(k, dtype=Q.dtype, device=Q.device))


def normc(A: torch.Tensor) -> torch.Tensor:
    """Column-normalized copy; zero columns stay zero (rl_util.hh:254)."""
    nrm = torch.linalg.vector_norm(A, dim=0, keepdim=True)
    return A / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def cond_num_check(A: torch.Tensor) -> torch.Tensor:
    """2-norm condition number from the singular values (rl_util.hh:403)."""
    s = torch.linalg.svdvals(A)
    return s[0] / s[-1]


def rank_check(A: torch.Tensor, rel_tol: float = 1e-12) -> torch.Tensor:
    """Numerical rank: singular values above rel_tol·σ₁, int32
    (rl_util.hh:427)."""
    s = torch.linalg.svdvals(A)
    return (s > rel_tol * s[0]).sum().to(torch.int32)


def fro_norm(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(A)


def diag_is_nonzero(A: torch.Tensor, tol=0.0) -> torch.Tensor:
    """Whether every diagonal entry exceeds ``tol`` in magnitude
    (rl_util.hh:138)."""
    return (torch.diagonal(A).abs() > tol).all()


def rank_search_binary(singvals: torch.Tensor, tol) -> torch.Tensor:
    """How many singular values exceed ``tol`` (rl_util.hh:223's answer,
    counted instead of searched), int32."""
    return (singvals > tol).sum().to(torch.int32)


def symmetrize(A: torch.Tensor, uplo: str = "upper") -> torch.Tensor:
    """Copy one triangle onto the other (RandBLAS ``symmetrize``);
    ``uplo`` names the triangle holding the data."""
    if uplo == "upper":
        return torch.triu(A) + torch.triu(A, 1).T
    return torch.tril(A) + torch.tril(A, -1).T


def safe_scal(alpha, x: torch.Tensor) -> torch.Tensor:
    """Overflow-guarded scaling (RandBLAS ``safe_scal``): α·x as
    (sign(α)·√|α|)·(√|α|·x) when |α| exceeds √(largest finite)."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    big = torch.finfo(x.dtype).max ** 0.5
    r = torch.sqrt(alpha.abs())
    return torch.where(alpha.abs() > big, (torch.sign(alpha) * r) * (r * x),
                       alpha * x)


def omatcopy(A: torch.Tensor, trans: bool = False, alpha=1.0) -> torch.Tensor:
    """Out-of-place scaled copy or transpose (RandBLAS ``omatcopy``;
    rl_util.hh:315 ``transposition`` is ``trans=True``)."""
    return torch.as_tensor(alpha, dtype=A.dtype, device=A.device) * (
        A.T if trans else A)


def dims_before_op(n_rows: int, n_cols: int, trans: bool):
    """Dimensions of X such that op(X) is n_rows × n_cols (RandBLAS
    ``dims_before_op``)."""
    return (n_cols, n_rows) if trans else (n_rows, n_cols)


def transpose_square(A: torch.Tensor) -> torch.Tensor:
    """Transpose of a square matrix (rl_util.hh:279); a view, since a
    tensor has no leading dimension to keep in place."""
    require(A.dim() == 2 and A.shape[0] == A.shape[1],
            f"transpose_square needs a square input, got {tuple(A.shape)}")
    return A.T
