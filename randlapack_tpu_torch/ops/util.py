"""Matrix utilities (counterpart of ``randlapack_tpu/ops/util.py``;
reference: RandLAPACK/misc/rl_util.hh): the rank estimate, column and
pivot permutations and the orthogonality measure the QR drivers use."""
from __future__ import annotations

import torch


def col_swap(A: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Column permutation A[:, J] — the reference's lapmt-backed col_swap
    (rl_util.hh:152) as a gather."""
    return A.index_select(1, J)


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
