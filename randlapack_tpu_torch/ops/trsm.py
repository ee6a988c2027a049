"""Blocked partitioned-inverse triangular solve, right side, upper R
(counterpart of ``randlapack_tpu/ops/trsm.py``).

Only the b×b diagonal blocks of R are inverted (small, well-conditioned
for a pivoted R, κ(R_jj) ≈ κ(R)^(b/n)); the back-substitution
recurrence runs as matrix products,

    X_j = (A_j − X_{:,<j} · R_{<j,j}) · R_jj⁻¹,

the cuBLAS/MAGMA restructure of trsm. The base case amplifies by
κ(R_jj) instead of being backward-stable; CQRRPT's rank gate clamps the
deficient diagonal entries first, which bounds the blocks.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from .util import matmul


def trsm_right_upper_blockinv(A, R, block: int = 256,
                              precision=STABLE_PRECISION, cols=None):
    """Solve X · R = A[:, cols] for X, with R (n×n) upper-triangular and A
    (m×·), by inverting the b×b diagonal blocks of R.

    ``cols`` (optional int vector of length n) gathers the columns of A
    block by block, so the permuted m×n operand is never materialized.
    One triangular solve when n does not split into two or more blocks.
    The block products run at ``precision`` (``ops.util.matmul``)."""
    precision = resolve_precision(precision)
    n = R.shape[1]
    if n % block or n // block < 2:
        if cols is not None:
            A = A.index_select(1, cols)
        return torch.linalg.solve_triangular(R, A, upper=True, left=False)
    nb = n // block
    # the inverses of the diagonal blocks by one batched solve
    diag = torch.stack([R[i * block:(i + 1) * block,
                          i * block:(i + 1) * block] for i in range(nb)])
    eye = torch.eye(block, dtype=A.dtype, device=A.device).expand(
        nb, block, block)
    dinv = torch.linalg.solve_triangular(diag, eye, upper=True)
    X = torch.empty((A.shape[0], n), dtype=A.dtype, device=A.device)
    for j in range(nb):
        sl = slice(j * block, (j + 1) * block)
        Aj = A[:, sl] if cols is None else A.index_select(1, cols[sl])
        if j:
            Aj = Aj - matmul(X[:, :j * block], R[:j * block, sl], precision)
        X[:, sl] = matmul(Aj, dinv[j], precision)
    return X
