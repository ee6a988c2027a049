"""The plain reference that decides ``correct``: what a QR with column
pivoting has to satisfy, worked out again from the factors a timed call
returned, and how good its pivots are.

Plain PyTorch in float64, on the device that holds the factors, in
blocks of columns. It imports nothing of the program: Q is formed here
from the packed Householder vectors and their taus of a LAPACK-format
QRCP, and the input A is the benchmark's own (``inputs.py``).

Each function returns plain Python numbers; ``check`` of an entry turns
them into the cell's named numbers, which ``harness`` holds to the
limits in the cell's file.
"""
from __future__ import annotations

import torch

COLS = 2048   # columns of A a block of the residual


def q_from_householder(packed: torch.Tensor,
                       taus: torch.Tensor) -> torch.Tensor:
    """Q = H₁·…·H_K·[I; 0] in float64 for Hᵢ = I − τᵢ·vᵢ·vᵢᵀ, vᵢ the unit
    head at row i and ``packed``'s column i strictly below it (LAPACK's
    layout; entries on and above the diagonal are not read)."""
    P = torch.tril(packed.double(), -1)
    return torch.linalg.householder_product(P, taus.double())


def orthogonality(Q: torch.Tensor) -> float:
    """‖QᵀQ − I‖_F of a float64 Q."""
    G = Q.T @ Q
    G.diagonal().sub_(1.0)
    return float(torch.linalg.matrix_norm(G))


def residual(A: torch.Tensor, J: torch.Tensor, Q: torch.Tensor,
             R: torch.Tensor) -> float:
    """‖A[:, J] − Q·R‖_F / ‖A‖_F in float64, ``COLS`` columns at a time;
    Q is m × k, R is k × n."""
    n = A.shape[1]
    num = den = 0.0
    for c in range(0, n, COLS):
        e = min(c + COLS, n)
        Ac = A.index_select(1, J[c:e].to(A.device)).double()
        Rc = R[:, c:e].double()
        num += float(torch.linalg.matrix_norm(Ac - Q @ Rc)) ** 2
        den += float(torch.linalg.matrix_norm(A[:, c:e].double())) ** 2
    return (num / den) ** 0.5 if den > 0 else float("inf")


def permutation_errors(J: torch.Tensor, n: int) -> int:
    """How many of 0..n−1 J misses (0 for a permutation of n columns;
    n when J has the wrong length)."""
    if J.dim() != 1 or J.numel() != n:
        return n
    Jc = J.long().cpu()
    if bool(((Jc < 0) | (Jc >= n)).any()):
        return n
    return n - int(torch.unique(Jc).numel())


def lower_entries(R: torch.Tensor) -> float:
    """max |R[i, j]| over i > j: 0 for an upper-trapezoidal R."""
    low = torch.tril(R, -1)
    return float(low.abs().max()) if low.numel() else 0.0


def qr_numbers(A: torch.Tensor, J: torch.Tensor, Q: torch.Tensor,
               R: torch.Tensor, fail) -> dict:
    """The numbers every pivoted QR of A is held to: the residual, the
    orthogonality of Q, whether J is a permutation, R's entries below
    the diagonal and the breakdown flag (1 raised, 0 not)."""
    n = A.shape[1]
    perm = permutation_errors(J, n)
    return dict(
        residual=residual(A, J, Q, R) if perm == 0 else float("inf"),
        orthogonality=orthogonality(Q), permutation=float(perm),
        below_diagonal=lower_entries(R), fail=float(bool(fail)))


def pivot_numbers(R: torch.Tensor, block: int | None = None) -> dict:
    """How far the pivots fall short of greedy column pivoting, from R
    alone. With A[:, J] = Q·R and Q orthonormal, ‖R[k:, j]‖ is what is
    left of column J[j] once the first k pivots are projected out, so
    d_k = max_j ‖R[k:, j]‖ / |R_kk| ≥ 1 is 1 exactly where pivot k was
    the largest column left.

    ``pivot_gap``: exp(mean_k log d_k) − 1 over R's rows; 0 for greedy
    pivoting, more the further the pivots are from it (a random choice
    of columns reads more than a randomized QRCP's).
    ``panel_order`` (with ``block``): max_k of the same ratio over the
    columns of k's own block of ``block`` from k on, − 1; 0 to rounding
    where each block is factored with greedy pivoting among its columns
    (HQRRP's panel)."""
    K, n = R.shape
    R = torch.triu(R)
    cols = COLS if block is None else block * max(1, COLS // block)
    top = torch.zeros(K, dtype=torch.float64, device=R.device)
    inner = torch.zeros(K, dtype=torch.float64, device=R.device)
    for c in range(0, n, cols):
        e = min(c + cols, n)
        # S[k, j] = ‖R[k:, c + j]‖
        S = R[:, c:e].double().square().flip(0).cumsum(0).flip(0).sqrt_()
        top = torch.maximum(top, S.max(1).values)
        if block is not None:
            for p in range(c, min(e, K), block):
                q = min(p + block, e, K)
                inner[p:q] = S[p:q, p - c:q - c].max(1).values
        del S
    diag = R.diagonal().abs().double()
    nums = dict(pivot_gap=float(torch.exp(torch.log(top / diag).mean())
                                - 1.0))
    if block is not None:
        nums["panel_order"] = float((inner / diag).max() - 1.0)
    return nums
