"""The plain reference of REVD2 over the squared-exponential kernel
(float64 PyTorch, nothing of the program): K(X, X) is never stored, but
formed in blocks of columns from the points wherever it is applied.

``revd2_plain`` is Algorithm E2 of Frangella, Tropp and Udell
(arXiv:2110.02820) as RandLAPACK's ``REVD2::call`` (rl_revd2.hh:152)
states it, from given starts: the CPU tests hold the program to it.
``numbers`` judges what the program returned, (V, λ), against K itself:
the benchmark's check after the window.
"""
from __future__ import annotations

import contextlib
import math

import torch

BLOCK = 2048


@contextlib.contextmanager
def _no_tf32():
    """Every float32 product of the scope in float32, not TF32 (float64
    products are unaffected; the switch is put back on leaving)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def kernel_times(X, bandwidth: float, M, block: int = BLOCK):
    """K(X, X)·M in float64, K_ij = exp(−‖x_i − x_j‖²/(2σ²)) formed from X
    (d, n), one point a column, in blocks of ``block`` columns: the
    squared distances from the norms and the cross term, clamped at 0."""
    X, M = X.double(), M.double()
    n = X.shape[1]
    sq = (X * X).sum(0)
    out = torch.zeros((n, M.shape[1]), dtype=torch.float64, device=X.device)
    with _no_tf32():
        for j0 in range(0, n, block):
            j = slice(j0, min(j0 + block, n))
            d2 = sq[:, None] + sq[None, j] - 2.0 * (X.T @ X[:, j])
            out += torch.exp(-d2.clamp_(min=0.0)
                             / (2.0 * bandwidth ** 2)) @ M[j]
    return out


def _plu_basis(A):
    """The unit lower factor of A's partially pivoted LU with its rows put
    back in A's order (A = B·U, B the result; rl_orth.hh PLUL)."""
    LU, piv = torch.linalg.lu_factor(A)
    m, k = A.shape
    L = torch.tril(LU, -1) + torch.eye(m, k, dtype=A.dtype, device=A.device)
    # LAPACK's row swaps in order: row i of L·U is row perm[i] of A
    perm = list(range(m))
    for i, p in enumerate((piv.cpu() - 1).tolist()):
        perm[i], perm[p] = perm[p], perm[i]
    B = torch.empty_like(L)
    B[torch.tensor(perm, device=A.device)] = L
    return B


def revd2_plain(X, bandwidth: float, k: int, omega, v0, passes: int = 3,
                est_passes: int = 10):
    """Rank-k REVD2 of K(X, X) from the n×k start ``omega`` and the power
    estimate's n×1 start ``v0``, in float64. Returns ``(V, lam, err, nu,
    fail)``.

    SYPS: ``passes`` products with K, each followed by PLU
    stabilization; SYRF: Q from the Householder QR of K·Ω; then Y = K·Q,
    the shift ν = √n·u·‖Y‖_F with u the unit roundoff of X's type (the
    program's working precision, as the reference takes it from its type
    T), C the Cholesky factor of Qᵀ(Y + νQ), B = (Y + νQ)·C⁻ᵀ, its SVD
    B = V·Σ·Wᵀ and λ = max(σ² − ν, 0); the error estimate is
    ``est_passes`` power steps on K − V·diag(λ)·Vᵀ.

    Departures from the program, none of which moves (V, λ) in exact
    arithmetic, since the Nyström approximation depends on range(Q)
    alone: no 2^(e−40) pad on the stabilized matrix's diagonal (the
    program's, which moves LU pivots at ties); Householder QR for SYRF
    where the program takes CholQR2 (it falls back to Householder QR
    only on breakdown); the library's SVD of B where the program may
    take another route (``svd_econ``). ``fail`` is the Cholesky factor's
    breakdown; V, λ and the estimate are then NaN."""
    eps = torch.finfo(X.dtype).eps
    Om = omega.double()
    for _ in range(passes):
        Om = _plu_basis(kernel_times(X, bandwidth, Om))
    Q = torch.linalg.qr(kernel_times(X, bandwidth, Om)).Q
    Y = kernel_times(X, bandwidth, Q)
    nu = math.sqrt(Q.shape[0]) * eps * float(torch.linalg.norm(Y))
    Y = Y + nu * Q
    G = Q.T @ Y
    C, info = torch.linalg.cholesky_ex(0.5 * (G + G.T))
    fail = bool(info != 0)
    if fail:
        nan = float("nan")
        return (torch.full_like(Q, nan), torch.full_like(Q[0], nan), nan, nu,
                True)
    B = torch.linalg.solve_triangular(C.T, Y, upper=True, left=False)
    V, S, _ = torch.linalg.svd(B, full_matrices=False)
    lam = torch.clamp(S * S - nu, min=0.0)
    v = v0.double() / torch.linalg.norm(v0.double())
    err = torch.zeros((), dtype=torch.float64)
    for _ in range(est_passes):
        w = kernel_times(X, bandwidth, v) - V @ (lam[:, None] * (V.T @ v))
        err = torch.linalg.norm(w)
        v = w / err
    return V, lam, err, nu, False


def numbers(X, bandwidth: float, V, lam, fail, pairs: int) -> dict:
    """The numbers that decide the cell's ``correct``, from the program's
    (V, λ) and K·V formed in float64 (``kernel_times``), each relative to
    λ₁ where it is a size:

    - ``pair_residual``: max ‖K·vᵢ − λᵢ·vᵢ‖₂ / λ₁ over the leading
      ``pairs`` pairs, where the power passes leave the approximation
      error below float32 rounding;
    - ``lambda_error``: max |λᵢ − vᵢᵀ·K·vᵢ| / λ₁ over all k: λ held to
      the program's own V;
    - ``trace_error``: 1 − tr(VᵀKV)/tr(K), tr(K) = n, the share of K's
      trace the rank-k projection misses;
    - ``orthogonality``: ‖VᵀV − I‖_F;
    - ``order``: the λᵢ that are negative, or not at least λᵢ₊₁ (NaN
      counts);
    - ``fail``: 1 where the program raised its breakdown flag."""
    n = V.shape[0]
    Vd, ld = V.double(), lam.double()
    KV = kernel_times(X, bandwidth, Vd)
    l1 = float(ld[0])
    res = torch.linalg.vector_norm(KV[:, :pairs] - Vd[:, :pairs] * ld[:pairs],
                                   dim=0)
    rayleigh = (Vd * KV).sum(0)
    del KV
    eye = torch.eye(Vd.shape[1], dtype=torch.float64, device=Vd.device)
    order = int((~(ld >= 0)).sum()) + int((~(ld[:-1] >= ld[1:])).sum())
    return dict(pair_residual=float(res.max()) / l1,
                lambda_error=float((ld - rayleigh).abs().max()) / l1,
                trace_error=1.0 - float(rayleigh.sum()) / n,
                orthogonality=float(torch.linalg.matrix_norm(Vd.T @ Vd
                                                             - eye)),
                order=float(order),
                fail=float(bool(fail)))
