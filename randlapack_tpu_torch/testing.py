"""Testing helpers (counterpart of ``randlapack_tpu/testing.py``) — the
RandBLAS/RandLAPACK test-utility surface (reference:
RandLAPACK/testing/rl_test_utils.hh; RandBLAS testing symbols
``matrices_approx_equal``, ``buffs_approx_equal``,
``iid_sparsify_random_dense``, ``random_coo``; ``coo_view_of_skop``).

The generators make tensors on ``device`` (the card unless the caller
asks for the CPU) and take ``draws=``, the random tensors they would draw
in their order, as ``gen`` does; the comparisons take tensors on any
device or arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .rng import RNGState


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def matrices_approx_equal(A, B, rel_tol: float | None = None) -> bool:
    """‖A − B‖_F ≤ tol·‖A‖_F, tol = eps^0.75 of A's dtype by default."""
    A, B = _np(A), _np(B)
    tol = rel_tol if rel_tol is not None else np.finfo(A.dtype).eps ** 0.75
    return bool(np.linalg.norm(A - B) <= tol * max(np.linalg.norm(A), 1e-30))


def buffs_approx_equal(a, b, atol: float) -> bool:
    return bool(np.max(np.abs(_np(a) - _np(b))) <= atol)


def iid_sparsify_random_dense(m: int, n: int, density: float,
                              state: RNGState, dtype=torch.float64,
                              device="cuda", draws=None):
    """Dense iid Gaussian matrix with iid Bernoulli(density)
    sparsification (RandBLAS testing helper). ``draws``: ``(G, U)``, the
    (m, n) Gaussian and the (m, n) f32 uniforms. Returns
    ``(A, next_state)``."""
    from .gen import _draw
    G, state = _draw(state, draws, 0, lambda g: torch.randn(
        (m, n), generator=g, dtype=dtype, device=device), device)
    U, state = _draw(state, draws, 1, lambda g: torch.rand(
        (m, n), generator=g, dtype=torch.float32, device=device), device)
    return G.to(dtype) * (U < density).to(dtype), state


def random_coo(m: int, n: int, nnz: int, state: RNGState,
               dtype=torch.float64, device="cuda", draws=None):
    """Random COO triple ``((rows, cols, vals), next_state)`` — RandBLAS
    testing helper (``gen.gen_sparse_coo``)."""
    from .gen import gen_sparse_coo
    return gen_sparse_coo(m, n, nnz, state, dtype, device, draws)


def coo_view_of_skop(op):
    """COO triple view of a sampled SASO (RandBLAS ``coo_view_of_skop``):
    ``(rows, cols, vals, shape)`` with the isometry scale folded into
    vals."""
    from .errors import require
    from .sketching.sparse_ops import SparseSkOp
    require(isinstance(op, SparseSkOp), "coo_view_of_skop takes a SASO")
    vec_nnz, long_axis = op.rows.shape
    cols = torch.arange(long_axis, device=op.rows.device).expand(
        vec_nnz, long_axis).reshape(-1)
    rows = op.rows.reshape(-1)
    vals = op.vals.reshape(-1) * op.dist.isometry_scale
    shape = (op.dist.n_rows, op.dist.n_cols)
    if op.dist.n_rows > op.dist.n_cols:  # tall operator: short axis = cols
        rows, cols = cols, rows
    return rows, cols, vals, shape


def materialize_linop(op):
    """Densify any operator (reference rl_test_utils.hh:191)."""
    from .linops.base import materialize
    return materialize(op)


def orthogonality_error(Q) -> float:
    from .ops import util
    return float(util.orthogonality_check(torch.as_tensor(Q)))


def write_dense_to_mtx(filename: str, A) -> None:
    """Write a dense matrix to a Matrix Market coordinate file, dropping
    entries ≤ eps·max|A| as structural zeros (rl_test_utils.hh:379)."""
    A = _np(A)
    tol = np.finfo(A.dtype).eps * np.max(np.abs(A)) if A.size else 0.0
    rows, cols = np.nonzero(np.abs(A) > tol)
    from .extras.io import mm_write
    mm_write(filename, rows.astype(np.int32), cols.astype(np.int32),
             A[rows, cols], A.shape)


def generate_spd_matrix_file(filename: str, n: int, cond_num: float,
                             state: RNGState, dtype=torch.float64,
                             device="cuda", draws=None):
    """Random n×n SPD matrix with κ = cond_num written to .mtx
    (rl_test_utils.hh:426). ``draws``: ``(G,)``, the basis's Gaussian.
    Returns ``next_state``."""
    from .gen import gen_quadratic_singvals, psd_from_eigvals
    lam = gen_quadratic_singvals(n, cond_num, dtype, device)
    A, state = psd_from_eigvals(n, lam, state, draws)
    write_dense_to_mtx(filename, A)
    return state


def generate_invertible_matrix_file(filename: str, n: int, cond_num: float,
                                    state: RNGState, dtype=torch.float64,
                                    device="cuda", draws=None):
    """Random invertible (non-symmetric) n×n matrix with κ = cond_num
    written to .mtx (rl_test_utils.hh:440). ``draws``: ``(G_U, G_V)``.
    Returns ``next_state``."""
    from .gen import gen_quadratic_singvals, gen_singvec
    s = gen_quadratic_singvals(n, cond_num, dtype, device)
    A, state = gen_singvec(n, n, s, state, draws)
    write_dense_to_mtx(filename, A)
    return state


def left_multiply_by_orthmat(A: torch.Tensor, state: RNGState, draws=None):
    """Q·A for a Haar-random orthogonal Q on A's device
    (rl_test_utils.hh:468). ``draws``: ``(G,)``. Returns
    ``(QA, next_state)``."""
    from .gen import haar_basis
    m = A.shape[0]
    Q, state = haar_basis(m, m, state, A.dtype, A.device, draws)
    return Q @ A, state
