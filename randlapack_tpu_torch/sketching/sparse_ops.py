"""Sparse sketching operators — SASO/SJLT (counterpart of
``randlapack_tpu/sketching/sparse_ops.py``; RandBLAS ``SparseDist`` /
``SparseSkOp``).

CQRRPT and the preconditioner constructors sketch with a short-axis
sparse operator, ``vec_nnz`` nonzeros per long-axis vector (reference:
RandLAPACK/drivers/rl_cqrrpt.hh:214-222, ``Axis::Short``). The operator
is a structure of arrays: for a d×m operator with d ≤ m, each of the m
columns holds ``vec_nnz`` entries at distinct random rows with iid ±1
values,

    rows : (vec_nnz, m) int   row index of each nonzero
    vals : (vec_nnz, m) dtype ±1 (unscaled; isometry_scale = 1/√vec_nnz)

S·A is ``vec_nnz`` layers of ``index_add_`` of sign-flipped copies of A
("scatter"), or a CSR-by-output-row gather ("gather"). On CUDA
``index_add_`` sums duplicate rows with atomics, in no fixed order, so
two scatter runs on the card may differ in the last bits; the gather
form sums in one order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..rng import RNGState
from .sampling import sample_distinct_uniform


@dataclasses.dataclass(frozen=True)
class SparseDist:
    """Distribution over short-axis sparse sketching operators (SASO)."""

    n_rows: int
    n_cols: int
    vec_nnz: int = 2

    @property
    def short_axis(self) -> int:
        return min(self.n_rows, self.n_cols)

    @property
    def isometry_scale(self) -> float:
        return 1.0 / math.sqrt(self.vec_nnz)


@dataclasses.dataclass(frozen=True)
class SparseSkOp:
    dist: SparseDist
    rows: torch.Tensor = None  # (vec_nnz, long_axis) short-axis indices
    vals: torch.Tensor = None  # (vec_nnz, long_axis) ±1

    @property
    def n_rows(self):
        return self.dist.n_rows

    @property
    def n_cols(self):
        return self.dist.n_cols


def fill_sparse(dist: SparseDist, state: RNGState, dtype=torch.float32,
                distinct: bool = True, device="cuda"):
    """Sample a SASO on ``device``. Returns ``(SparseSkOp, next_state)``.

    ``distinct=True`` draws the vec_nnz positions per vector without
    replacement (exact SASO); ``False`` draws iid."""
    d = dist.short_axis
    long_axis = max(dist.n_rows, dist.n_cols)
    if distinct and dist.vec_nnz > 1:
        idx, state = sample_distinct_uniform(d, dist.vec_nnz, long_axis,
                                             state, device=device)
        rows = idx.T.contiguous()  # (vec_nnz, long_axis)
    else:
        gen, state = state.spawn(device)
        rows = torch.randint(0, d, (dist.vec_nnz, long_axis), generator=gen,
                             device=device)
    gen, state = state.spawn(device)
    signs = torch.randint(0, 2, (dist.vec_nnz, long_axis), generator=gen,
                          device=device)
    vals = (2 * signs - 1).to(dtype)
    return SparseSkOp(dist, rows, vals), state


def saso_left_apply(S: SparseSkOp, A: torch.Tensor, scale: bool = True,
                    method: str = "auto"):
    """(Isometry-scaled) S @ A for a wide d×m SASO and m×n dense A.

    ``"scatter"``: vec_nnz ``index_add_`` layers,
    out[rows[j, c], :] += vals[j, c]·A[c, :]; each layer streams A once.
    ``"gather"``: the nonzeros re-packed by output row (one sort) into L
    padded slots a row, then gather-FMA layers out[r, :] += val·A[col, :];
    entries past L go through one small ``index_add_``, and if more than
    ``l_over`` overflow (a Python ``if`` on the count) the scatter form
    computes the result instead. ``"auto"`` is ``"scatter"``, as in the
    JAX package."""
    d = S.dist.n_rows
    m, n = A.shape
    assert S.dist.n_cols == m, (S.dist, A.shape)
    if method == "auto":
        method = "scatter"
    if method == "gather":
        out = _saso_left_gather(S, A, d, m, n)
    else:
        out = _saso_left_scatter(S, A, d, n)
    if scale:
        out = out * S.dist.isometry_scale
    return out


def _saso_left_scatter(S: SparseSkOp, A: torch.Tensor, d: int, n: int):
    """Scatter-layer SASO apply — vec_nnz ``index_add_`` passes over A.
    Exact for any row occupancy (duplicate indices accumulate)."""
    out = torch.zeros((d, n), dtype=A.dtype, device=A.device)
    for j in range(S.dist.vec_nnz):
        out.index_add_(0, S.rows[j], S.vals[j, :, None] * A)
    return out


def _saso_left_gather(S: SparseSkOp, A: torch.Tensor, d: int, m: int,
                      n: int, chunk: int = 8, l_over: int = 4096):
    """Gather-layer SASO apply (see :func:`saso_left_apply`)."""
    dev = A.device
    nnz = S.dist.vec_nnz
    N = nnz * m
    mean = N / d
    L = int(mean + 6.0 * math.sqrt(max(mean, 1.0)) + 8)
    L = min(L + (-L) % chunk, N)  # round up to the chunk size

    flat_r = S.rows.reshape(-1).to(torch.int64)
    order = torch.argsort(flat_r, stable=True)
    sr = flat_r[order]
    sc = torch.arange(m, device=dev).repeat(nnz)[order]
    sv = S.vals.reshape(-1)[order]
    start = torch.searchsorted(sr, torch.arange(d, device=dev))
    pos = torch.arange(N, device=dev) - start[sr]
    in_main = pos < L
    n_over = N - int(in_main.sum())
    if n_over > l_over:
        # beyond the overflow buffer (a 6σ Binomial tail plus 4096): the
        # exact scatter formulation, never a silently dropped entry
        return _saso_left_scatter(S, A, d, n)
    slot = torch.where(in_main, sr * L + pos, d * L)  # slot d·L: dropped
    cols_pad = torch.zeros(d * L + 1, dtype=torch.int64, device=dev)
    cols_pad[slot] = sc
    vals_pad = torch.zeros(d * L + 1, dtype=A.dtype, device=dev)
    vals_pad[slot] = sv
    cols_pad = cols_pad[:-1].view(d, L)
    vals_pad = vals_pad[:-1].view(d, L)

    out = torch.zeros((d, n), dtype=A.dtype, device=dev)
    for lb in range(0, L, chunk):
        gathered = A[cols_pad[:, lb:lb + chunk]]    # (d, chunk, n) gather
        out = out + torch.bmm(vals_pad[:, None, lb:lb + chunk],
                              gathered)[:, 0]

    if n_over:
        # the overflow entries, in their sorted order, by one small scatter
        ov = torch.nonzero(~in_main)[:, 0]
        out.index_add_(0, sr[ov], sv[ov, None] * A[sc[ov]])
    return out


def saso_right_apply(A: torch.Tensor, S: SparseSkOp, scale: bool = True):
    """A @ S for an m×d tall SASO (sketching columns): (n×m)·(m×d)."""
    n, m = A.shape
    assert S.dist.n_rows == m, (S.dist, A.shape)
    d = S.dist.n_cols
    out = torch.zeros((n, d), dtype=A.dtype, device=A.device)
    for j in range(S.dist.vec_nnz):
        out.index_add_(1, S.rows[j], A * S.vals[j][None, :])
    if scale:
        out = out * S.dist.isometry_scale
    return out


def saso_to_dense(S: SparseSkOp, dtype=None, scale: bool = True):
    """Materialize the SASO as a dense (n_rows, n_cols) tensor (tests,
    small d)."""
    dtype = dtype or S.vals.dtype
    d = S.dist.short_axis
    long_axis = max(S.dist.n_rows, S.dist.n_cols)
    dense = torch.zeros((d, long_axis), dtype=dtype, device=S.vals.device)
    cols = torch.arange(long_axis, device=S.vals.device).expand(
        S.rows.shape)
    dense.index_put_((S.rows.reshape(-1).to(torch.int64),
                      cols.reshape(-1)), S.vals.reshape(-1).to(dtype),
                     accumulate=True)
    if scale:
        dense = dense * S.dist.isometry_scale
    if S.dist.n_rows > S.dist.n_cols:  # tall operator: short axis is cols
        dense = dense.T
    return dense
