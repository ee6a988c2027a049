"""Shared linop helpers: materialization and block views (counterpart of
``randlapack_tpu/linops/base.py``; reference: rl_materialize.hh,
rl_dense_linop.hh:295-329, rl_sparse_views.hh, rl_composite_linop.hh).

Block views are free functions dispatching on the operator: a view is a
new operator over sliced (dense) or filtered (sparse) storage.
"""
from __future__ import annotations

import torch


def materialize(op, dtype=None):
    """Densify any operator via A @ I, on the operator's device, with the
    dense fast path (rl_materialize.hh:34,53,69)."""
    if hasattr(op, "mat"):
        return op.mat if dtype is None else op.mat.to(dtype)
    dtype = dtype or op.dtype
    return op.matmat(torch.eye(op.n_cols, dtype=dtype, device=op.device))


def row_block(op, start: int, stop: int):
    """Operator view of rows [start, stop)."""
    return op.row_block(start, stop)


def col_block(op, start: int, stop: int):
    """Operator view of columns [start, stop)."""
    return op.col_block(start, stop)


def submatrix(op, r0: int, r1: int, c0: int, c1: int):
    return op.row_block(r0, r1).col_block(c0, c1)
