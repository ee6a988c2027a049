"""Sided sketch application (counterpart of ``randlapack_tpu/sketching/
apply.py``; the RandBLAS ``sketch_general`` capability).

Dispatches on the operator kind (dense tensor, DenseSkOp, SparseSkOp,
SRHTSkOp) and the side, and returns the sketched tensor.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.util import matmul
from .dense import DenseSkOp
from .sparse_ops import SparseSkOp, saso_left_apply, saso_right_apply
from .srht import SRHTSkOp, srht_left_apply


def sketch_left(S, A: torch.Tensor,
                precision=STABLE_PRECISION) -> torch.Tensor:
    """S @ A with isometric scaling (E[SᵀS] = I for the scaled operator);
    a plain tensor S is applied unscaled. Dense products at
    ``precision`` (``ops.util.matmul``); SASO's scatter has no product."""
    precision = resolve_precision(precision)
    if isinstance(S, DenseSkOp):
        return S.dist.isometry_scale * matmul(S.mat.to(A.dtype), A,
                                              precision)
    if isinstance(S, SparseSkOp):
        return saso_left_apply(S, A)
    if isinstance(S, SRHTSkOp):
        return srht_left_apply(S, A, precision)
    return matmul(S.to(A.dtype), A, precision)


def sketch_right(A: torch.Tensor, S,
                 precision=STABLE_PRECISION) -> torch.Tensor:
    """A @ S with isometric scaling; a plain tensor S unscaled."""
    precision = resolve_precision(precision)
    if isinstance(S, DenseSkOp):
        return S.dist.isometry_scale * matmul(A, S.mat.to(A.dtype),
                                              precision)
    if isinstance(S, SparseSkOp):
        return saso_right_apply(A, S)
    if isinstance(S, SRHTSkOp):
        return srht_left_apply(S, A.T, precision).T
    return matmul(A, S.to(A.dtype), precision)
