"""Sided sketch application (counterpart of ``randlapack_tpu/sketching/
apply.py``; the RandBLAS ``sketch_general`` capability).

Dispatches on the operator kind (dense tensor, DenseSkOp, SparseSkOp,
SRHTSkOp) and the side, and returns the sketched tensor.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION
from ..ops.wy import _require_highest
from .dense import DenseSkOp
from .sparse_ops import SparseSkOp, saso_left_apply, saso_right_apply
from .srht import SRHTSkOp, srht_left_apply


def sketch_left(S, A: torch.Tensor,
                precision=STABLE_PRECISION) -> torch.Tensor:
    """S @ A with isometric scaling (E[SᵀS] = I for the scaled operator);
    a plain tensor S is applied unscaled."""
    _require_highest(precision)
    if isinstance(S, DenseSkOp):
        return S.dist.isometry_scale * (S.mat.to(A.dtype) @ A)
    if isinstance(S, SparseSkOp):
        return saso_left_apply(S, A)
    if isinstance(S, SRHTSkOp):
        return srht_left_apply(S, A, precision)
    return S.to(A.dtype) @ A


def sketch_right(A: torch.Tensor, S,
                 precision=STABLE_PRECISION) -> torch.Tensor:
    """A @ S with isometric scaling; a plain tensor S unscaled."""
    _require_highest(precision)
    if isinstance(S, DenseSkOp):
        return S.dist.isometry_scale * (A @ S.mat.to(A.dtype))
    if isinstance(S, SparseSkOp):
        return saso_right_apply(A, S)
    if isinstance(S, SRHTSkOp):
        return srht_left_apply(S, A.T, precision).T
    return A @ S.to(A.dtype)
