"""Dense linear operator (counterpart of ``randlapack_tpu/linops/
dense.py``; reference: rl_dense_linop.hh:36). Its products are cuBLAS
calls on the card at ``precision`` (``ops.util.matmul``)."""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION
from ..config import resolve_precision
from ..ops.util import matmul


class DenseLinOp:
    """Wraps a dense (m, n) tensor."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat

    @property
    def n_rows(self):
        return self.mat.shape[0]

    @property
    def n_cols(self):
        return self.mat.shape[1]

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def matmat(self, X, precision=STABLE_PRECISION):
        return matmul(self.mat, X, precision)

    def tmatmat(self, X, precision=STABLE_PRECISION):
        return matmul(self.mat.T, X, precision)

    def rmatmat(self, X, precision=STABLE_PRECISION):
        """X @ A (the reference's Side::Right apply, rl_dense_linop.hh:94)."""
        return matmul(X, self.mat, precision)

    def fro_nrm(self):
        return torch.linalg.norm(self.mat)

    # views (rl_dense_linop.hh:295-329)
    def row_block(self, start: int, stop: int):
        return DenseLinOp(self.mat[start:stop, :])

    def col_block(self, start: int, stop: int):
        return DenseLinOp(self.mat[:, start:stop])

    def cols(self, start: int, size: int, precision=STABLE_PRECISION):
        """Columns [start, start + size) as a dense tensor — the block
        access of the column-blocked Gram loops."""
        resolve_precision(precision)
        return self.mat[:, int(start):int(start) + size]

    def T(self):
        return DenseLinOp(self.mat.T)
