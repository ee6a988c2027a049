"""Implicit product operator (counterpart of ``randlapack_tpu/linops/
composite.py``; reference: rl_composite_linop.hh:43)."""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION
from ..errors import require


class CompositeLinOp:
    """A = Op1 · Op2, applied as two chained applies through an
    intermediate (never materialized)."""

    def __init__(self, op1, op2):
        require(op1.n_cols == op2.n_rows,
                f"inner dimensions differ: {op1.n_cols} != {op2.n_rows}")
        self.op1 = op1
        self.op2 = op2

    @property
    def n_rows(self):
        return self.op1.n_rows

    @property
    def n_cols(self):
        return self.op2.n_cols

    @property
    def dtype(self):
        return self.op1.dtype

    @property
    def device(self):
        return self.op1.device

    def matmat(self, X, precision=STABLE_PRECISION):
        return self.op1.matmat(self.op2.matmat(X, precision), precision)

    def tmatmat(self, X, precision=STABLE_PRECISION):
        return self.op2.tmatmat(self.op1.tmatmat(X, precision), precision)

    def rmatmat(self, X, precision=STABLE_PRECISION):
        return self.op2.rmatmat(self.op1.rmatmat(X, precision), precision)

    def fro_nrm(self):
        # no exact norm without materializing (‖Op1‖_F·‖Op2‖_F only bounds
        # it); the reference materializes for this case too
        return torch.linalg.norm(self.matmat(torch.eye(
            self.n_cols, dtype=self.dtype, device=self.device)))

    # views slice the outer factor of the corresponding side
    # (rl_composite_linop.hh block views)
    def row_block(self, start: int, stop: int):
        return CompositeLinOp(self.op1.row_block(start, stop), self.op2)

    def col_block(self, start: int, stop: int):
        return CompositeLinOp(self.op1, self.op2.col_block(start, stop))

    def cols(self, start: int, size: int, precision=STABLE_PRECISION):
        return self.op1.matmat(self.op2.cols(start, size, precision),
                               precision)
