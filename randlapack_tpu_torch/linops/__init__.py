"""Linear-operator protocol (counterpart of ``randlapack_tpu/linops``;
reference: RandLAPACK/linops/rl_concepts.hh:31,46; rl_linops.hh:12-18).

Operators are small classes with a duck-typed surface:
    n_rows, n_cols, dtype, device
    matmat(X)  -> A @ X
    tmatmat(X) -> Aᵀ @ X
    fro_nrm()  -> ‖A‖_F
General operators add ``rmatmat``, ``cols`` and the block views;
symmetric operators add ``dim`` and the per-column regularization hooks.
"""
from .base import col_block, materialize, row_block, submatrix
from .composite import CompositeLinOp
from .dense import DenseLinOp
from .sparse import SparseLinOp
from .sparse_views import (CSCColBlockView, CSCRowBlock, CSRColBlock,
                           CSRMatrixView, CSRRowBlockView, csc_col_block,
                           csc_row_block, csr_col_block, csr_row_block)
from .symmetric import (ExplicitSymLinOp, RegExplicitSymLinOp,
                        SpectralPrecond)

__all__ = [
    "DenseLinOp", "SparseLinOp", "CompositeLinOp",
    "ExplicitSymLinOp", "RegExplicitSymLinOp", "SpectralPrecond",
    "materialize", "row_block", "col_block", "submatrix",
    "CSRMatrixView", "CSRRowBlockView", "CSRColBlock", "CSCColBlockView",
    "CSCRowBlock", "csr_row_block", "csr_col_block", "csc_col_block",
    "csc_row_block",
]
