"""Sparse linear operator over torch sparse CSR (counterpart of
``randlapack_tpu/linops/sparse.py``, which wraps a BCOO matrix;
reference: rl_sparse_linop.hh wraps RandBLAS CSR/CSC/COO).

The operator keeps the stored entries as given (COO, duplicates and all)
and two canonical CSR matrices built from them once: A's and Aᵀ's, with
int32 indices. ``matmat`` is one CSR product (cuSPARSE SpMM on the card)
and so is ``tmatmat``, on Aᵀ's CSR: no transposed operand is converted on
a call. ``cols`` reads a column window of A as a row window of Aᵀ's CSR.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..sketching.sparse_data import _host, _quiet


def _csr(rows, cols, vals, shape):
    """The canonical CSR (sorted, duplicates summed) of COO entries, with
    int32 indices, on the entries' device."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                  check_invariants=False).coalesce()
    r, c = coo.indices()
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=shape[0]), 0)
    return _quiet(torch.sparse_csr_tensor, crow.to(torch.int32),
                  c.to(torch.int32), coo.values(), shape,
                  check_invariants=False)


class SparseLinOp:
    """A sparse (m, n) operator from its stored COO entries."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, shape):
        self.shape = (int(shape[0]), int(shape[1]))
        # the stored entries, as BCOO holds them: (2, nse) indices, data
        self.indices = torch.stack([rows.to(torch.int64),
                                    cols.to(torch.int64)])
        self.data = vals
        self.A = _csr(*self.indices, vals, self.shape)
        self.At = _csr(*self.indices.flip(0), vals, self.shape[::-1])
        # Aᵀ's row pointers on the host (n + 1 numbers), read once here,
        # so a column window needs no device read
        self._at_crow = self.At.crow_indices().cpu().numpy().astype(np.int64)
        self._at_row = torch.repeat_interleave(
            torch.arange(self.shape[1], device=vals.device),
            torch.diff(self.At.crow_indices().to(torch.int64)))

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, device="cuda"):
        """From COO arrays (numpy or tensors), on ``device``."""
        return cls(torch.as_tensor(_host(rows), device=device),
                   torch.as_tensor(_host(cols), device=device),
                   torch.as_tensor(_host(vals), device=device), shape)

    @classmethod
    def from_dense(cls, mat: torch.Tensor):
        """The nonzeros of a dense tensor, on its device."""
        rows, cols = torch.nonzero(mat, as_tuple=True)
        return cls(rows, cols, mat[rows, cols], mat.shape)

    @property
    def n_rows(self):
        return self.shape[0]

    @property
    def n_cols(self):
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        """Stored entries of the canonical CSR (duplicates merged)."""
        return self.A.values().shape[0]

    def matmat(self, X, precision=STABLE_PRECISION):
        resolve_precision(precision)
        return self.A @ X

    def tmatmat(self, X, precision=STABLE_PRECISION):
        resolve_precision(precision)
        return self.At @ X

    def rmatmat(self, X, precision=STABLE_PRECISION):
        """X @ A = (Aᵀ·Xᵀ)ᵀ."""
        resolve_precision(precision)
        return (self.At @ X.T).T

    def fro_nrm(self):
        """The norm of the stored values, as in the JAX package: for COO
        input with duplicate (row, col) entries this is not ‖A‖_F."""
        return torch.linalg.vector_norm(self.data)

    def to_dense(self):
        return self.A.to_dense()

    def cols(self, start: int, size: int, precision=STABLE_PRECISION):
        """Columns [start, start + size) as a dense (m, size) tensor: the
        entries of rows [start, start + size) of Aᵀ's CSR, put in place
        (each (row, col) once, so the values are the stored ones exactly;
        the JAX package's one-hot product gives the same)."""
        lo, hi = (int(self._at_crow[int(start)]),
                  int(self._at_crow[int(start) + size]))
        out = torch.zeros((self.n_rows, size), dtype=self.dtype,
                          device=self.device)
        out[self.At.col_indices()[lo:hi].to(torch.int64),
            self._at_row[lo:hi] - int(start)] = self.At.values()[lo:hi]
        return out

    # views: the stored entries in the window, rebased (the JAX package
    # masks them to keep BCOO's static nse; the operator is the same)
    def _window(self, axis: int, start: int, stop: int):
        idx = self.indices[axis]
        keep = (idx >= start) & (idx < stop)
        new = self.indices[:, keep]
        new[axis] -= start
        shape = list(self.shape)
        shape[axis] = stop - start
        return SparseLinOp(new[0], new[1], self.data[keep], shape)

    def row_block(self, start: int, stop: int):
        return self._window(0, start, stop)

    def col_block(self, start: int, stop: int):
        return self._window(1, start, stop)

