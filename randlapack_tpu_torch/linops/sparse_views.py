"""CSR/CSC block-view types (counterpart of ``randlapack_tpu/linops/
sparse_views.py``; reference: RandLAPACK/linops/rl_sparse_views.hh —
``CSRRowBlockView`` :27 zero-copy rowptr offset, ``CSRColBlock`` :56
copy+filter, ``CSCColBlockView`` :94, ``CSCRowBlock`` :119 and the
factory free functions).

A row view holds the parent's index and value tensors and an offset, and
copies nothing. A column block of CSR has no zero-copy form, so it copies
the entries in the window (compacted, with its own row pointers; the JAX
package masks them instead to keep static shapes). CSC is carried as the
CSR of the transpose. Application densifies the viewed block.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["CSRMatrixView", "CSRRowBlockView", "CSRColBlock",
           "CSCColBlockView", "CSCRowBlock", "csr_row_block",
           "csr_col_block", "csc_col_block", "csc_row_block"]


@dataclasses.dataclass(frozen=True)
class CSRMatrixView:
    """A CSR matrix (or a row-window view into one): ``indptr`` addresses
    ``indices``/``data`` globally, with rows [row0, row0+n_rows)."""
    indptr: torch.Tensor               # (parent_rows + 1,) int
    indices: torch.Tensor              # (nnz,) int — shared, never copied
    data: torch.Tensor                 # (nnz,)     — shared, never copied
    shape: tuple
    row0: int = 0

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

    def materialize(self):
        """Densify the viewed block (rl_materialize.hh fast path): the row
        of entry k by a search of the row pointers, the entries outside
        the window sent to a row past the block and dropped. The (row,
        col) pairs of a canonical CSR are unique, so a plain put is
        exact."""
        nr, nc = self.shape
        ptr = self.indptr.to(torch.int64)
        k = torch.arange(self.indices.shape[0], device=self.device)
        inside = (k >= ptr[self.row0]) & (k < ptr[self.row0 + nr])
        r = torch.searchsorted(ptr, k, right=True) - 1 - self.row0
        r = torch.where(inside, r, nr)
        out = torch.zeros((nr + 1, nc), dtype=self.dtype, device=self.device)
        out[r, torch.where(inside, self.indices.to(torch.int64), 0)] = \
            self.data
        return out[:nr]

    def matmat(self, X, precision=None):
        """(view) @ X through the densified block."""
        return self.materialize() @ X

    def row_block(self, start: int, stop: int) -> "CSRRowBlockView":
        return csr_row_block(self, start, stop)

    def col_block(self, start: int, stop: int) -> "CSRColBlock":
        return csr_col_block(self, start, stop)


class CSRRowBlockView(CSRMatrixView):
    """Zero-copy row-window view (rl_sparse_views.hh:27): shares the
    parent's indptr/indices/data; only offsets change."""


class CSRColBlock(CSRMatrixView):
    """Column block of a CSR matrix — like the reference (:56) this one
    copies and filters: the entries with start ≤ col < stop, rebased, with
    row pointers of their own over the parent's rows."""


def csr_row_block(A: CSRMatrixView, start: int, stop: int):
    """Zero-copy: same indices/data tensors, shifted row window."""
    return CSRRowBlockView(A.indptr, A.indices, A.data,
                           (stop - start, A.shape[1]), row0=A.row0 + start)


def csr_col_block(A: CSRMatrixView, start: int, stop: int):
    """Copy + filter (reference :56): keep entries with start ≤ col <
    stop, rebase their columns and count them again by row."""
    ptr = A.indptr.to(torch.int64)
    keep = (A.indices >= start) & (A.indices < stop)
    k = torch.arange(A.indices.shape[0], device=A.device)
    row = torch.searchsorted(ptr, k, right=True) - 1
    counts = torch.bincount(row[keep], minlength=ptr.shape[0] - 1)
    indptr = torch.zeros_like(ptr)
    indptr[1:] = torch.cumsum(counts, 0)
    return CSRColBlock(indptr.to(A.indptr.dtype), A.indices[keep] - start,
                       A.data[keep], (A.shape[0], stop - start), row0=A.row0)


def csc_col_block(At_csr: CSRMatrixView, start: int, stop: int):
    """CSC column window = zero-copy CSR row window of the transpose
    (rl_sparse_views.hh:94)."""
    return CSCColBlockView(csr_row_block(At_csr, start, stop))


def csc_row_block(At_csr: CSRMatrixView, start: int, stop: int):
    """CSC row window = CSR column block of the transpose (:119)."""
    return CSCRowBlock(csr_col_block(At_csr, start, stop))


@dataclasses.dataclass(frozen=True)
class _CSCView:
    """A CSC view: the transpose's CSR view, transposed on
    materialization."""
    t: CSRMatrixView

    @property
    def shape(self):
        return (self.t.shape[1], self.t.shape[0])

    @property
    def n_rows(self):
        return self.shape[0]

    @property
    def n_cols(self):
        return self.shape[1]

    @property
    def dtype(self):
        return self.t.dtype

    @property
    def device(self):
        return self.t.device

    def materialize(self):
        return self.t.materialize().T

    def matmat(self, X, precision=None):
        return self.materialize() @ X


class CSCColBlockView(_CSCView):
    """CSC column-window view — wraps the transpose's CSR row view
    (zero-copy)."""


class CSCRowBlock(_CSCView):
    """CSC row window — wraps the transpose's CSR column block."""
