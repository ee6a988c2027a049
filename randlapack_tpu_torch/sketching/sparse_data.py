"""Sparse matrix formats and conversions (counterpart of
``randlapack_tpu/sketching/sparse_data.py``; the RandBLAS ``sparse_data``
capability, SURVEY.md §2.9: COO/CSR/CSC matrices, ``coo_to_csr/csc``,
``*_to_dense``, ``dense_to_*``, ``left_spmm``/``right_spmm``, ``spgemm``
and the sparse triangular solve).

The format conversions are host numpy code, as in the JAX package. The
products take torch sparse tensors: on the card a CSR or COO operand
goes to cuSPARSE. CSC is carried as the CSR of the transpose, as in the
JAX package: every CSC operation is a transposed CSR one.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def coo_sort(rows, cols, vals, shape):
    """Canonicalize COO: sort by (row, col) and sum duplicates (host)."""
    rows, cols, vals = _host(rows), _host(cols), _host(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows.astype(np.int64) * shape[1] + cols
    uniq, inv = np.unique(key, return_inverse=True)
    out = np.zeros(len(uniq), dtype=vals.dtype)
    np.add.at(out, inv, vals)
    return (uniq // shape[1]).astype(np.int32), \
        (uniq % shape[1]).astype(np.int32), out


def coo_to_csr(rows, cols, vals, shape):
    """COO → CSR triple ``(indptr, indices, data)`` (host conversion)."""
    rows, cols, vals = coo_sort(rows, cols, vals, shape)
    indptr = np.zeros(shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, cols, vals


def coo_to_csc(rows, cols, vals, shape):
    """COO → CSC triple ``(indptr, indices, data)`` = CSR of the transpose."""
    return coo_to_csr(cols, rows, vals, (shape[1], shape[0]))


def csr_to_coo(indptr, indices, data):
    counts = np.diff(_host(indptr))
    rows = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    return rows, _host(indices).astype(np.int32), _host(data)


def coo_to_dense(rows, cols, vals, shape, dtype=None, device="cuda"):
    """Densify COO (duplicates summed) on the host, as a tensor on
    ``device``."""
    vals = _host(vals)
    out = np.zeros(shape, dtype=dtype or vals.dtype)
    np.add.at(out, (_host(rows), _host(cols)), vals)
    return torch.from_numpy(out).to(device)


def dense_to_coo(A, tol: float = 0.0):
    """The entries of A with |a| > tol as host COO arrays, row-major."""
    Ah = _host(A)
    rows, cols = np.nonzero(np.abs(Ah) > tol)
    return rows.astype(np.int32), cols.astype(np.int32), Ah[rows, cols]


def _quiet(fn, *args, **kwargs):
    """``fn(*args)`` with PyTorch's "sparse CSR is in beta" warning
    silenced (it is raised on every CSR construction)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse CSR tensor "
                                "support is in beta.*")
        return fn(*args, **kwargs)


def to_bcoo(rows, cols, vals, shape, device="cuda") -> torch.Tensor:
    """A torch sparse COO tensor on ``device`` (``torch.sparse_coo_tensor``;
    replaces the JAX package's ``jax.experimental.sparse.BCOO``). Not
    coalesced: duplicate entries stay separate until an operation sums
    them."""
    idx = torch.stack([torch.as_tensor(_host(rows), dtype=torch.int64),
                       torch.as_tensor(_host(cols), dtype=torch.int64)])
    return torch.sparse_coo_tensor(idx, torch.as_tensor(_host(vals)),
                                   tuple(shape),
                                   check_invariants=False).to(device)


def to_bcsr(indptr, indices, data, shape, device="cuda") -> torch.Tensor:
    """A torch sparse CSR tensor on ``device`` with int32 indices
    (``torch.sparse_csr_tensor``; replaces the JAX package's
    ``jax.experimental.sparse.BCSR``)."""
    return _quiet(torch.sparse_csr_tensor,
                  torch.as_tensor(_host(indptr), dtype=torch.int32),
                  torch.as_tensor(_host(indices), dtype=torch.int32),
                  torch.as_tensor(_host(data)), tuple(shape),
                  device=device, check_invariants=False)


def left_spmm(sp, B, precision=None):
    """sp @ B for a sparse COO or CSR ``sp`` (RandBLAS left_spmm)."""
    return sp @ B


def right_spmm(A, sp, precision=None):
    """A @ sp (RandBLAS right_spmm), as (spᵀ·Aᵀ)ᵀ: the transpose of a
    COO tensor is COO, that of a CSR tensor its CSC form."""
    return (sp.t() @ A.T).T


def spgemm(sp1, sp2):
    """Sparse × sparse (RandBLAS spgemm capability); cuSPARSE SpGEMM on
    the card for two CSR operands."""
    return sp1 @ sp2


def _pad_csr_rows(rows, cols, vals, n, dtype):
    """Host-side exact padded-CSR packing: (n, L) col/val arrays with
    L = max row occupancy (pad entries have val 0)."""
    rows, cols, vals = _host(rows), _host(cols), _host(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n)
    L = max(int(counts.max(initial=0)), 1)
    start = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    pos = np.arange(len(rows)) - start[rows]
    cols_pad = np.zeros((n, L), np.int64)
    vals_pad = np.zeros((n, L), dtype)
    cols_pad[rows, pos] = cols
    vals_pad[rows, pos] = vals
    return cols_pad, vals_pad, L


class PackedTriangular(NamedTuple):
    """A sparse triangular matrix packed for ``packed_trsm`` on one device:
    the off-diagonal-block entries as padded CSR rows (``cols``, ``vals``:
    (npad, L), L the widest row, pad entries 0) and the diagonal blocks
    densified (``diag``: (nb, bs, bs))."""
    cols: torch.Tensor
    vals: torch.Tensor
    diag: torch.Tensor
    n: int
    lower: bool

    @property
    def width(self) -> int:
        """L, the padded row length every row is stored at."""
        return self.cols.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.cols, self.vals, self.diag))


def pack_triangular(rows, cols, vals, n: int, lower: bool = True,
                    unit_diagonal: bool = False, block: int = 256,
                    dtype=None, device="cuda") -> PackedTriangular:
    """Pack the triangular T given in COO form (host index arrays) for
    ``packed_trsm``: padded CSR rows built once on the host, the diagonal
    blocks of ``block`` rows densified by one accumulating scatter on
    ``device``. Values are cast to ``dtype`` (default: the values' own)."""
    vals_np = _host(vals)
    cols_pad, vals_pad, L = _pad_csr_rows(rows, cols, vals_np, n,
                                          vals_np.dtype)
    dtype = dtype or torch.from_numpy(vals_np[:0]).dtype
    bs = min(block, n)
    nb = -(-n // bs)
    npad = nb * bs
    cols_pad = torch.as_tensor(cols_pad, device=device)
    vals_pad = torch.as_tensor(vals_pad, device=device).to(dtype)
    if npad != n:
        cols_pad = torch.nn.functional.pad(cols_pad, (0, 0, 0, npad - n))
        vals_pad = torch.nn.functional.pad(vals_pad, (0, 0, 0, npad - n))

    # densify the diagonal blocks (one scatter over the packed entries)
    ri = torch.arange(npad, device=device)[:, None].expand(npad, L)
    in_diag = (cols_pad // bs) == (ri // bs)
    zero = torch.zeros((), dtype=dtype, device=device)
    scatter_vals = torch.where(in_diag, vals_pad, zero)
    if unit_diagonal:
        # LAPACK semantics: stored diagonal entries are ignored
        scatter_vals = torch.where(cols_pad == ri, zero, scatter_vals)
    D = torch.zeros((nb, bs, bs), dtype=dtype, device=device)
    D.index_put_((ri // bs, ri % bs, cols_pad % bs), scatter_vals,
                 accumulate=True)
    eye = torch.eye(bs, dtype=dtype, device=device)
    if unit_diagonal:
        D = D + eye[None]
    elif npad != n:
        # pad rows beyond n get an identity diagonal
        fix = (torch.arange(npad, device=device) >= n).to(dtype).view(nb,
                                                                      bs)
        D = D + fix[:, :, None] * eye[None]
    # off-diagonal entries only in the gather layers
    return PackedTriangular(cols_pad, torch.where(in_diag, zero, vals_pad),
                            D, n, lower)


def packed_trsm(T: PackedTriangular, B: torch.Tensor) -> torch.Tensor:
    """Solve T·X = B for a packed T on B's device, one block row at a
    time in the JAX package's blocking and order: the coupling to the
    solved rows by a gather-FMA layer, then the dense triangular solve of
    the diagonal block. Returns X (n, k), or (n,) for a vector B."""
    if B.ndim == 1:
        return packed_trsm(T, B[:, None])[:, 0]
    nb, bs = T.diag.shape[:2]
    npad = nb * bs
    D, vals = T.diag.to(B.dtype), T.vals.to(B.dtype)
    if npad != T.n:
        B = torch.nn.functional.pad(B, (0, 0, 0, npad - T.n))
    X = torch.zeros_like(B)
    for i in (range(nb) if T.lower else range(nb - 1, -1, -1)):
        c = i * bs
        cp, vp = T.cols[c:c + bs], vals[c:c + bs]
        acc = torch.einsum("rl,rln->rn", vp, X[cp])
        X[c:c + bs] = torch.linalg.solve_triangular(
            D[i], B[c:c + bs] - acc, upper=not T.lower)
    return X[:T.n]


def sparse_trsm(rows, cols, vals, n: int, B: torch.Tensor,
                lower: bool = True, unit_diagonal: bool = False,
                block: int = 256, precision=None):
    """Blocked sparse triangular solve T·X = B on B's device — the
    RandBLAS ``sparse_data::trsm`` capability (the reference's solver
    linops run bulk multi-RHS solves through it,
    ext_cholsolver_linop.hh).

    T is given in COO form (host index arrays): ``pack_triangular`` packs
    it (padded CSR rows on the host, dense diagonal blocks of ``block``
    rows), ``packed_trsm`` solves. A caller that solves with one T many
    times packs it once. Returns X (n, k), or (n,) for a vector B.
    """
    return packed_trsm(pack_triangular(rows, cols, vals, n, lower,
                                       unit_diagonal, block, B.dtype,
                                       B.device), B)
