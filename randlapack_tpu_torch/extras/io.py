"""Matrix Market IO (counterpart of ``randlapack_tpu/extras/io.py``;
reference: extras read .mtx via fast_matrix_market; testing utilities
write .mtx, rl_test_utils.hh:379-472).

Host code through scipy. The JAX package first tries a native C++ reader
and writer built from ``native/``; the port has no native route yet
(ROADMAP.md §1 lists it).
"""
from __future__ import annotations

import numpy as np


def mm_read(path: str, dense: bool = False):
    """Read a Matrix Market file → ``(rows, cols, vals, shape)`` COO
    arrays, or a dense ndarray if ``dense=True`` (duplicates summed)."""
    import scipy.io as sio
    mat = sio.mmread(path)
    if not hasattr(mat, "tocoo"):  # dense array file
        arr = np.asarray(mat)
        if dense:
            return arr
        rows, cols = np.nonzero(arr)
        return rows.astype(np.int32), cols.astype(np.int32), \
            arr[rows, cols], arr.shape
    coo = mat.tocoo()
    rows, cols, vals = (coo.row.astype(np.int32), coo.col.astype(np.int32),
                        coo.data)
    if dense:
        out = np.zeros(coo.shape, dtype=vals.dtype)
        np.add.at(out, (rows, cols), vals)
        return out
    return rows, cols, vals, coo.shape


def mm_write(path: str, rows, cols, vals, shape, symmetric: bool = False):
    """Write a COO matrix in Matrix Market coordinate format."""
    import scipy.io as sio
    import scipy.sparse as sp
    A = sp.coo_matrix((np.asarray(vals),
                       (np.asarray(rows), np.asarray(cols))), shape=shape)
    sio.mmwrite(path, A, symmetry="symmetric" if symmetric else "general")
