"""Matrix Market IO (counterpart of ``randlapack_tpu/extras/io.py``;
reference: extras read .mtx via fast_matrix_market; testing utilities
write .mtx, rl_test_utils.hh:379-472).

Host code. ``mm_read`` and ``mm_write`` go through scipy where scipy
has its own C++ reader and writer (fast_matrix_market, scipy 1.12 and
later): at 1e7 entries it reads 3-4x and writes several times faster
than the native route (PERF.md, ``[mm-native]``). Elsewhere they take the
native C++ reader and writer (``native/fast_mm.cpp``, built with ``g++``
into ``build/native/`` on first use) when it builds, as the JAX package
does. Symmetric writes and files the native reader refuses (array
format) always go through scipy. ``PREFER_NATIVE`` overrides the choice;
``ROUTES`` counts the calls each route served, so a caller can see which
one was taken.
"""
from __future__ import annotations

import subprocess

import numpy as np

# calls served by each route since the last reset
ROUTES = {"read_native": 0, "read_scipy": 0, "write_native": 0,
          "write_scipy": 0}
# True or False forces the route; None decides by the scipy version
PREFER_NATIVE = None
_native = []   # [module or None] once the build was tried


def prefer_native() -> bool:
    """Whether the native route goes first: ``PREFER_NATIVE`` when set,
    else True only where scipy predates its C++ reader (1.12)."""
    if PREFER_NATIVE is not None:
        return PREFER_NATIVE
    import scipy
    major, minor = (int(p) for p in scipy.__version__.split(".")[:2])
    return (major, minor) < (1, 12)


def native_module():
    """The native module, or None where it cannot be built (no ``g++``,
    or the build failed); the build is tried once a process."""
    if not _native:
        from .. import _build
        try:
            _native.append(_build.load_native())
        except (OSError, subprocess.CalledProcessError):
            _native.append(None)
    return _native[0]


def _read_scipy(path: str, dense: bool):
    import scipy.io as sio
    ROUTES["read_scipy"] += 1
    mat = sio.mmread(path)
    if not hasattr(mat, "tocoo"):  # dense array file
        arr = np.asarray(mat)
        if dense:
            return arr
        rows, cols = np.nonzero(arr)
        return rows.astype(np.int32), cols.astype(np.int32), \
            arr[rows, cols], arr.shape
    coo = mat.tocoo()
    return (coo.row.astype(np.int32), coo.col.astype(np.int32), coo.data,
            coo.shape)


def mm_read(path: str, dense: bool = False):
    """Read a Matrix Market file → ``(rows, cols, vals, shape)`` COO
    arrays, or a dense ndarray if ``dense=True`` (duplicates summed).
    Symmetric files come back with both triangles, as scipy reads them."""
    native = native_module() if prefer_native() else None
    out = None
    if native is not None:
        try:
            rows, cols, vals, m, n = native.fast_mm_read(str(path))
            out = rows, cols, vals, (m, n)
            ROUTES["read_native"] += 1
        except ValueError:   # a file it does not parse (array format)
            pass
    if out is None:
        out = _read_scipy(str(path), dense)
        if dense and not isinstance(out, tuple):
            return out
    rows, cols, vals, shape = out
    if dense:
        arr = np.zeros(shape, dtype=vals.dtype)
        np.add.at(arr, (rows, cols), vals)
        return arr
    return rows, cols, vals, shape


def mm_write(path: str, rows, cols, vals, shape, symmetric: bool = False):
    """Write a COO matrix in Matrix Market coordinate format (values as
    ``%.17g`` on the native route: f64 round-trips exactly on both)."""
    native = None if symmetric or not prefer_native() else native_module()
    if native is not None:
        native.fast_mm_write(str(path), np.asarray(rows, np.int32),
                             np.asarray(cols, np.int32),
                             np.asarray(vals, np.float64), int(shape[0]),
                             int(shape[1]))
        ROUTES["write_native"] += 1
        return
    import scipy.io as sio
    import scipy.sparse as sp
    ROUTES["write_scipy"] += 1
    A = sp.coo_matrix((np.asarray(vals),
                       (np.asarray(rows), np.asarray(cols))), shape=shape)
    sio.mmwrite(path, A, symmetry="symmetric" if symmetric else "general")
