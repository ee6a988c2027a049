"""Factorization-backed solver operators (counterpart of
``randlapack_tpu/extras/solver_linops.py``; reference:
extras/linops/ext_cholsolver_linop.hh — ``CholSolverLinOp`` exposes K⁻¹
(or the half-solve L⁻¹) of a sparse SPD matrix as a linear operator;
ext_lusolver_linop.hh:53 the same with a sparse LU).

The sparse direct factorization runs once on the host (scipy SuperLU,
with the JAX package's ``permc_spec`` choices). The bulk multi-RHS
triangular solves run on the operator's device by default
(``device_solves=True``), through the packed triangular solve of
``sketching.sparse_data`` with the permutations as gathers:
x = P_c·U⁻¹·L⁻¹·P_r·b for SuperLU's P_r·K·P_c = L·U. The factors are
packed once, at construction. ``device_solves=False`` (the JAX package's
``pure_callback``) solves on the host in f64 and casts back to the
input's dtype and device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sketching.sparse_data import pack_triangular, packed_trsm


class HostFactors(NamedTuple):
    """A solver operator's host factors (scipy CSR matrices and int
    permutations): P_r·K·P_c = L·U, or for the half-solve factor L̃⁻¹,
    L = L_c, U = None, perm_c = None and L̃ = P_rᵀ·L_c."""
    L: object
    U: object
    perm_r: np.ndarray
    perm_c: np.ndarray | None


def _spmatrix(rows, cols, vals, n: int):
    import scipy.sparse as sp
    return sp.csc_matrix((np.asarray(vals, dtype=np.float64),
                          (np.asarray(rows), np.asarray(cols))),
                         shape=(n, n))


def lu_factors(K) -> HostFactors:
    """SuperLU with its default column ordering (COLAMD)."""
    import scipy.sparse.linalg as spla
    lu = spla.splu(K.tocsc())
    return HostFactors(lu.L.tocsr(), lu.U.tocsr(), lu.perm_r, lu.perm_c)


def half_factors(K) -> HostFactors:
    """A half-solve factor of SPD K without cholmod, any n:
    symmetric-mode SuperLU with diagonal pivoting off does no row
    pivoting on an SPD matrix, so P·K·Pᵀ = L·U with U = D·Lᵀ, and
    L_c = L·√D is the Cholesky factor of the permuted matrix:
    K = (Pᵀ·L_c)(Pᵀ·L_c)ᵀ. Whitening needs some L̃ with L̃·L̃ᵀ = K; the
    reference's layout-flip trick (ext_cholsolver_linop.hh:30-33) likewise
    exposes the permuted factor."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    lu = spla.splu(K.tocsc(), permc_spec="MMD_AT_PLUS_A",
                   diag_pivot_thresh=0.0, options={"SymmetricMode": True})
    if not np.array_equal(lu.perm_r, lu.perm_c):
        raise ValueError("SuperLU row-pivoted despite SymmetricMode — the "
                         "matrix is not SPD (half-solve requires SPD K)")
    d = lu.U.diagonal()
    if np.any(d <= 0.0):
        raise ValueError("non-positive pivot: K is not positive definite")
    return HostFactors((lu.L @ sp.diags(np.sqrt(d))).tocsr(), None,
                       lu.perm_r, None)


def _coo(M):
    M = M.tocoo()
    return M.row, M.col, M.data


class _SolverLinOp:
    """Shared machinery: host factors, their packed device forms and the
    solves. Subclasses construct from a COO matrix; ``from_factors`` takes
    ready host factors (``interop`` builds them from numpy arrays);
    factors without U are a half-solve factor."""

    def _setup(self, factors: HostFactors, n: int, dtype, device_solves,
               device):
        self.factors = factors
        self._half = factors.U is None
        self._n = n
        self._dtype = dtype
        self._device_solves = device_solves
        self._device = torch.device(device)
        self._packed = {}
        if device_solves:
            # the forward solve's factors; LU's tmatmat packs the
            # transposed ones on its first call
            self._pack("L", factors.L, True)
            if factors.U is not None:
                self._pack("U", factors.U, False)

    @classmethod
    def from_factors(cls, factors: HostFactors, n: int, dtype=torch.float32,
                     device_solves: bool = True, device="cuda"):
        """The operator over ready host factors (no factorization)."""
        op = cls.__new__(cls)
        op._setup(factors, n, dtype, device_solves, device)
        return op

    def _pack(self, name, M, lower):
        self._packed[name] = pack_triangular(*_coo(M), self._n, lower=lower,
                                             dtype=self._dtype,
                                             device=self._device)

    def packed(self, name):
        """The packed device form of factor ``name`` ("L", "U", and after
        a transposed LU solve "Lt", "Ut")."""
        return self._packed[name]

    # protocol ---------------------------------------------------------
    @property
    def dim(self):
        return self._n

    @property
    def n_rows(self):
        return self._n

    @property
    def n_cols(self):
        return self._n

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def fro_nrm(self):
        raise NotImplementedError("implicit inverse operator")

    # solves -----------------------------------------------------------
    def _gather(self, X, perm):
        return X[torch.as_tensor(perm, device=X.device)]

    def _device_solve(self, X, transpose=False):
        f = self.factors
        if self._half:
            return packed_trsm(self._packed["L"],
                               self._gather(X, np.argsort(f.perm_r)))
        if not transpose:
            t = self._gather(X, np.argsort(f.perm_r))
            z = packed_trsm(self._packed["U"],
                            packed_trsm(self._packed["L"], t))
            return self._gather(z, f.perm_c)
        if "Ut" not in self._packed:
            self._pack("Ut", f.U.T, True)
            self._pack("Lt", f.L.T, False)
        t = self._gather(X, np.argsort(f.perm_c))
        z = packed_trsm(self._packed["Lt"],
                        packed_trsm(self._packed["Ut"], t))
        return self._gather(z, f.perm_r)

    def _host_solve(self, X, transpose=False):
        from scipy.sparse.linalg import spsolve_triangular as tri
        f = self.factors
        B = X.detach().cpu().numpy().astype(np.float64)
        if self._half:
            Z = tri(f.L, B[np.argsort(f.perm_r)], lower=True)
        elif not transpose:
            Z = tri(f.U, tri(f.L, B[np.argsort(f.perm_r)], lower=True),
                    lower=False)[f.perm_c]
        else:
            Z = tri(f.L.T.tocsr(), tri(f.U.T.tocsr(), B[np.argsort(
                f.perm_c)], lower=True), lower=False)[f.perm_r]
        return torch.from_numpy(np.ascontiguousarray(Z)).to(
            dtype=X.dtype, device=X.device)

    def _solve(self, X, transpose=False):
        if self._device_solves:
            return self._device_solve(X, transpose)
        return self._host_solve(X, transpose)

    def matmat(self, X, precision=None):
        return self._solve(X)

    # K symmetric (Chol); the JAX package's half operator answers tmatmat
    # with the same half-solve as matmat, and so does this one
    tmatmat = matmat


class CholSolverLinOp(_SolverLinOp):
    """K⁻¹ of a sparse SPD matrix as a linear operator (reference
    ext_cholsolver_linop.hh). ``half=True`` exposes the half-solve L̃⁻¹
    for a sparse permuted Cholesky factor L̃ = Pᵀ·L_c with L̃·L̃ᵀ = K (see
    ``half_factors``). The factors live on ``device``."""

    def __init__(self, rows, cols, vals, n, dtype=torch.float32,
                 half: bool = False, device_solves: bool = True,
                 device="cuda"):
        K = _spmatrix(rows, cols, vals, n)
        self._setup(half_factors(K) if half else lu_factors(K), n, dtype,
                    device_solves, device)


class LUSolverLinOp(_SolverLinOp):
    """K⁻¹ of a general sparse matrix through a sparse LU (reference
    ext_lusolver_linop.hh:53); ``tmatmat`` solves with Kᵀ. The factors
    live on ``device``."""

    def __init__(self, rows, cols, vals, n, dtype=torch.float32,
                 device_solves: bool = True, device="cuda"):
        self._setup(lu_factors(_spmatrix(rows, cols, vals, n)), n, dtype,
                    device_solves, device)

    def tmatmat(self, X, precision=None):
        return self._solve(X, transpose=True)

    @classmethod
    def from_mm(cls, path, dtype=torch.float32, device="cuda"):
        """The operator of the square matrix in a Matrix Market file."""
        from ..errors import require
        from .io import mm_read
        rows, cols, vals, shape = mm_read(path)
        require(shape[0] == shape[1], f"not square: {shape}")
        return cls(rows, cols, vals, shape[0], dtype, device=device)
