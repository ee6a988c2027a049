"""Factors across the two packages, through numpy: the JAX package's
``BQRRPFactors`` (one array per field) become the port's and back, so
either package's ``bqrrp_q``/``bqrrp_apply_qt`` can consume factors the
other made; HQRRP's GEQP3-format ``(packed, taus, R, J)`` crosses the same
way, and so does KRILL's state: the kernel operator, the spectral
preconditioner (one package's drives the other's ``pcg``) and the
RPCholesky factor with its pivots. The sketching operators cross too (a
SASO's rows and values, an SRHT's signs and sampled rows), so both
packages can apply the same draw. So do the low-rank results: QB's
(Q, B, errs), a low-rank SVD's (U, S, Vt) and REVD2's Nyström pair
(V, λ), from which either package builds its ``SpectralPrecond``. The
operator slice's state crosses too: a sparse operator from its COO
arrays, a CSR view from its ``(indptr, indices, data)`` and a dense
sketching operator from its distribution's fields and its matrix. The
solver operators' host factors cross as numpy COO arrays and
permutations, so both packages can solve with one factorization (the
JAX operators keep scipy's SuperLU object, which
``splu_factors_to_numpy`` reads)."""
from __future__ import annotations

import numpy as np
import torch

from .drivers.bqrrp import BQRRPFactors
from .extras.solver_linops import (CholSolverLinOp, HostFactors,
                                   LUSolverLinOp)
from .linops import CSRMatrixView, SparseLinOp
from .linops.symmetric import SpectralPrecond
from .pdkernels import SquaredExpKernelLinOp
from .sketching import (DenseDist, DenseSkOp, ScalarDist, SparseDist,
                        SparseSkOp, SRHTSkOp)


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def factors_from_numpy(arrays: dict, device="cuda") -> BQRRPFactors:
    """``{"V", "T", "R", "J", "rank", "fail"}`` numpy arrays → factors on
    ``device`` (J as int64, rank int32, fail bool)."""
    def t(name, dtype=None):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)
    return BQRRPFactors(V=t("V"), T=t("T"), R=t("R"),
                        J=t("J", torch.int64), rank=t("rank", torch.int32),
                        fail=t("fail", torch.bool))


def factors_to_numpy(fac: BQRRPFactors) -> dict:
    """Factors → a dict of numpy arrays, one per field."""
    return {name: _to_numpy(getattr(fac, name))
            for name in BQRRPFactors._fields}


LAPACK_FORMAT_FIELDS = ("packed", "taus", "R", "J")


def lapack_format_from_numpy(arrays: dict, device="cuda"):
    """``{"packed", "taus", "R", "J"}`` numpy arrays (as
    ``hqrrp_lapack_format`` returns them; in its row-sharded mode
    ``packed`` is a rank's rows, taken as they are) → the tuple
    ``(packed, taus, R, J)`` on ``device`` (J as int64)."""
    return tuple(torch.tensor(np.asarray(arrays[name]),
                              dtype=torch.int64 if name == "J" else None,
                              device=device)
                 for name in LAPACK_FORMAT_FIELDS)


def lapack_format_to_numpy(packed, taus, R, J) -> dict:
    """HQRRP's GEQP3-format output → a dict of numpy arrays."""
    return {name: _to_numpy(t)
            for name, t in zip(LAPACK_FORMAT_FIELDS, (packed, taus, R, J))}


def kernel_linop_from_numpy(arrays: dict, evals_include_reg: bool = True,
                            block: int = 2048,
                            device="cuda") -> SquaredExpKernelLinOp:
    """``{"X", "bandwidth", "mus"}`` (the JAX operator's leaves as numpy
    arrays) → the kernel operator on ``device``."""
    X = torch.tensor(np.asarray(arrays["X"]), device=device)
    return SquaredExpKernelLinOp(
        X, float(np.asarray(arrays["bandwidth"])),
        np.array(arrays["mus"], ndmin=1), evals_include_reg, block)


def kernel_linop_to_numpy(G: SquaredExpKernelLinOp) -> dict:
    """The kernel operator's leaves → a dict of numpy arrays."""
    return {"X": _to_numpy(G.X), "bandwidth": np.float64(G.bandwidth),
            "mus": _to_numpy(G.mus)}


def spectral_precond_from_numpy(arrays: dict,
                                device="cuda") -> SpectralPrecond:
    """``{"V", "D"}`` numpy arrays → the spectral preconditioner on
    ``device`` (D (k,) for one μ, (k, s) for per-column μ)."""
    return SpectralPrecond(*(torch.tensor(np.asarray(arrays[name]),
                                          device=device)
                             for name in ("V", "D")))


def spectral_precond_to_numpy(P: SpectralPrecond) -> dict:
    """The spectral preconditioner → a dict of numpy arrays."""
    return {"V": _to_numpy(P.V), "D": _to_numpy(P.D)}


def rpchol_from_numpy(arrays: dict, device="cuda"):
    """``{"F", "pivots"}`` numpy arrays (as ``rp_cholesky`` returns them)
    → the tuple ``(F, pivots)`` on ``device`` (pivots as int64)."""
    return (torch.tensor(np.asarray(arrays["F"]), device=device),
            torch.tensor(np.asarray(arrays["pivots"]), dtype=torch.int64,
                         device=device))


def rpchol_to_numpy(F, pivots) -> dict:
    """RPCholesky's factor and pivots → a dict of numpy arrays."""
    return {"F": _to_numpy(F), "pivots": _to_numpy(pivots)}


def saso_from_numpy(dist_fields: dict, rows, vals,
                    device="cuda") -> SparseSkOp:
    """A SASO from its distribution's fields (``{"n_rows", "n_cols",
    "vec_nnz"}``) and its (vec_nnz, long_axis) rows (int64 on
    ``device``) and values."""
    return SparseSkOp(SparseDist(**{k: int(v) for k, v in
                                    dist_fields.items()}),
                      torch.tensor(np.asarray(rows), dtype=torch.int64,
                                   device=device),
                      torch.tensor(np.asarray(vals), device=device))


def saso_to_numpy(S: SparseSkOp) -> tuple:
    """A SASO → ``(dist_fields, rows, vals)`` as ``saso_from_numpy``
    takes them."""
    return ({"n_rows": S.dist.n_rows, "n_cols": S.dist.n_cols,
             "vec_nnz": S.dist.vec_nnz}, _to_numpy(S.rows),
            _to_numpy(S.vals))


def srht_from_numpy(d: int, m: int, signs, rows, device="cuda") -> SRHTSkOp:
    """A d×m SRHT from its (m,) signs and (d,) sampled rows (int64)."""
    return SRHTSkOp(int(d), int(m),
                    torch.tensor(np.asarray(signs), device=device),
                    torch.tensor(np.asarray(rows), dtype=torch.int64,
                                 device=device))


def srht_to_numpy(S: SRHTSkOp) -> tuple:
    """An SRHT → ``(d, m, signs, rows)`` as ``srht_from_numpy`` takes
    them."""
    return S.n_rows, S.n_cols, _to_numpy(S.signs), _to_numpy(S.rows)


def tensors_from_numpy(arrays, device="cuda") -> tuple:
    """Numpy arrays (or anything ``np.asarray`` takes) → a tuple of
    tensors on ``device``, in the same order."""
    return tuple(torch.tensor(np.asarray(a), device=device) for a in arrays)


def tensors_to_numpy(*tensors) -> tuple:
    """Tensors → a tuple of numpy arrays, in the same order."""
    return tuple(_to_numpy(t) for t in tensors)


# the low-rank results cross as tuples in their drivers' order: QB's
# (Q, B, errs), a low-rank SVD's (U, S, Vt), REVD2's Nyström pair (V, λ)
qb_from_numpy = lowrank_svd_from_numpy = nystrom_from_numpy = \
    tensors_from_numpy
qb_to_numpy = lowrank_svd_to_numpy = nystrom_to_numpy = tensors_to_numpy


def sparse_linop_from_numpy(rows, cols, vals, shape,
                            device="cuda") -> SparseLinOp:
    """A sparse operator from COO arrays (the JAX operator's
    ``A.indices[:, 0]``, ``A.indices[:, 1]`` and ``A.data``), on
    ``device``; duplicates stay stored entries."""
    return SparseLinOp.from_coo(rows, cols, vals, tuple(shape),
                                device=device)


def sparse_linop_to_numpy(op: SparseLinOp) -> tuple:
    """A sparse operator → ``(rows, cols, vals, shape)`` of its stored
    entries."""
    rows, cols = _to_numpy(op.indices)
    return rows, cols, _to_numpy(op.data), op.shape


def csr_view_from_numpy(indptr, indices, data, shape, row0: int = 0,
                        device="cuda") -> CSRMatrixView:
    """A CSR matrix (or row window, from ``row0``) from its arrays."""
    indptr, indices, data = tensors_from_numpy((indptr, indices, data),
                                               device)
    return CSRMatrixView(indptr, indices, data, tuple(shape), row0)


def csr_view_to_numpy(A: CSRMatrixView) -> tuple:
    """A CSR view → ``(indptr, indices, data, shape, row0)``."""
    return (*tensors_to_numpy(A.indptr, A.indices, A.data), A.shape,
            A.row0)


def dense_skop_from_numpy(dist_fields: dict, mat,
                          device="cuda") -> DenseSkOp:
    """A dense sketching operator from its distribution's fields
    (``{"n_rows", "n_cols", "family"}``, the family by its value,
    "gaussian" or "uniform") and its matrix."""
    dist = DenseDist(int(dist_fields["n_rows"]), int(dist_fields["n_cols"]),
                     ScalarDist(dist_fields.get("family", "gaussian")))
    return DenseSkOp(dist, torch.tensor(np.asarray(mat), device=device))


def dense_skop_to_numpy(S: DenseSkOp) -> tuple:
    """A dense sketching operator → ``(dist_fields, mat)``."""
    return ({"n_rows": S.dist.n_rows, "n_cols": S.dist.n_cols,
             "family": S.dist.family.value}, _to_numpy(S.mat))


def _coo_arrays(M) -> tuple:
    M = M.tocoo()
    return M.row.astype(np.int32), M.col.astype(np.int32), M.data


def splu_factors_to_numpy(lu) -> dict:
    """A scipy ``SuperLU`` (P_r·K·P_c = L·U) → ``{"L": (rows, cols,
    vals), "U": (rows, cols, vals), "perm_r", "perm_c"}``."""
    return {"L": _coo_arrays(lu.L), "U": _coo_arrays(lu.U),
            "perm_r": np.asarray(lu.perm_r), "perm_c": np.asarray(lu.perm_c)}


def solver_factors_to_numpy(op) -> dict:
    """A solver operator's host factors → ``{"L", "U", "perm_r",
    "perm_c"}`` as ``splu_factors_to_numpy`` gives them; a half-solve
    operator's have only ``"L"`` (L_c) and ``"perm_r"``."""
    f = op.factors
    out = {"L": _coo_arrays(f.L), "perm_r": np.asarray(f.perm_r)}
    if f.U is not None:
        out.update(U=_coo_arrays(f.U), perm_c=np.asarray(f.perm_c))
    return out


def solver_linop_from_numpy(arrays: dict, n: int, dtype=torch.float32,
                            device_solves: bool = True, lu: bool = False,
                            device="cuda"):
    """The solver operator over the factors in ``arrays`` (as
    ``solver_factors_to_numpy`` gives them): a ``CholSolverLinOp`` (a
    half-solve one when there is no ``"U"``), or with ``lu`` an
    ``LUSolverLinOp``; no factorization is run."""
    import scipy.sparse as sp

    def csr(rows, cols, vals):
        return sp.csr_matrix((np.asarray(vals, np.float64),
                              (np.asarray(rows), np.asarray(cols))),
                             shape=(n, n))

    half = "U" not in arrays
    factors = HostFactors(
        csr(*arrays["L"]), None if half else csr(*arrays["U"]),
        np.asarray(arrays["perm_r"]),
        None if half else np.asarray(arrays["perm_c"]))
    if lu:
        return LUSolverLinOp.from_factors(factors, n, dtype, device_solves,
                                          device)
    return CholSolverLinOp.from_factors(factors, n, dtype, device_solves,
                                        device)
