"""Distributed tall-skinny orthogonalization over row shards (counterpart
of ``randlapack_tpu/parallel/tsqr.py``).

CholeskyQR over a mesh: each rank computes its shard's Gram, one
``psum`` of the k×k tile gives the Gram on every rank, the Cholesky
factor is computed on every rank, and the triangular solve is local:
``ops.cholqr``'s functions with their ``mesh``. A holds this rank's rows;
Q comes back as this rank's rows, R and the failure flag replicated.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.cholqr import _finite_scaled, cholqr, shifted_cholqr3
from ..ops.util import matmul
from .mesh import Mesh, check_axis, global_rows


def dist_gram(A: torch.Tensor, mesh: Mesh, axis: str = "rows",
              precision=STABLE_PRECISION) -> torch.Tensor:
    """G = AᵀA for row-sharded A — local product + one psum."""
    check_axis(mesh, axis)
    global_rows(A.shape[0], mesh, "dist_gram")
    return mesh.psum(matmul(A.T, A, resolve_precision(precision)))


def _band_guard_local(a: torch.Tensor, mesh: Mesh):
    """The JAX function's shard-local band guard: ``ops.cholqr``'s
    ``_finite_scaled`` on the shard, its max and non-finite flag reduced
    over the mesh, the overflow bound sized by the LOCAL row count.
    Returns ``(a_scaled, scale, nonfinite)``."""
    return _finite_scaled(a, mesh)


def dist_cholqr(A: torch.Tensor, mesh: Mesh, axis: str = "rows",
                passes: int = 2, precision=STABLE_PRECISION):
    """Distributed CholeskyQR over row shards. Returns ``(Q, R, fail)``
    with Q this rank's rows and R replicated. ``passes=2`` (CholQR2) is
    the stability default."""
    check_axis(mesh, axis)
    global_rows(A.shape[0], mesh, "dist_cholqr")
    precision = resolve_precision(precision)
    q, r, fail = cholqr(A, precision, mesh)
    for _ in range(passes - 1):
        q, r2, f2 = cholqr(q, precision, mesh)
        r = matmul(r2, r, precision)
        fail = fail | f2
    return q, r, fail


def dist_shifted_cholqr3(A: torch.Tensor, mesh: Mesh, axis: str = "rows",
                         precision=STABLE_PRECISION):
    """Distributed shifted CholeskyQR3: survives cond(A) ~ 1/eps without
    Householder. Returns ``(Q, R, fail)`` as ``dist_cholqr``."""
    check_axis(mesh, axis)
    global_rows(A.shape[0], mesh, "dist_shifted_cholqr3")
    return shifted_cholqr3(A, resolve_precision(precision), mesh)
