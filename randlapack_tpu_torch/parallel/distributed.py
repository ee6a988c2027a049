"""Distributed sketching + rangefinder step (counterpart of
``randlapack_tpu/parallel/distributed.py``): one randomized power /
orthogonalize / project cycle over a row-sharded operator, with the
m-contractions (Gram tiles, sketch partial sums) as psums over the mesh.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.cholqr import cholqr
from ..ops.util import matmul
from .mesh import Mesh, check_axis, global_rows


def dist_sketch_left(S: torch.Tensor, A: torch.Tensor, mesh: Mesh,
                     axis: str = "rows",
                     precision=STABLE_PRECISION) -> torch.Tensor:
    """(d×m dense sketch) @ (row-sharded m×n A) → replicated d×n: ``S`` is
    this rank's column block of the sketch (the columns matching A's
    rows, ``P(None, axis)``), and the partial products psum over the
    mesh."""
    check_axis(mesh, axis)
    global_rows(A.shape[0], mesh, "dist_sketch_left")
    return mesh.psum(matmul(S, A, resolve_precision(precision)))


def dist_rangefinder_step(A: torch.Tensor, Omega: torch.Tensor, mesh: Mesh,
                          axis: str = "rows", precision=STABLE_PRECISION):
    """One sharded rangefinder cycle (the core of RSVD/QB over a mesh):

        Y = A·Ω            (local rows)
        Q = dist CholQR(Y) (one k×k psum a pass + redundant Cholesky)
        B = QᵀA            (local + psum)
        Ω' = Bᵀ            (the power refresh with the orthonormal basis)

    A and Y/Q row-sharded; Ω, B replicated. Returns
    ``(Q, B, Omega', fail)``."""
    check_axis(mesh, axis)
    global_rows(A.shape[0], mesh, "dist_rangefinder_step")
    precision = resolve_precision(precision)
    q = matmul(A, Omega, precision)
    # CholQR2 (band guard, psummed Gram and solve a pass); Q is invariant
    # under the guard's power-of-2 scale, and no R is returned
    q, _, f1 = cholqr(q, precision, mesh)
    q, _, f2 = cholqr(q, precision, mesh)
    b = mesh.psum(matmul(q.T, A, precision))
    return q, b, b.T, f1 | f2
