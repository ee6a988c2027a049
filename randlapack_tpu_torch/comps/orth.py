"""Orthogonalizers and stabilizers (counterpart of
``randlapack_tpu/comps/orth.py``; reference: RandLAPACK/comps/rl_orth.hh:
CholQRQ :69, HQRQ :145, PLUL :212) as an enum-dispatched function.

PLU stabilization keeps the JAX package's non-finite flag and its
δ = 2^(e_max−40) cyclic pad verbatim: the pad moves LU pivots at ties.
The LU is ``ops.qr.lu_factor`` (cuSOLVER on the card). The row
permutation is built on the host from LAPACK's swap sequence (one host
read a call), so no m×m permutation matrix is ever formed; under
``torch.func.vmap`` it comes from ``torch.lu_unpack`` on the device, and
the Householder fallback runs beside the CholQR and is selected there.
Each host read (the swaps, the fallback's flag) adds one to the counter
``revd2.host_reads`` (``utils.timing.count``).
"""
from __future__ import annotations

import enum

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.cholqr import (_pow2, cholqr, cholqr2, cholqr_auto,
                          shifted_cholqr3)
from ..ops.qr import lu_factor, qr_econ
from ..ops.util import is_batched
from ..utils.timing import count


class Stab(enum.Enum):
    cholqr = "cholqr"            # CholQRQ: syrk→potrf→trsm
    cholqr2 = "cholqr2"          # two-pass (default orthogonalizer)
    scholqr3 = "scholqr3"        # shifted CholQR3 (unconditionally stable)
    hqr = "hqr"                  # Householder (geqrf+ungqr)
    plu = "plu"                  # PLUL: pivoted-LU lower factor (stabilize only)
    auto = "auto"                # condition-aware ladder
                                 # (ops/cholqr.py::cholqr_auto)


def orth(A: torch.Tensor, method: Stab = Stab.cholqr2,
         precision=STABLE_PRECISION):
    """Orthonormalize the columns of A. Returns ``(Q, fail)``, ``fail`` a
    bool tensor on A's device (the reference's ``chol_fail``; callers
    fall back to ``hqr``)."""
    precision = resolve_precision(precision)
    if method == Stab.auto:
        Q, _, fail = cholqr_auto(A, precision)
    elif method == Stab.cholqr:
        Q, _, fail = cholqr(A, precision)
    elif method == Stab.cholqr2:
        Q, _, fail = cholqr2(A, precision)
    elif method == Stab.scholqr3:
        Q, _, fail = shifted_cholqr3(A, precision)
    elif method == Stab.hqr:
        Q, _ = qr_econ(A)
        fail = torch.zeros((), dtype=torch.bool, device=A.device)
    else:
        raise ValueError(f"{method} is a stabilizer, not an orthogonalizer")
    return Q, fail


def _orth_or_hqr(Y: torch.Tensor, method: Stab, precision) -> torch.Tensor:
    """orth(Y) with the Householder fallback on a CholQR failure: one
    host read of the flag (``lax.cond`` in the JAX package); the
    Householder QR runs only when the flag is set (under vmap it runs
    and is selected on the device)."""
    Q, fail = orth(Y, method, precision)
    if method == Stab.hqr:
        return Q
    if is_batched(fail):
        return torch.where(fail, orth(Y, Stab.hqr, precision)[0], Q)
    count("revd2.host_reads")
    if bool(fail):
        Q, _ = orth(Y, Stab.hqr, precision)
    return Q


def _swaps_to_permutation(piv: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's 1-based row swaps (row i ↔ piv[i]) as the permutation
    ``perm`` with (P·A)[i] = A[perm[i]], on piv's device."""
    perm = list(range(m))
    count("revd2.host_reads")
    for i, p in enumerate((piv.cpu() - 1).tolist()):
        perm[i], perm[p] = perm[p], perm[i]
    return torch.tensor(perm, dtype=torch.int64, device=piv.device)


def stabilize(A: torch.Tensor, method: Stab = Stab.plu,
              precision=STABLE_PRECISION):
    """A well-conditioned basis of range(A), used between power passes
    where orthonormality is not needed (reference PLUL, rl_orth.hh:
    212-230: getrf → unit-lower L, rows un-permuted). Returns
    ``(B, fail)``."""
    precision = resolve_precision(precision)
    if method != Stab.plu:
        return orth(A, method, precision)
    finite = torch.isfinite(A)
    bad = ~finite.all()
    A = torch.where(finite, A, torch.zeros((), dtype=A.dtype,
                                           device=A.device))
    m, n = A.shape
    mx = A.abs().max()
    e = torch.floor(torch.log2(torch.where(mx > 0, mx, 1.0))).to(torch.int32)
    rows = torch.arange(m, device=A.device)
    pad = torch.zeros_like(A)
    pad[rows, rows % n] = _pow2(e - 40, A.dtype)
    LU, piv, _ = lu_factor(A + pad)
    L = torch.tril(LU[:, :n], -1) + torch.eye(m, n, dtype=A.dtype,
                                              device=A.device)
    # A + pad = P·L·U with L's row i belonging to row perm[i]: un-permute
    if is_batched(piv):
        # P·L with P from the swaps, as a gather: (P·L)[P's row of i] = L[i]
        P, _, _ = torch.lu_unpack(LU, piv, unpack_data=False)
        return L.index_select(0, torch.argsort(P.argmax(0))), bad
    out = torch.empty_like(L)
    out[_swaps_to_permutation(piv, m)] = L
    return out, bad
