"""Blocked QB factorization (counterpart of ``randlapack_tpu/comps/qb.py``;
reference: RandLAPACK/comps/rl_qb.hh: QBalg :18, QB::call :134 — grow Q, B
by b columns a block, re-orthogonalize against the earlier blocks, track
the Frobenius error, stop early).

Q, B and the error history are gathered block by block and joined at the
end (out of place, so autograd and ``torch.func.vmap`` go through). The
in-loop
stop (error growth or loss of orthogonality) freezes the loop on the
device, as the JAX package's ``fori_loop`` does: later blocks are zeroed
and their errors hold ``min(prev_err, 1)``. The only host reads are the
Householder fallbacks (``rf`` and the re-orthogonalization, one each a
block) and PLU's pivots inside ``rs``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from ..ops.util import matmul
from ..rng import RNGState
from .orth import Stab, _orth_or_hqr
from .rf import RFConfig, rf


@dataclasses.dataclass(frozen=True)
class QBConfig:
    rf: RFConfig = RFConfig()
    orth: Stab = Stab.cholqr2     # re-orthogonalization method
    block_size: int = 64


def qb_blocked(A: torch.Tensor, k: int, cfg: QBConfig, state: RNGState,
               precision=STABLE_PRECISION, omegas=None):
    """Fixed-rank blocked QB: A ≈ Q B with Q (m, k) orthonormal, B (k, n).

    Returns ``(Q, B, block_errs, next_state)``: ``block_errs[i]`` is
    ‖A − Q_{:(i+1)b} B_{:(i+1)b}‖_F / ‖A‖_F after block i. Block i draws
    from ``state.branch(i)``; ``omegas[i]``, when given, injects its RS
    start instead (see ``rs``). The returned state is ``state.advance()``,
    apart from every block's stream. Products at ``precision``
    (``ops.util.matmul``)."""
    precision = resolve_precision(precision)
    m, n = A.shape
    b = cfg.block_size
    require(k % b == 0, "k must be a multiple of block_size")
    nblocks = k // b
    require(omegas is None or len(omegas) == nblocks,
            f"omegas: one start a block ({nblocks})")
    dtype, dev = A.dtype, A.device
    eps = torch.finfo(dtype).eps
    tol_orth = 100.0 * eps ** 0.5 * b ** 0.5
    eye = torch.eye(b, dtype=dtype, device=dev)
    norm_A = torch.linalg.norm(A)
    Qs, Bs, errs = [], [], []
    # block 0 compares with 2.0, above any relative error
    prev_err = torch.full((), 2.0, dtype=dtype, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    A_work = A
    for i in range(nblocks):
        Qi, _ = rf(A_work, b, cfg.rf, state.branch(i), precision,
                   None if omegas is None else omegas[i])
        # re-orthogonalize against the blocks already in Q
        Qf = (torch.cat(Qs, 1) if Qs
              else torch.zeros((m, 0), dtype=dtype, device=dev))
        Qi = _orth_or_hqr(
            Qi - matmul(Qf, matmul(Qf.T, Qi, precision), precision),
            cfg.orth, precision)
        Bi = matmul(Qi.T, A_work, precision)
        A_next = A_work - matmul(Qi, Bi, precision)
        new_err = torch.linalg.norm(A_next) / norm_A
        # the in-loop stop (rl_qb.hh:228, codes 3-4): error growth or
        # orthogonality loss freezes the loop, this block and every later
        # one discarded
        grew = new_err > prev_err * (1.0 + 100.0 * eps)
        lost = torch.linalg.norm(matmul(Qi.T, Qi, precision) - eye) > tol_orth
        stopped = stopped | grew | lost
        keep = (~stopped).to(dtype)
        A_work = torch.where(stopped, A_work, A_next)
        Qs.append(Qi * keep)
        Bs.append(Bi * keep)
        prev_err = torch.where(stopped, torch.clamp(prev_err, max=1.0),
                               new_err)
        errs.append(prev_err)
    return (torch.cat(Qs, 1), torch.cat(Bs, 0), torch.stack(errs),
            state.advance())


# Status codes of the reference QB's return codes 0–6 (rl_qb.hh:193-256)
# that the static design can show
QB_OK = 0                 # tolerance met within rank budget
QB_RANK_EXHAUSTED = 1     # ran to rank k without reaching tol
QB_ERROR_GREW = 2         # blockwise error increased -> loop froze
QB_STAGNATED = 3          # error history froze before the rank budget


def qb(A: torch.Tensor, k: int, cfg: QBConfig, state: RNGState,
       tol: float = 0.0, precision=STABLE_PRECISION, omegas=None):
    """Adaptive QB: the blocked factorization at k rounded up to whole
    blocks, cut at the first block whose relative Frobenius error is
    ≤ tol (or at rank k). Returns ``(Q, B, rank, err, next_state)``."""
    b = cfg.block_size
    k_pad = -(-k // b) * b
    Q, B, errs, state = qb_blocked(A, k_pad, cfg, state, precision, omegas)
    errs_h = errs.cpu().numpy()
    nb = len(errs_h)
    stop = next((i for i in range(nb) if errs_h[i] <= tol), nb - 1)
    rank = min((stop + 1) * b, k)
    return Q[:, :rank], B[:rank, :], rank, float(errs_h[stop]), state


def qb_status(errs, tol: float) -> int:
    """The reference's return code for a blocked-QB error history: the
    in-loop stop freezes the history, so a flat tail before the budget
    shows the tripped condition."""
    e = (errs.cpu().numpy() if isinstance(errs, torch.Tensor)
         else np.asarray(errs))
    if np.any(np.diff(e) > 1e-12):
        return QB_ERROR_GREW
    if e.min() <= tol:
        return QB_OK
    flat = np.isclose(np.diff(e), 0.0, atol=0.0)
    if len(e) > 1 and flat[-1] and not flat.all():
        return QB_STAGNATED
    return QB_RANK_EXHAUSTED
