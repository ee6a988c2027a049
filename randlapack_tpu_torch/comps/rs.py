"""Row sketcher — power iteration aligning the sketch with the top right
singular subspace (counterpart of ``randlapack_tpu/comps/rs.py``;
reference: RandLAPACK/comps/rl_rs.hh: RowSketcher :16, RS::call :117).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from ..ops.util import matmul
from ..rng import RNGState
from .orth import Stab, stabilize


@dataclasses.dataclass(frozen=True)
class RSConfig:
    passes_over_data: int = 2     # total products with A or Aᵀ
    passes_per_stab: int = 1
    stab: Stab = Stab.plu
    cond_check: bool = False      # one cond(Ω) estimate per stabilization
                                  # in a returned vector (rl_rs.hh:112)


def _cond_est(M: torch.Tensor, precision) -> torch.Tensor:
    """cond₂ from the Gram spectrum (rl_util.hh:403), for a skinny M."""
    G = matmul(M.T, M, precision)
    lam = torch.clamp(torch.linalg.eigvalsh(0.5 * (G + G.T)), min=0.0)
    lo = torch.sqrt(torch.clamp(lam[0], min=torch.finfo(M.dtype).tiny))
    return torch.sqrt(lam[-1]) / lo


def _gaussian_start(shape, dtype, device, state: RNGState, given):
    """The Gaussian start of a power method: ``given`` (an injected draw,
    which still advances ``state``) or a draw from ``state``. Returns
    ``(start, next_state)``."""
    if given is not None:
        require(tuple(given.shape) == tuple(shape),
                f"injected start {tuple(given.shape)}, expected {shape}")
        return given.to(dtype=dtype, device=device), state.advance()
    gen, state = state.spawn(device)
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device), state


def rs(A: torch.Tensor, k: int, cfg: RSConfig, state: RNGState,
       precision=STABLE_PRECISION, omega=None):
    """An n×k sketching matrix Ω. Returns ``(Omega, next_state)``, or
    ``(Omega, next_state, cond_nums)`` with ``cfg.cond_check``.

    ``omega`` injects the Gaussian start: n×k for an even
    ``passes_over_data``, m×k for an odd one. Products at ``precision``
    (``ops.util.matmul``)."""
    precision = resolve_precision(precision)
    m, n = A.shape
    p = cfg.passes_over_data
    conds = []

    def _stab(M):
        out, _ = stabilize(M, cfg.stab, precision)
        if cfg.cond_check:
            conds.append(_cond_est(out, precision))
        return out

    if p % 2 == 0:
        omega, state = _gaussian_start((n, k), A.dtype, A.device, state,
                                       omega)
        passes_done = 0
    else:
        omega_m, state = _gaussian_start((m, k), A.dtype, A.device, state,
                                         omega)
        omega = matmul(A.T, omega_m, precision)
        passes_done = 1
        if cfg.passes_per_stab == 1:
            omega = _stab(omega)
    while passes_done < p:
        y = matmul(A, omega, precision)
        passes_done += 1
        if passes_done % cfg.passes_per_stab == 0:
            y = _stab(y)
        omega = matmul(A.T, y, precision)
        passes_done += 1
        if passes_done % cfg.passes_per_stab == 0:
            omega = _stab(omega)
    if cfg.cond_check:
        return omega, state, (torch.stack(conds) if conds else
                              torch.zeros((0,), dtype=A.dtype,
                                          device=A.device))
    return omega, state
