"""Range finder — Q = orth(A·Ω) (counterpart of
``randlapack_tpu/comps/rf.py``; reference: RandLAPACK/comps/rl_rf.hh:
RangeFinder :17, RF::call :107)."""
from __future__ import annotations

import dataclasses

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.util import matmul
from ..rng import RNGState
from .orth import Stab, _orth_or_hqr
from .rs import RSConfig, _cond_est, rs


@dataclasses.dataclass(frozen=True)
class RFConfig:
    rs: RSConfig = RSConfig()
    orth: Stab = Stab.cholqr2
    cond_check: bool = False      # also estimate cond(Y) before the
                                  # orthogonalization (rl_rf.hh:102)


def rf(A: torch.Tensor, k: int, cfg: RFConfig, state: RNGState,
       precision=STABLE_PRECISION, omega=None):
    """Orthonormal basis for an approximate dominant k-dim range of A.

    Returns ``(Q, next_state)`` with Q (m, k), plus a ``cond_nums``
    vector (RS's stabilization conds, then cond(Y), rl_rf.hh:102) when
    ``cfg.cond_check``. A CholQR failure falls back to Householder QR.
    ``omega`` injects RS's Gaussian start (see ``rs``). Products at
    ``precision`` (``ops.util.matmul``)."""
    precision = resolve_precision(precision)
    rs_cfg = cfg.rs
    if cfg.cond_check and not rs_cfg.cond_check:
        rs_cfg = dataclasses.replace(rs_cfg, cond_check=True)
    # unpack by rs_cfg's own arity: RSConfig(cond_check=True) under
    # RFConfig(cond_check=False) makes rs return conds, which rf drops
    if rs_cfg.cond_check:
        omega, state, conds = rs(A, k, rs_cfg, state, precision, omega)
    else:
        omega, state = rs(A, k, rs_cfg, state, precision, omega)
    y = matmul(A, omega, precision)
    if cfg.cond_check:
        conds = torch.cat([conds, _cond_est(y, precision)[None].to(A.dtype)])
    q = _orth_or_hqr(y, cfg.orth, precision)
    if cfg.cond_check:
        return q, state, conds
    return q, state
