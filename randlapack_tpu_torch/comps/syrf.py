"""Symmetric range finder — SYRF = SYPS, then orth(A·Ω) (counterpart of
``randlapack_tpu/comps/syrf.py``; reference: RandLAPACK/comps/rl_syrf.hh:
SYRF::call :72/:85). The orthogonalization, with its fallback, is the span
``syrf_orth``."""
from __future__ import annotations

import dataclasses

from ..config import STABLE_PRECISION
from ..rng import RNGState
from ..utils.timing import span
from .orth import Stab, _orth_or_hqr
from .syps import SYPSConfig, _apply_sym, syps


@dataclasses.dataclass(frozen=True)
class SYRFConfig:
    syps: SYPSConfig = SYPSConfig()
    orth: Stab = Stab.cholqr2


def syrf(A, k: int, cfg: SYRFConfig, state: RNGState,
         precision=STABLE_PRECISION, omega=None):
    """Orthonormal basis aligned with the dominant eigenspace of a
    symmetric operator; a CholQR failure falls back to Householder QR.
    ``omega`` goes to ``syps``. Returns ``(Q, next_state)``."""
    omega, state = syps(A, k, cfg.syps, state, precision, omega)
    Y = _apply_sym(A, omega, precision)
    with span("syrf_orth"):
        return _orth_or_hqr(Y, cfg.orth, precision), state
