"""Symmetric power sketch — SYPS (counterpart of
``randlapack_tpu/comps/syps.py``; reference: RandLAPACK/comps/rl_syps.hh:
SYPS::call :82/:96): Ω ← A·Ω on a symmetric operator, stabilized every
``passes_per_stab`` passes. A is a dense symmetric tensor or a symmetric
linop with ``matmat(X)`` and a ``dim`` property.

Spans (``utils.timing``): ``syps``, in it a ``stabilize`` a stabilization;
every product with A, here and in SYRF, REVD2 and ``nystrom_pc_data``, is
an ``apply_a`` span, counted in ``revd2.applies`` and, by its n·s
entries, in ``revd2.apply_columns``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.util import matmul
from ..rng import RNGState
from ..utils.timing import count, span
from .orth import Stab, stabilize
from .rs import _gaussian_start


def _apply_sym(A, X, precision):
    """A·X at ``precision`` for a dense tensor or a linop."""
    count("revd2.applies")
    count("revd2.apply_columns", X.shape[0] * X.shape[1])
    with span("apply_a"):
        if isinstance(A, torch.Tensor):
            return matmul(A, X, precision)
        return A.matmat(X, precision)


def _sym_dim(A) -> int:
    """The order n of a symmetric operator (``Tensor.dim`` is a method,
    a linop's ``dim`` a property)."""
    return A.shape[0] if isinstance(A, torch.Tensor) else A.dim


@dataclasses.dataclass(frozen=True)
class SYPSConfig:
    passes_over_data: int = 3
    passes_per_stab: int = 1
    stab: Stab = Stab.plu


def syps(A, k: int, cfg: SYPSConfig, state: RNGState,
         precision=STABLE_PRECISION, omega=None):
    """n×k power-iterated sketch of a symmetric operator. ``omega``
    injects the n×k Gaussian start (``state`` still advances). Returns
    ``(Omega, next_state)``."""
    precision = resolve_precision(precision)
    n = _sym_dim(A)
    omega, state = _gaussian_start((n, k), A.dtype, A.device, state, omega)
    with span("syps"):
        for p in range(cfg.passes_over_data):
            omega = _apply_sym(A, omega, precision)
            if (p + 1) % cfg.passes_per_stab == 0:
                with span("stabilize"):
                    omega, _ = stabilize(omega, cfg.stab, precision)
    return omega, state
