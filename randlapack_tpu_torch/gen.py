"""Synthetic test matrices (counterpart of ``randlapack_tpu/gen.py``;
reference: RandLAPACK/testing/rl_gen.hh). Only the benchmark generator
is ported so far. Generators are deterministic in the RNGState and
return ``(A, next_state)``."""
from __future__ import annotations

import math

import torch

from .rng import RNGState


def fast_decay_matrix(m: int, n: int, state: RNGState,
                      dtype=torch.float32, decay: float = 6.0,
                      device="cuda"):
    """Benchmark matrix with an approximately exponential spectrum:
    A = (G₁·diag(e^{-decay·i/k}))·G₂ᵀ/√(mk) with iid Gaussian factors
    drawn on ``device`` (one GEMM, no orthogonal factors)."""
    k = min(m, n)
    gen1, state = state.spawn(device)
    gen2, state = state.spawn(device)
    s = torch.exp(-decay * torch.arange(k, dtype=dtype, device=device) / k)
    G1 = torch.randn((m, k), generator=gen1, dtype=dtype, device=device)
    G2 = torch.randn((n, k), generator=gen2, dtype=dtype, device=device)
    A = ((G1 * s[None, :]) @ G2.T) / math.sqrt(float(m) * k)
    return A, state
