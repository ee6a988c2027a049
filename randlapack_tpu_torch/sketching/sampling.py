"""Index-sampling utilities (counterpart of
``randlapack_tpu/sketching/sampling.py``; RandBLAS sampling capability):
``weights_to_cdf`` and ``sample_indices_iid``, used by RPCholesky pivot
sampling (reference: RandLAPACK/comps/rl_rpchol.hh:139-143). CDF
inversion is one vectorized ``searchsorted``.
"""
from __future__ import annotations

import torch

from ..rng import RNGState


def weights_to_cdf(weights: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize nonnegative weights to a CDF. Negative weights are clamped.

    ``eps`` mirrors the reference's error_if_below guard loosely: weights
    below eps are treated as zero.
    """
    w = torch.where(weights > eps, weights, torch.zeros_like(weights))
    c = torch.cumsum(w, dim=0)
    total = c[-1]
    return c / torch.where(total > 0, total, torch.ones_like(total))


def cdf_to_indices(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Invert the CDF at the uniforms ``u``: the first index whose CDF
    value is ≥ u, clipped into range. int64 indices."""
    idx = torch.searchsorted(cdf, u.contiguous(), right=False)
    return torch.clamp(idx, 0, cdf.shape[0] - 1)


def sample_indices_iid(cdf: torch.Tensor, n: int, state: RNGState):
    """n iid draws from the distribution with the given CDF.

    Returns ``(indices, next_state)``; int64 indices in [0, len(cdf)).
    """
    gen, nxt = state.spawn(cdf.device)
    u = torch.rand((n,), generator=gen, dtype=cdf.dtype, device=cdf.device)
    return cdf_to_indices(cdf, u), nxt
