"""Index-sampling utilities (counterpart of
``randlapack_tpu/sketching/sampling.py``; RandBLAS sampling capability):
``weights_to_cdf`` and ``sample_indices_iid``, used by RPCholesky pivot
sampling (reference: RandLAPACK/comps/rl_rpchol.hh:139-143), and the
uniform draws SASO construction needs. CDF inversion is one vectorized
``searchsorted``; sampling without replacement takes the top k of
uniforms per batch (the role of RandBLAS's ``repeated_fisher_yates``).
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


def sample_indices_iid_uniform(n_population: int, n: int, state: RNGState,
                               device="cuda"):
    """n iid uniform indices in [0, n_population) on ``device``.
    Returns ``(indices, next_state)``, int64."""
    gen, nxt = state.spawn(device)
    return torch.randint(0, n_population, (n,), generator=gen,
                         device=device), nxt


def sample_distinct_uniform(n_population: int, k: int, n_batches: int,
                            state: RNGState, chunk: int = 8192,
                            device="cuda"):
    """For each of ``n_batches`` independent batches, ``k`` DISTINCT
    uniform indices in [0, n_population): per batch, the positions of the
    k largest of n_population uniforms — exact sampling without
    replacement. Batches go ``chunk`` at a time, so at most
    ``chunk * n_population`` uniforms exist at once. The positions come
    from a stable descending sort (ties keep the lower index first, as
    ``jax.lax.top_k`` does).

    Returns ``(idx, next_state)`` with idx (n_batches, k), int64."""
    gen, nxt = state.spawn(device)
    out = torch.empty((n_batches, k), dtype=torch.int64, device=device)
    for c0 in range(0, n_batches, chunk):
        rows = min(chunk, n_batches - c0)
        u = torch.rand((rows, n_population), generator=gen, device=device)
        out[c0:c0 + rows] = torch.sort(u, dim=1, descending=True,
                                       stable=True).indices[:, :k]
    return out, nxt
