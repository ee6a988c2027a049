"""RPCholesky — randomly pivoted block Cholesky of an implicit PSD matrix
(counterpart of ``randlapack_tpu/comps/rpchol.py``; reference:
RandLAPACK/comps/rl_rpchol.hh: rp_cholesky :112/:195, algorithm of
arXiv:2304.12465). The operator is accessed only through column
evaluations and its diagonal — exactly the access pattern of kernel
matrices in KRILL.

Fixed block size b, a Python loop over k/b blocks. Within-block duplicate
pivots (iid CDF sampling can repeat) are resolved by a scatter-winner mask
+ eigh-based pseudo-inverse square root of the block Gram — numerically
equivalent to the reference's dedup + potrf/trsm, but branch-free and
static-shaped.

The random draws can be injected (``noise=``), because PyTorch's
generators cannot reproduce the JAX package's streams: one row of noise
per block, Gumbel variates of length n (``"gumbel"``) or uniforms of
length b (``"iid"``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from ..ops.util import matmul
from ..rng import RNGState
from ..sketching.sampling import cdf_to_indices, weights_to_cdf


@dataclasses.dataclass(frozen=True)
class RPCholConfig:
    block_size: int = 64
    sampling: str = "gumbel"      # "gumbel": exact without-replacement
                                  # block sampling (Gumbel top-k over the
                                  # residual diagonal — distinct pivots by
                                  # construction, no zero factor columns);
                                  # "iid": the reference's
                                  # sample-with-replacement + dedup
                                  # (collisions become zero columns under
                                  # static shapes)


def _draw_noise(cfg: RPCholConfig, n: int, state: RNGState, dtype, device):
    gen, _ = state.spawn(device)
    if cfg.sampling == "gumbel":
        # −log of a unit exponential is a standard Gumbel variate
        return -torch.log(torch.empty((n,), dtype=dtype, device=device)
                          .exponential_(generator=gen))
    return torch.rand((cfg.block_size,), generator=gen, dtype=dtype,
                      device=device)


def rp_cholesky(A, k: int, cfg: RPCholConfig, state: RNGState,
                precision=STABLE_PRECISION, noise=None):
    """Rank-k approximation A ≈ F Fᵀ with randomly pivoted column selection.

    ``A`` is any object with ``dim``, ``diagonal()`` and ``columns(idx)``
    (ExplicitSymLinOp, RegExplicitSymLinOp, or a kernel linop).

    ``noise``: the random draws, one row per block — shape (k/b, n) of
    Gumbel variates for ``"gumbel"`` sampling, (k/b, b) of uniforms in
    [0, 1) for ``"iid"``; ``None`` draws them from ``state`` on the
    operator's device.

    Returns ``(F, pivots, next_state)``: F (n, k), pivots (k,) int64 (the
    selected columns; repeated draws yield zero columns in F). The two
    block products run at ``precision`` (``ops.util.matmul``).
    """
    precision = resolve_precision(precision)
    require(cfg.sampling in ("gumbel", "iid"),
            f"unknown sampling {cfg.sampling!r}")
    n = A.dim
    b = cfg.block_size
    require(k % b == 0, "k must be a multiple of block_size")
    nblocks = k // b
    d = A.diagonal()
    dtype, device = d.dtype, d.device
    eps = torch.finfo(dtype).eps
    width = n if cfg.sampling == "gumbel" else b
    if noise is not None:
        require(tuple(noise.shape) == (nblocks, width),
                f"noise must have shape {(nblocks, width)} for "
                f"{cfg.sampling!r} sampling, got {tuple(noise.shape)}")
        noise = noise.to(dtype=dtype, device=device)

    F = torch.zeros((n, k), dtype=dtype, device=device)
    piv = torch.zeros((k,), dtype=torch.int64, device=device)
    slots = torch.arange(b, device=device)

    for i in range(nblocks):
        draw = (noise[i] if noise is not None
                else _draw_noise(cfg, n, state.branch(i), dtype, device))
        # 1. sample b pivots from the residual-diagonal distribution
        if cfg.sampling == "gumbel":
            # exact without-replacement: argtop-b of log d + Gumbel noise.
            # The finite floor decides which dead entries win when fewer
            # than b are live: −1e30 + noise rounds to −1e30, a tie that
            # the stable sort gives to the lower index
            live = d > 0
            logd = torch.where(live, torch.log(torch.where(
                live, d, torch.ones_like(d))), torch.full_like(d, -1e30))
            idx = torch.sort(logd + draw, descending=True,
                             stable=True).indices[:b]
        else:
            idx = cdf_to_indices(weights_to_cdf(d), draw)
        # 2. winner mask: one representative per distinct pivot (the
        #    last of its draws)
        winner = torch.zeros((n,), dtype=torch.int64, device=device
                             ).scatter_reduce(0, idx, slots, "amax")
        keep = (winner[idx] == slots).to(dtype)
        # 3. residual columns: G = A[:, idx] − F F[idx,:]ᵀ
        G = (A.columns(idx) - matmul(F, F[idx, :].T, precision)
             ) * keep[None, :]
        # 4. block factor via pinv-sqrt of the (possibly singular) pivot
        #    Gram — replaces potrf/trsm, robust to duplicates/deficiency.
        #    Rows AND columns of the pivot Gram are masked: duplicate
        #    pivots must be fully zeroed or H loses symmetry (their row
        #    would alias the winner's) and the Schur complement overshoots.
        H = G[idx, :] * keep[None, :] * keep[:, None]
        w, U = torch.linalg.eigh(0.5 * (H + H.T))
        tol = torch.clamp(w.max(), min=0.0) * b * eps
        good = w > tol
        inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.where(
            good, w, torch.ones_like(w))), torch.zeros_like(w))
        Fb = matmul(G, U * inv_sqrt[None, :], precision)
        # 5. commit block, downdate the diagonal
        F[:, i * b:(i + 1) * b] = Fb
        piv[i * b:(i + 1) * b] = idx
        d = torch.clamp(d - torch.sum(Fb * Fb, dim=1), min=0.0)
        d[idx] = 0.0               # every drawn index has a kept winner
    # advance the counter so later branch()/spawn() streams differ from the
    # per-block streams consumed above (branch folds the counter in)
    return F, piv, state.advance()
