"""KRILL — kernel ridge regression via RPCholesky-preconditioned CG
(counterpart of ``randlapack_tpu/drivers/krill.py``; reference:
RandLAPACK/drivers/rl_krill.hh: krill_full_rpchol :21 — RPCholesky
preconditioner data at k≈√n, SpectralPrecond::prep, then pcg on the
regularized kernel operator; supports one μ or per-column μ).

With a ``SquaredExpKernelLinOp`` on a CUDA device every operator
application of the PCG is one launch of the fused kernel K4
(``ops.kernels.kernel_matmat``): ``iters + 1`` launches a solve.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..comps.determiter import PCGConfig, pcg
from ..comps.preconditioners import rpchol_pc_data
from ..comps.rpchol import RPCholConfig, rp_cholesky
from ..config import STABLE_PRECISION, resolve_precision
from ..linops.symmetric import SpectralPrecond
from ..ops.util import matmul
from ..rng import RNGState


@dataclasses.dataclass(frozen=True)
class KrillConfig:
    k: int | None = None          # preconditioner rank (None → ~√n)
    rpchol_block: int = 64
    pcg: PCGConfig = PCGConfig(tol=1e-8, max_iters=200)
    seminorm: object = None       # optional problem seminorm callable
                                  # val = seminorm(R) routed to pcg
                                  # (rl_determiter.hh:299-345) — the
                                  # convergence metric then becomes
                                  # seminorm(N·R) ≤ tol·(1+seminorm(N·R₀))
                                  # and hist holds the seminorm trace


def _default_rank(n: int, cfg: KrillConfig) -> int:
    return cfg.k or max(cfg.rpchol_block,
                        (math.isqrt(n) // cfg.rpchol_block)
                        * cfg.rpchol_block)


def krill_full_rpchol(G, H: torch.Tensor, mus, cfg: KrillConfig,
                      state: RNGState, precision=STABLE_PRECISION,
                      noise=None):
    """Solve (K + μᵢ I) xᵢ = hᵢ for all columns of H.

    ``G`` is a regularized symmetric kernel operator exposing
    ``with_reg(flag)`` (RegExplicitSymLinOp or SquaredExpKernelLinOp);
    the preconditioner is built from the *unregularized* operator
    (rl_krill.hh:47) and applied per-column when μ is a vector.

    NOTE: the regularization that defines the linear systems lives in
    ``G`` itself (construct it with the same scalar-or-vector μ, exactly
    as the reference's RegExplicitSymLinOp holds its μs) — the ``mus``
    argument here only parameterizes the preconditioner and must match
    ``G``'s regularization, or PCG solves a different system than the
    preconditioner targets.

    ``noise`` injects RPCholesky's random draws (see
    ``comps.rpchol.rp_cholesky``); ``None`` draws them from ``state``.
    ``precision`` sets the products (``ops.util.matmul``); K4 ignores it.

    Returns ``(X, res_hist, iters, next_state)``, iters a Python int.
    """
    precision = resolve_precision(precision)
    k = _default_rank(G.dim, cfg)
    V, lam, _, state = rpchol_pc_data(G.with_reg(False), k, state,
                                      block_size=cfg.rpchol_block,
                                      precision=precision, noise=noise)
    P = SpectralPrecond.prep(V, lam, torch.atleast_1d(torch.as_tensor(
        mus, dtype=H.dtype, device=H.device)))
    X, hist, iters = pcg(G.with_reg(True), H, P, torch.zeros_like(H),
                         cfg.pcg, precision, seminorm=cfg.seminorm)
    return X, hist, iters, state


def krill_restricted_rpchol(G, H: torch.Tensor, mus, cfg: KrillConfig,
                            state: RNGState, precision=STABLE_PRECISION,
                            noise=None):
    """Restricted-domain kernel ridge regression — the API the reference
    documents but ships disabled (rl_krill.hh:75-141
    ``krill_restricted_rpchol``, commented out): restrict the solution to
    the span of the k RPCholesky pivot columns.

    With F the rank-k RPCholesky factor (F·Fᵀ ≈ K Nyström, with
    (F·Fᵀ)[inds, inds] = K[inds, inds]) and M = F[inds, :], solve

        min ‖F·Mᵀ·x − H‖² + μ‖Mᵀ·x‖²   over x supported on ``inds``

    by the reference's change of basis y = Mᵀx: a k-dimensional ridge
    problem (FᵀF + μI)y = FᵀH solved directly (O(n·k²), the cost class
    the reference calls reasonable), then x[inds] = M⁻ᵀ·y.

    Returns ``(X, inds, y, next_state)``: X (n, s) zero off the pivot
    rows (the k·s nonzeros + k indices representation the reference
    notes), y the coefficients in the restricted basis.
    """
    precision = resolve_precision(precision)
    n = G.dim
    H2 = H if H.dim() == 2 else H[:, None]
    s = H2.shape[1]
    mus_arr = torch.atleast_1d(torch.as_tensor(
        mus, dtype=H.dtype, device=H.device)).expand(s)
    k = _default_rank(n, cfg)
    F, inds, state = rp_cholesky(G.with_reg(False), k,
                                 RPCholConfig(block_size=cfg.rpchol_block),
                                 state, precision, noise=noise)
    Gv = matmul(F.T, F, precision)                             # (k, k)
    rhs = matmul(F.T, H2, precision)                           # (k, s)
    eye = torch.eye(k, dtype=H.dtype, device=H.device)
    y = torch.stack([torch.cholesky_solve(
        rhs[:, j:j + 1], torch.linalg.cholesky(Gv + mus_arr[j] * eye))[:, 0]
        for j in range(s)], dim=1)
    x_active = torch.linalg.solve(F[inds, :].T, y)             # (k, s)
    X = torch.zeros((n, s), dtype=H.dtype, device=H.device)
    X[inds] = x_active
    if H.dim() == 1:
        return X[:, 0], inds, y[:, 0], state
    return X, inds, y, state
