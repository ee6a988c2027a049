"""Adaptive-sign unpivoted LU (``getrfnp``) — replaces
``randlapack_tpu/ops/pallas_lu.py`` (its Pallas kernel becomes the
hand-written CUDA kernel of ``csrc/getrfnp.cu``).

``getrfnp`` is the LAPACK ``launhr_col_getrfnp2`` analogue behind
``orhr_col``: it factors M − diag(s) = L·U, choosing each
sᵢ = −sign(current Schur diagonal) during the elimination, so every pivot
satisfies |uᵢᵢ| ≥ 1. The plain version here is the JAX package's
recursive halving (GEMM and triangular solves at the inner nodes,
``base``-step rank-1 loops at the leaves). The kernel (``getrfnp_cuda``)
is a right-looking blocked elimination over panels of 32 columns, modelled
step for step by ``getrfnp_schedule``; the earlier flat kernel stays
reachable as ``getrfnp_flat``.
"""
from __future__ import annotations

import torch

from ..errors import require
from .util import require_kernel_operands

# kernel launches since the last reset
LAUNCHES = {"getrfnp": 0, "getrfnp_flat": 0}

MAX_K = 2048
NB = 32           # the blocked kernel's panel width


def getrfnp(M: torch.Tensor, base: int = 32):
    """Plain version: recursive adaptive-sign unpivoted LU.
    Returns ``(F, s)``: F packed (unit-L strict-lower + U upper), s (k,)."""
    k = M.shape[0]
    if k <= base:
        F = M.clone()
        s = []
        one = torch.ones((), dtype=M.dtype, device=M.device)
        for j in range(k):
            d = F[j, j]
            sj = torch.where(d >= 0, -one, one)
            piv = d - sj
            col = F[j + 1:, j] / piv
            F[j + 1:, j + 1:] -= torch.outer(col, F[j, j + 1:])
            F[j, j] = piv
            F[j + 1:, j] = col
            s.append(sj)
        return F, (torch.stack(s) if s
                   else torch.zeros(0, dtype=M.dtype, device=M.device))

    k1 = k // 2
    M11, M12 = M[:k1, :k1], M[:k1, k1:]
    M21, M22 = M[k1:, :k1], M[k1:, k1:]
    F11, s1 = getrfnp(M11, base)
    U12 = torch.linalg.solve_triangular(F11, M12, upper=False, left=True,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(F11, M21, upper=True, left=False)
    F22, s2 = getrfnp(M22 - L21 @ U12, base)
    F = torch.cat([torch.cat([F11, U12], 1), torch.cat([L21, F22], 1)], 0)
    return F, torch.cat([s1, s2])


def getrfnp_schedule(M: torch.Tensor, nb: int = NB):
    """Plain model of the blocked kernel's order (tests only): for each
    panel of ``nb`` columns, the rank-1 steps of its diagonal block with
    adaptive signs, the rows of L21 = A21·U11⁻¹ and the columns of
    U12 = L11⁻¹·A12, then A22 −= L21·U12 one rank-1 term at a time.
    Returns ``(F, s)`` in ``getrfnp``'s layout."""
    k = M.shape[0]
    F = M.clone()
    s = torch.zeros(k, dtype=M.dtype, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    for j in range(0, k, nb):
        e = min(j + nb, k)
        for p in range(j, e):
            d = F[p, p].clone()
            s[p] = torch.where(d >= 0, -one, one)
            F[p, p] = d - s[p]
            F[p + 1:e, p] /= F[p, p]
            F[p + 1:e, p + 1:e] -= torch.outer(F[p + 1:e, p], F[p, p + 1:e])
        for p in range(j, e):
            F[e:, p] /= F[p, p]
            F[e:, p + 1:e] -= torch.outer(F[e:, p], F[p, p + 1:e])
            F[p + 1:e, e:] -= torch.outer(F[p + 1:e, p], F[p, e:])
        for p in range(j, e):
            F[e:, e:] -= torch.outer(F[e:, p], F[p, e:])
    return F, s


def _launch(name: str, M: torch.Tensor):
    from .. import _build
    require(M.device.type == "cuda", f"{name} takes a CUDA tensor, "
            f"got {M.device}")
    require(M.dtype in (torch.float32, torch.float64),
            f"{name} dtype must be float32/float64, got {M.dtype}")
    require(M.dim() == 2 and M.shape[0] == M.shape[1],
            f"{name} takes a square matrix, got {tuple(M.shape)}")
    require(M.is_contiguous(), f"{name} takes a contiguous matrix")
    k = M.shape[0]
    require(1 <= k <= MAX_K, f"{name} takes 1 <= k <= {MAX_K}, got {k}")
    F = torch.empty_like(M)
    s = torch.empty(k, dtype=M.dtype, device=M.device)
    _build.call("rl_" + name.removesuffix("_cuda"), F, M, F, s, k)
    LAUNCHES[name.removesuffix("_cuda")] += 1
    return F, s


def getrfnp_cuda(M: torch.Tensor):
    """K3 on the card: the blocked elimination in one launch of one
    block. Returns ``(F, s)`` in ``getrfnp``'s layout."""
    return _launch("getrfnp_cuda", M)


def getrfnp_flat(M: torch.Tensor):
    """The earlier K3 kernel: the flat k-step elimination, one block of
    1024 threads on F in device memory. On no path; kept to compare."""
    return _launch("getrfnp_flat", M)


def getrfnp_routed(M: torch.Tensor):
    """``getrfnp``: K3 on CUDA, the recursive plain version on the CPU."""
    if M.device.type == "cuda":
        require_kernel_operands("K3", M)
        return getrfnp_cuda(M.contiguous())
    if M.device.type == "cpu":
        return getrfnp(M)
    raise NotImplementedError(f"no getrfnp for device {M.device}")
