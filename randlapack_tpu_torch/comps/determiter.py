"""Deterministic iterative solvers — preconditioned CG family
(counterpart of ``randlapack_tpu/comps/determiter.py``; reference:
RandLAPACK/comps/rl_determiter.hh: pcg :372 with lockstep and block
modes, posm_square :232, psd_sqrt_pinv :181, pcg_saddle :19,
StatefulFrobeniusNorm :140).

A Python ``while`` loop with a convergence *mask* — converged columns
freeze (the reference's lockstep mode zeroing off-diagonal scalars,
:418-440, is exactly per-column masked CG). The loop's test reads one
boolean from the device per iteration; everything else stays on the
device. The residual history is a preallocated (max_iters+1, s) tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from ..ops.util import matmul


def _apply(op, X, precision):
    if op is None:
        return X
    if hasattr(op, "matmat"):
        return op.matmat(X, precision)
    if callable(op):
        return op(X)
    return matmul(op, X, precision)


@dataclasses.dataclass(frozen=True)
class PCGConfig:
    tol: float = 1e-8             # relative residual target
    max_iters: int = 100
    mode: str = "lockstep"        # "lockstep" (per-column) | "block"
    verbose: bool = False         # per-iteration residual trace on stdout
                                  # (the reference's ``verbose`` cout
                                  # trace, rl_determiter.hh:428,466)


def frobenius_seminorm(R: torch.Tensor):
    """The reference's ``StatefulFrobeniusNorm`` measure
    (rl_determiter.hh:140) minus the host-side history (pcg's returned
    hist tensor carries it): ‖R‖_F over the whole block residual."""
    return torch.linalg.norm(R)


def _safe_div(num, den):
    """num/den where den ≠ 0, else 0."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _psd_solve(M, B):
    """Solve M·Y = B for a symmetric PSD s×s M: Cholesky, or the eigh
    pseudo-inverse when Cholesky fails (posm_square). Reads the
    factorization's status from the device."""
    M = 0.5 * (M + M.T)
    L, info = torch.linalg.cholesky_ex(M)
    if int(info) == 0 and bool(torch.isfinite(L).all()):
        return torch.cholesky_solve(B, L)
    s = M.shape[0]
    w, U = torch.linalg.eigh(M)
    tol = w.abs().max() * s * torch.finfo(M.dtype).eps
    winv = torch.where(w.abs() > tol, 1.0 / torch.where(
        w != 0, w, torch.ones_like(w)), torch.zeros_like(w))
    return U @ (winv[:, None] * (U.T @ B))


def pcg(G, H: torch.Tensor, N, X0: torch.Tensor, cfg: PCGConfig,
        precision=STABLE_PRECISION, seminorm=None):
    """Preconditioned CG for G X = H (s columns).

    ``G``/``N`` are linops, callables, or dense tensors; ``N=None`` means
    no preconditioner. Lockstep mode solves the s systems independently
    with per-column scalars and a convergence mask; block mode couples
    them with s×s scalar solves (classical block CG, faster for one
    operator with multiple right-hand sides).

    ``seminorm`` (rl_determiter.hh:299-345): an optional callable
    ``val = seminorm(R)`` mapping the (n, s) block residual to a scalar
    tensor — a problem seminorm (may be 0 on a fixed subspace). When
    given, the reference's stopping rule replaces the per-column one:
    iterate until ``seminorm(N·R) ≤ tol·(1 + seminorm(N·R₀))``, and the
    returned hist is (max_iters+1, 2) holding the even/odd seminorm calls
    — column 0 the raw residual R, column 1 the preconditioned residual
    N·R (the reference calls seminorm twice per iteration in exactly this
    order). ``frobenius_seminorm`` reproduces StatefulFrobeniusNorm.

    Returns ``(X, res_hist, iters)``: res_hist (max_iters+1, s) of
    per-column residual norms (‖·‖₂; rows past ``iters`` stay zero) — or
    the (max_iters+1, 2) seminorm trace above — and iters, a Python int,
    the iteration count actually performed. Operator applies and block
    products at ``precision`` (``ops.util.matmul``).
    """
    require(cfg.mode in ("lockstep", "block"), f"unknown mode {cfg.mode!r}")
    prec = resolve_precision(precision)
    n, s = H.shape
    dtype, device = H.dtype, H.device
    lockstep = cfg.mode == "lockstep"
    nrm_H = torch.linalg.norm(H, dim=0)
    tol_abs = cfg.tol * torch.clamp(nrm_H, min=torch.finfo(dtype).tiny)

    X = X0
    R = H - _apply(G, X0, prec)
    Z = _apply(N, R, prec)
    P = Z
    res = torch.linalg.norm(R, dim=0)
    if seminorm is None:
        hist = torch.zeros((cfg.max_iters + 1, s), dtype=dtype, device=device)
        hist[0] = res
    else:
        sn_z = seminorm(Z)
        sn_stop = cfg.tol * (1.0 + sn_z)
        hist = torch.zeros((cfg.max_iters + 1, 2), dtype=dtype, device=device)
        hist[0, 0] = seminorm(R)
        hist[0, 1] = sn_z
    # lockstep: per-column scalars; block: s×s coupled scalars (ONE
    # operator, s right-hand sides)
    rho = torch.sum(R * Z, dim=0) if lockstep else matmul(R.T, Z, prec)

    it = 0
    while it < cfg.max_iters:
        unconverged = (res > tol_abs) if seminorm is None else None
        # a device read; lockstep mode makes no other in an iteration,
        # block mode up to four more (two in each _psd_solve)
        if not bool(unconverged.any() if seminorm is None
                    else sn_z > sn_stop):
            break
        W = _apply(G, P, prec)
        if lockstep:
            # with a seminorm the stop is global and no column freezes
            active = (unconverged.to(dtype) if seminorm is None
                      else torch.ones((s,), dtype=dtype, device=device))
            alpha = _safe_div(rho, torch.sum(P * W, dim=0)) * active
            X = X + P * alpha[None, :]
            R = R - W * alpha[None, :]
            Z = _apply(N, R, prec)
            rho_new = torch.sum(R * Z, dim=0)
            beta = _safe_div(rho_new, rho) * active
            P = Z + P * beta[None, :]
        else:
            alpha = _psd_solve(matmul(P.T, W, prec), rho)
            X = X + matmul(P, alpha, prec)
            R = R - matmul(W, alpha, prec)
            Z = _apply(N, R, prec)
            rho_new = matmul(R.T, Z, prec)
            P = Z + matmul(P, _psd_solve(rho, rho_new), prec)
        rho = rho_new
        res = torch.linalg.norm(R, dim=0)
        if seminorm is None:
            hist[it + 1] = res
            shown = res
        else:
            sn_z = seminorm(Z)
            hist[it + 1, 0] = seminorm(R)
            hist[it + 1, 1] = sn_z
            shown = sn_z
        it += 1
        if cfg.verbose:
            print(f"pcg{'' if lockstep else '(block)'} iter {it}: max "
                  f"residual {float(shown.max())}", flush=True)
    return X, hist, it


def psd_sqrt_pinv(A: torch.Tensor):
    """Square-root pseudo-inverse factor of a symmetric PSD matrix
    (reference: rl_determiter.hh:181 ``psd_sqrt_pinv``): B with
    pinv(A) = B·Bᵀ via eigendecomposition, kernel eigenvectors zeroed.

    Returns ``(B, ker_dim, code)`` — B (n, n) with the kernel
    eigenvectors' columns zeroed in place (eigh orders eigenvalues
    ASCENDING, so the zeroed columns are the LEADING ``ker_dim`` columns
    of B, not the trailing ones), ker_dim = dim(ker A) as an int32 tensor,
    and ``code`` the analogue of the reference's return value: ker_dim
    when A is PSD, −(n+1) when A is not PSD (λ_min < −tol), −(n+2) when
    A ≈ 0 — a returned flag, never an exception, per the repo's failure
    convention.
    """
    n = A.shape[0]
    w, U = torch.linalg.eigh(0.5 * (A + A.T))
    rel_tol = 10.0 * torch.finfo(A.dtype).eps
    abs_tol = rel_tol * torch.clamp(w[-1], min=1.0)
    not_psd = w[0] < -abs_tol
    is_zero = w[-1] < abs_tol
    keep = w > abs_tol
    ker = (n - keep.sum()).to(torch.int32)
    scale = torch.where(keep, 1.0 / torch.sqrt(torch.where(
        keep, w, torch.ones_like(w))), torch.zeros_like(w))
    B = U * scale[None, :]
    code = torch.where(not_psd, torch.full_like(ker, -(n + 1)),
                       torch.where(is_zero, torch.full_like(ker, -(n + 2)),
                                   ker))
    return B, ker, code


@dataclasses.dataclass(frozen=True)
class PCGSaddleConfig:
    tol: float = 1e-10
    max_iters: int = 200
    refresh_every: int = 50       # exact-residual recompute period (:92)
    verbose: bool = False         # per-iteration residual trace
                                  # (rl_determiter.hh:428 analogue)


def pcg_saddle(A: torch.Tensor, b: torch.Tensor, c: torch.Tensor, mu,
               M: torch.Tensor, x0: torch.Tensor, cfg: PCGSaddleConfig,
               precision=STABLE_PRECISION):
    """PCG for the regularized normal equations (AᵀA + μI) x = Aᵀb − c with
    right preconditioner M (so N = M Mᵀ) — the sketch-and-precondition
    least-squares core (reference: rl_determiter.hh:19).

    Returns ``(x, res_hist, iters)``, iters a Python int. Products at
    ``precision`` (``ops.util.matmul``).
    """
    prec = resolve_precision(precision)

    def normal(x):
        return matmul(A.T, matmul(A, x, prec), prec)

    rhs = matmul(A.T, b, prec) - c
    return pcg_saddle_normal(normal, rhs, mu, M, x0, cfg, prec)


def pcg_saddle_normal(normal, rhs: torch.Tensor, mu, M: torch.Tensor,
                      x0: torch.Tensor, cfg: PCGSaddleConfig,
                      precision=STABLE_PRECISION):
    """``pcg_saddle``'s loop on (AᵀA + μI) x = rhs, with the product
    x ↦ Aᵀ(A·x) given as ``normal``: the distributed least-squares driver
    passes one whose Aᵀ contraction is all-reduced over a mesh. The stop
    test reads one value from the device an iteration, so ``rhs`` and what
    ``normal`` returns must be the same on every rank of a mesh.

    Returns ``(x, res_hist, iters)``, iters a Python int."""
    prec = resolve_precision(precision)

    def G(x):
        return normal(x) + mu * x

    def N(r):
        return matmul(M, matmul(M.T, r, prec), prec)

    tol_abs = cfg.tol * torch.clamp(torch.linalg.norm(rhs),
                                    min=torch.finfo(rhs.dtype).tiny)
    x = x0
    r = rhs - G(x0)
    z = N(r)
    p = z
    rho = torch.sum(r * z)
    nrm_r = torch.linalg.norm(r)
    hist = torch.zeros((cfg.max_iters + 1,), dtype=rhs.dtype,
                       device=rhs.device)
    hist[0] = nrm_r

    it = 0
    while it < cfg.max_iters and bool(nrm_r > tol_abs):
        w = G(p)
        alpha = rho / torch.sum(p * w)
        x = x + alpha * p
        # periodic exact-residual refresh fights drift (:92)
        if (it + 1) % cfg.refresh_every == 0:
            r = rhs - G(x)
        else:
            r = r - alpha * w
        z = N(r)
        rho_new = torch.sum(r * z)
        p = z + (rho_new / rho) * p
        rho = rho_new
        nrm_r = torch.linalg.norm(r)
        hist[it + 1] = nrm_r
        it += 1
        if cfg.verbose:
            print(f"pcg_saddle iter {it}: residual {float(nrm_r)}",
                  flush=True)
    return x, hist, it
