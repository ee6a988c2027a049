"""LSQR — Golub-Kahan bidiagonalization least squares with right
preconditioning (counterpart of ``randlapack_tpu/comps/lsqr.py``).

The reference solves sketch-preconditioned least squares through PCG on
the normal equations (rl_determiter.hh pcg_saddle), whose attainable
x-accuracy is κ(A)²·eps. LSQR works on A directly (one A-apply and one
Aᵀ-apply an iteration), so its attainable accuracy is κ(A)·eps. With the
sketch-derived right preconditioner M (A·M near-orthonormal) it converges
in O(log 1/tol) iterations, independent of κ(A).

The JAX ``lax.while_loop`` is a Python loop here: the stop test (residual
estimate above tol·β₁, fewer than ``stall_patience`` stalled iterations
in a row) is one boolean read from the device an iteration; everything
else stays on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..ops.util import matmul


@dataclasses.dataclass(frozen=True)
class LSQRConfig:
    tol: float = 1e-10            # relative residual-reduction target
    max_iters: int = 200
    stall_patience: int = 3       # consecutive no-progress iterations
                                  # before the plateau cutoff fires; the
                                  # threshold is dtype-aware (1 − 8·eps),
                                  # so a single rounded-to-zero decrease
                                  # (common in f32) doesn't abort a
                                  # genuine mid-convergence plateau


def lsqr(A: torch.Tensor, b: torch.Tensor, M: torch.Tensor | None,
         cfg: LSQRConfig, precision=STABLE_PRECISION):
    """Solve min‖A x − b‖₂ by LSQR on the right-preconditioned system
    A·M·y = b (x = M·y). ``M=None`` runs plain LSQR.

    Returns ``(x, res_hist, iters)``: res_hist (max_iters+1,) holds φ̄, the
    estimate of ‖Ax − b‖, per iteration (rows past ``iters`` stay zero);
    iters is a Python int."""
    precision = resolve_precision(precision)
    dtype, dev = A.dtype, A.device
    b = b if b.ndim == 1 else b[:, 0]

    def op(v):       # A M v
        return matmul(A, v if M is None else matmul(M, v, precision),
                      precision)

    def op_t(u):     # (A M)ᵀ u
        w = matmul(A.T, u, precision)
        return w if M is None else matmul(M.T, w, precision)

    tiny = torch.finfo(dtype).tiny

    def guard(x):
        return torch.clamp(x, min=tiny)

    beta1 = torch.linalg.vector_norm(b)
    u = b / guard(beta1)
    v_raw = op_t(u)
    alpha = torch.linalg.vector_norm(v_raw)
    v = v_raw / guard(alpha)
    w = v
    y = torch.zeros((A.shape[1],), dtype=dtype, device=dev)
    hist = torch.zeros((cfg.max_iters + 1,), dtype=dtype, device=dev)
    hist[0] = beta1
    # plateau threshold: φ̄ is monotone nonincreasing; an iteration whose
    # decrease rounds below 8·eps relative counts as stalled, and only
    # ``stall_patience`` CONSECUTIVE stalls stop the loop
    stall_thresh = 1.0 - 8.0 * float(torch.finfo(dtype).eps)
    rhobar, phibar = alpha, beta1
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < cfg.max_iters and bool(
            (phibar > cfg.tol * beta1) & (stall < cfg.stall_patience)):
        phibar_prev = phibar
        # bidiagonalization step
        u_raw = op(v) - alpha * u
        beta = torch.linalg.vector_norm(u_raw)
        u = u_raw / guard(beta)
        v_raw = op_t(u) - beta * v
        alpha = torch.linalg.vector_norm(v_raw)
        v = v_raw / guard(alpha)
        # Givens rotation
        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        c = rhobar / guard(rho)
        s = beta / guard(rho)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        # update
        y = y + (phi / guard(rho)) * w
        w = v - (theta / guard(rho)) * w
        hist[it + 1] = phibar
        stall = torch.where(phibar > stall_thresh * phibar_prev, stall + 1,
                            torch.zeros_like(stall))
        it += 1
    x = y if M is None else matmul(M, y, precision)
    return x, hist, it
