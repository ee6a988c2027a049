"""Sketch-and-precondition least squares (counterpart of
``randlapack_tpu/drivers/spls.py``; the reference exposes the pieces —
rpc_data_svd_saso + pcg_saddle — and tests them end to end in extras'
test_pcgls; this driver is the composed API):

    min_x ‖A x − b‖² + μ‖x‖²

by LSQR on A (or on [A; √μ I] for μ > 0), or by PCG on
(AᵀA + μI) x = Aᵀb, right-preconditioned by M from a d×m SASO sketch of
A: M = R_sk⁻¹ (``precond="qr"``) or V_sk·diag(1/√(σ_sk² + μ))
(``precond="svd"``, optionally refined against the sketch Gram).

No step is a Pallas kernel in the JAX package: the products are cuBLAS
GEMV/GEMM on the card, the sketch is the SASO scatter, QR, SVD and
Cholesky are cuSOLVER. The SASO can be injected (``sketch=``, drawn by
JAX in the tests); an injected sketch still advances ``state``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..rng import RNGState
from ..comps.determiter import PCGSaddleConfig, pcg_saddle
from ..comps.lsqr import LSQRConfig, lsqr
from ..comps.preconditioners import (make_right_orthogonalizer,
                                     right_precond_saso, rpc_data_svd_saso,
                                     saso_sketch)


@dataclasses.dataclass(frozen=True)
class SPLSConfig:
    """The JAX package's configuration, field for field (see
    ``randlapack_tpu/drivers/spls.py`` for each field's story)."""
    d_factor: float = 4.0         # sketch rows = d_factor * n
    vec_nnz: int = 8
    precond: str = "svd"          # "qr": M = R_sk⁻¹; "svd": V/√(σ²+μ)
    solver: str = "auto"          # "auto": lsqr for one right-hand side,
                                  # pcg for several; "lsqr" | "pcg"
    refine_precond: bool = True   # one Cholesky pass of M against the
                                  # sketch Gram (precond "svd")
    pcg: PCGSaddleConfig = PCGSaddleConfig()


def _qr_precond(A, d, cfg, state, sketch):
    """M = R_sk⁻¹ from the QR of the SASO sketch, its diagonal floored at
    eps·max|diag| (relative only: an absolute +eps would swamp every
    diagonal of a small-normed sketch)."""
    n = A.shape[1]
    A_sk, state = saso_sketch(A, d, cfg.vec_nnz, state, sketch)
    R = torch.linalg.qr(A_sk, mode="r")[1]
    dg = torch.diagonal(R)
    mxd = dg.abs().max()
    ref = torch.where(mxd > 0, mxd * torch.finfo(A.dtype).eps,
                      torch.ones_like(mxd))
    R = R - torch.diag(dg) + torch.diag(torch.where(dg.abs() > ref, dg,
                                                    ref))
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(R, eye, upper=True), state


def spls(A: torch.Tensor, b: torch.Tensor, mu, cfg: SPLSConfig,
         state: RNGState, precision=STABLE_PRECISION, sketch=None):
    """Solve the regularized overdetermined least-squares problem for one
    right-hand side b (m,) or several (m, s).

    ``sketch``: the d×m ``SparseSkOp`` (d = min(d_factor·n, m)) to use in
    place of the one drawn from ``state``; "svd" with d = m draws none.
    For μ > 0 the LSQR path reads max(μ) on the host, as the JAX package
    does.

    Returns ``(x, res_hist, iters, next_state)``, iters a Python int.
    Products at ``precision`` (``ops.util.matmul``); SASO's scatter has
    none."""
    require_fp32_matmul()
    precision = resolve_precision(precision)
    require(cfg.precond in ("qr", "svd"), f"unknown precond {cfg.precond!r}")
    m, n = A.shape
    d = min(int(cfg.d_factor * n), m)
    if cfg.precond == "qr":
        M, state = _qr_precond(A, d, cfg, state, sketch)
    elif cfg.refine_precond:
        M, _, _, state = right_precond_saso(A, d, mu, state, cfg.vec_nnz,
                                            precision=precision,
                                            sketch=sketch)
    else:
        V_sk, sigma_sk, state = rpc_data_svd_saso(A, d, state, cfg.vec_nnz,
                                                  precision=precision,
                                                  sketch=sketch)
        M, _ = make_right_orthogonalizer(V_sk, sigma_sk, mu)
    one_rhs = b.ndim == 1 or b.shape[1] == 1
    solver = cfg.solver
    if solver == "auto":
        solver = "lsqr" if one_rhs else "pcg"
    require(solver in ("lsqr", "pcg"), f"unknown solver {cfg.solver!r}")
    if solver == "lsqr":
        require(one_rhs, "the lsqr path takes one right-hand side")
        lcfg = LSQRConfig(tol=cfg.pcg.tol, max_iters=cfg.pcg.max_iters)
        mu_ = torch.as_tensor(mu, dtype=A.dtype, device=A.device)
        if float(mu_.max()) > 0.0:
            # damped least squares as the augmented system
            # [A; √μ I] x = [b; 0] (Paige-Saunders damping): plain LSQR on
            # A would silently drop the regularizer
            eye = torch.eye(n, dtype=A.dtype, device=A.device)
            A = torch.cat([A, torch.sqrt(mu_) * eye])
            b = torch.cat([b.reshape(-1), torch.zeros((n,), dtype=A.dtype,
                                                      device=A.device)])
        x, hist, iters = lsqr(A, b, M, lcfg, precision)
        return x, hist, iters, state
    vector = b.ndim == 1
    x0 = torch.zeros((n,) + tuple(b.shape[1:]), dtype=A.dtype,
                     device=A.device)
    c = torch.zeros_like(x0)
    if vector:
        b, x0, c = b[:, None], x0[:, None], c[:, None]
    x, hist, iters = pcg_saddle(A, b, c, mu, M, x0, cfg.pcg, precision)
    return (x[:, 0] if vector else x), hist, iters, state
