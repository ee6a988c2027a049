"""ABRIK — block-Krylov truncated SVD (counterpart of
``randlapack_tpu/drivers/abrik.py``; reference: RandLAPACK/drivers/
rl_abrik.hh: ABRIK::call :122/:146/:165; algorithm A.1 variant of
arXiv:2306.12418): alternating A·V / Aᵀ·U block Lanczos
bidiagonalization with full two-pass re-orthogonalization, a band matrix
of QR coefficients, and the small SVD of the band factor at the end.

The bases are preallocated (m, q·b) and (n, q·b) tensors filled block by
block, as in the JAX package; re-orthogonalizing against the columns not
yet filled (zeros) changes nothing. The JAX package's ``while_loop`` is a
Python loop that reads its stop flag on the host between iterations; a
stopped iteration writes zero blocks and ends the loop, so the outputs
equal the full-budget run's. Every step is a PyTorch call (the JAX
package runs none of it in Pallas): the operator's products (cuBLAS or
cuSPARSE), cuSOLVER QR and Cholesky, the band SVD of ``ops.svd``.

Row-sharded mode (``ABRIKConfig.shard_axis`` under ``parallel.set_mesh``;
``parallel.dist_abrik`` sets both): A (a tensor) is this rank's rows and
U comes back so; A·V is row-local, Aᵀ·U, the U-side re-orthogonalization
Uᵀ·Z and the squared norms of Z and A are psummed, so the stop flag is
replicated; the m-side tall QRs run on the shard (``"cqrrt"``: the sketch
S·W psummed, then the sharded preconditioned CholQR; ``"geqrf"`` and the
rescue gather the block); the n-side work is replicated.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..ops.cholqr import preconditioned_cholqr
from ..ops.qr import qr_econ, qr_econ_rows
from ..ops.svd import svd_econ
from ..ops.util import matmul
from ..rng import RNGState
from ..utils.timing import PhaseTimer, device_sync
from .cholqr_linops import _floor_diag


def _matmat(A, X, precision):
    if hasattr(A, "matmat"):
        return A.matmat(X, precision)
    return matmul(A, X, precision)


def _tmatmat(A, X, precision):
    if hasattr(A, "tmatmat"):
        return A.tmatmat(X, precision)
    return matmul(A.T, X, precision)


def _shape(A):
    return (A.shape[0], A.shape[1]) if isinstance(A, torch.Tensor) \
        else (A.n_rows, A.n_cols)


@dataclasses.dataclass(frozen=True)
class ABRIKConfig:
    block_size: int = 32          # Krylov block width b
    max_iters: int = 10           # q: Krylov space dimension = q·b
    reorth_passes: int = 2        # full re-orthogonalization passes
    svd_method: str = "auto"      # band-factor SVD (see ops.svd.svd_econ)
    qr_explicit: str = "geqrf"    # inner tall-QR subroutine
                                  # (rl_abrik.hh:38-40 QR_explicit):
                                  # "geqrf" = Householder qr_econ;
                                  # "cqrrt" = Gaussian-sketch
                                  # preconditioned CholQR (the
                                  # CQRRT->call route, :311-348) — one
                                  # Gram GEMM instead of a Householder
                                  # chain, with a qr_econ rescue on
                                  # Cholesky breakdown
    d_factor: float = 1.25        # cqrrt sketch rows = d_factor·b
    shard_axis: str | None = None # row-sharded mode over the mesh of this
                                  # axis set by ``parallel.set_mesh``: A
                                  # and U the rank's rows (the module
                                  # docstring says how each step shards)


class _Draws:
    """ABRIK's random draws: the (n, b) Gaussian start and, in "cqrrt"
    mode, one Gaussian sketch (⌈d_factor·b⌉ ∧ rows, rows) per tall QR
    from a second spawned generator, 2q of them (index 1 is never used,
    as in the JAX package). Injected tensors stand in for the draws; the
    state advances as if they were drawn. In the row-sharded mode an
    m-side sketch (i = 0 and every odd i) is this rank's column block:
    injected so, or drawn whole (every rank draws every sketch in one
    order) and sliced, so the result does not depend on the world
    size."""

    def __init__(self, A, cfg: ABRIKConfig, state: RNGState, dtype,
                 device, v0=None, qr_sketches=None):
        m, n = _shape(A)
        b, q = cfg.block_size, cfg.max_iters
        self.cfg, self.dtype, self.device = cfg, dtype, device
        if v0 is None:
            gen, state = state.spawn(device)
            v0 = torch.randn((n, b), generator=gen, dtype=dtype,
                             device=device)
        else:
            state = state.advance()
        self.v0 = v0.to(device=device, dtype=dtype)
        self.qr_gen = None
        self.qr_sketches = qr_sketches
        if cfg.qr_explicit != "geqrf":
            require(qr_sketches is None or len(qr_sketches) == 2 * q,
                    f"qr_sketches: one a tall QR ({2 * q})")
            if qr_sketches is None:
                self.qr_gen, state = state.spawn(device)
            else:
                state = state.advance()
        self.state = state

    def sketch(self, i: int, rows: int, cols=None):
        """The Gaussian sketch of tall QR ``i`` (rows × b input), scaled
        by 1/√d; ``cols`` = (c0, c1) keeps only those columns (this
        rank's, for an m-side sketch under a mesh)."""
        if self.cfg.qr_explicit == "geqrf":
            return None
        d = min(rows, int(math.ceil(self.cfg.d_factor
                                    * self.cfg.block_size)))
        c0, c1 = (0, rows) if cols is None else cols
        if self.qr_sketches is not None:
            S = self.qr_sketches[i]
            require(isinstance(S, torch.Tensor)
                    and tuple(S.shape) == (d, c1 - c0),
                    f"qr_sketches[{i}] must be a {(d, c1 - c0)} tensor")
            S = S.to(device=self.device, dtype=self.dtype)
        else:
            S = torch.randn((d, rows), generator=self.qr_gen,
                            dtype=self.dtype, device=self.device)
            if cols is not None:
                S = S[:, c0:c1]
        return S / math.sqrt(d)


def _qr_explicit(W, S, cfg: ABRIKConfig, precision, mesh=None):
    """Inner tall-QR dispatch (rl_abrik.hh:311-348): geqrf → qr_econ;
    cqrrt → CholQR preconditioned by the R of the sketch S·W, with a
    qr_econ rescue (a host branch, one read) when the Cholesky breaks on
    a deficient or frozen block. With ``mesh``, W is this rank's rows and
    S its column block: S·W and the Gram are psummed, and ``qr_econ``
    gathers W (``ops.qr.qr_econ_rows``)."""
    if cfg.qr_explicit == "geqrf":
        return qr_econ_rows(W, mesh)
    Wsk = matmul(S, W, precision)
    if mesh is not None:
        Wsk = mesh.psum(Wsk)
    R_sk = _floor_diag(torch.linalg.qr(Wsk, mode="r")[1])
    Q, R, failq = preconditioned_cholqr(
        W, R_sk, precision, mesh, None if mesh is None
        else W.shape[0] * mesh.size)
    if bool(failq):
        return qr_econ_rows(W, mesh)
    return Q, R


def _check_cfg(cfg: ABRIKConfig, precision):
    """Refuse what the port does not take; return the mesh that
    ``cfg.shard_axis`` names (None when it is None)."""
    require_fp32_matmul()
    resolve_precision(precision)
    if cfg.shard_axis is None:
        return None
    from ..parallel.mesh import current_mesh
    return current_mesh(cfg.shard_axis)


def _sharding(A, cfg: ABRIKConfig, precision):
    """``(m, n, mesh, cols)``: A's global shape, the mesh of the
    row-sharded mode (None for none or one rank) and this rank's columns
    of an m-side sketch (None unsharded)."""
    mesh = _check_cfg(cfg, precision)
    m, n = _shape(A)
    if mesh is None:
        return m, n, None, None
    from ..parallel.mesh import shard_rows
    require(isinstance(A, torch.Tensor), "shard_axis: the row-sharded "
            "mode takes a tensor (this rank's rows), not an operator")
    m, mesh = shard_rows(A, mesh, "abrik")
    return m, n, mesh, (None if mesh is None else mesh.rows(A.shape[0]))


def _psum(t, mesh):
    return t if mesh is None else mesh.psum(t)


def _norm(X, mesh):
    """‖X‖_F of X, or of the row-sharded matrix whose rows X holds."""
    if mesh is None:
        return torch.linalg.norm(X)
    return torch.sqrt(mesh.psum(torch.sum(X * X)))


def _reorth(W, Basis, passes: int, precision, mesh=None):
    for _ in range(passes):
        W = W - matmul(Basis, _psum(matmul(Basis.T, W, precision), mesh),
                       precision)
    return W


def abrik_factor(A, state: RNGState, cfg: ABRIKConfig,
                 precision=STABLE_PRECISION, tol: float = 0.0, v0=None,
                 qr_sketches=None):
    """Block Golub-Kahan bidiagonalization of A (a tensor or an operator).

    Returns ``(U, V, B, capture, iters, state)``: U (m, qb), V (n, qb)
    orthonormal bases, B (qb, qb) upper block-bidiagonal with A·V ≈ U·B,
    ``capture`` (q,) the Frobenius capture ‖B_{:jb}‖_F after each
    iteration and ``iters`` (an int) the Krylov iterations run.

    The loop stops early on (a) Krylov exhaustion: a residual block below
    100·eps of the first block's norm is frozen rather than fed to a QR
    of noise; and (b), when ``tol > 0``, the reference's Frobenius capture
    test ‖B‖_F ≥ √(1−tol²)·‖A‖_F (rl_abrik.hh:454,595), tested in gap form
    ‖A‖² − ‖B‖² ≤ max(tol², 32·eps)·‖A‖² (the direct form rounds to true
    for any tol below √ulp(1)). The flag is read on the host after every
    iteration but the last (q − 2 reads); the blocks after a stop stay
    zero, as the full-budget run would have written them.

    ``v0`` injects the (n, b) Gaussian start, ``qr_sketches`` the 2q
    unscaled Gaussian sketches of "cqrrt" mode (entry i for tall QR i:
    0 the first A·V, 2j the Aᵀ·U of iteration j, 2j+1 its A·V; entry 1 is
    unused).
    """
    m, n, mesh, cols = _sharding(A, cfg, precision)
    b, q = cfg.block_size, cfg.max_iters
    K = q * b
    dtype = A.dtype
    dev = A.device
    dr = _Draws(A, cfg, state, dtype, dev, v0, qr_sketches)

    # V_1 from a Gaussian block (rl_abrik.hh:272-299)
    V1, _ = qr_econ(dr.v0)
    U1, R1 = _qr_explicit(_matmat(A, V1, precision), dr.sketch(0, m, cols),
                          cfg, precision, mesh)
    U = torch.zeros((_shape(A)[0], K), dtype=dtype, device=dev)
    V = torch.zeros((n, K), dtype=dtype, device=dev)
    B = torch.zeros((K, K), dtype=dtype, device=dev)
    capture = torch.zeros((q,), dtype=dtype, device=dev)
    U[:, :b], V[:, :b], B[:b, :b] = U1, V1, R1
    capture[0] = torch.linalg.norm(R1)
    eps = torch.finfo(dtype).eps
    tol_bd = 100.0 * eps * torch.linalg.norm(R1)
    if tol and tol > 0.0:
        norm_A = (A.fro_nrm() if hasattr(A, "fro_nrm")
                  else _norm(A, mesh))
        norm_A2 = norm_A * norm_A
        gap_thresh = max(float(tol) ** 2, 32.0 * eps) * norm_A2
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    j = 1
    while j < q:
        c = j * b
        Uj = U[:, c - b:c]
        Vj = V[:, c - b:c]
        Rj = B[c - b:c, c - b:c]
        # odd half-step: W = AᵀU_j − V_j R_jᵀ, reorth, QR → V_{j+1}, L
        W = _psum(_tmatmat(A, Uj, precision), mesh) - matmul(Vj, Rj.T,
                                                            precision)
        W = _reorth(W, V, cfg.reorth_passes, precision)
        stopped = stopped | (torch.linalg.norm(W) < tol_bd)
        Vn, L = _qr_explicit(W, dr.sketch(2 * j, n), cfg, precision)
        # even half-step: Z = A V_{j+1} − U_j Lᵀ, reorth, QR → U_{j+1}, R
        Z = _matmat(A, Vn, precision) - matmul(Uj, L.T, precision)
        Z = _reorth(Z, U, cfg.reorth_passes, precision, mesh)
        stopped = stopped | (_norm(Z, mesh) < tol_bd)
        Un, Rn = _qr_explicit(Z, dr.sketch(2 * j + 1, m, cols), cfg,
                              precision, mesh)

        keep = (~stopped).to(dtype)
        U[:, c:c + b] = Un * keep
        V[:, c:c + b] = Vn * keep
        # B[j-1, j] block = Lᵀ ; B[j, j] = R
        B[c - b:c, c:c + b] = L.T * keep
        B[c:c + b, c:c + b] = Rn * keep
        cap_j = torch.linalg.norm(B)
        capture[j] = cap_j
        if tol and tol > 0.0:
            stopped = stopped | (norm_A2 - cap_j * cap_j <= gap_thresh)
        j += 1
        if j < q and bool(stopped):
            break
    return U, V, B, capture, j, dr.state


def _abrik_factor_timed(A, state, cfg, precision, timer, v0=None,
                        qr_sketches=None):
    """The bidiagonalization split into the reference's phase slots
    (rl_abrik.hh:734: allocation / sketching / gemm_A / reorth / qr /
    r_cpy / s_cpy / norm / main_loop / get_factors / total), each phase
    synced; all q iterations run (a stopped one writes zeros), as in the
    JAX package's measurement mode."""
    m, n, mesh, cols = _sharding(A, cfg, precision)
    b, q = cfg.block_size, cfg.max_iters
    K = q * b
    dtype, dev = A.dtype, A.device

    with timer.phase("allocation"):
        dr = _Draws(A, cfg, state, dtype, dev, v0, qr_sketches)
        U = torch.zeros((_shape(A)[0], K), dtype=dtype, device=dev)
        V = torch.zeros((n, K), dtype=dtype, device=dev)
        B = torch.zeros((K, K), dtype=dtype, device=dev)
        capture = torch.zeros((q,), dtype=dtype, device=dev)
        device_sync(B)
    with timer.phase("sketching"):
        V1, _ = qr_econ(dr.v0)
        device_sync(V1)
    with timer.phase("gemm_A"):
        Z1 = _matmat(A, V1, precision)
        device_sync(Z1)
    with timer.phase("qr"):
        U1, R1 = _qr_explicit(Z1, dr.sketch(0, m, cols), cfg, precision,
                              mesh)
        device_sync(U1)
    with timer.phase("r_cpy"):
        U[:, :b], V[:, :b], B[:b, :b] = U1, V1, R1
        device_sync(B)
    with timer.phase("norm"):
        capture[0] = torch.linalg.norm(R1)
        device_sync(capture)

    eps = torch.finfo(dtype).eps
    tol_bd = 100.0 * eps * torch.linalg.norm(B[:b, :b])
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    t_loop0 = time.perf_counter()
    for j in range(1, q):
        c = j * b
        Uj, Vj = U[:, c - b:c], V[:, c - b:c]
        Rj = B[c - b:c, c - b:c]
        with timer.phase("gemm_A"):
            W = _psum(_tmatmat(A, Uj, precision), mesh) - matmul(
                Vj, Rj.T, precision)
            device_sync(W)
        with timer.phase("reorth"):
            W = _reorth(W, V, cfg.reorth_passes, precision)
            device_sync(W)
        with timer.phase("qr"):
            stopped = stopped | (torch.linalg.norm(W) < tol_bd)
            Vn, L = _qr_explicit(W, dr.sketch(2 * j, n), cfg, precision)
            device_sync(Vn)
        with timer.phase("gemm_A"):
            Z = _matmat(A, Vn, precision) - matmul(Uj, L.T, precision)
            device_sync(Z)
        with timer.phase("reorth"):
            Z = _reorth(Z, U, cfg.reorth_passes, precision, mesh)
            device_sync(Z)
        with timer.phase("qr"):
            stopped = stopped | (_norm(Z, mesh) < tol_bd)
            Un, Rn = _qr_explicit(Z, dr.sketch(2 * j + 1, m, cols), cfg,
                                  precision, mesh)
            device_sync(Un)
        with timer.phase("s_cpy"):
            keep = (~stopped).to(dtype)
            U[:, c:c + b] = Un * keep
            V[:, c:c + b] = Vn * keep
            B[c - b:c, c:c + b] = L.T * keep
            B[c:c + b, c:c + b] = Rn * keep
            device_sync(B)
        with timer.phase("norm"):
            capture[j] = torch.linalg.norm(B)
            device_sync(capture)
    timer.times["main_loop"] = time.perf_counter() - t_loop0
    return U, V, B, capture, dr.state


def abrik(A, k: int, cfg: ABRIKConfig, state: RNGState, tol: float = 0.0,
          precision=STABLE_PRECISION, timing: bool = False, v0=None,
          qr_sketches=None):
    """Truncated SVD via block-Krylov bidiagonalization.

    Returns ``(U, S, Vt, info, next_state)`` with the leading k singular
    triplets; ``info`` holds ``num_krylov_iters`` (the iterations run:
    with ``tol > 0`` the loop stops early on the Frobenius capture test)
    and the ``capture`` history (the reference's ``num_krylov_iters`` /
    ``singular_triplets_found`` diagnostics).

    ``timing=True`` appends the phase dict of the 13 slots the JAX
    package fills (rl_abrik.hh:734): the iteration-split synced run,
    measurement mode only, with all q iterations. ``v0`` and
    ``qr_sketches`` inject the draws (see ``abrik_factor``).
    """
    b, q = cfg.block_size, cfg.max_iters
    require(k <= q * b, f"need max_iters*block_size >= k ({q * b} < {k})")
    if timing:
        timer = PhaseTimer()
        t0 = time.perf_counter()
        Ub, Vb, B, capture, state = _abrik_factor_timed(
            A, state, cfg, precision, timer, v0, qr_sketches)
        with timer.phase("get_factors"):
            Us, S, Vst = svd_econ(B, cfg.svd_method, precision)
            U = matmul(Ub, Us[:, :k], precision)
            V = matmul(Vb, Vst.T[:, :k], precision)
            device_sync(U)
        timer.times["total"] = time.perf_counter() - t0
        info = {"num_krylov_iters": q, "capture": capture}
        return U, S[:k], V.T, info, state, timer.report()
    Ub, Vb, B, capture, iters, state = abrik_factor(
        A, state, cfg, precision, tol, v0, qr_sketches)
    # small dense SVD of the band factor (rl_abrik.hh:690-701)
    Us, S, Vst = svd_econ(B, cfg.svd_method, precision)
    U = matmul(Ub, Us[:, :k], precision)
    V = matmul(Vb, Vst.T[:, :k], precision)
    info = {"num_krylov_iters": iters, "capture": capture}
    return U, S[:k], V.T, info, state
