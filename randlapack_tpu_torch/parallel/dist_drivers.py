"""Distributed drivers over row shards (counterpart of
``randlapack_tpu/parallel/dist_drivers.py``): the tall-matrix pipelines
with the tall dimension split over a mesh, each JAX body followed line
for line. Where XLA's partitioner inserts a collective under
``with_sharding_constraint``, the port writes it out: a psum for every
m-contraction (sketch, Gram, Aᵀ·X), a gather (a psum of the shard placed
in zeros) where a row-sharded value is needed whole. The small d×n / n×n
work (the sketch's QR or QRCP, Cholesky, SVD) runs on every rank.

Every function takes this rank's rows of the tall operand and returns Q,
U, V as this rank's rows, and R, J, S, B, λ, x and the flags replicated
(bit-equal on every rank, so every host branch goes the same way).

Random draws: the JAX functions draw with ``jax.random`` from
``state.spawn()``; the port cannot reproduce threefry, so each takes the
draw injected after the JAX parameters (``sketch=``: this rank's (d, m/p)
column block of S or G; ``omega=``, ``v0=``, ``qr_sketches=``; ``noise=``
for RPCholesky), and an injected draw still advances ``state``. An undrawn
S of the tall drivers is the counter-based Philox operator of
``ops.kernels.gaussian_sketch_matrix`` of the state's seed, each rank
generating only its own columns; the BQRRP sketches, HQRRP's G and
ABRIK's m-side sketches are drawn whole on every rank, as the unsharded
driver draws them, and sliced. Neither depends on the world size. The
small replicated draws come from ``state.spawn`` on the rank's device.
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from ..ops import util
from ..ops.cholqr import _cholesky, _finite_scaled, _gram, _solve_rt
from ..ops.kernels import gaussian_sketch_matrix
from ..ops.qr import geqp3, qr_econ
from ..ops.svd import svd_econ
from ..ops.util import matmul
from ..rng import RNGState, _derive
from .distributed import dist_rangefinder_step
from .mesh import Mesh, check_axis, global_rows, set_mesh


def _sketch_cols(d: int, A: torch.Tensor, mesh: Mesh, state: RNGState,
                 sketch):
    """This rank's (d, m_local) column block of the (d, m) Gaussian sketch
    S ~ N(0, 1/d): the injected block, or the state's Philox operator's
    columns. Returns ``(S_local, next_state)``."""
    ml = A.shape[0]
    if sketch is None:
        sketch = gaussian_sketch_matrix(
            d, ml, _derive(state.key, state.counter), A.dtype, A.device,
            col0=mesh.rows(ml)[0])
    require(isinstance(sketch, torch.Tensor)
            and tuple(sketch.shape) == (d, ml),
            f"sketch must be this rank's {(d, ml)} column block of S")
    return sketch.to(device=A.device, dtype=A.dtype), state.advance()


def _normal(shape, A: torch.Tensor, state: RNGState, given, name: str):
    """A replicated standard-normal draw: ``given``, or drawn from
    ``state`` on A's device. Returns ``(draw, next_state)``."""
    if given is None:
        gen, _ = state.spawn(A.device)
        given = torch.randn(shape, generator=gen, dtype=A.dtype,
                            device=A.device)
    require(isinstance(given, torch.Tensor)
            and tuple(given.shape) == tuple(shape),
            f"{name} must be a {tuple(shape)} tensor")
    return given.to(device=A.device, dtype=A.dtype), state.advance()


def _safe_eye(bad, L):
    return torch.where(bad, torch.eye(L.shape[0], dtype=L.dtype,
                                      device=L.device), L)


def dist_cqrrpt(A: torch.Tensor, mesh: Mesh, state: RNGState,
                d_factor: float = 1.25, axis: str = "rows",
                precision=STABLE_PRECISION, sketch=None):
    """Pivoted QR of a row-sharded tall A: A[:, J] ≈ Q R with Q this
    rank's rows and R/J replicated (Gaussian sketch; the sketch's columns
    shard with A's rows, so the d×n sketch is one psum).

    Returns ``(Q, R, J, rank, fail, next_state)``."""
    check_axis(mesh, axis)
    precision = resolve_precision(precision)
    m, n = global_rows(A.shape[0], mesh, "dist_cqrrpt"), A.shape[1]
    require(m >= n, "dist_cqrrpt requires a tall input (m >= n) — got "
            f"{(m, n)}")
    d = int(d_factor * n)
    dtype = A.dtype
    S, state = _sketch_cols(d, A, mesh, state, sketch)

    # sketch: column-sharded S against row-sharded A → replicated d×n
    A_sk = mesh.psum(matmul(S, A, precision))
    # QRCP of the small sketch on every rank; rank 0's pivots
    _, R_sk, J = geqp3(A_sk, want_q=False, precision=precision)
    J = mesh.broadcast(J.contiguous())
    R_sk = mesh.broadcast(R_sk.contiguous())
    eps = torch.finfo(dtype).eps
    diag = torch.diagonal(R_sk).abs()
    rank = util.naive_rank_est(torch.diagonal(R_sk), diag[0] * eps)
    keep = (torch.arange(n, device=A.device) < rank).to(dtype)
    dsafe = torch.where(keep > 0, torch.diagonal(R_sk),
                        torch.ones((), dtype=dtype, device=A.device))
    R_sk_safe = (torch.triu(R_sk) - torch.diag(torch.diagonal(R_sk))
                 + torch.diag(dsafe))
    # pivot + precondition: row-local ops on the shard
    A_piv = A.index_select(1, J)
    A_pre = torch.linalg.solve_triangular(
        R_sk_safe, A_piv, upper=True, left=False) * keep[None, :]
    # band guard: the global max (one pmax), sized by the global shape
    A_pre, s, nonfin = _finite_scaled(A_pre, mesh, m)
    G = _gram(A_pre, precision, mesh) + torch.diag(1.0 - keep)
    L = _cholesky(G)
    fail = torch.isnan(L).any() | nonfin
    Q = _solve_rt(A_pre, L.T)
    R = matmul(L.T * s, R_sk_safe, precision)
    return Q, R, J, rank, fail, state


def dist_rsvd(A: torch.Tensor, k: int, mesh: Mesh, state: RNGState,
              power_iters: int = 2, axis: str = "rows",
              precision=STABLE_PRECISION, omega=None):
    """Fixed-rank randomized SVD of a row-sharded A: one sharded
    rangefinder cycle per power iteration (distributed CholQR2), then a
    replicated small SVD. ``omega`` injects the (n, k) start. Returns
    ``(U, S, Vt, fail, next_state)`` with U this rank's rows; ``fail`` ORs
    the CholQR breakdown flags of every step."""
    check_axis(mesh, axis)
    precision = resolve_precision(precision)
    global_rows(A.shape[0], mesh, "dist_rsvd")
    n = A.shape[1]
    Omega, state = _normal((n, k), A, state, omega, "omega")
    Q = B = None
    fail = torch.zeros((), dtype=torch.bool, device=A.device)
    for _ in range(max(power_iters, 1)):
        Q, B, Omega, step_fail = dist_rangefinder_step(A, Omega, mesh, axis,
                                                       precision)
        fail = fail | step_fail
    Ub, S, Vt = svd_econ(B, precision=precision)
    return matmul(Q, Ub, precision), S, Vt, fail, state


def dist_bqrrp(A: torch.Tensor, mesh: Mesh, state: RNGState,
               block_size: int = 256, stages: int = 1, axis: str = "rows",
               precision=STABLE_PRECISION, sketch=None):
    """Distributed explicit BQRRP (``drivers.bqrrp``'s row-sharded mode):
    panel Grams, the BCGS2 projections and the trailing projections
    psummed, the trailing updates row-local, pivots on the replicated
    sketch. ``sketch`` injects this rank's (d, m/p) column block of the
    sketch (d = 1.25·b); an undrawn sketch is the unsharded driver's,
    sliced. Returns ``(Q, R, J, rank, fail, next_state)`` with Q this
    rank's rows."""
    from ..drivers.bqrrp import BQRRPConfig, bqrrp
    check_axis(mesh, axis)
    cfg = BQRRPConfig(block_size=block_size, stages=stages,
                      shard_axis=axis)
    with set_mesh(mesh):
        return bqrrp(A, cfg, state, precision, sketch=sketch)


def dist_bqrrp_factored(A: torch.Tensor, mesh: Mesh, state: RNGState,
                        block_size: int = 256, stages: int = 1,
                        axis: str = "rows", precision=STABLE_PRECISION,
                        sketch=None):
    """Distributed factored (implicit-Q) BQRRP: the WY engine with the
    tall dimension row-sharded (``drivers.bqrrp_factored``'s row-sharded
    mode): K1 and K2 on each rank's rows, K3 on the replicated b×b block,
    pivots on the replicated sketch. ``sketch`` injects this rank's
    (d, m/p) column block of the sketch (d = 1.25·b); an undrawn sketch is
    the unsharded driver's, sliced, so one rank reproduces it. Returns
    ``(BQRRPFactors, next_state)`` with V this rank's rows; materialize
    with ``drivers.bqrrp_q(fac, mesh=mesh)``."""
    from ..drivers.bqrrp import BQRRPConfig, bqrrp_factored
    check_axis(mesh, axis)
    cfg = BQRRPConfig(block_size=block_size, stages=stages,
                      shard_axis=axis)
    with set_mesh(mesh):
        return bqrrp_factored(A, cfg, state, precision, sketch=sketch)


def dist_hqrrp(A: torch.Tensor, mesh: Mesh, state: RNGState,
               block_size: int = 64, axis: str = "rows",
               precision=STABLE_PRECISION, sketch=None):
    """Distributed HQRRP (``drivers.hqrrp``'s row-sharded mode): the
    sketch QRCP (K5) on the replicated sketch, each Householder panel (K6)
    on the panel gathered whole, the WY trailing updates row-local with
    their Vᵀ·A psummed, the uniform operator G column-sharded along m.
    ``sketch`` injects this rank's (d, m/p) column block of G (d = b +
    10); an undrawn G is drawn whole on every rank and sliced. Returns
    ``(Q, R, J, rank, fail, next_state)`` with Q this rank's rows."""
    from ..drivers.hqrrp import HQRRPConfig, hqrrp
    check_axis(mesh, axis)
    cfg = HQRRPConfig(block_size=block_size, shard_axis=axis)
    with set_mesh(mesh):
        return hqrrp(A, cfg, state, precision, sketch=sketch)


def dist_abrik(A: torch.Tensor, k: int, mesh: Mesh, state: RNGState,
               block_size: int = 32, max_iters: int = 10,
               axis: str = "rows", precision=STABLE_PRECISION, v0=None,
               qr_sketches=None):
    """Distributed ABRIK (``drivers.abrik``'s row-sharded mode, its inner
    tall QRs through CQRRT on the shards): A·V row-local, Aᵀ·U and the
    inner Grams psummed, the n-side work replicated. ``v0`` injects the
    (n, b) start and ``qr_sketches`` the 2q unscaled sketches: the m-side
    ones (i = 0 and every odd i) as this rank's column block, the n-side
    ones (every even i from 2) whole, entry 1 unused. Returns ``(U, S,
    Vt, info, next_state)`` with U this rank's rows."""
    from ..drivers.abrik import ABRIKConfig, abrik
    check_axis(mesh, axis)
    cfg = ABRIKConfig(block_size=block_size, max_iters=max_iters,
                      qr_explicit="cqrrt", shard_axis=axis)
    with set_mesh(mesh):
        return abrik(A, k, cfg, state, precision=precision, v0=v0,
                     qr_sketches=qr_sketches)


def dist_spls(A: torch.Tensor, b: torch.Tensor, mu, mesh: Mesh,
              state: RNGState, d_factor: float = 4.0, tol: float = 1e-8,
              max_iters: int = 200, axis: str = "rows",
              precision=STABLE_PRECISION, sketch=None):
    """Distributed sketch-and-precondition least squares: solve
    min ‖Ax−b‖² + μ‖x‖² with A and b row-sharded (b this rank's rows, one
    or several columns). A column-sharded Gaussian sketch contracts the
    shards into one replicated d×n sketch (one psum), the SVD
    preconditioner and its CholQR refinement run on every rank, and each
    PCG iteration's Aᵀ(A·v) is a row-local product and one psum.

    Returns ``(x, res_hist, iters, next_state)`` with x replicated."""
    from ..comps.determiter import PCGSaddleConfig, pcg_saddle_normal
    from ..comps.preconditioners import make_right_orthogonalizer
    check_axis(mesh, axis)
    precision = resolve_precision(precision)
    m, n = global_rows(A.shape[0], mesh, "dist_spls"), A.shape[1]
    require(b.shape[0] == A.shape[0], "b must be this rank's rows of b")
    d = min(int(d_factor * n), m)
    dtype = A.dtype
    S, state = _sketch_cols(d, A, mesh, state, sketch)

    A_sk = mesh.psum(matmul(S, A, precision))
    _, sigma, Vt = svd_econ(A_sk, precision=precision)
    M, _ = make_right_orthogonalizer(Vt.T, sigma, mu)
    # one CholQR refinement pass in sketch space
    AskM = matmul(A_sk, M, precision)
    G = matmul(AskM.T, AskM, precision)
    G = G + mu * matmul(M.T, M, precision)
    keep = torch.diagonal(G) > 0
    G = G + torch.diag(torch.where(keep, 0.0, 1.0).to(dtype))
    L = _cholesky(0.5 * (G + G.T))
    M = _solve_rt(M, _safe_eye(torch.isnan(L).any(), L).T)
    b2 = b[:, None] if b.dim() == 1 else b

    def normal(x):
        return mesh.psum(matmul(A.T, matmul(A, x, precision), precision))

    rhs = mesh.psum(matmul(A.T, b2, precision))
    x0 = torch.zeros((n,) + tuple(b2.shape[1:]), dtype=dtype,
                     device=A.device)
    x, hist, iters = pcg_saddle_normal(
        normal, rhs - torch.zeros_like(x0), mu, M, x0,
        PCGSaddleConfig(tol=tol, max_iters=max_iters), precision)
    if b.dim() == 1:
        x = x[:, 0]
    return x, hist, iters, state


def dist_cqrrt(A: torch.Tensor, mesh: Mesh, state: RNGState,
               d_factor: float = 1.25, axis: str = "rows",
               precision=STABLE_PRECISION, sketch=None):
    """Unpivoted sketch-preconditioned QR of a row-sharded tall A: one
    psum gives the replicated d×n sketch, its Householder QR runs on every
    rank, the preconditioning solve is row-local and the CholQR Gram is
    the second psum.

    Returns ``(Q, R, fail, next_state)`` with Q this rank's rows, R
    replicated."""
    check_axis(mesh, axis)
    precision = resolve_precision(precision)
    m, n = global_rows(A.shape[0], mesh, "dist_cqrrt"), A.shape[1]
    require(m >= n, "dist_cqrrt requires a tall input (m >= n) — got "
            f"{(m, n)}")
    d = min(int(d_factor * n), m)
    dtype = A.dtype
    S, state = _sketch_cols(d, A, mesh, state, sketch)

    A_sk = mesh.psum(matmul(S, A, precision))
    _, R_sk = qr_econ(A_sk)
    # eps-relative diagonal floor, as cqrrt's sketch QR
    d_sk = torch.diagonal(R_sk)
    mx_d = d_sk.abs().max()
    ref_d = torch.where(mx_d > 0.0, mx_d * torch.finfo(dtype).eps,
                        torch.ones((), dtype=dtype, device=A.device))
    dsafe = torch.where(d_sk.abs() > ref_d, d_sk, ref_d)
    R_sk = torch.triu(R_sk) - torch.diag(d_sk) + torch.diag(dsafe)
    A_pre = _solve_rt(A, R_sk)
    A_pre, s, nonfin = _finite_scaled(A_pre, mesh, m)
    L = _cholesky(_gram(A_pre, precision, mesh))
    fail = torch.isnan(L).any() | nonfin
    L_safe = _safe_eye(fail, L)
    Q = _solve_rt(A_pre, L_safe.T)
    R = matmul(L_safe.T * s, R_sk, precision)
    return Q, R, fail, state


def dist_revd2(A: torch.Tensor, k: int, mesh: Mesh, state: RNGState,
               power_iters: int = 2, error_est_passes: int = 10,
               axis: str = "rows", precision=STABLE_PRECISION, omega=None,
               v0=None):
    """Distributed rank-k Nyström EVD of a row-sharded PSD A (n×n, this
    rank's n/p rows). Every A·X is row-local on the gathered X; each
    rangefinder orthogonalization and the Nyström Gram QᵀY cost one k×k
    psum; the small-factor algebra (ν shift, Cholesky, Gram-SVD
    de-regularization) runs on every rank, and the power error estimate
    gathers its vector every pass. ``omega`` (n, k) and ``v0`` (n, 1)
    inject the draws.

    Returns ``(V, lam, err_est, nu, fail, next_state)`` with V this rank's
    rows."""
    check_axis(mesh, axis)
    precision = resolve_precision(precision)
    n = global_rows(A.shape[0], mesh, "dist_revd2")
    require(A.shape[1] == n, f"A must be square, got {n} rows and "
            f"{A.shape[1]} columns")
    dtype = A.dtype
    r0, r1 = mesh.rows(A.shape[0])
    Omega, state = _normal((n, k), A, state, omega, "omega")
    v0, state = _normal((n, 1), A, state, v0, "v0")

    fail = torch.zeros((), dtype=torch.bool, device=A.device)
    X = Omega
    for it in range(max(power_iters, 1)):
        Y = matmul(A, X if it == 0 else mesh.gather_rows(X), precision)
        L = _cholesky(_gram(Y, precision, mesh))
        step_fail = torch.isnan(L).any()
        X = _solve_rt(Y, _safe_eye(step_fail, L).T)
        # second Gram pass (CholQR2 stability default)
        L2 = _cholesky(_gram(X, precision, mesh))
        step_fail = step_fail | torch.isnan(L2).any()
        X = _solve_rt(X, _safe_eye(step_fail, L2).T)
        fail = fail | step_fail
    Q = X
    Y = matmul(A, mesh.gather_rows(Q), precision)
    eps = torch.finfo(dtype).eps
    sqrt_n = torch.sqrt(torch.tensor(float(n), dtype=dtype, device=A.device))
    nu = sqrt_n * eps * torch.sqrt(mesh.psum(torch.sum(Y * Y)))
    Y = Y + nu * Q
    C = _cholesky(mesh.psum(matmul(Q.T, Y, precision)))
    badc = torch.isnan(C).any()
    fail = fail | badc
    B = torch.linalg.solve_triangular(_safe_eye(badc, C).T, Y, upper=True,
                                      left=False)
    # Gram-SVD of the sharded tall B: BᵀB is one psum, the basis rotation
    # stays row-local
    GB = _gram(B, precision, mesh)
    lam_g, W = torch.linalg.eigh(0.5 * (GB + GB.T))
    lam_g, W = lam_g.flip(0), W.flip(1)
    s = torch.sqrt(torch.clamp(lam_g, min=0.0))
    s_safe = torch.clamp(s, min=torch.finfo(dtype).tiny)
    V = matmul(B, W / s_safe[None, :], precision)
    lam = torch.clamp(s * s - nu, min=0.0)
    # power error estimate; w gathered to every rank each pass
    v = v0 / torch.linalg.norm(v0)
    err = torch.zeros((), dtype=dtype, device=A.device)
    tiny = torch.finfo(dtype).tiny
    for _ in range(error_est_passes):
        Vtv = mesh.psum(matmul(V.T, v[r0:r1], precision))
        w = mesh.gather_rows(matmul(A, v, precision) - matmul(
            V, lam[:, None] * Vtv, precision))
        err = torch.linalg.norm(w)
        v = w / torch.clamp(err, min=tiny)
    return V, lam, err, nu, fail, state


class DistSquaredExpKernelLinOp:
    """Squared-exponential kernel operator whose matvec is sharded over row
    blocks of the (never stored) kernel matrix: each rank evaluates
    k(X_local, X)·V for its n/p points (an (n/p)×n slab, plain PyTorch:
    K4 takes only the square K(X, X)·V, and the JAX package computes this
    outside Pallas too), and the rows are gathered, so ``matmat`` returns
    the whole n×s product on every rank (what PCG reads). Column and
    diagonal access (RPCholesky's) is the replicated base operator's.
    X (d, n) and V are replicated; n must be a multiple of the mesh size.
    """

    def __init__(self, X: torch.Tensor, bandwidth, mus, mesh: Mesh,
                 axis: str = "rows", evals_include_reg: bool = True,
                 block: int = 2048):
        from ..pdkernels import SquaredExpKernelLinOp
        check_axis(mesh, axis)
        self._base = SquaredExpKernelLinOp(X, bandwidth, mus,
                                           evals_include_reg, block)
        self.mesh = mesh
        self.axis = axis

    def with_reg(self, flag: bool):
        new = object.__new__(DistSquaredExpKernelLinOp)
        new._base = self._base.with_reg(flag)
        new.mesh, new.axis = self.mesh, self.axis
        return new

    @property
    def dim(self):
        return self._base.dim

    n_rows = n_cols = dim

    @property
    def num_ops(self):
        return self._base.num_ops

    @property
    def dtype(self):
        return self._base.dtype

    @property
    def device(self):
        return self._base.device

    @property
    def X(self):
        return self._base.X

    def diagonal(self):
        return self._base.diagonal()

    def columns(self, idx):
        return self._base.columns(idx)

    def matmat(self, V: torch.Tensor, precision=STABLE_PRECISION):
        from ..pdkernels import squared_exp_kernel
        precision = resolve_precision(precision)
        base = self._base
        n, p = base.dim, self.mesh.size
        require(n % p == 0, f"{n} points do not split over {p} ranks")
        r0, r1 = self.mesh.rows(n // p)
        # rows of K for this rank's points, against all points
        Kl = squared_exp_kernel(base.X[:, r0:r1], base.X, base.bandwidth,
                                precision)
        out = matmul(Kl, V, precision)
        if base.evals_include_reg:
            if base.num_ops == 1:
                out = out + base.mus[0] * V[r0:r1]
            else:
                out = out + V[r0:r1] * base.mus[None, :]
        return self.mesh.gather_rows(out)

    tmatmat = matmat

    def fro_nrm(self):
        raise NotImplementedError("implicit kernel operator")


def dist_krill(X: torch.Tensor, bandwidth, mu, H: torch.Tensor, mesh: Mesh,
               state: RNGState, k: int = 256, rpchol_block: int = 64,
               tol: float = 1e-5, max_iters: int = 100, axis: str = "rows",
               precision=STABLE_PRECISION, noise=None):
    """Distributed KRILL: kernel ridge regression whose PCG matvecs run the
    sharded kernel row blocks of :class:`DistSquaredExpKernelLinOp`, with
    the RPCholesky preconditioner built on every rank (``noise`` injects
    its draws). Returns ``(X, res_hist, iters, next_state)`` with the
    solution replicated."""
    from ..comps.determiter import PCGConfig
    from ..drivers.krill import KrillConfig, krill_full_rpchol
    G = DistSquaredExpKernelLinOp(X, bandwidth, mu, mesh, axis)
    cfg = KrillConfig(k=k, rpchol_block=rpchol_block,
                      pcg=PCGConfig(tol=tol, max_iters=max_iters))
    return krill_full_rpchol(G, H, mu, cfg, state, precision, noise=noise)
