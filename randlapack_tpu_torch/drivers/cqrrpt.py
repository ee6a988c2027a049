"""CQRRPT — CholeskyQR with randomized pivoting for tall matrices
(counterpart of ``randlapack_tpu/drivers/cqrrpt.py``; reference:
RandLAPACK/drivers/rl_cqrrpt.hh: CQRRPTalg :21, CQRRPT::call :147;
algorithm of arXiv:2311.08316):

    1. sketch A_sk = S·A (d×n, d = d_factor·n)              [:214-222]
    2. QRCP on the small sketch                             [:230-248]
    3. rank estimate from diag(R_sk)                        [:267-272]
    4. pivot A, precondition A·R_sk⁻¹, CholQR               [:287-332]
    5. un-precondition R = R_chol·R_sk                      [:338-345]

Static shapes, as in the JAX package: the rank estimate is returned, not
used to shrink tensors; columns past it are zeroed and the Gram padded
with the identity there (Cholesky nests, so the leading rank×rank factor
is the shrunken computation's). ``qrcp=hqrrp`` runs the kernels K5/K6 on
a CUDA tensor; every other step is a PyTorch call, as the JAX package
computes them outside any Pallas kernel.

The random draws can be injected (the tests draw them with JAX): the
sketch operator (``sketch=``: a ``SparseSkOp``, an ``SRHTSkOp`` or the
dense (d, m) Gaussian S), the sketch QRCP's own sketch (``qrcp_sketch=``,
passed to BQRRP/HQRRP as their ``sketch=``) and the Gaussians of the
basis completion (``noise=``, (m, n)). An injected draw still advances
``state`` as the draw it replaces would.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..ops import util
from ..ops.cholqr import _cholesky, _finite_scaled, cholqr2, gram_syrk
from ..ops.qr import geqp3
from ..ops.trsm import trsm_right_upper_blockinv
from ..ops.util import matmul
from ..rng import RNGState
from ..sketching import (SparseDist, SparseSkOp, SRHTSkOp, fill_sparse,
                         saso_left_apply, srht_left_apply, srht_skop)
from ..utils.timing import UNTIMED, PhaseTimer, span
from .bqrrp import BQRRPConfig, _sketch_product, bqrrp
from .hqrrp import HQRRPConfig, hqrrp_lapack_format


class QRCPKind(enum.Enum):
    """QRCP subroutine for the sketch (rl_cqrrpt.hh:230-248,
    CQRRPTSubroutines::QRCP {geqp3,hqrrp,bqrrp})."""
    geqp3 = "geqp3"       # pivoted Householder on the sketch
    hqrrp = "hqrrp"       # Householder QR with randomized pivoting
    bqrrp = "bqrrp"       # blocked randomized QRCP (for larger n)


@dataclasses.dataclass(frozen=True)
class CQRRPTConfig:
    """The JAX package's configuration, field for field (see
    ``randlapack_tpu/drivers/cqrrpt.py`` for each field's story)."""
    d_factor: float = 1.25
    vec_nnz: int = 2
    sketch: str = "saso"          # "saso" | "srht" | "gaussian"
    qrcp: QRCPKind = QRCPKind.geqp3
    bqrrp_block: int = 128        # block size when qrcp == bqrrp/hqrrp
    bqrrp_stages: int = 1         # shrinking-width stages of the sketch
                                  # BQRRP
    bqrrp_pivot_candidates: int | None = None
    bqrrp_trailing_precision: str = "highest"
                                  # the sketch BQRRP's trailing-update
                                  # product (qrcp == bqrrp, passed to its
                                  # ``BQRRPConfig.trailing_precision``:
                                  # "highest"; on a CUDA f32 tensor "high"
                                  # one TF32 and "default" one bf16 product
                                  # through K2's form, as "highest" on the
                                  # CPU and in f64; "bf16_3x_emul" three
                                  # bf16 products). Its R rows are
                                  # computed at the driver's precision but
                                  # from the trailing-updated matrix, so
                                  # they carry the mode's error into the
                                  # preconditioner (a one-product mode
                                  # breaks config 3's; ROADMAP §3)
    bqrrp_update_defer: int = 1
    eps_rank: float | None = None  # rank threshold (None → machine eps)
    orthogonalization: bool = False  # complete a rank-deficient basis to
                                     # a full orthonormal Q with projected
                                     # Gaussians (rl_cqrrpt.hh:343-368)
    q_form: str = "inverse"       # "inverse": L⁻ᵀ from a small solve
                                  # against I, then ONE m×n product;
                                  # "trsm": the m×n triangular solve
    gram_block: int = 512         # > 0: the CholQR Gram by gram_syrk at
                                  # this column block; 0: one AᵀA product
    trsm_mode: str = "xla"        # "xla": one triangular solve;
                                  # "blockinv": ops/trsm.py
    trsm_block: int = 256         # diagonal-block size for blockinv


def _sketch_phase(A, cfg: CQRRPTConfig, state: RNGState, precision,
                  sketch=None):
    m, n = A.shape
    d = int(cfg.d_factor * n)
    if d >= m:
        # near-square input: A itself is the exact sketch
        return A, state
    if cfg.sketch == "saso":
        if sketch is None:
            sketch, state = fill_sparse(SparseDist(d, m, cfg.vec_nnz), state,
                                        dtype=A.dtype, device=A.device)
        else:
            require(isinstance(sketch, SparseSkOp),
                    "sketch='saso' takes a SparseSkOp")
            state = state.advance().advance()
        return saso_left_apply(sketch, A), state
    if cfg.sketch == "srht":
        if sketch is None:
            sketch, state = srht_skop(d, m, state, dtype=A.dtype,
                                      device=A.device)
        else:
            require(isinstance(sketch, SRHTSkOp),
                    "sketch='srht' takes an SRHTSkOp")
            state = state.advance().advance()
        return srht_left_apply(sketch, A, precision=precision), state
    require(cfg.sketch == "gaussian", f"unknown sketch {cfg.sketch!r}")
    return _sketch_product(A, d, state, sketch, precision), state.advance()


def _qrcp_phase(A_sk, cfg: CQRRPTConfig, state: RNGState, precision,
                qrcp_sketch=None):
    n = A_sk.shape[1]
    if cfg.qrcp == QRCPKind.geqp3:
        _, R_sk, J = geqp3(A_sk, want_q=False, precision=precision)
    elif cfg.qrcp == QRCPKind.hqrrp:
        _, _, R_sk, J, state = hqrrp_lapack_format(
            A_sk, HQRRPConfig(block_size=cfg.bqrrp_block), state, precision,
            sketch=qrcp_sketch)
        R_sk = R_sk[:n, :]
    else:
        # the EXPLICIT driver on purpose: its final-orth pass re-couples R
        # to an orthonormalized Q, and R_sk becomes the preconditioner
        _, R_sk, J, _, _, state = bqrrp(
            A_sk, BQRRPConfig(block_size=cfg.bqrrp_block,
                              stages=cfg.bqrrp_stages,
                              pivot_candidates=cfg.bqrrp_pivot_candidates,
                              update_defer=cfg.bqrrp_update_defer,
                              trailing_precision=(
                                  cfg.bqrrp_trailing_precision)),
            state, precision, sketch=qrcp_sketch)
        R_sk = R_sk[:n, :]
    return R_sk, J, state


def _rank_phase(R_sk, cfg: CQRRPTConfig):
    # the reference truncates where R[i,i]/R[0,0] < eps just to keep the
    # preconditioner invertible (rl_cqrrpt.hh:263-272); the real rank
    # comes a posteriori
    n = R_sk.shape[1]
    dt, dev = R_sk.dtype, R_sk.device
    eps = cfg.eps_rank or torch.finfo(dt).eps
    dg = torch.diagonal(R_sk)
    rank = util.naive_rank_est(dg, dg[0].abs() * eps)
    keep = (torch.arange(n, device=dev) < rank).to(dt)
    dsafe = torch.where(keep > 0, dg, 1.0)
    R_sk_safe = torch.triu(R_sk) - torch.diag(dg) + torch.diag(dsafe)
    return rank, keep, R_sk_safe


def _trsm_phase(A_piv, R_sk_safe, keep, mode="xla", block=256,
                precision=STABLE_PRECISION):
    if mode == "blockinv":
        A_pre = trsm_right_upper_blockinv(A_piv, R_sk_safe, block,
                                          precision)
    else:
        A_pre = torch.linalg.solve_triangular(R_sk_safe, A_piv, upper=True,
                                              left=False)
    return A_pre.mul_(keep[None, :])


def _trsm_phase_gather(A, J, R_sk_safe, keep, block=256,
                       precision=STABLE_PRECISION):
    # blockinv's untimed path: the pivot gather A[:, J] is folded into the
    # per-block reads, so the permuted m×n operand never materializes
    A_pre = trsm_right_upper_blockinv(A, R_sk_safe, block, precision,
                                      cols=J)
    return A_pre.mul_(keep[None, :])


def _cholqr_gram(A_pre, keep, precision, gram_block=0):
    # band guard (ops/cholqr.py::_finite_scaled): the solve against the
    # clamped R_sk diagonal can leave huge/Inf columns on deficient input
    A_pre, s, nonfin = _finite_scaled(A_pre)
    G = (gram_syrk(A_pre, precision, gram_block) if gram_block > 0
         else matmul(A_pre.T, A_pre, precision)) + torch.diag(1.0 - keep)
    return A_pre, G, s, nonfin


def _cholqr_qform(A_pre, L, q_form, precision):
    if q_form == "inverse":
        # L factors the PRECONDITIONED Gram: κ(L) is the sketch's
        # distortion, O(1), so the explicit n×n inverse loses nothing and
        # Q is one m×n product
        n = A_pre.shape[1]
        Linv_t = torch.linalg.solve_triangular(
            L.T, torch.eye(n, dtype=A_pre.dtype, device=A_pre.device),
            upper=True)
        return matmul(A_pre, Linv_t, precision)
    return torch.linalg.solve_triangular(L.T, A_pre, upper=True, left=False)


def _cholqr_steps(A_pre, keep, R_sk_safe, q_form, precision, gram_block,
                  timer: PhaseTimer):
    with timer.phase("cholqr_gram"):
        A_pre, G, s, nonfin = _cholqr_gram(A_pre, keep, precision,
                                           gram_block)
    with timer.phase("cholqr_potrf"):
        L = _cholesky(G)
    with timer.phase("cholqr_qform"):
        Q = _cholqr_qform(A_pre, L, q_form, precision)
    with timer.phase("cholqr_unprec"):
        R = matmul(L.T * s, R_sk_safe, precision)
        fail = torch.isnan(L).any() | nonfin
    return Q, R, fail


def _cholqr_phase(A_pre, keep, R_sk_safe, q_form, precision, gram_block=0):
    """The untimed CholQR phase: its four steps, each a span."""
    return _cholqr_steps(A_pre, keep, R_sk_safe, q_form, precision,
                         gram_block, UNTIMED)


def _orth_phase(Q, keep, state: RNGState, fail, precision, noise=None):
    # basis completion (rl_cqrrpt.hh:343-368): the zeroed trailing columns
    # become Gaussians projected against the leading rank columns and
    # orthonormalized by CholQR2 (all n candidates completed, rank-masked)
    if noise is None:
        gen, _ = state.spawn(Q.device)
        noise = torch.randn(Q.shape, generator=gen, dtype=Q.dtype,
                            device=Q.device)
    require(tuple(noise.shape) == tuple(Q.shape),
            f"noise must be {tuple(Q.shape)}, got {tuple(noise.shape)}")
    G_rand = noise.to(device=Q.device, dtype=Q.dtype)
    Qk = Q * keep[None, :]
    for _ in range(2):  # two projection passes (BCGS2)
        G_rand = G_rand - matmul(Qk, matmul(Qk.T, G_rand, precision),
                                 precision)
    Qc, _, f2 = cholqr2(G_rand, precision)
    return torch.where(keep[None, :] > 0, Q, Qc), fail | f2


def cqrrpt(A: torch.Tensor, cfg: CQRRPTConfig, state: RNGState,
           precision=STABLE_PRECISION, timing: bool = False, sketch=None,
           qrcp_sketch: torch.Tensor | None = None,
           noise: torch.Tensor | None = None):
    """Pivoted QR of tall A: A[:, J] ≈ Q R.

    Returns ``(Q, R, J, rank, fail, next_state)``: Q (m, n) orthonormal,
    R (n, n) upper-triangular, J (n,) int64 pivots, ``rank`` the estimated
    numerical rank (int32 0-d tensor; columns of Q and rows of R past it
    are garbage, as in the reference's truncated outputs), ``fail`` the
    CholQR breakdown flag. ``timing=True`` appends the phase dict (``saso``,
    ``qrcp``, ``rank_reveal``, ``a_mod_piv``, ``a_mod_trsm``, ``cholqr``
    with its sub-slots ``cholqr_gram``, ``cholqr_potrf``, ``cholqr_qform``,
    ``cholqr_unprec``, and ``orth``), with a device sync between phases;
    with ``trsm_mode="blockinv"`` the timed path gathers A[:, J] as its own
    phase where the untimed one folds the gather into the solve. The call
    is the span ``cqrrpt`` and each phase a span inside it, timed or not
    (``utils.timing.span``; the untimed blockinv solve is ``a_mod_trsm``).
    ``sketch``, ``qrcp_sketch`` and ``noise`` inject the random draws
    (module docstring). ``precision`` sets the products the JAX package
    runs at the driver's precision (``ops.util.matmul``).
    """
    require(A.shape[0] >= A.shape[1],
            "cqrrpt requires a tall input (m >= n, the reference's CQRRPT "
            f"contract, rl_cqrrpt.hh) — got {tuple(A.shape)}; use "
            "hqrrp/bqrrp for wide matrices")
    with span("cqrrpt", A.device):
        return _cqrrpt_body(A, cfg, state, precision, timing, sketch,
                            qrcp_sketch, noise)


def _cqrrpt_body(A, cfg, state, precision, timing, sketch, qrcp_sketch,
                 noise):
    require_fp32_matmul()
    precision = resolve_precision(precision)
    timer = PhaseTimer() if timing else UNTIMED

    with timer.phase("saso"):
        A_sk, state = _sketch_phase(A, cfg, state, precision, sketch)
    with timer.phase("qrcp"):
        R_sk, J, state = _qrcp_phase(A_sk, cfg, state, precision,
                                     qrcp_sketch)
    with timer.phase("rank_reveal"):
        rank, keep, R_sk_safe = _rank_phase(R_sk, cfg)
    if cfg.trsm_mode == "blockinv" and not timing:
        with span("a_mod_trsm"):
            A_pre = _trsm_phase_gather(A, J, R_sk_safe, keep,
                                       cfg.trsm_block, precision)
    else:
        with timer.phase("a_mod_piv"):
            A_piv = util.col_swap(A, J)
        with timer.phase("a_mod_trsm"):
            A_pre = _trsm_phase(A_piv, R_sk_safe, keep, cfg.trsm_mode,
                                cfg.trsm_block, precision)
            del A_piv
    with timer.phase("cholqr"):
        if timing:
            Q, R, fail = _cholqr_steps(A_pre, keep, R_sk_safe, cfg.q_form,
                                       precision, cfg.gram_block, timer)
        else:
            Q, R, fail = _cholqr_phase(A_pre, keep, R_sk_safe, cfg.q_form,
                                       precision, cfg.gram_block)
    del A_pre
    if cfg.orthogonalization:
        with timer.phase("orth"):
            Q, fail = _orth_phase(Q, keep, state, fail, precision, noise)
            state = state.advance()
    if timing:
        return Q, R, J, rank, fail, state, timer.report()
    return Q, R, J, rank, fail, state
