"""BQRRP — blocked randomized QR with column pivoting (counterpart of
``randlapack_tpu/drivers/bqrrp.py``; reference: RandLAPACK/drivers/
rl_bqrrp.hh BQRRP::call :155), in both of the JAX package's forms.

Per block: LU pivots on a one-time sketch (``luqr``), a sketch-
preconditioned CholQR panel, a trailing update and an exact sketch
downdate (rl_bqrrp.hh:630-650). Retirement is mask-based inside a stage
and ONE permutation per stage moves the pivots to the window front, so
``stages > 1`` shrinks the trailing window; ``update_defer = g`` applies
the trailing update once per g blocks as one k = g·b product.

* ``bqrrp`` — the explicit form: Q = [Q₁ | Q₂ | …] accumulated directly
  (panels re-projected against the filled basis, BCGS2), the trailing
  update A ← A − Q_panel·(Q_panelᵀA ⊙ live) as plain products (the JAX
  package computes it in ``jnp``, outside any Pallas kernel; a
  ``trailing_precision`` other than "highest" sends its A −= Q·T through
  K2's form on the card), and a final CholQR pass on the finished Q.
  CQRRPT's sketch QRCP runs this form.
* ``bqrrp_factored`` — the factored (block-WY, implicit-Q) form: the
  LAPACK ``orhr_col`` Householder reconstruction and the masked WY
  trailing update through the kernels K1–K3.

The JAX package's ``lax.cond`` rescues become Python ``if``s on a device
bool (one host sync per block on the healthy path); ``fori_loop``s become
Python loops. The trailing window is updated in place, on a copy of the
caller's matrix.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
import typing

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..ops import util
from ..ops.cholqr import (_cholesky, _finite_scaled, _pow2, cholqr,
                          preconditioned_cholqr, shifted_cholqr3)
from ..ops.householder import orhr_col
from ..ops.qr import lu_pivot_columns, qr_econ, qr_econ_rows
from ..ops.util import matmul
from ..ops.wy import (a_minus_vz_masked_mixed, masked_vt_a_mixed,
                      trailing_form)
from ..rng import RNGState
from ..utils.timing import PhaseTimer, device_sync


class QRTall(enum.Enum):
    cholqr = "cholqr"     # sketch-preconditioned CholQR (default)
    hqr = "hqr"           # Householder panel QR (more robust, slower)


@dataclasses.dataclass(frozen=True)
class BQRRPConfig:
    """The JAX package's configuration, field for field (see
    ``randlapack_tpu/drivers/bqrrp.py`` for each field's story)."""
    block_size: int = 256
    d_factor: float = 1.25        # sketch rows d = d_factor * block_size
    qr_tall: QRTall = QRTall.cholqr
    panel_reorth: bool = True     # second CholQR pass on each panel
    block_reorth: bool = True     # explicit form only
    final_orth: int = 1           # explicit form only
    stages: int = 1               # shrinking-width stages
    shard_axis: str | None = None # row-sharded mode over the mesh of this
                                  # axis set by ``parallel.set_mesh``: A is
                                  # the rank's rows, Q (explicit) or V
                                  # (factored) comes back so, R/T/J
                                  # replicated
    pivot_candidates: int | None = None
                                  # preselect this many × block_size
                                  # top-norm sketch columns before the LU
                                  # pivot pass; None = full-width LU
    pallas_trailing: str = "auto" # TPU kernel routing: only "auto" is
                                  # ported (CUDA tensors always take the
                                  # kernels)
    sketch_r: str = "auto"        # panel preconditioner from the sketch:
                                  # "gram", "qr", "auto" = gram for b ≤ 512
    trailing_precision: str = "highest"
                                  # the trailing-update products (factored:
                                  # W = Vᵀ·A and the group-end A −= V·Z;
                                  # explicit: A −= Q·T only), as
                                  # ``ops.wy.trailing_form`` maps it:
                                  # "highest" fp32/f64; on a CUDA f32 tensor
                                  # "high" one TF32 product, "default" one
                                  # bf16 product, on the CPU and in f64 both
                                  # as "highest" (XLA's CPU dot ignores the
                                  # precision, its f64 dot is f64);
                                  # "bf16_3x_emul" (and any other string)
                                  # three bf16 products of bf16 hi/lo halves
                                  # (``ops.wy.bf16_3x_matmul``) everywhere.
                                  # Panel math, R, T and the sketch
                                  # downdate run at the driver's precision,
                                  # on the trailing-updated matrix
    update_defer: int = 1         # blocks per aggregated trailing update


class BQRRPFactors(typing.NamedTuple):
    """Implicit factored output of :func:`bqrrp_factored`: A[:, J] = Q·R
    with Q = H₁·…·H_nb, Hᵢ = I − Vᵢ·Tᵢ·Vᵢᵀ (T a general b×b matrix per
    block). Consume it with :func:`bqrrp_q` / :func:`bqrrp_apply_qt`."""
    V: torch.Tensor        # (m, K) block reflector basis, block i in
                           # cols i·b:(i+1)·b, zeros above row i·b
    T: torch.Tensor        # (nb, b, b) per-block WY factors
    R: torch.Tensor        # (K, n) upper-trapezoidal
    J: torch.Tensor        # (n,) int64 pivots
    rank: torch.Tensor     # int32 upper-bound rank estimate
    fail: torch.Tensor     # bool — CholQR breakdown along the way


def _check_cfg(cfg: BQRRPConfig):
    """Refuse what the port does not take; return the mesh that
    ``cfg.shard_axis`` names (None when it is None)."""
    if cfg.pallas_trailing != "auto":
        raise NotImplementedError(
            f"pallas_trailing={cfg.pallas_trailing!r} routes TPU kernels; "
            "only the default 'auto' is accepted")
    if cfg.shard_axis is None:
        return None
    from ..parallel.mesh import current_mesh
    return current_mesh(cfg.shard_axis)


def _select_pivots(Y_m, b, cfg: BQRRPConfig):
    """The per-block qrcp_wide pivot pass: LU partial pivoting on the
    masked sketch (rl_bqrrp.hh luqr), optionally restricted to top-norm
    candidate columns. Returns (b,) int64 column indices."""
    n = Y_m.shape[1]
    Y_m = torch.where(torch.isfinite(Y_m), Y_m,
                      torch.zeros((), dtype=Y_m.dtype, device=Y_m.device))
    if cfg.pivot_candidates is not None:
        n_cand = min(n, cfg.pivot_candidates * b)
        norms2 = (Y_m * Y_m).sum(0)
        # stable descending sort: equal norms keep the lower index first,
        # the order jax.lax.top_k gives (torch.topk does not)
        cand = torch.sort(norms2, descending=True, stable=True).indices
        cand = cand[:n_cand]
        perm_sub = lu_pivot_columns(Y_m.index_select(1, cand).T)
        return cand.index_select(0, perm_sub[:b])
    return lu_pivot_columns(Y_m.T)[:b]


def _fix_pivots(chosen, retired):
    """Make an LU-derived pivot block valid: b distinct, un-retired
    columns. Invalid slots (retired or duplicate picks, e.g. past the
    numerical rank) are remapped to the lowest-index unchosen live columns
    (rl_bqrrp.hh:373-399). Computed without a branch: on a healthy block
    every slot is valid and the result is ``chosen`` itself, as in the
    JAX package's ``lax.cond``."""
    b = chosen.shape[0]
    n = retired.shape[0]
    dev = chosen.device
    live_mask = retired < 0.5
    slots = torch.arange(b, device=dev)
    first_pos = torch.full((n,), b, device=dev).scatter_reduce(
        0, chosen, slots, "amin")
    valid = live_mask[chosen] & (first_pos[chosen] == slots)
    taken = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(valid, chosen, n), True)
    avail = live_mask & ~taken[:n]
    cols = torch.arange(n, device=dev)
    ord_ = torch.argsort(torch.where(avail, cols, n + cols), stable=True)
    slot_rank = (torch.cumsum(~valid, 0) - 1).clamp(min=0)
    return torch.where(valid, chosen, ord_[slot_rank])


def _sanitize_sketch(Y, fail):
    """Keep the downdated sketch finite and boundedly scaled: non-finite
    entries → 0 with ``fail`` raised, and a GLOBAL exact power-of-two
    rescale back to max|Y| ≲ 2^26. Pivot selection and the sketch
    preconditioner are invariant under a global scale, so both are exact
    no-ops on healthy data (scale == 1.0, bitwise pass-through)."""
    finite = torch.isfinite(Y)
    bad = ~finite.all()
    Y = torch.where(finite, Y, torch.zeros((), dtype=Y.dtype,
                                           device=Y.device))
    mx = Y.abs().max()
    k = torch.ceil(torch.log2(torch.where(mx > 0, mx, 1.0))).to(torch.int32)
    scale = torch.where(mx > 2.0**26, _pow2(k - 26, Y.dtype),
                        torch.ones((), dtype=Y.dtype, device=Y.device))
    return Y / scale, fail | bad


def _safe_triu_diag(R):
    """Replace (near-)zero diagonal entries by a purely relative floor
    max|diag|·eps (1 for a zero matrix) so triangular solves stay
    finite."""
    eps = torch.finfo(R.dtype).eps
    d = torch.diagonal(R)
    mx = d.abs().max()
    ref = torch.where(mx > 0.0, mx * eps, 1.0)
    dsafe = torch.where(d.abs() > ref, d, ref)
    return R - torch.diag(d) + torch.diag(dsafe)


def _tp_subtract(A, X, Y, trailing_precision, precision):
    """A ← A − X·Y in place (A owned by the caller) with X·Y at the
    trailing precision — the JAX package's ``A - _tp_matmul(X, Y, ...)``:
    "highest" (and "high"/"default" where ``trailing_form`` maps them to
    it) as a product at the driver's ``precision``; any other form
    through K2's form with an all-live mask (on the CPU,
    ``bf16_3x_matmul``)."""
    if trailing_form(trailing_precision, A) == "highest":
        A -= matmul(X, Y, precision)
        return A
    ones = torch.ones(A.shape[1], dtype=A.dtype, device=A.device)
    return a_minus_vz_masked_mixed(A, X, Y, ones, trailing_precision)


def _stage(A_loc, A_sk_loc, Q, R_loc, J_loc, fail, cfg: BQRRPConfig,
           g0: int, q_hi: int, nblocks: int, precision, mesh=None):
    """Explicit-form stage: ``nblocks`` panel blocks inside the column
    window starting at global column ``g0``. ``A_loc`` (owned, updated in
    place), ``A_sk_loc``, ``R_loc`` (K rows × window columns, written in
    place) and ``J_loc`` are local to the window; ``Q`` is the full basis,
    filled through column g0 + nblocks·b ≤ q_hi. Returns the permuted
    ``(A_loc, A_sk_loc, R_loc, J_loc, fail)``.

    The chosen columns' R values (the BCGS2 projection and R11) are
    written into ``R_loc`` as each block commits; the JAX package stacks
    them in a scatter-free buffer and adds it after the permutation,
    which gives the same values.

    With ``mesh`` (of more than one rank) ``A_loc`` and ``Q`` are this
    rank's rows: the BCGS2 projection, the panel CholQR Grams and T =
    Q_panelᵀ·A are psummed, the trailing update is row-local, the
    ``qr_econ`` rescue gathers the panel, and the pivots are rank 0's."""
    m, w = A_loc.shape
    rows = None if mesh is None else m * mesh.size
    b = cfg.block_size
    K = R_loc.shape[0]
    dt, dev = A_loc.dtype, A_loc.device
    Qp = Q[:, :q_hi]
    order = torch.zeros(nblocks * b, dtype=torch.int64, device=dev)
    retired = torch.zeros(w, dtype=dt, device=dev)

    def block(i, A_work, A_sk, fail, j=None, Qg=None, Tg=None):
        """One panel block. With ``j`` given (update-deferred group slot)
        the trailing update is left to the group's end and the true panel
        and T row-block are recovered through the pending aggregates,
        A_j = A_stale − Qg·Tg."""
        deferred = j is not None
        c = i * b

        # -- qrcp_wide: LU pivots on the masked live sketch -------------
        live = 1.0 - retired
        chosen = _select_pivots(A_sk * live[None, :], b, cfg)
        chosen = _fix_pivots(chosen, retired)
        if mesh is not None:
            chosen = mesh.broadcast(chosen)

        # -- panel QR: sketch-preconditioned CholQR ---------------------
        A_sk_panel = A_sk.index_select(1, chosen)
        panel = A_work.index_select(1, chosen)
        if deferred and j > 0:
            panel = panel - matmul(Qg, Tg.index_select(1, chosen), precision)
        patch = torch.zeros((K, b), dtype=dt, device=dev)
        if cfg.block_reorth:
            # BCGS2 against the filled basis prefix; the correction goes
            # into R's earlier rows at the chosen columns
            proj = matmul(Qp.T, panel, precision)
            if mesh is not None:
                proj = mesh.psum(proj)
            panel = panel - matmul(Qp, proj, precision)
            patch[:q_hi] = proj
        if cfg.qr_tall == QRTall.cholqr:
            R_sk = _safe_triu_diag(qr_econ(A_sk_panel)[1])
            Q_panel, R11, failp = preconditioned_cholqr(
                panel, R_sk, precision, mesh, rows)
            if cfg.panel_reorth:
                Q_panel, R2, f2 = cholqr(Q_panel, precision, mesh, rows)
                R11 = matmul(R2, R11, precision)
                failp = failp | f2
            if bool(failp):
                Q_panel, R11 = qr_econ_rows(panel, mesh)
        else:
            Q_panel, R11 = qr_econ_rows(panel, mesh)
            failp = torch.zeros((), dtype=torch.bool, device=dev)
        R11 = torch.triu(R11)
        patch[g0 + c:g0 + c + b] = R11

        # -- trailing update over the (masked) window -------------------
        retired[chosen] = 1.0
        live2 = 1.0 - retired
        T = matmul(Q_panel.T, A_work, precision)
        if mesh is not None:
            T = mesh.psum(T)
        if deferred and j > 0:
            # T must read the TRUE trailing matrix
            T = T - matmul(matmul(Q_panel.T, Qg, precision), Tg, precision)
        T = T * live2[None, :]
        if not deferred:
            _tp_subtract(A_work, Q_panel, T, cfg.trailing_precision,
                         precision)

        # -- sketch downdate --------------------------------------------
        SQ = torch.linalg.solve_triangular(
            _safe_triu_diag(R11), A_sk_panel, upper=True, left=False)
        A_sk, fail = _sanitize_sketch(A_sk - matmul(SQ, T, precision), fail)

        # -- commit -----------------------------------------------------
        Qp[:, g0 + c:g0 + c + b] = Q_panel
        R_loc[g0 + c:g0 + c + b] = T
        R_loc[:, chosen] += patch
        order[c:c + b] = chosen
        fail = fail | failp
        if not deferred:
            return A_sk, fail
        Qg = Q_panel if j == 0 else torch.cat([Qg, Q_panel], 1)
        Tg = T if j == 0 else torch.cat([Tg, T], 0)
        return A_sk, fail, Qg, Tg

    A_work, A_sk = A_loc, A_sk_loc
    # the row-sharded mode keeps the per-block updates, as JAX's does
    g = 1 if cfg.shard_axis is not None else max(
        1, min(int(cfg.update_defer), nblocks))
    if g == 1:
        for i in range(nblocks):
            A_sk, fail = block(i, A_work, A_sk, fail)
    else:
        for i0 in range(0, nblocks, g):
            Qg = Tg = None
            for j in range(min(g, nblocks - i0)):
                A_sk, fail, Qg, Tg = block(i0 + j, A_work, A_sk, fail, j,
                                           Qg, Tg)
            # ONE wide k = g·b trailing update (the per-block GEMM sum,
            # reordered)
            _tp_subtract(A_work, Qg, Tg, cfg.trailing_precision, precision)

    # stage-end permutation: pivots (in selection order) to the front,
    # the rest in their relative order, for the next (narrower) window
    k_sel = nblocks * b
    cols = torch.arange(w, device=dev)
    pos = torch.zeros(w, dtype=torch.int64, device=dev)
    pos[order] = torch.arange(k_sel, device=dev)
    perm = torch.argsort(torch.where(retired > 0, pos, k_sel + cols),
                         stable=True)
    return (A_work.index_select(1, perm), A_sk.index_select(1, perm),
            R_loc.index_select(1, perm), J_loc.index_select(0, perm), fail)


def bqrrp(A: torch.Tensor, cfg: BQRRPConfig, state: RNGState,
          precision=STABLE_PRECISION, timing: bool = False,
          sketch: torch.Tensor | None = None):
    """Blocked randomized QRCP of A (any aspect ratio), explicit form:
    A[:, J] ≈ Q R.

    Returns ``(Q, R, J, rank, fail, next_state)``: Q (m, K) orthonormal,
    R (K, n) upper-trapezoidal, J (n,) int64, K = min(m, n) (a
    non-multiple K runs a one-block remainder stage, rl_bqrrp.hh:569-576),
    ``rank`` an int32 upper-bound estimate from diag(R), ``fail`` the
    CholQR breakdown flag. ``timing=True`` appends the phase dict
    (``sketch``, ``stage_<s>``, ``final_orth``). ``sketch`` injects the
    (d, m) Gaussian sketch S (d = int(d_factor·b)); when it is None, S is
    drawn from ``state`` on A's device. ``A`` is not modified.
    ``precision`` sets every product the JAX package runs at the driver's
    precision (``ops.util.matmul``).

    Row-sharded mode (``cfg.shard_axis`` names the axis of the mesh set by
    ``parallel.set_mesh``; ``parallel.dist_bqrrp`` sets both): A is this
    rank's rows, ``sketch`` the matching (d, m_local) column block of S
    (an undrawn S is the unsharded driver's, sliced), Q comes back as this
    rank's rows and R, J, rank and fail replicated; ``update_defer`` is
    read as 1, as in the JAX package. A mesh of one rank is the unsharded
    call. Collectives: one psum of the sketch; per block, the BCGS2
    projection, each panel CholQR Gram (with the band guard's pmax) and
    T = Q_panelᵀ·A; the final pass's K×K Gram QᵀQ. The trailing update
    is row-local (K2's form in a trailing mode), and rank 0's pivots are
    broadcast.
    """
    require_fp32_matmul()
    mesh = _check_cfg(cfg)
    precision = resolve_precision(precision)
    require(A.dim() == 2, f"A must be a matrix, got shape {tuple(A.shape)}")
    timer = PhaseTimer()

    def _phase(name):
        return timer.phase(name) if timing else contextlib.nullcontext()

    from ..parallel.mesh import shard_rows
    m, mesh = shard_rows(A, mesh, "bqrrp")
    m_loc, n = A.shape
    dt, dev = A.dtype, A.device
    b = min(cfg.block_size, min(m, n))
    if b != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=b)
    K = min(m, n)
    K_full, r = divmod(K, b)
    K_full *= b
    d = int(cfg.d_factor * b)
    S = cfg.stages if (cfg.stages > 1 and K_full > 0
                       and K_full % (cfg.stages * b) == 0) else 1
    chunk = K_full // S if K_full else 0

    with _phase("sketch"):
        A_sk = _sketch_product(A, d, state, sketch, precision, mesh)
        state = state.advance()
        if timing:
            device_sync(A_sk)

    Q = torch.zeros((m_loc, K), dtype=dt, device=dev)
    R = torch.zeros((K, n), dtype=dt, device=dev)
    J = torch.arange(n, device=dev)
    fail = torch.zeros((), dtype=torch.bool, device=dev)
    A_work = A

    # stage plan: (g0, q_hi, nblocks, stage cfg) — S full stages plus an
    # optional one-block remainder stage of width r
    plan = [(s * chunk, min((s + 1) * chunk, K_full), chunk // b, cfg)
            for s in range(S) if chunk]
    if r:
        plan.append((K_full, K, 1, dataclasses.replace(
            cfg, block_size=r,
            pivot_candidates=(None if cfg.pivot_candidates is None
                              else max(1, cfg.pivot_candidates)))))

    for s, (g0, q_hi, nblocks, scfg) in enumerate(plan):
        # the stage owns a contiguous copy of its window (the first copy
        # also keeps the caller's A intact under the in-place updates)
        A_loc = A_work[:, g0:].clone(memory_format=torch.contiguous_format)
        with _phase(f"stage_{s}"):
            A_loc, A_sk_loc, R_loc, J_loc, fail = _stage(
                A_loc, A_sk[:, g0:], Q, R[:, g0:], J[g0:], fail, scfg, g0,
                q_hi, nblocks, precision, mesh)
            if timing:
                device_sync(Q)
        if g0 == 0:
            A_work, A_sk, R, J = A_loc, A_sk_loc, R_loc, J_loc
        else:
            A_work[:, g0:] = A_loc
            A_sk[:, g0:] = A_sk_loc
            R[:, g0:] = R_loc
            J[g0:] = J_loc

    with _phase("final_orth"):
        eps = torch.finfo(dt).eps
        for _ in range(cfg.final_orth):
            # one CholQR pass on the finished Q; a degenerate Q (colliding
            # fallback panels) breaks the unshifted Cholesky, and the
            # shifted factor keeps the outputs finite with `fail` raised
            G = matmul(Q.T, Q, precision)
            if mesh is not None:
                G = mesh.psum(G)
            L = _cholesky(G)
            bad = torch.isnan(L).any() | (torch.diagonal(L) <= 0).any()
            if bool(bad):
                s2 = 11.0 * eps * torch.trace(G) + eps
                L = _cholesky(G + s2 * torch.eye(K, dtype=dt, device=dev))
            Q = torch.linalg.solve_triangular(L.T, Q, upper=True,
                                              left=False)
            R = matmul(L.T, R, precision)
            fail = fail | bad
        if timing:
            device_sync(Q)

    diag = torch.diagonal(R[:, :K])
    tol = diag[0].abs() * math.sqrt(torch.finfo(dt).eps)
    rank = util.naive_rank_est(diag, tol)
    if timing:
        return Q, R, J, rank, fail, state, timer.report()
    return Q, R, J, rank, fail, state


def _sketch_product(A, d, state: RNGState, sketch, precision, mesh=None):
    """S·A for the dense (d, m) Gaussian sketch S, N(0, 1/d) entries: the
    injected ``sketch``, or drawn from ``state`` on A's device (the caller
    advances ``state``). On a row shard, A is the rank's rows, ``sketch``
    the matching (d, m_local) column block (an undrawn S is drawn whole,
    as the unsharded driver draws it, and sliced), and the product is
    psummed."""
    ml = A.shape[0]
    m = ml if mesh is None else ml * mesh.size
    if sketch is None:
        gen, _ = state.spawn(A.device)
        sketch = torch.randn((d, m), generator=gen, dtype=A.dtype,
                             device=A.device) / math.sqrt(d)
        if mesh is not None:
            r0, r1 = mesh.rows(ml)
            sketch = sketch[:, r0:r1]
    require(isinstance(sketch, torch.Tensor)
            and tuple(sketch.shape) == (d, A.shape[0]),
            f"sketch must be a {(d, A.shape[0])} tensor")
    Y = matmul(sketch.to(device=A.device, dtype=A.dtype), A, precision)
    return Y if mesh is None else mesh.psum(Y)


def _householder_r(panel_m, b, mesh):
    """The floored R of a Householder QR of the panel: on a row shard the
    panel is gathered whole (the rescue rungs only) and rank 0's R is
    broadcast."""
    if mesh is None:
        return _safe_triu_diag(torch.linalg.qr(panel_m, mode="r").R[:b, :])
    R = torch.linalg.qr(mesh.gather_rows(panel_m), mode="r").R[:b, :]
    return _safe_triu_diag(mesh.broadcast(R.contiguous()))


def _panel_qr(panel_m, Ysk_p, b, cfg: BQRRPConfig, precision, mesh=None):
    """Panel QR at its row offset, with the JAX package's rescue ladder.
    Returns ``(Q_panel, R11, failp, fail_all)``: ``failp`` that the first
    attempt broke down, ``fail_all`` that every rescue did too. On a row
    shard the Grams are psummed and the flags reduced, so every rank takes
    the same branches."""
    dt, dev = panel_m.dtype, panel_m.device
    rows = None if mesh is None else panel_m.shape[0] * mesh.size

    def anyr(flag):
        return flag if mesh is None else mesh.any(flag)

    if cfg.qr_tall == QRTall.hqr:
        # Householder-R panel (the reference's geqrf qr_tall option): R
        # from a backward-stable QR, explicit Q via one solve, which keeps
        # the zeros above row c that the WY form needs
        R11 = _householder_r(panel_m, b, mesh)
        Q_panel = torch.linalg.solve_triangular(R11, panel_m, upper=True,
                                                left=False)
        failp = anyr((~torch.isfinite(Q_panel)).any())
    else:
        if cfg.sketch_r == "qr" or (cfg.sketch_r == "auto" and b > 512):
            R_sk = _safe_triu_diag(qr_econ(Ysk_p)[1])
        else:
            # pow2 band-normalize before the Gram (a uniformly tiny sketch
            # underflows G_sk and destroys the preconditioner)
            Ysk_n, s_y, _ = _finite_scaled(Ysk_p)
            L_sk = _cholesky(matmul(Ysk_n.T, Ysk_n, precision))
            badsk = torch.isnan(L_sk).any()
            R_sk = _safe_triu_diag(torch.where(
                badsk, torch.eye(b, dtype=dt, device=dev), L_sk.T * s_y))
        Q_panel, R11, failp = preconditioned_cholqr(panel_m, R_sk, precision,
                                                    mesh, rows)
    if cfg.panel_reorth:
        Q_panel, R2, f2 = cholqr(Q_panel, precision, mesh, rows)
        R11 = matmul(R2, R11, precision)
        failp = failp | f2
    fail_all = torch.zeros((), dtype=torch.bool, device=dev)
    # rescue 1: shifted CholQR3; rescue 1.5: Householder-R preconditioned
    # CholQR (backward-stable R is the perfect preconditioner). One host
    # sync per block decides whether the ladder runs at all; a batched
    # call (torch.func.vmap) runs both rungs and selects on the device.
    if util.is_batched(failp):
        Q_r, R_r, f_r = shifted_cholqr3(panel_m, precision)
        R_h = _safe_triu_diag(torch.linalg.qr(panel_m, mode="r").R[:b, :])
        Q_h, R_hh, f_h = preconditioned_cholqr(panel_m, R_h, precision)
        f_h = f_h | (~torch.isfinite(Q_h)).any()
        Q_r, R_r = torch.where(f_r, Q_h, Q_r), torch.where(f_r, R_hh, R_r)
        return (torch.where(failp, Q_r, Q_panel),
                torch.where(failp, R_r, R11), failp,
                failp & f_r & f_h)
    if bool(failp):
        Q_panel, R11, f_r = shifted_cholqr3(panel_m, precision, mesh, rows)
        if bool(f_r):
            R_h = _householder_r(panel_m, b, mesh)
            Q_panel, R11, f_h = preconditioned_cholqr(panel_m, R_h,
                                                      precision, mesh, rows)
            fail_all = f_h | anyr((~torch.isfinite(Q_panel)).any())
    return Q_panel, R11, failp, fail_all


def _wy_stage(A, Y, Vs, Ts, bT: int, J_loc, fail, cfg: BQRRPConfig,
              c0: int, nblocks: int, bsz: int, precision, mesh=None):
    """Factored-form stage over a column WINDOW (columns [g0:n) of the
    global problem): in-place Householder coordinates (live columns carry
    QᵀA), mask-based retirement, exact trsm sketch downdate, then ONE
    stage-end permutation moving the pivots to the window front.

    ``A`` is owned by the stage and updated in place; each block's V
    (zero-padded to the T-slot width ``bT``) and T (identity-padded) are
    appended to ``Vs`` / ``Ts``, the chosen columns' final values, pivot
    order and retired mask are gathered out of place (so
    ``torch.func.vmap`` batches a CPU call); ``bsz`` is the block width
    (the remainder stage passes r < b). Blocks run in groups of
    ``update_defer``: inside a group each block reads the stale A plus an
    exact low-rank correction through the group aggregates (Vg, Ug), and
    the group ends with ONE k = g·b masked update. Returns the permuted
    ``(A, Y, J_loc, fail)``.

    With ``mesh`` (of more than one rank) A and V are this rank's rows and
    ``c0`` counts global rows: K1 and K2 run on the shard, W and the R12
    rows are psummed, the b×b block ``orhr_col`` factors (K3) is gathered
    and factored on every rank, and the pivots are rank 0's.
    """
    m, n = A.shape
    b = bsz
    dt, dev = A.dtype, A.device
    order, Fstk = [], []
    retired = torch.zeros(n, dtype=dt, device=dev)

    def subblock(i, j, Vg, Ug, Y, fail, retired):
        c = c0 + i * b
        live = 1.0 - retired

        # -- qrcp_wide: LU pivots on the masked live sketch -------------
        chosen = _select_pivots(Y * live[None, :], b, cfg)
        chosen = _fix_pivots(chosen, retired)
        if mesh is not None:
            chosen = mesh.broadcast(chosen)

        # -- panel QR at row offset c (lazily-corrected true panel) ------
        # (lo, hi): the local rows of the global rows [c, c + b); cl: the
        # local rows above row c
        lo, hi = (c, c + b) if mesh is None else mesh.local_rows(m, c, c + b)
        cl = c if mesh is None else mesh.local_rows(m, 0, c)[1]
        panel = A.index_select(1, chosen)
        if j > 0:
            panel = panel - matmul(Vg, Ug.index_select(1, chosen), precision)
        panel_m = panel.clone()
        panel_m[:cl] = 0.0
        Ysk_p = Y.index_select(1, chosen)
        Q_panel, R11, failp, fail_all = _panel_qr(panel_m, Ysk_p, b, cfg,
                                                  precision, mesh)
        fail = fail | (failp & fail_all)
        # rescue 2: degenerate panels NaN even the rescues; substitute
        # identity columns so outputs stay finite with `fail` raised
        nanp = torch.isnan(Q_panel).any() | torch.isnan(R11).any()
        if mesh is not None:
            nanp = mesh.any(nanp)
        r0 = 0 if mesh is None else mesh.rows(m)[0]
        idx = torch.arange(lo, hi, device=dev)
        E_pad = torch.zeros((m, b), dtype=dt, device=dev)
        E_pad[idx, r0 + idx - c] = 1.0
        Q_panel = torch.where(nanp, E_pad, Q_panel)
        R11 = torch.triu(torch.where(nanp, 0.0, R11))
        fail = fail | nanp

        # -- Householder reconstruction (adaptive-sign orhr_col) ----------
        V, T, s = orhr_col(Q_panel, c - r0, precision, Q1=None
                           if mesh is None else mesh.rows_of(Q_panel, c,
                                                               c + b))

        # -- the chosen columns' final values: R12 rows (< c) kept and the
        # signed R11, stacked in selection order (merged at stage end)
        F = panel.new_zeros((m, b))
        F[:cl] = panel[:cl]
        F[lo:hi] = (s[:, None] * R11)[r0 + lo - c:r0 + hi - c]
        Fstk.append(F)
        live2 = live.index_fill(0, chosen, 0.0)

        # -- W = Vᵀ·(A_true ⊙ live2); U = Tᵀ·W (update stays deferred) --
        W = masked_vt_a_mixed(V, A, live2, cfg.trailing_precision)
        if j > 0:
            W = W - matmul(matmul(V.T, Vg, precision), Ug * live2[None, :],
                           precision)
        if mesh is not None:
            W = mesh.psum(W)
        U = matmul(T.T, W, precision)

        # -- R12 = rows c:c+b of the true post-update A, on live cols ---
        R12 = A[lo:hi, :]
        if j > 0:
            R12 = R12 - matmul(Vg[lo:hi, :], Ug, precision)
        R12 = (R12 - matmul(V[lo:hi, :], U, precision)) * live2[None, :]
        if mesh is not None:
            R12 = mesh.join_rows(R12, m, c, c + b)

        # -- exact sketch downdate: B = Y_panel·R11⁻¹·S -----------------
        B = torch.linalg.solve_triangular(
            _safe_triu_diag(R11), Ysk_p, upper=True, left=False) \
            * s[None, :]
        Y = Y - matmul(B, R12, precision) * live2[None, :]
        Y, fail = _sanitize_sketch(Y, fail)

        # -- commit ------------------------------------------------------
        # remainder blocks (b < T-slot width) pad T with identity; the
        # matching V columns are zero, so H is unaffected
        Vs.append(V if b == bT else torch.cat(
            [V, V.new_zeros((m, bT - b))], 1))
        Ts.append(T if b == bT else torch.block_diag(
            T, torch.eye(bT - b, dtype=dt, device=dev)))
        order.append(chosen)
        retired = retired.index_fill(0, chosen, 1.0)
        Vg = V if j == 0 else torch.cat([Vg, V], 1)
        Ug = U if j == 0 else torch.cat([Ug, U], 0)
        return Vg, Ug, Y, fail, retired

    g = max(1, min(int(cfg.update_defer), nblocks))
    for i0 in range(0, nblocks, g):
        Vg = Ug = None
        for j in range(min(g, nblocks - i0)):
            Vg, Ug, Y, fail, retired = subblock(i0 + j, j, Vg, Ug, Y, fail,
                                                retired)
        A = a_minus_vz_masked_mixed(A, Vg, Ug, 1.0 - retired,
                                    cfg.trailing_precision)

    # stage-end permutation: pivots to the window front in selection
    # order; the rest keep relative order for the next (narrower) stage
    k_sel = nblocks * b
    cols = torch.arange(n, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev).index_put(
        (torch.cat(order),), torch.arange(k_sel, device=dev))
    perm = torch.argsort(torch.where(retired > 0, pos, k_sel + cols),
                         stable=True)
    A = torch.cat([torch.cat(Fstk, 1), A.index_select(1, perm[k_sel:])], 1)
    Y = Y.index_select(1, perm)
    J_loc = J_loc.index_select(0, perm)
    return A, Y, J_loc, fail


def bqrrp_factored(A: torch.Tensor, cfg: BQRRPConfig, state: RNGState,
                   precision=STABLE_PRECISION, timing: bool = False,
                   sketch: torch.Tensor | None = None):
    """Blocked randomized QRCP in the reference's native *factored* form:
    A[:, J] = Q·R with Q implicit (block-WY reflectors). Materialize Q
    with :func:`bqrrp_q`, or apply Qᵀ with :func:`bqrrp_apply_qt`.

    Any size/aspect ratio: a non-multiple min(m, n) runs one remainder
    block (identity-padded T slot, zero-padded V columns). ``sketch``
    injects the (d, m) Gaussian sketch S (d = int(d_factor·b)); when it
    is None, S is drawn from ``state`` on A's device. ``A`` is not
    modified. Returns ``(BQRRPFactors, next_state)`` (+ phase dict when
    ``timing=True``). ``precision`` sets the products the JAX package
    runs in ``jnp`` at the driver's precision (``ops.util.matmul``); the
    kernels K1–K3 ignore it, as the Pallas kernels do.

    Row-sharded mode (``cfg.shard_axis`` names the axis of the mesh set by
    ``parallel.set_mesh``; ``parallel.dist_bqrrp_factored`` sets both): A
    is this rank's rows (the ranks hold equal blocks, in rank order),
    ``sketch`` the matching (d, m_local) column block of S, V comes back as
    this rank's rows and R, T, J, rank and fail replicated. A mesh of one
    rank is the unsharded call. Per block: one psum of the sketch (once),
    of each CholQR Gram with the band guard's pmax, of the b×b block K3
    factors, of W = Vᵀ·A (K1 on the shard) and of the R12 rows; K2
    updates the shard in place; rank 0's pivots are broadcast.
    """
    require_fp32_matmul()
    mesh = _check_cfg(cfg)
    precision = resolve_precision(precision)
    require(A.dim() == 2, f"A must be a matrix, got shape {tuple(A.shape)}")
    if A.device.type == "cuda":
        # K1–K3 run on every call: refuse vmap and autograd up front
        util.require_kernel_operands("bqrrp_factored", A)
    timer = PhaseTimer()

    def _phase(name):
        return timer.phase(name) if timing else contextlib.nullcontext()

    from ..parallel.mesh import shard_rows
    m, mesh = shard_rows(A, mesh, "bqrrp_factored")
    m_loc, n = A.shape
    dt, dev = A.dtype, A.device
    b = min(cfg.block_size, min(m, n))
    if b != cfg.block_size:
        cfg = dataclasses.replace(cfg, block_size=b)
    K = min(m, n)
    nb_full, rrem = divmod(K, b)
    K_full = nb_full * b
    nblocks = nb_full + (1 if rrem else 0)
    d = int(cfg.d_factor * b)

    with _phase("sketch"):
        Y = _sketch_product(A, d, state, sketch, precision, mesh)
        state = state.advance()
        if timing:
            device_sync(Y)

    Vs, Ts = [], []
    fail = torch.zeros((), dtype=torch.bool, device=dev)
    J = torch.arange(n, device=dev)
    A_work = A

    # shrinking-width stage plan: S windows over the full blocks + an
    # optional remainder stage (g0, blocks, block width)
    S = cfg.stages if (cfg.stages > 1 and nb_full > 0
                       and nb_full % cfg.stages == 0) else 1
    chunk = nb_full // S if nb_full else 0
    plan = [(s * chunk * b, chunk, b) for s in range(S) if chunk]
    if rrem:
        plan.append((K_full, 1, rrem))

    for si, (g0, nbl, bsz) in enumerate(plan):
        # the stage owns a contiguous copy of its window (the first copy
        # also keeps the caller's A intact under the in-place updates)
        A_loc = A_work[:, g0:].clone(memory_format=torch.contiguous_format)
        with _phase(f"stage_{si}"):
            A_loc, Y_loc, J_loc, fail = _wy_stage(
                A_loc, Y[:, g0:], Vs, Ts, b, J[g0:], fail, cfg, g0, nbl, bsz,
                precision, mesh)
            if timing:
                device_sync(A_loc)
        if g0 == 0:
            A_work, Y, J = A_loc, Y_loc, J_loc
        else:
            A_work[:, g0:] = A_loc
            Y[:, g0:] = Y_loc
            J[g0:] = J_loc

    with _phase("epilogue"):
        R = torch.triu(A_work[:K, :] if mesh is None
                       else mesh.rows_of(A_work, 0, K))
        if timing:
            device_sync(R)

    diag = torch.diagonal(R[:, :K])
    tol = diag[0].abs() * math.sqrt(torch.finfo(dt).eps)
    rank = util.naive_rank_est(diag, tol)
    fac = BQRRPFactors(
        V=torch.cat(Vs, 1) if Vs else A.new_zeros((m_loc, 0)),
        T=torch.stack(Ts) if Ts else A.new_zeros((0, b, b)), R=R, J=J,
        rank=rank, fail=fail)
    if timing:
        return fac, state, timer.report()
    return fac, state


def _wy_tree_merge(fac: BQRRPFactors, precision, mesh=None):
    """Merge the per-block WY factors into ONE (V, T) pair by pairwise
    combination: H₁H₂ = I − [V₁ V₂]·[[T₁, −T₁(V₁ᵀV₂)T₂],[0, T₂]]·[V₁ V₂]ᵀ
    (V₁ᵀV₂ psummed over ``mesh`` when V is row-sharded)."""
    nb, b, _ = fac.T.shape
    Vs = [fac.V[:, i * b:(i + 1) * b] for i in range(nb)]
    Ts = [fac.T[i] for i in range(nb)]
    while len(Vs) > 1:
        nVs, nTs = [], []
        for i in range(0, len(Vs) - 1, 2):
            V1, T1 = Vs[i], Ts[i]
            V2, T2 = Vs[i + 1], Ts[i + 1]
            G = matmul(V1.T, V2, precision)
            if mesh is not None:
                G = mesh.psum(G)
            cross = -matmul(T1, matmul(G, T2, precision), precision)
            zeros = torch.zeros((T2.shape[0], T1.shape[0]), dtype=T1.dtype,
                                device=T1.device)
            nTs.append(torch.cat([torch.cat([T1, cross], 1),
                                  torch.cat([zeros, T2], 1)], 0))
            nVs.append(torch.cat([V1, V2], 1))
        if len(Vs) % 2:
            nVs.append(Vs[-1])
            nTs.append(Ts[-1])
        Vs, Ts = nVs, nTs
    return Vs[0], Ts[0]


def _factor_mesh(fac: BQRRPFactors, mesh):
    """The mesh of row-sharded factors, after checking that the ranks hold
    equal blocks (None for a mesh of one rank or none)."""
    if mesh is None or mesh.size == 1:
        return None
    from ..parallel.mesh import global_rows
    global_rows(fac.V.shape[0], mesh, "row-sharded factors")
    return mesh


def bqrrp_q(fac: BQRRPFactors, k: int | None = None,
            method: str = "sequential", precision=STABLE_PRECISION,
            mesh=None):
    """Materialize the leading ``k`` (default all K = min(m,n)) columns of
    Q from the factored form — the orgqr/ungqr analogue. ``"sequential"``
    applies the nb blocks one by one; ``"tree"`` merges them pairwise
    into one reflector block first. Products at ``precision``. With the
    ``mesh`` of a row-sharded factorization (V this rank's rows), the
    rank's rows of Q: each Vᵀ·Q is psummed."""
    precision = resolve_precision(precision)
    mesh = _factor_mesh(fac, mesh)
    m = fac.V.shape[0]
    nb, b, _ = fac.T.shape
    k = fac.R.shape[0] if k is None else k
    r0 = 0 if mesh is None else mesh.rows(m)[0]
    lo, hi = (0, min(m, k)) if mesh is None else mesh.local_rows(m, 0, k)
    diag = torch.arange(lo, hi, device=fac.V.device)
    if method == "tree":
        V, T = _wy_tree_merge(fac, precision, mesh)
        Vk = V[:k, :] if mesh is None else mesh.rows_of(V, 0, k)
        Q = -matmul(V, matmul(T, Vk.T, precision), precision)
        Q[diag, r0 + diag] += 1.0
        return Q
    require(method == "sequential", f"unknown method {method!r}")
    if mesh is None:
        Q = torch.eye(m, k, dtype=fac.V.dtype, device=fac.V.device)
    else:
        Q = fac.V.new_zeros((m, k))
        Q[diag, r0 + diag] = 1.0
    for i in reversed(range(nb)):
        Vi = fac.V[:, i * b:(i + 1) * b]
        P = matmul(Vi.T, Q, precision)
        if mesh is not None:
            P = mesh.psum(P)
        Q = Q - matmul(Vi, matmul(fac.T[i], P, precision), precision)
    return Q


def bqrrp_apply_qt(fac: BQRRPFactors, X: torch.Tensor,
                   precision=STABLE_PRECISION, mesh=None):
    """Qᵀ·X from the factored form — the ormqr/gemqrt analogue
    (rl_bqrrp.hh:535-547); products at ``precision``. With the ``mesh``
    of a row-sharded factorization, X and the result are this rank's
    rows: each Vᵀ·X is psummed."""
    precision = resolve_precision(precision)
    mesh = _factor_mesh(fac, mesh)
    nb, b, _ = fac.T.shape
    for i in range(nb):
        Vi = fac.V[:, i * b:(i + 1) * b]
        P = matmul(Vi.T, X, precision)
        if mesh is not None:
            P = mesh.psum(P)
        X = X - matmul(Vi, matmul(fac.T[i].T, P, precision), precision)
    return X
