"""HQRRP — Householder QR with randomized pivoting (counterpart of
``randlapack_tpu/drivers/hqrrp.py``; reference: RandLAPACK/drivers/
rl_hqrrp.hh: hqrrp() :812, the Martinsson/Quintana-Ortí/Heavner/van de
Geijn algorithm).

Per block of ``b`` columns:

  1. QRCP of the downdated sketch Y = G·A on the live columns (K5,
     ``ops/qrcp.py``): b pivots.
  2. Panel factorization of A[:, chosen] at row offset c: pivoted
     Householder QRCP (K6), unpivoted Householder, or CholQR with the
     ``orhr_col`` Householder reconstruction (K3 inside it).
  3. Compact-WY trailing update A ← QᵀA on the live columns (two GEMMs)
     that reads and writes only rows ≥ c, where the block's reflectors
     are nonzero; the live-column mask goes on the b×n product, not on A.
  4. Exact sketch downdate: G ← G·Q_blk, then Y ← Y − G[:, c:c+b]·R₁₂.

As in the JAX package, chosen columns stay in place behind a ``retired``
mask, their packed columns are stacked in selection order, and ONE
permutation at the end moves them to the front; ``update_defer = g``
aggregates g blocks' trailing updates into one k = g·b product. The
JAX ``fori_loop``s become Python loops; every per-block quantity
(pivots, sigma, the ``fail`` flag) stays on the device, so the blocks run
without a host round trip. The trailing GEMMs are ``torch.matmul`` /
``addmm`` (the JAX package computes them outside any Pallas kernel), and
update the driver's own copy of A in place. A ``trailing_precision``
other than "highest" sends the two the JAX package computes at that
precision — W = Vᵀ·(A ⊙ live) and the trailing update A − V·(U ⊙ live),
on the same rows — through K1's and K2's forms on the card
(``ops.wy.trailing_form``), which take the row view A[c:] as it is.
Under tracing (``utils.timing``) the counters ``hqrrp.rows.<product>``
give the rows each product with the reflectors reads against A's, and
``hqrrp.masked_copies`` the masks laid on an operand the size of A (none).
The driver's ``precision`` sets every other product (``ops.util.matmul``);
K5, K6 and K3 ignore it, as the Pallas kernels do. The packed columns,
pivot order, taus and retired mask are built out of place, so
``torch.func.vmap`` batches a CPU call.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import warnings

import torch

from ..config import (STABLE_PRECISION, require_fp32_matmul,
                      resolve_precision)
from ..errors import require
from ..ops import util
from ..ops.cholqr import cholqr2
from ..ops.householder import apply_reflectors, orhr_col
from ..ops.qr import wy_T
from ..ops.qrcp import qrcp_panel_routed, qrcp_select_pivots_routed
from ..ops.util import matmul, product_form
from ..ops.wy import (a_minus_vz_masked_mixed, masked_vt_a_mixed,
                      trailing_form)
from ..rng import RNGState
from ..utils.timing import UNTIMED, PhaseTimer, count, span


class PanelQR(enum.Enum):
    qrcp = "qrcp"        # pivoted panels (reference panel_pivoting=1)
    geqrf = "geqrf"      # qr_type 1: unpivoted Householder panels
    cholqr = "cholqr"    # qr_type 2: CholQR + Householder reconstruction


@dataclasses.dataclass(frozen=True)
class HQRRPConfig:
    """The JAX package's configuration, field for field (see
    ``randlapack_tpu/drivers/hqrrp.py`` for each field's story).

    ``pallas_qrcp`` and ``pallas_panel`` default to ``"auto"`` here, where
    the JAX package defaults them to ``"never"``: that default was a TPU
    timing verdict (XLA's fused loop beat both Pallas kernels on the TPU)
    and says nothing about this card. A CUDA tensor always runs K5/K6 and
    accepts only ``"auto"`` (``"never"`` raises); a CPU tensor takes the
    plain versions under either value."""
    block_size: int = 64
    oversample: int = 10          # sketch rows d = block_size + oversample
    panel_qr: PanelQR = PanelQR.qrcp
    pallas_qrcp: str = "auto"     # K5 routing: "auto" | "never" (CPU only)
    pallas_panel: str = "auto"    # K6 routing: "auto" | "never" (CPU only)
    shard_axis: str | None = None  # row-sharded mode over the mesh of
                                   # this axis set by
                                   # ``parallel.set_mesh``: A and the
                                   # sketch operator G (its columns) stay
                                   # sharded, Y/T/R replicated
    trailing_precision: str = "highest"
                                  # the trailing-update products W = Vᵀ·A
                                  # and A −= V·U (``ops.wy.trailing_form``):
                                  # "highest" fp32/f64; on a CUDA f32 tensor
                                  # "high" one TF32 product, "default" one
                                  # bf16 product (K1/K2's forms), on the CPU
                                  # and in f64 both as "highest";
                                  # "bf16_3x_emul" (and any other string)
                                  # three bf16 products of bf16 hi/lo
                                  # halves. Pivots, panels and the sketch
                                  # downdate run at the driver's precision,
                                  # on the trailing-updated matrix
    update_defer: int = 1         # blocks per aggregated trailing update


def _check_cfg(cfg: HQRRPConfig, precision, device: torch.device):
    """Refuse what the port does not take; return the mesh that
    ``cfg.shard_axis`` names (None when it is None)."""
    if device.type == "cuda" and (cfg.pallas_qrcp, cfg.pallas_panel) != (
            "auto", "auto"):
        raise NotImplementedError(
            f"pallas_qrcp={cfg.pallas_qrcp!r}, pallas_panel="
            f"{cfg.pallas_panel!r} on a CUDA tensor: a CUDA tensor always "
            "takes the kernels, only 'auto' is accepted there")
    resolve_precision(precision)
    if cfg.shard_axis is None:
        return None
    from ..parallel.mesh import current_mesh
    return current_mesh(cfg.shard_axis)


def _cholqr_panel(panel, row0: int, precision, mesh=None):
    """CHOLQR_mod_WY (rl_hqrrp.hh:506): CholQR2 of the row-masked panel,
    then the ``orhr_col`` reconstruction at offset row0 (K3 on the card).
    τₗ = 2/‖vₗ‖² makes each stored reflector exact. A breakdown substitutes
    identity columns at the panel offset, so the outputs stay finite with
    ``fail`` raised. Returns (W, V, taus, sigma, fail) in ``qrcp_panel``'s
    layout. With ``mesh`` the panel, W and V are this rank's rows: the
    CholQR2 Grams and the reflector norms are psummed, and K3 factors the
    b×b block gathered to every rank."""
    m, b = panel.shape
    dt, dev = panel.dtype, panel.device
    r0 = 0 if mesh is None else mesh.rows(m)[0]
    rows = r0 + torch.arange(m, device=dev)[:, None]     # global rows
    cols = torch.arange(b, device=dev)[None, :]
    Pm = torch.where(rows >= row0, panel, 0.0)
    Qp, R_chol, fail = cholqr2(Pm, precision, mesh,
                               None if mesh is None else m * mesh.size)
    nanp = (~torch.isfinite(Qp)).any() | (~torch.isfinite(R_chol)).any()
    if mesh is not None:
        nanp = mesh.any(nanp)
    E_pad = (rows == row0 + cols).to(dt)
    Qp = torch.where(nanp, E_pad, Qp)
    R_chol = torch.where(nanp, 0.0, R_chol)
    fail = fail | nanp
    V, _, s = orhr_col(Qp, row0 - r0, precision, Q1=None if mesh is None
                       else mesh.rows_of(Qp, row0, row0 + b))
    vv = (V * V).sum(0)
    taus = 2.0 / (vv if mesh is None else mesh.psum(vv))
    W = torch.where(rows < row0, panel, 0.0)
    lo, hi = (row0, row0 + b) if mesh is None else mesh.local_rows(
        m, row0, row0 + b)
    W[lo:hi] += (s[:, None] * R_chol)[r0 + lo - row0:r0 + hi - row0]
    W = W + torch.where(rows > row0 + cols, V, 0.0)
    sigma = torch.arange(b, device=dev)
    return W, V, taus, sigma, fail


def _panel(panel, c: int, cfg: HQRRPConfig, precision, mesh=None):
    """The configured panel factorization at row offset c →
    (W, V, taus, sigma, fail). With ``mesh`` a Householder panel (K6 on
    the card) factors the panel gathered whole on every rank, each rank
    keeps its rows of W and V, and rank 0's pivots and taus are
    broadcast."""
    if cfg.panel_qr == PanelQR.cholqr:
        return _cholqr_panel(panel, c, precision, mesh)
    W, V, taus, sigma = qrcp_panel_routed(
        panel if mesh is None else mesh.gather_rows(panel), c,
        pivot=(cfg.panel_qr == PanelQR.qrcp), precision=precision,
        use_pallas=cfg.pallas_panel)
    if mesh is not None:
        r0, r1 = mesh.rows(panel.shape[0])
        W, V = W[r0:r1], V[r0:r1]
        taus = mesh.broadcast(taus.contiguous())
        sigma = mesh.broadcast(sigma.contiguous())
    return W, V, taus, sigma, torch.zeros((), dtype=torch.bool,
                                          device=panel.device)


class _State:
    """The loop carry: A (updated in place), the sketch Y and its
    operator G, the driver's ``precision``, the mesh of the row-sharded
    mode (None unsharded: A and G's columns are then this rank's), the
    packed pivot columns, the pivot order and taus a block each in
    selection order (joined at the end), the retired mask and the
    ``fail`` flag."""

    def __init__(self, A, Y, G, precision, mesh=None):
        n = A.shape[1]
        dt, dev = A.dtype, A.device
        self.A, self.Y, self.G, self.precision = A, Y, G, precision
        self.mesh = mesh
        self.Fstk, self.order, self.taus = [], [], []
        self.retired = torch.zeros(n, dtype=dt, device=dev)
        self.fail = torch.zeros((), dtype=torch.bool, device=dev)

    def commit(self, W, chosen, taus, fail):
        self.Fstk.append(W)
        self.order.append(chosen)
        self.taus.append(taus)
        self.retired = self.retired.index_fill(0, chosen, 1.0)
        self.fail = self.fail | fail


def _first_row(st: _State, c: int) -> int:
    """A's first local row at or below global row ``c``: the first row a
    block's reflectors at row ``c`` reach (they are zero above it), and
    so the first every product with them reads or writes."""
    if st.mesh is None:
        return c
    return st.mesh.local_rows(st.A.shape[0], c, c)[0]


def _reads(st: _State, product: str, lo: int) -> None:
    """Count the rows ``product`` reads from local row ``lo`` against A's
    (the counter ``hqrrp.rows.<product>``)."""
    m = st.A.shape[0]
    count("hqrrp.rows." + product, m - lo, m)


def _rows_to_update(st: _State, lo: int):
    """A[lo:], to update in place. Where autograd records A (a CPU call:
    a CUDA call refuses autograd), a product has saved a view of A for
    the backward pass, so A is copied first."""
    if st.A.requires_grad:
        st.A = st.A.clone()
    return st.A[lo:]


def _live_cols(st: _State, X, live):
    """X ⊙ live over the columns. Every mask here goes on a thin factor;
    one the size of A counts as a masked copy (the counter
    ``hqrrp.masked_copies``)."""
    if X.numel() >= st.A.numel():
        count("hqrrp.masked_copies")
    return X * live[None, :]


def _block_step(st: _State, c: int, bsz: int, cfg: HQRRPConfig,
                timer: PhaseTimer = UNTIMED):
    """One HQRRP block with its trailing update applied at once (the
    ``update_defer = 1`` path, the timed path and the row-sharded mode),
    in the reference's slots (rl_hqrrp.hh:1150-1160), each a span and,
    under ``timing=True``, a ``timer`` phase. Every product with the
    block's reflectors reads the rows from ``c`` down only.

    With ``st.mesh``: K5 runs on the replicated Y and rank 0's pivots are
    broadcast; the panel as ``_panel`` says; VᵀV (``wy_T``), Wk = Vᵀ·A
    and G·V are psummed over each rank's rows from ``c`` down (in a
    trailing mode K1's form runs on them first); the update of A and of
    G's columns are row-local; the b rows of A and columns of G the Y
    downdate reads are gathered."""
    p, mesh = st.precision, st.mesh

    def psum(t):
        return t if mesh is None else mesh.psum(t)

    with timer.phase("qrcp"):
        live = 1.0 - st.retired
        chosen = qrcp_select_pivots_routed(st.Y, bsz, live, p,
                                           use_pallas=cfg.pallas_qrcp)
        if mesh is not None:
            chosen = mesh.broadcast(chosen)
    with timer.phase("qr"):
        panel = st.A.index_select(1, chosen)
        W, V, taus, sigma, failp = _panel(panel, c, cfg, p, mesh)
        chosen = chosen.index_select(0, sigma)
    lo = _first_row(st, c)
    with timer.phase("wy_t"):
        T, Vz = wy_T(V[lo:], taus, p, mesh)
        _reads(st, "wy_t", lo)
    with timer.phase("updating_A"):
        live2 = live.index_fill(0, chosen, 0.0)
        tp = cfg.trailing_precision
        if trailing_form(tp, st.A) == "highest":
            # Wk's retired columns are 0, and so are U's
            Wk = _live_cols(st, psum(matmul(Vz.T, st.A[lo:], p)), live2)
            U = matmul(T.T, Wk, p)
            A_lo = _rows_to_update(st, lo)
            if product_form(p, st.A) == "highest":
                A_lo.addmm_(Vz, U, alpha=-1.0)
            else:
                A_lo.sub_(matmul(Vz, U, p))
        else:
            Wk = psum(masked_vt_a_mixed(Vz, st.A[lo:], live2, tp))
            a_minus_vz_masked_mixed(_rows_to_update(st, lo), Vz,
                                    matmul(T.T, Wk, p), live2, tp)
        _reads(st, "vt_a", lo)
        _reads(st, "a_update", lo)
    with timer.phase("updating_sketch_g"):
        GV = psum(matmul(st.G[:, lo:], Vz, p))
        st.G = torch.cat([st.G[:, :lo], st.G[:, lo:]
                          - matmul(matmul(GV, T, p), Vz.T, p)], 1)
        _reads(st, "g_v", lo)
        _reads(st, "g_update", lo)
    with timer.phase("updating_sketch_y"):
        if mesh is None:
            B, R12 = st.G[:, c:c + bsz], st.A[c:c + bsz, :]
        else:
            B = mesh.rows_of(st.G.T, c, c + bsz).T
            R12 = mesh.rows_of(st.A, c, c + bsz)
        R12 = _live_cols(st, R12, live2)
        st.Y = st.Y - _live_cols(st, matmul(B, R12, p), live2)
    with timer.phase("downdating"):
        st.commit(W, chosen, taus, failp)


def _subblock_deferred(st: _State, c: int, bsz: int, j: int, agg,
                       cfg: HQRRPConfig):
    """One block inside an update-deferred group (slot ``j``): pivots and
    the exact sketch downdate run per block on lazily corrected operands,
    while the trailing update of A and the update of G are appended to the
    group aggregates ``agg = (Vg, Ug, Hg)`` (the JAX package's
    telescoping identities: A_j = A − Σ V_i U_i, G_j = G − Σ H_i V_iᵀ).
    Vg holds the rows from the group's first row c₀ = c − j·b down (the
    group's reflectors are zero above it), and so does the block's VᵀV;
    the block's other products read the rows from c down. Returns the new aggregates. The spans are
    ``_block_step``'s slots: ``updating_A`` forms the block's U (its
    trailing product with A), ``updating_sketch_g`` its H, ``downdating``
    the commit and the aggregates."""
    Vg, Ug, Hg = agg
    A, G, p = st.A, st.G, st.precision
    c0 = c - j * bsz
    r = c - c0                       # the block's first row in Vg

    with span("qrcp"):
        live = 1.0 - st.retired
        chosen = qrcp_select_pivots_routed(st.Y, bsz, live, p,
                                           use_pallas=cfg.pallas_qrcp)
    with span("qr"):
        panel = A.index_select(1, chosen)
        if j > 0:
            panel[c0:] -= matmul(Vg, Ug.index_select(1, chosen), p)
        W, V, taus, sigma, failp = _panel(panel, c, cfg, p)
        chosen = chosen.index_select(0, sigma)
    with span("wy_t"):
        # from the group's first row: Vz's rows in Vg's layout, zero above c
        T, Vz_g = wy_T(V[c0:], taus, p)
        Vz = Vz_g[r:]
        _reads(st, "wy_t", c0)
    with span("updating_A"):
        live2 = live.index_fill(0, chosen, 0.0)
        if trailing_form(cfg.trailing_precision, A) == "highest":
            Wk = _live_cols(st, matmul(Vz.T, A[c:], p), live2)
        else:
            Wk = masked_vt_a_mixed(Vz, A[c:], live2, cfg.trailing_precision)
        _reads(st, "vt_a", c)
        if j > 0:
            Wk = Wk - matmul(matmul(Vz.T, Vg[r:], p),
                             _live_cols(st, Ug, live2), p)
        U = matmul(T.T, Wk, p)
    with span("updating_sketch_g"):
        GV = matmul(G[:, c:], Vz, p)
        _reads(st, "g_v", c)
        if j > 0:
            GV = GV - matmul(Hg, matmul(Vg[r:].T, Vz, p), p)
        H = matmul(GV, T, p)
    with span("updating_sketch_y"):
        B = G[:, c:c + bsz]
        Vz_rows = Vz[:bsz]
        R12 = A[c:c + bsz, :]
        if j > 0:
            Vg_rows = Vg[r:r + bsz]
            B = B - matmul(Hg, Vg_rows.T, p)
            R12 = R12 - matmul(Vg_rows, Ug, p)
        B = B - matmul(H, Vz_rows.T, p)
        R12 = _live_cols(st, R12 - matmul(Vz_rows, U, p), live2)
        st.Y = st.Y - _live_cols(st, matmul(B, R12, p), live2)
    with span("downdating"):
        st.commit(W, chosen, taus, failp)
        if j == 0:
            return Vz_g, U, H
        return (torch.cat([Vg, Vz_g], 1), torch.cat([Ug, U], 0),
                torch.cat([Hg, H], 1))


def _blocks(st: _State, c0: int, nblocks: int, bsz: int,
            cfg: HQRRPConfig, timer: PhaseTimer = UNTIMED) -> None:
    """``nblocks`` blocks of ``bsz`` columns from rank position ``c0``, in
    groups of ``update_defer`` blocks with ONE k = g·b trailing update
    each (one block a group under ``timing=True``), each block a
    ``block`` span; a group's update of A is an ``updating_A`` span and
    of G an ``updating_sketch_g`` span beside its blocks, both on the
    rows and columns from the group's first row down."""
    g = 1 if timer is not UNTIMED else max(1, min(int(cfg.update_defer),
                                                 nblocks))
    if g == 1:
        for ib in range(nblocks):
            with span("block"):
                _block_step(st, c0 + ib * bsz, bsz, cfg, timer)
        return
    for i0 in range(0, nblocks, g):
        cg = c0 + i0 * bsz
        agg = (None, None, None)
        for j in range(min(g, nblocks - i0)):
            with span("block"):
                agg = _subblock_deferred(st, cg + j * bsz, bsz, j, agg, cfg)
        Vg, Ug, Hg = agg
        with span("updating_A"):
            # retired columns hold stale values every read masks out;
            # their final packed values live in Fstk
            live_end = 1.0 - st.retired
            A_lo = _rows_to_update(st, cg)
            Z = _live_cols(st, Ug, live_end)
            if trailing_form(cfg.trailing_precision, st.A) != "highest":
                a_minus_vz_masked_mixed(A_lo, Vg, Z, live_end,
                                        cfg.trailing_precision)
            elif product_form(st.precision, st.A) == "highest":
                A_lo.addmm_(Vg, Z, alpha=-1.0)
            else:
                A_lo.sub_(matmul(Vg, Z, st.precision))
            _reads(st, "a_update", cg)
        with span("updating_sketch_g"):
            st.G = torch.cat([st.G[:, :cg], st.G[:, cg:]
                              - matmul(Hg, Vg.T, st.precision)], 1)
            _reads(st, "g_update", cg)


def _hqrrp_core(A: torch.Tensor, cfg: HQRRPConfig, state: RNGState,
                precision=STABLE_PRECISION, timing: bool = False,
                sketch: torch.Tensor | None = None):
    """Shared core: returns ``(A_packed, R, taus, J, rank, fail, state,
    mesh[, phases])`` with ``A_packed`` the pivoted matrix in LAPACK GEQP3
    layout (R in the upper triangle, reflector tails below; this rank's
    rows under a mesh), R its K leading rows (replicated) and ``mesh`` that
    of the row-sharded mode (None for none or one rank). The call is the
    span ``hqrrp``, with ``sketch``, ``blocks`` (each block's slots) and
    ``epilogue`` inside."""
    with span("hqrrp", A.device):
        return _hqrrp_body(A, cfg, state, precision, timing, sketch)


def _hqrrp_body(A, cfg, state, precision, timing, sketch):
    require_fp32_matmul()
    mesh = _check_cfg(cfg, precision, A.device)
    precision = resolve_precision(precision)
    if A.device.type == "cuda":
        # K5/K6 run on every call: refuse vmap and autograd up front
        util.require_kernel_operands("hqrrp", A)
    require(A.dim() == 2, f"A must be a matrix, got shape {tuple(A.shape)}")
    if cfg.shard_axis is not None:
        # the row-sharded mode keeps the per-block updates, as JAX's does
        cfg = dataclasses.replace(cfg, update_defer=1)
    from ..parallel.mesh import shard_rows
    m, mesh = shard_rows(A, mesh, "hqrrp")
    timer = PhaseTimer() if timing else UNTIMED

    m_loc, n = A.shape
    dt, dev = A.dtype, A.device
    K = min(m, n)
    b = min(cfg.block_size, K)
    d = b + cfg.oversample
    nb_full, r = divmod(K, b)
    r0, r1 = (0, m) if mesh is None else mesh.rows(m_loc)

    with timer.phase("sketch"):
        # uniform sketch on [-1, 1), as the reference (ScalarDist::Uniform);
        # under a mesh each rank keeps G's columns of its rows, drawn whole
        gen, state = state.spawn(dev)
        if sketch is None:
            G = torch.rand((d, m), generator=gen, dtype=dt, device=dev)
            G = (2.0 * G - 1.0)[:, r0:r1].contiguous()
        else:
            require(tuple(sketch.shape) == (d, m_loc),
                    f"sketch must be {(d, m_loc)}, got "
                    f"{tuple(sketch.shape)}")
            G = sketch.to(device=dev, dtype=dt)
        Y = matmul(G, A, precision)
        if mesh is not None:
            Y = mesh.psum(Y)

    # the driver's own copy of A, updated in place
    st = _State(A.clone(memory_format=torch.contiguous_format), Y, G,
                precision, mesh)
    with timer.phase("blocks"):
        if timing and cfg.update_defer > 1:
            warnings.warn(
                "hqrrp(timing=True) forces eager trailing updates; "
                f"cfg.update_defer={cfg.update_defer} is ignored in "
                "the phase breakdown (time deferred configs with "
                "timing=False whole-run aggregates instead)",
                stacklevel=4)
        if nb_full:
            _blocks(st, 0, nb_full, b, cfg, timer)
        if r:
            _blocks(st, nb_full * b, 1, r, cfg, timer)

    with timer.phase("epilogue"):
        # pivots to the front in selection order; the rest keep their
        # relative order (only reachable when n > K)
        cols = torch.arange(n, device=dev)
        order = torch.cat(st.order)
        pos = torch.zeros(n, dtype=torch.int64, device=dev).index_put(
            (order,), torch.arange(K, device=dev))
        perm = torch.argsort(torch.where(st.retired > 0, pos, K + cols))
        A_perm = torch.cat([torch.cat(st.Fstk, 1),
                            st.A.index_select(1, perm[K:])], 1)
        R = torch.triu(A_perm[:K, :] if mesh is None
                       else mesh.rows_of(A_perm, 0, K))

    diag = torch.diagonal(R[:, :K])
    tol = diag[0].abs() * math.sqrt(torch.finfo(dt).eps)
    rank = util.naive_rank_est(diag, tol)
    out = (A_perm, R, torch.cat(st.taus), perm, rank, st.fail, state, mesh)
    return (*out, timer.report()) if timing else out


def _packed(A_perm, K: int, mesh):
    """The reflector tails strictly below the diagonal of A_perm's first K
    columns (this rank's rows under ``mesh``)."""
    if mesh is None:
        return torch.tril(A_perm[:, :K], -1)
    m = A_perm.shape[0]
    rows = mesh.rows(m)[0] + torch.arange(m, device=A_perm.device)
    cols = torch.arange(K, device=A_perm.device)
    return torch.where(rows[:, None] > cols[None, :], A_perm[:, :K], 0.0)


def _sharded_q(packed, taus, b: int, precision, mesh):
    """This rank's rows of Q = H₁·…·H_K·E from row-sharded packed
    reflectors: the blocked WY from the last block of ``b`` back, each
    block's VᵀQ psummed (as ``bqrrp_q(mesh=)``); block i leaves Q's
    columns before its first untouched, so it updates the rest only."""
    m, K = packed.shape
    dev = packed.device
    r0 = mesh.rows(m)[0]
    rows = r0 + torch.arange(m, device=dev)[:, None]
    lo, hi = mesh.local_rows(m, 0, K)
    diag = torch.arange(lo, hi, device=dev)
    Q = packed.new_zeros((m, K))
    Q[diag, r0 + diag] = 1.0
    for c in reversed(range(0, K, b)):
        e = min(c + b, K)
        heads = (rows == torch.arange(c, e, device=dev)[None, :])
        T, Vz = wy_T(packed[:, c:e] + heads.to(packed.dtype), taus[c:e],
                     precision, mesh)
        P = mesh.psum(matmul(Vz.T, Q[:, c:], precision))
        Q[:, c:] -= matmul(Vz, matmul(T, P, precision), precision)
    return Q


def hqrrp(A: torch.Tensor, cfg: HQRRPConfig, state: RNGState,
          precision=STABLE_PRECISION, timing: bool = False,
          sketch: torch.Tensor | None = None):
    """Randomized-pivoting Householder QR of A (any aspect ratio):
    A[:, J] ≈ Q·R.

    Returns ``(Q, R, J, rank, fail, next_state)``: Q (m, K) orthonormal
    (K = min(m, n)), a product of exact Householder reflectors; R (K, n)
    upper-trapezoidal; J (n,) int64 pivots; ``rank`` an int32 estimate
    from diag(R); ``fail`` the CholQR-panel breakdown flag (always False
    for Householder panels). ``sketch`` injects the (d, m) uniform
    operator G (d = block + oversample); when None, G is drawn from
    ``state`` on A's device. ``A`` is not modified. ``timing=True``
    appends a phase dict (sketch / blocks / epilogue and the seven
    per-block slots).

    Row-sharded mode (``cfg.shard_axis`` names the axis of the mesh set by
    ``parallel.set_mesh``; ``parallel.dist_hqrrp`` sets both): A is this
    rank's rows, ``sketch`` G's matching (d, m_local) column block (an
    undrawn G is drawn whole on every rank, each keeping its columns), Q
    comes back as this rank's rows and R, J, rank and fail replicated;
    ``update_defer`` is read as 1, as in the JAX package. A mesh of one
    rank is the unsharded call. Collectives a block: the pivots (K5 on the
    replicated sketch) broadcast from rank 0; a Householder panel (K6)
    gathered whole and its pivots and taus broadcast, or a CholQR panel's
    Grams, reflector norms and the b×b block K3 factors psummed; VᵀV,
    Vᵀ·A and G·V psummed; the b rows of A and columns of G the sketch
    downdate reads gathered. Q is formed by the blocked WY, each block's
    VᵀQ psummed."""
    out = _hqrrp_core(A, cfg, state, precision, timing, sketch)
    A_perm, R, taus, J, rank, fail, state, mesh = out[:8]
    K = R.shape[0]
    if mesh is None:
        Q = apply_reflectors(_packed(A_perm, K, None), taus)
    else:
        Q = _sharded_q(_packed(A_perm, K, mesh), taus,
                       min(cfg.block_size, K), precision, mesh)
    if timing:
        return Q, R, J, rank, fail, state, out[8]
    return Q, R, J, rank, fail, state


def hqrrp_lapack_format(A: torch.Tensor, cfg: HQRRPConfig,
                        state: RNGState, precision=STABLE_PRECISION,
                        sketch: torch.Tensor | None = None):
    """GEQP3-compatible output ``(packed, taus, R, J, next_state)``:
    ``packed`` (m, K) holds the reflector tails strictly below the
    diagonal (unit heads implicit) — HQRRP's native form (rl_hqrrp.hh:
    778-779). Form Q with :func:`randlapack_tpu_torch.ops.householder.
    apply_reflectors`. In the row-sharded mode (see :func:`hqrrp`)
    ``packed`` is this rank's rows, the rest replicated."""
    A_perm, R, taus, J, rank, fail, state, mesh = _hqrrp_core(
        A, cfg, state, precision, sketch=sketch)
    return _packed(A_perm, R.shape[0], mesh), taus, R, J, state
