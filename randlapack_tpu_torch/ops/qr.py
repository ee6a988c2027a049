"""QR kernels (counterpart of ``randlapack_tpu/ops/qr.py``): Householder
QR, column-pivoted Householder QR (``geqp3``), HQRRP's sketch pivot pass
and panel QR(CP) with Drmač norm downdating, the compact-WY T factor,
and LU-based pivot selection (the reference BQRRP's ``luqr`` qrcp_wide,
rl_bqrrp.hh:339-356) through ``lu_factor``, the port's one pivoted LU
(PLU stabilization in ``comps.orth`` takes it too).

``qrcp_select_pivots`` and ``qrcp_panel`` are the plain versions of the
kernels K5 and K6 (``ops/qrcp.py``, ``csrc/qrcp.cu``): Python loops of
small tensor ops, one reflector step per iteration, with the JAX
package's masking, penalties and tie rules kept as they are. Their
per-step pivots and taus are gathered and stacked, not written into
preallocated buffers, so ``torch.func.vmap`` batches them.
``precision`` sets the reflector products (``ops.util.matmul``)."""
from __future__ import annotations

import ctypes
import math

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require
from .cholqr import _pow2
from .util import is_batched, matmul


def qr_econ(A: torch.Tensor):
    """Economy Householder QR → (Q, R)."""
    return torch.linalg.qr(A, mode="reduced")


def qr_econ_rows(A: torch.Tensor, mesh=None):
    """``qr_econ`` of A; with ``mesh`` (a ``parallel.Mesh``), A holds this
    rank's rows of a row-sharded matrix, which is gathered whole (a rescue
    path of the sharded drivers): R is rank 0's, broadcast, and each rank
    keeps its rows of Q."""
    if mesh is None:
        return qr_econ(A)
    Q, R = qr_econ(mesh.gather_rows(A))
    r0, r1 = mesh.rows(A.shape[0])
    return Q[r0:r1].contiguous(), mesh.broadcast(R.contiguous())


def lu_factor_backward(LU: torch.Tensor, piv: torch.Tensor,
                       gLU: torch.Tensor) -> torch.Tensor:
    """The gradient of A from that of the packed L\\U of A = P·L·U (m×n,
    ``piv`` LAPACK's 1-based row swaps). With B = Pᵀ·A = L·U, k = min(m,
    n), L₁ and U₁ the leading k×k blocks, L₂ the rows of L below them and
    U₂ the columns of U right of them: X = L₁⁻¹·dB₁·U₁⁻¹ gives dL₁ =
    L₁·tril(X, −1) and dU₁ = triu(X)·U₁; dL₂ = (dB₂ − L₂·dU₁)·U₁⁻¹ (tall)
    and dU₂ = L₁⁻¹·(dB₂ − dL₁·U₂) (wide). So gB₂ = gL₂·U₁⁻ᵀ (tall) or
    L₁⁻ᵀ·gU₂ (wide), gB₁ = L₁⁻ᵀ·(tril(L₁ᵀ·gL₁', −1) + triu(gU₁'·U₁ᵀ))·U₁⁻ᵀ
    with gU₁' = gU₁ − L₂ᵀ·gB₂ (tall), gL₁' = gL₁ − gB₂·U₂ᵀ (wide), and gA =
    P·gB."""
    m, n = LU.shape
    k = min(m, n)
    L1 = torch.tril(LU[:k, :k], -1) + torch.eye(k, dtype=LU.dtype,
                                                device=LU.device)
    U1 = torch.triu(LU[:k, :k])
    gL1, gU1 = torch.tril(gLU[:k, :k], -1), torch.triu(gLU[:k, :k])
    if m >= n:
        gB2 = torch.linalg.solve_triangular(U1.mT, gLU[k:], upper=False,
                                            left=False)
        gU1 = gU1 - LU[k:].mT @ gB2
    else:
        gB2 = torch.linalg.solve_triangular(L1.mT, gLU[:, k:], upper=True,
                                            unitriangular=True)
        gL1 = gL1 - gB2 @ LU[:, k:].mT
    gX = torch.tril(L1.mT @ gL1, -1) + torch.triu(gU1 @ U1.mT)
    gB1 = torch.linalg.solve_triangular(
        L1.mT, torch.linalg.solve_triangular(U1.mT, gX, upper=False,
                                             left=False),
        upper=True, unitriangular=True)
    gA = torch.cat([gB1, gB2], dim=0 if m >= n else 1)
    for i, p in reversed(list(enumerate(piv.tolist()))):
        if p - 1 != i:          # the swaps undone in reverse order
            gA[[i, p - 1]] = gA[[p - 1, i]]
    return gA


class _GetrfLU(torch.autograd.Function):
    """cuSOLVER's getrf (``csrc/getrf.cu``) of a CUDA f32/f64 matrix; its
    backward is ``lu_factor_backward``."""

    @staticmethod
    def forward(ctx, A):
        from .. import _build
        m, n = A.shape
        F = A.mT.contiguous()            # A column-major, lda m, in place
        lwork = ctypes.c_int(0)
        _build.call("rl_getrf_lwork", F, F, m, n, ctypes.addressof(lwork))
        work = torch.empty(max(lwork.value, 1), dtype=A.dtype,
                           device=A.device)
        piv = torch.empty(min(m, n), dtype=torch.int32, device=A.device)
        info = torch.empty((), dtype=torch.int32, device=A.device)
        _build.call("rl_getrf", F, F, work, piv, info, m, n)
        LU = F.mT
        ctx.save_for_backward(LU, piv)
        ctx.mark_non_differentiable(piv, info)
        return LU, piv, info

    @staticmethod
    def backward(ctx, gLU, _gpiv, _ginfo):
        return lu_factor_backward(*ctx.saved_tensors, gLU)


def lu_factor(A: torch.Tensor):
    """``torch.linalg.lu_factor_ex(A)`` → ``(LU, pivots, info)``: the
    packed L\\U, 1-based int32 row swaps and LAPACK's info. On the card it is cuSOLVER's getrf, called through
    ``csrc/getrf.cu`` on PyTorch's current stream: for a tall matrix the
    library's own choice of backend (MAGMA) takes several times as long
    with the same pivots (``chip_smoke.py``'s ``[revd2-lu]`` line), and
    asking PyTorch for cuSOLVER would take ``torch.backends.cuda.
    preferred_linalg_library``, a setting of the whole process. A backend
    the caller has chosen there stands. Differentiable; under
    ``torch.func.vmap`` a CUDA tensor raises, as the kernels do."""
    if (A.device.type != "cuda"
            or torch._C._get_linalg_preferred_backend()
            != torch._C._LinalgBackend.Default):   # read, never written
        return torch.linalg.lu_factor_ex(A)
    require(A.dim() == 2 and A.numel() > 0
            and A.dtype in (torch.float32, torch.float64),
            f"lu_factor: a nonempty f32/f64 matrix on the card, got "
            f"{tuple(A.shape)} {A.dtype}")
    require(not is_batched(A), "lu_factor: torch.func.vmap over a CUDA "
            "tensor is not supported: the cuSOLVER call has no batching rule")
    return _GetrfLU.apply(A)


def lu_pivot_columns(A_panel_t: torch.Tensor) -> torch.Tensor:
    """Column-pivot selection via partial-pivoted LU (rl_bqrrp.hh:339-349):
    getrf on the transposed sketch panel; the LU row permutation of A_skᵀ
    is the column pivot order of A_sk.

    ``A_panel_t``: (n, d) = transposed d×n sketch panel. Returns the full
    length-n permutation (int64; the first d entries are the chosen pivot
    columns, in order), computed on the input's device.
    """
    A_panel_t = torch.where(torch.isfinite(A_panel_t), A_panel_t,
                            torch.zeros((), dtype=A_panel_t.dtype,
                                        device=A_panel_t.device))
    # STRUCTURAL-DEFICIENCY PAD, kept verbatim from the JAX package because
    # it decides pivots at ties: a cyclic identity pattern at
    # δ = 2^(e_max − 40) (an exact power of two) makes every LU pivot
    # nonzero when fewer than d rows are live, while sitting 2^-40 below
    # the data scale
    n, d = A_panel_t.shape
    mx = A_panel_t.abs().max()
    e = torch.floor(torch.log2(torch.where(mx > 0, mx, 1.0))).to(torch.int32)
    delta = _pow2(e - 40, A_panel_t.dtype)
    rows = torch.arange(n, device=A_panel_t.device)
    pad = torch.zeros_like(A_panel_t)
    pad[rows, rows % d] = delta
    LU, piv, _ = lu_factor(A_panel_t + pad)
    # A = P·L·U, so row i of L·U is row perm[i] of A, the column that
    # holds P's one in column i
    P, _, _ = torch.lu_unpack(LU, piv, unpack_data=False)
    return P.argmax(0)


def _larfg(x: torch.Tensor, i: int):
    """Householder reflector annihilating x[i+1:] with rows < i masked out
    (LAPACK larfg semantics). Returns ``(v, tau, alpha)``: v with v[i] = 1
    and zeros in rows < i, H = I − tau·v·vᵀ, H·x = alpha·e_i on the
    masked part. A zero column gives tau = 0 and alpha = x[i]."""
    m = x.shape[0]
    rows = torch.arange(m, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    xm = torch.where(rows >= i, x, zero)
    xi = x[i]
    normx = torch.linalg.vector_norm(xm)
    sign = torch.where(xi >= 0, one, -one)
    alpha = -sign * normx
    denom = xi - alpha
    safe = denom.abs() > 0
    denom_s = torch.where(safe, denom, one)
    v = torch.where(rows > i, xm / denom_s, zero)
    v[i] = 1.0
    tau = torch.where(safe, (alpha - xi) / torch.where(alpha != 0, alpha,
                                                       one), zero)
    tau = torch.where(normx > 0, tau, zero)
    alpha = torch.where(normx > 0, alpha, xi)
    return v, tau, alpha


def _swap_perm(cols, l: int, p):
    """The permutation that swaps positions ``l`` and ``p`` (a 0-d
    tensor), as a gather index."""
    return torch.where(cols == l, p, torch.where(cols == p, l, cols))


def geqp3(A: torch.Tensor, k: int | None = None, want_q: bool = True,
          pivot: bool = True, precision=STABLE_PRECISION):
    """Column-pivoted Householder QR (GEQP3 capability): greedy max-norm
    pivoting with squared-norm downdating over (at most) k columns.
    Returns ``(Q, R, J)``: Q (m×k) explicit (None if ``want_q=False``), R
    (k×n) upper-trapezoidal of the pivoted matrix, J (n,) int64 with
    A[:, J] ≈ Q·R. O(m·n·k) work in k steps: for small matrices."""
    precision = resolve_precision(precision)
    m, n = A.shape
    k = min(min(m, n) if k is None else k, m, n)
    dev = A.device
    cols = torch.arange(n, device=dev)
    rows = torch.arange(m, device=dev)
    W = A.clone()
    V = torch.zeros((m, k), dtype=A.dtype, device=dev)
    taus = torch.zeros(k, dtype=A.dtype, device=dev)
    J = torch.arange(n, device=dev)
    cn2 = (A * A).sum(0)
    for i in range(k):
        if pivot:
            # finite penalty on the columns already factored (cn2 >= 0)
            p = torch.argmax(torch.where(cols >= i, cn2, -1.0))
            perm = _swap_perm(cols, i, p)
            W = W.index_select(1, perm)
            J = J.index_select(0, perm)
            cn2 = cn2.index_select(0, perm)
        v, tau, alpha = _larfg(W[:, i], i)
        w = torch.where(cols >= i, tau * matmul(v, W, precision), 0.0)
        W = W - torch.outer(v, w)
        coli = torch.where(rows < i, W[:, i], 0.0)
        coli[i] = alpha
        W[:, i] = coli
        V[:, i] = v
        taus[i] = tau
        cn2 = torch.where(cols > i, torch.clamp(cn2 - W[i, :] ** 2, min=0.0),
                          cn2)
    R = torch.triu(W[:k, :])
    Q = None
    if want_q:
        packed = torch.tril(V, -1) + torch.eye(m, k, dtype=A.dtype,
                                                device=dev)
        Q = torch.linalg.householder_product(packed, taus)
    return Q, R, J


def _drmac_downdate(W, i: int, r_row, dN, eN, update_mask):
    """Drmač partial-norm downdating with cancellation-triggered exact
    recompute (rl_hqrrp.hh::NoFLA_QRP_downdate_partial_norms :360-411,
    LAPACK dlaqp2's rule). ``W`` is the working matrix after step ``i``'s
    reflector, ``r_row`` = W[i, :], ``update_mask`` (bool) the columns to
    downdate. Returns ``(dN, eN)``."""
    return _drmac_rule(dN, eN, r_row, torch.sqrt((W[i + 1:] ** 2).sum(0)),
                       update_mask)


def _drmac_rule(dN, eN, r_row, trail, update_mask):
    """``_drmac_downdate`` given the exact trailing norms ``trail``."""
    tol3z = math.sqrt(torch.finfo(dN.dtype).eps)
    one = torch.ones((), dtype=dN.dtype, device=dN.device)
    dsafe = torch.where(dN > 0, dN, one)
    esafe = torch.where(eN > 0, eN, one)
    temp = r_row.abs() / dsafe
    temp = torch.clamp((1.0 + temp) * (1.0 - temp), min=0.0)
    temp5 = dN / esafe
    temp2 = temp * temp5 * temp5
    recompute = temp2 <= tol3z
    d_new = torch.where(recompute, trail, dN * torch.sqrt(temp))
    e_new = torch.where(recompute, trail, eN)
    keep = ~update_mask | (dN == 0)
    return torch.where(keep, dN, d_new), torch.where(keep, eN, e_new)


def qrcp_select_pivots(Y: torch.Tensor, nsteps: int, live: torch.Tensor,
                       precision=STABLE_PRECISION):
    """Plain version of K5: greedy Householder-QRCP pivot selection on a
    (d × n) sketch restricted to ``live`` columns — the reference HQRRP's
    per-block QRCP of the downdated sketch (rl_hqrrp.hh::
    NoFLA_QRPmod_WY_unb_var4 :557, pivoting=1) with Drmač downdating.
    Columns are never swapped: step l's reflector is built from pivot
    column p_l on rows ≥ l and applied to the remaining available
    columns. The pivot is the FIRST index of the masked maximum;
    unavailable columns score −1. Returns (nsteps,) int64 indices in
    pivot order."""
    precision = resolve_precision(precision)
    d, n = Y.shape
    dev = Y.device
    cols = torch.arange(n, device=dev)
    avail = live > 0
    W = torch.where(avail[None, :], Y, 0.0)
    dN = torch.linalg.vector_norm(W, dim=0)
    eN = dN
    chosen = []
    for i in range(nsteps):
        p = torch.argmax(torch.where(avail, dN, -1.0))
        chosen.append(p)
        avail = avail & (cols != p)
        v, tau, _ = _larfg(W.index_select(1, p.view(1))[:, 0], i)
        w = torch.where(avail, tau * matmul(v, W, precision), 0.0)
        W = W - torch.outer(v, w)
        dN, eN = _drmac_downdate(W, i, W[i, :], dN, eN, avail)
    return (torch.stack(chosen) if chosen
            else torch.zeros(0, dtype=torch.int64, device=dev))


def qrcp_panel(panel: torch.Tensor, row0: int, pivot: bool = True,
               precision=STABLE_PRECISION):
    """Plain version of K6: unblocked Householder QR(CP) of a full-height
    panel whose factorization starts at row ``row0`` (rl_hqrrp.hh:1088,
    NoFLA_QRPmod_WY_unb_var4 on A[j:, j:j+b]). Reflector l has its head at
    row row0 + l; rows < row0 hold earlier R12 values, are never
    transformed and move only with the column swaps.

    Returns ``(W, V, taus, sigma)``: W (m, b) in LAPACK packed layout at
    offset row0 (R above, alpha on the diagonal, reflector tails below),
    V (m, b) the explicit reflectors (unit head, zeros above), taus (b,),
    sigma (b,) int64 the in-panel pivot order (identity when
    ``pivot=False``)."""
    precision = resolve_precision(precision)
    m, b = panel.shape
    dev = panel.device
    rows = torch.arange(m, device=dev)
    cols = torch.arange(b, device=dev)
    W = panel.clone()
    V = torch.zeros_like(panel)
    taus = []
    sigma = torch.arange(b, device=dev)
    dN = torch.linalg.vector_norm(panel[row0:], dim=0)
    eN = dN
    for l in range(b):
        i = row0 + l
        if pivot:
            p = torch.argmax(torch.where(cols >= l, dN, -1.0))
            perm = _swap_perm(cols, l, p)
            W = W.index_select(1, perm)
            sigma = sigma.index_select(0, perm)
            dN = dN.index_select(0, perm)
            eN = eN.index_select(0, perm)
        v, tau, alpha = _larfg(W[:, l], i)
        w = torch.where(cols >= l, tau * matmul(v, W, precision), 0.0)
        # the update selects rows >= i of columns >= l rather than relying
        # on v's and w's zeros elsewhere: on finite data the two agree, and
        # where a norm has left the range (tau not finite) rows < row0 and
        # finished columns keep their values, as the docstring says and
        # the kernel does
        W = torch.where((rows >= i)[:, None] & (cols >= l)[None, :],
                        W - torch.outer(v, w), W)
        # column l packed: R above, alpha at row i, the tail of v below
        W[:, l] = torch.where(rows < i, W[:, l],
                              torch.where(rows == i, alpha, v))
        V[:, l] = v
        taus.append(tau)
        if pivot:
            dN, eN = _drmac_downdate(W, i, W[i, :], dN, eN, cols > l)
    return W, V, (torch.stack(taus) if taus else
                  torch.zeros(0, dtype=panel.dtype, device=dev)), sigma


def wy_T(V: torch.Tensor, taus: torch.Tensor, precision=STABLE_PRECISION,
         mesh=None):
    """Compact-WY triangular factor: T (b×b upper) with
    H₁·…·H_b = I − V·T·Vᵀ (LAPACK larft, forward/columnwise), built from
    T⁻¹ = diag(1/τ) + strict_upper(VᵀV) by one triangular solve.
    τ = 0 (identity reflector) columns are zeroed in V and get a unit
    diagonal. Returns ``(T, Vz)`` with Vz the zeroed V. With ``mesh`` (a
    ``parallel.Mesh``), V holds this rank's rows and VᵀV is psummed."""
    b = taus.shape[0]
    active = taus != 0
    Vz = torch.where(active[None, :], V, 0.0)
    S = matmul(Vz.T, Vz, precision)
    if mesh is not None:
        S = mesh.psum(S)
    one = torch.ones((), dtype=V.dtype, device=V.device)
    tinv = torch.where(active, 1.0 / torch.where(active, taus, one), one)
    Tinv = torch.triu(S, 1) + torch.diag(tinv)
    T = torch.linalg.solve_triangular(
        Tinv, torch.eye(b, dtype=V.dtype, device=V.device), upper=True)
    return T, Vz
