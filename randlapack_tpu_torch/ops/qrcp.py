"""HQRRP's sketch-QRCP pivot pass and panel QR(CP) — replaces
``randlapack_tpu/ops/pallas_qrcp.py`` (its two Pallas kernels become the
hand-written CUDA kernels of ``csrc/qrcp.cu``):

    qrcp_select_pivots  greedy QRCP pivot order on a (d, n) sketch   (K5)
    qrcp_panel          full-height (m, b) panel QR(CP) from row0    (K6)

The ``*_routed`` functions keep the JAX package's signatures, so a JAX
configuration maps one-to-one. A CUDA tensor always takes a kernel (f32
and f64, any size): only ``use_pallas="auto"`` is accepted there,
``"never"`` raises, and the call never falls back to the plain version.
A CPU tensor takes the plain PyTorch version of ``ops/qr.py`` under
either value.

Each operation has two kernels. The step kernels (``qrcp_*_cuda``, counted
in ``LAUNCHES["qrcp_select_pivots"]`` / ``["qrcp_panel"]``) hold their
slabs in registers and exchange once (K5) or twice (K6) a reflector step;
the earlier cooperative kernels (``qrcp_*_coop``, counted apart) take the
shapes the step kernels cannot hold, which the card decides before the
launch (``csrc/qrcp.cu``). ``qrcp_select_pivots_schedule`` and
``qrcp_panel_schedule`` are plain PyTorch models of the step kernels'
schedule, for the tests.
"""
from __future__ import annotations

import functools

import torch

from ..config import resolve_precision
from ..errors import require
from .qr import (_drmac_downdate, _drmac_rule, qrcp_panel,
                 qrcp_select_pivots)
from .util import require_kernel_operands

# kernel launches since the last reset
LAUNCHES = {"qrcp_select_pivots": 0, "qrcp_panel": 0,
            "qrcp_select_pivots_coop": 0, "qrcp_panel_coop": 0}

_KERNEL_DTYPES = (torch.float32, torch.float64)
_MAX_GRID = 1024            # csrc/qrcp.cu kMaxGrid: partial slots per call
_SELECT_WARPS = 8           # csrc/qrcp.cu kSelWarps: K5 step kernel
_OFFER_COLS = 8             # kCols: the columns behind one offer
_ROUTES = ("auto", "never")


def _check(t: torch.Tensor, what: str) -> None:
    require(t.device.type == "cuda", f"{what} takes CUDA tensors, got "
            f"{t.device}")
    require(t.dtype in _KERNEL_DTYPES, f"{what} dtype must be "
            f"float32/float64, got {t.dtype}")
    require(t.dim() == 2 and t.is_contiguous(),
            f"{what} takes a contiguous matrix, got {tuple(t.shape)}")
    require(all(s < 2**31 for s in t.shape), "dimension too large")


@functools.lru_cache(maxsize=None)
def _step_grid(name: str, dtype: torch.dtype, index: int, *dims) -> int:
    """The grid of ``name``'s step kernel for these dimensions on card
    ``index``, 0 where the shape takes the cooperative kernel."""
    from .. import _build
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    with torch.cuda.device(index):
        return _build.lib()[name + "_grid" + suffix](*dims)


def _check_select(Y, nsteps, live):
    _check(Y, "qrcp_select_pivots")
    d, n = Y.shape
    require(live.shape == (n,) and live.dtype == Y.dtype
            and live.device == Y.device and live.is_contiguous(),
            f"live must be a contiguous ({n},) tensor like Y")
    require(0 <= nsteps <= min(d, n),
            f"nsteps must lie in [0, min(d, n)] = [0, {min(d, n)}], "
            f"got {nsteps}")
    return torch.empty(nsteps, dtype=torch.int64, device=Y.device)


def qrcp_select_pivots_cuda(Y: torch.Tensor, nsteps: int,
                            live: torch.Tensor) -> torch.Tensor:
    """K5 on the card: all ``nsteps`` reflector steps in one cooperative
    launch of the step kernel, or of the earlier kernel where the step
    kernel cannot hold the shape (d > 256, or more column slabs than fit
    on the card at once). Y (d, n), live (n,) of Y's dtype → (nsteps,)
    int64 pivots."""
    from .. import _build
    chosen = _check_select(Y, nsteps, live)
    d, n = Y.shape
    grid = _step_grid("rl_qrcp_select_pivots", Y.dtype,
                      Y.device.index or 0, d, n)
    if grid == 0:
        return qrcp_select_pivots_coop(Y, nsteps, live)
    if nsteps == 0:
        return chosen
    # each warp's offered column and (value, index), for two steps
    offers = 2 * grid * _SELECT_WARPS
    work = torch.empty(offers * ((d + 1) * Y.element_size() + 4),
                       dtype=torch.uint8, device=Y.device)
    _build.call("rl_qrcp_select_pivots", Y, Y, live, chosen, work, d, n,
                nsteps)
    LAUNCHES["qrcp_select_pivots"] += 1
    return chosen


def qrcp_select_pivots_coop(Y: torch.Tensor, nsteps: int,
                            live: torch.Tensor,
                            force_global: bool = False) -> torch.Tensor:
    """K5's earlier cooperative kernel (slabs in shared memory, two grid
    exchanges a step). ``force_global`` keeps the slabs in device memory
    even where they would fit in shared memory (the path large sketches
    take)."""
    from .. import _build
    chosen = _check_select(Y, nsteps, live)
    if nsteps == 0:
        return chosen
    d, n = Y.shape
    # d·n working copy, (3, n) column state, the pivot column and the
    # per-block partials (values, then int32 indices)
    work = torch.empty((d * n + 3 * n + d + _MAX_GRID) * Y.element_size()
                       + 4 * _MAX_GRID, dtype=torch.uint8, device=Y.device)
    _build.call("rl_qrcp_select_pivots_coop", Y, Y, live, chosen, work, d,
                n, nsteps, int(force_global))
    LAUNCHES["qrcp_select_pivots_coop"] += 1
    return chosen


def _check_panel(panel, row0):
    _check(panel, "qrcp_panel")
    m, b = panel.shape
    require(0 <= row0 and row0 + b <= m,
            f"qrcp_panel needs 0 <= row0 and row0 + b <= m, got "
            f"row0={row0}, panel {tuple(panel.shape)}")
    return (torch.empty_like(panel),
            torch.empty(b, dtype=panel.dtype, device=panel.device),
            torch.empty(b, dtype=torch.int64, device=panel.device))


def qrcp_panel_cuda(panel: torch.Tensor, row0: int, pivot: bool = True):
    """K6 on the card: the panel's ``b`` reflector steps in one
    cooperative launch of the step kernel, or of the earlier kernel where
    the step kernel cannot hold the shape (b > 128, or more row slabs than
    fit on the card at once). Returns ``(W, taus, sigma)`` in
    ``qrcp_panel``'s packed layout (sigma int64). ``row0`` is a host int
    with row0 + b ≤ m; rows < row0 are only permuted."""
    from .. import _build
    row0 = int(row0)
    W, taus, sigma = _check_panel(panel, row0)
    m, b = panel.shape
    grid = (_step_grid("rl_qrcp_panel", panel.dtype,
                       panel.device.index or 0, m, b, row0) if b else 0)
    if grid == 0:
        return qrcp_panel_coop(panel, row0, pivot)
    # dots and sums of squares of every block, and one row
    part = torch.empty((2 * grid + 1) * b, dtype=panel.dtype,
                       device=panel.device)
    _build.call("rl_qrcp_panel", panel, panel, W, taus, sigma, part, m, b,
                row0, int(bool(pivot)))
    LAUNCHES["qrcp_panel"] += 1
    return W, taus, sigma


def qrcp_panel_coop(panel: torch.Tensor, row0: int, pivot: bool = True,
                    force_global: bool = False):
    """K6's earlier cooperative kernel (slabs in shared memory, three grid
    exchanges a step), with ``qrcp_panel_cuda``'s contract;
    ``force_global`` keeps the slabs in device memory."""
    from .. import _build
    row0 = int(row0)
    W, taus, sigma = _check_panel(panel, row0)
    m, b = panel.shape
    if b == 0:
        return W.copy_(panel), taus, sigma
    part = torch.empty(_MAX_GRID * (2 * b + 1) + b + 1, dtype=panel.dtype,
                       device=panel.device)
    _build.call("rl_qrcp_panel_coop", panel, panel, W, taus, sigma, part, m,
                b, row0, int(bool(pivot)), int(force_global))
    LAUNCHES["qrcp_panel_coop"] += 1
    return W, taus, sigma


def _reflector(norm2, xi):
    """larfg's scalars from a squared norm and the head, as the step
    kernels compute them: (tau, divisor of the tail, alpha)."""
    zero = torch.zeros((), dtype=xi.dtype, device=xi.device)
    one = torch.ones((), dtype=xi.dtype, device=xi.device)
    normx = torch.sqrt(norm2)
    alpha = torch.where(xi >= 0, -normx, normx)
    denom = xi - alpha
    safe = denom.abs() > 0
    tau = torch.where(safe, (alpha - xi) / torch.where(alpha != 0, alpha,
                                                       one), zero)
    tau = torch.where(normx > 0, tau, zero)
    alpha = torch.where(normx > 0, alpha, xi)
    return tau, torch.where(safe, denom, one), alpha


def qrcp_select_pivots_schedule(Y: torch.Tensor, nsteps: int,
                                live: torch.Tensor,
                                offer_cols: int = _OFFER_COLS):
    """Plain PyTorch model of K5's step kernel: each group of
    ``offer_cols`` columns (a warp's) offers its best column, the pivot is
    the best offer, and the reflector is built from the offered column.
    Same contract as ``qrcp_select_pivots``."""
    d, n = Y.shape
    dev = Y.device
    cols = torch.arange(n, device=dev)
    avail = live > 0
    W = torch.where(avail[None, :], Y, 0.0)
    dN = torch.sqrt((W * W).sum(0))
    eN = dN
    rows = torch.arange(d, device=dev)
    G = -(-n // offer_cols)
    chosen = torch.zeros(nsteps, dtype=torch.int64, device=dev)
    for l in range(nsteps):
        score = torch.where(avail, dN, -1.0)
        pad = torch.full((G * offer_cols - n,), -2.0, dtype=Y.dtype,
                         device=dev)
        groups = torch.cat([score, pad]).view(G, offer_cols)
        offer = groups.argmax(1)              # each group's best, first wins
        g = int(groups[torch.arange(G, device=dev), offer].argmax())
        p = g * offer_cols + int(offer[g])
        chosen[l] = p
        avail = avail & (cols != p)
        x = W[:, p]                           # the winner's offered column
        tau, denom, _ = _reflector(
            (torch.where(rows >= l, x, 0.0) ** 2).sum(), x[l])
        v = torch.where(rows > l, x / denom, (rows == l).to(Y.dtype))
        w = torch.where(avail, tau * (v @ W), 0.0)
        W = W - torch.outer(v, w)
        dN, eN = _drmac_downdate(W, l, W[l, :], dN, eN, avail)
    return chosen


def qrcp_panel_schedule(panel: torch.Tensor, row0: int, pivot: bool = True):
    """Plain PyTorch model of K6's step kernel. The columns never move: a
    logical map decides ties as the swapped panel would. Step l's norm
    and head come from the previous step's sums of squares of rows ≥ i
    and its row i (exchange A), the Drmač downdate of step l − 1 runs
    once those are known, and the columns take their logical places at
    the end. Same contract as ``qrcp_panel``."""
    m, b = panel.shape
    dev = panel.device
    rows = torch.arange(m, device=dev)
    W = panel.clone()
    taus = torch.zeros(b, dtype=panel.dtype, device=dev)
    ph = torch.arange(b, device=dev)          # logical -> physical
    live = torch.ones(b, dtype=torch.bool, device=dev)
    S, H = (W[row0:] ** 2).sum(0), W[row0].clone()
    dN = torch.sqrt(S)
    eN = dN
    for l in range(b):
        i = row0 + l
        if pivot and l > 0:
            dN, eN = _drmac_rule(dN, eN, r_row, torch.sqrt(S), live)
        lp = l + int(torch.argmax(dN[ph[l:]])) if pivot else l
        p = int(ph[lp])
        ph[lp], ph[l] = ph[l].clone(), p
        tau, denom, alpha = _reflector(S[p], H[p])
        x = W[:, p]
        v = torch.where(rows > i, x / denom, (rows == i).to(W.dtype))
        W[:, p] = torch.where(rows > i, v, torch.where(rows == i, alpha, x))
        live[p] = False
        taus[l] = tau
        if l + 1 == b:
            break
        tw = tau * (v[i:] @ W[i:])
        W[i:] = torch.where(live[None, :], W[i:] - torch.outer(v[i:], tw),
                            W[i:])
        r_row = H - tw
        S, H = (W[i + 1:] ** 2).sum(0), W[i + 1].clone()
    W = W[:, ph]
    V = torch.where(rows[:, None] > row0 + torch.arange(b, device=dev), W,
                    0.0) + (rows[:, None] == row0 + torch.arange(
                        b, device=dev)).to(W.dtype)
    return W, V, taus, ph


def _take_kernel(t: torch.Tensor, use_pallas: str) -> bool:
    require(use_pallas in _ROUTES, f"use_pallas must be one of {_ROUTES}, "
            f"got {use_pallas!r}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {t.device}")
    if use_pallas != "auto":
        raise NotImplementedError(
            f"use_pallas={use_pallas!r} on a CUDA tensor: a CUDA tensor "
            "always takes the kernel, only 'auto' is accepted there")
    require_kernel_operands("K5/K6", t)
    return True


def qrcp_select_pivots_routed(Y: torch.Tensor, nsteps: int,
                              live: torch.Tensor, precision="highest",
                              use_pallas: str = "auto") -> torch.Tensor:
    """``qrcp_select_pivots``: K5 for a CUDA tensor, the plain version for
    a CPU tensor. Returns (nsteps,) int64 pivots. K5 ignores
    ``precision``, as the Pallas kernel does; the plain version takes it."""
    precision = resolve_precision(precision)
    if _take_kernel(Y, use_pallas):
        return qrcp_select_pivots_cuda(Y.contiguous(), nsteps,
                                       live.to(Y.dtype).contiguous())
    return qrcp_select_pivots(Y, nsteps, live, precision)


def qrcp_panel_routed(panel: torch.Tensor, row0: int, pivot: bool = True,
                      precision="highest", use_pallas: str = "auto"):
    """``qrcp_panel``: K6 for a CUDA tensor (V rebuilt from the packed W:
    unit heads at row0 + l, tails below), the plain version for a CPU
    tensor. Same ``(W, V, taus, sigma)`` contract. K6 ignores
    ``precision``, as the Pallas kernel does; the plain version takes it."""
    precision = resolve_precision(precision)
    if not _take_kernel(panel, use_pallas):
        return qrcp_panel(panel, row0, pivot, precision)
    W, taus, sigma = qrcp_panel_cuda(panel.contiguous(), row0, pivot)
    m, b = panel.shape
    rows = torch.arange(m, device=panel.device)[:, None]
    diag = row0 + torch.arange(b, device=panel.device)[None, :]
    V = torch.where(rows > diag, W, 0.0) + (rows == diag).to(W.dtype)
    return W, V, taus, sigma
