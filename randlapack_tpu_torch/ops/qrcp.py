"""HQRRP's sketch-QRCP pivot pass and panel QR(CP) — replaces
``randlapack_tpu/ops/pallas_qrcp.py`` (its two Pallas kernels become the
hand-written CUDA kernels of ``csrc/qrcp.cu``):

    qrcp_select_pivots  greedy QRCP pivot order on a (d, n) sketch   (K5)
    qrcp_panel          full-height (m, b) panel QR(CP) from row0    (K6)

The ``*_routed`` functions keep the JAX package's signatures, so a JAX
configuration maps one-to-one. A CUDA tensor always takes the kernel
(f32 and f64, any size: where the slabs do not fit in shared memory the
kernel keeps them in device memory): only ``use_pallas="auto"`` is
accepted there, ``"never"`` raises, and the call never falls back to the
plain version. A CPU tensor takes the plain PyTorch version of
``ops/qr.py`` under either value.
"""
from __future__ import annotations

import torch

from ..errors import require
from .qr import qrcp_panel, qrcp_select_pivots
from .wy import _require_highest

# kernel launches since the last reset
LAUNCHES = {"qrcp_select_pivots": 0, "qrcp_panel": 0}

_KERNEL_DTYPES = (torch.float32, torch.float64)
_MAX_GRID = 1024            # csrc/qrcp.cu kMaxGrid: partial slots per call
_ROUTES = ("auto", "never")


def _check(t: torch.Tensor, what: str) -> None:
    require(t.device.type == "cuda", f"{what} takes CUDA tensors, got "
            f"{t.device}")
    require(t.dtype in _KERNEL_DTYPES, f"{what} dtype must be "
            f"float32/float64, got {t.dtype}")
    require(t.dim() == 2 and t.is_contiguous(),
            f"{what} takes a contiguous matrix, got {tuple(t.shape)}")
    require(all(s < 2**31 for s in t.shape), "dimension too large")


def qrcp_select_pivots_cuda(Y: torch.Tensor, nsteps: int,
                            live: torch.Tensor,
                            force_global: bool = False) -> torch.Tensor:
    """K5 on the card: all ``nsteps`` reflector steps in one cooperative
    launch. Y (d, n), live (n,) of Y's dtype → (nsteps,) int64 pivots.
    ``force_global`` keeps the slabs in device memory even where they
    would fit in shared memory (the path large sketches take)."""
    from .. import _build
    _check(Y, "qrcp_select_pivots_cuda")
    d, n = Y.shape
    require(live.shape == (n,) and live.dtype == Y.dtype
            and live.device == Y.device and live.is_contiguous(),
            f"live must be a contiguous ({n},) tensor like Y")
    require(0 <= nsteps <= min(d, n),
            f"nsteps must lie in [0, min(d, n)] = [0, {min(d, n)}], "
            f"got {nsteps}")
    chosen = torch.empty(nsteps, dtype=torch.int64, device=Y.device)
    if nsteps == 0:
        return chosen
    # d·n working copy, (3, n) column state, the pivot column and the
    # per-block partials (values, then int32 indices)
    work = torch.empty((d * n + 3 * n + d + _MAX_GRID) * Y.element_size()
                       + 4 * _MAX_GRID, dtype=torch.uint8, device=Y.device)
    _build.call("rl_qrcp_select_pivots", Y, Y, live, chosen, work, d, n,
                nsteps, int(force_global))
    LAUNCHES["qrcp_select_pivots"] += 1
    return chosen


def qrcp_panel_cuda(panel: torch.Tensor, row0: int, pivot: bool = True,
                    force_global: bool = False):
    """K6 on the card: the panel's ``b`` reflector steps in one
    cooperative launch. Returns ``(W, taus, sigma)`` in ``qrcp_panel``'s
    packed layout (sigma int64). ``row0`` is a host int with
    row0 + b ≤ m; rows < row0 are only permuted."""
    from .. import _build
    _check(panel, "qrcp_panel_cuda")
    m, b = panel.shape
    row0 = int(row0)
    require(0 <= row0 and row0 + b <= m,
            f"qrcp_panel_cuda needs 0 <= row0 and row0 + b <= m, got "
            f"row0={row0}, panel {tuple(panel.shape)}")
    W = torch.empty_like(panel)
    taus = torch.empty(b, dtype=panel.dtype, device=panel.device)
    sigma = torch.empty(b, dtype=torch.int64, device=panel.device)
    if b == 0:
        return W.copy_(panel), taus, sigma
    part = torch.empty(_MAX_GRID * (2 * b + 1) + b + 1, dtype=panel.dtype,
                       device=panel.device)
    _build.call("rl_qrcp_panel", panel, panel, W, taus, sigma, part, m, b,
                row0, int(bool(pivot)), int(force_global))
    LAUNCHES["qrcp_panel"] += 1
    return W, taus, sigma


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
    return True


def qrcp_select_pivots_routed(Y: torch.Tensor, nsteps: int,
                              live: torch.Tensor, precision="highest",
                              use_pallas: str = "auto") -> torch.Tensor:
    """``qrcp_select_pivots``: K5 for a CUDA tensor, the plain version for
    a CPU tensor. Returns (nsteps,) int64 pivots."""
    _require_highest(precision)
    if _take_kernel(Y, use_pallas):
        return qrcp_select_pivots_cuda(Y.contiguous(), nsteps,
                                       live.to(Y.dtype).contiguous())
    return qrcp_select_pivots(Y, nsteps, live)


def qrcp_panel_routed(panel: torch.Tensor, row0: int, pivot: bool = True,
                      precision="highest", use_pallas: str = "auto"):
    """``qrcp_panel``: K6 for a CUDA tensor (V rebuilt from the packed W:
    unit heads at row0 + l, tails below), the plain version for a CPU
    tensor. Same ``(W, V, taus, sigma)`` contract."""
    _require_highest(precision)
    if not _take_kernel(panel, use_pallas):
        return qrcp_panel(panel, row0, pivot)
    W, taus, sigma = qrcp_panel_cuda(panel.contiguous(), row0, pivot)
    m, b = panel.shape
    rows = torch.arange(m, device=panel.device)[:, None]
    diag = row0 + torch.arange(b, device=panel.device)[None, :]
    V = torch.where(rows > diag, W, 0.0) + (rows == diag).to(W.dtype)
    return W, V, taus, sigma
