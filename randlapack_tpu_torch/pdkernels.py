"""Positive-definite kernel utilities + kernel linear operator
(counterpart of ``randlapack_tpu/pdkernels.py``; reference:
RandLAPACK/misc/rl_pdkernels.hh: standardize_dataset :34,
euclidean_distance_submatrix :74, squared_exp_kernel :102,
squared_exp_kernel_submatrix :133, block_arrowhead_multiply :161).

Data convention: X is (d, n) — n points in d dimensions, one point per
column (the reference's convention). All distance math is GEMM-based.
"""
from __future__ import annotations

import torch

from .config import STABLE_PRECISION, resolve_precision
from .errors import require
from .ops.kernels import kernel_matmat, kernel_matmat_reference
from .ops.util import matmul, require_kernel_operands
from .ops.wy import _device_route


def standardize_dataset(X: torch.Tensor) -> torch.Tensor:
    """Center each coordinate (row) and scale so the average squared column
    norm is the dimension count — the reference's preprocessing for kernel
    matrices with unit diagonal scale."""
    Xc = X - X.mean(dim=1, keepdim=True)
    scale = torch.sqrt(torch.mean(torch.sum(Xc * Xc, dim=0)) / X.shape[0])
    return Xc / torch.clamp(scale, min=torch.finfo(X.dtype).tiny)


def squared_distances(XI: torch.Tensor, XJ: torch.Tensor,
                      precision=STABLE_PRECISION) -> torch.Tensor:
    """Pairwise squared Euclidean distances between columns of XI (d,p) and
    XJ (d,q) → (p, q); GEMM-based (euclidean_distance_submatrix), the
    cross term at ``precision`` (``ops.util.matmul``)."""
    ni = torch.sum(XI * XI, dim=0)
    nj = torch.sum(XJ * XJ, dim=0)
    return torch.clamp(
        ni[:, None] + nj[None, :] - 2.0 * matmul(XI.T, XJ, precision),
        min=0.0)


def squared_exp_kernel(XI: torch.Tensor, XJ: torch.Tensor, bandwidth,
                       precision=STABLE_PRECISION) -> torch.Tensor:
    """k(x, y) = exp(−‖x−y‖² / (2σ²)) for all column pairs."""
    return torch.exp(-squared_distances(XI, XJ, precision)
                     / (2.0 * bandwidth ** 2))


def squared_exp_kernel_submatrix(X: torch.Tensor, rows: torch.Tensor,
                                 cols: torch.Tensor, bandwidth,
                                 precision=STABLE_PRECISION) -> torch.Tensor:
    """K[rows, cols] for the squared-exponential kernel over X (d, n)."""
    return squared_exp_kernel(X[:, rows], X[:, cols], bandwidth, precision)


def block_arrowhead_multiply(D_diag: torch.Tensor, B: torch.Tensor,
                             C: torch.Tensor, V: torch.Tensor,
                             precision=STABLE_PRECISION):
    """Multiply the block-arrowhead matrix [[diag(D), B], [Bᵀ, C]] by V —
    helper for restricted KRR systems (rl_pdkernels.hh:161)."""
    k = D_diag.shape[0]
    V1, V2 = V[:k, :], V[k:, :]
    top = D_diag[:, None] * V1 + matmul(B, V2, precision)
    bot = matmul(B.T, V1, precision) + matmul(C, V2, precision)
    return torch.cat([top, bot], dim=0)


class SquaredExpKernelLinOp:
    """Implicit kernel matrix K(X, X) + μ·I as a symmetric linop — the
    KRILL working operator (reference: RegExplicitSymLinOp over a kernel,
    rl_krill.hh usage). Column evaluation (``columns``) is what RPCholesky
    needs. ``matmat`` on a CUDA tensor always runs the fused kernel K4
    (``ops.kernels.kernel_matmat``: no part of K is stored); on a CPU
    tensor it evaluates K in blocks of ``block`` columns to cap memory at
    O(n·block).

    ``bandwidth`` is kept as a Python float (the kernel takes it as a
    launch argument) and ``mus`` as a 1-D tensor on X's device.
    """

    def __init__(self, X: torch.Tensor, bandwidth, mus,
                 evals_include_reg: bool = True, block: int = 2048):
        self.X = X
        self.bandwidth = float(bandwidth)
        self.mus = torch.atleast_1d(torch.as_tensor(
            mus, dtype=X.dtype, device=X.device))
        self.evals_include_reg = evals_include_reg
        self.block = block

    def with_reg(self, flag: bool):
        return SquaredExpKernelLinOp(self.X, self.bandwidth, self.mus, flag,
                                     self.block)

    @property
    def dim(self):
        return self.X.shape[1]

    n_rows = n_cols = dim

    @property
    def num_ops(self):
        return self.mus.shape[0]

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self):
        return self.X.device

    def diagonal(self):
        d = torch.ones((self.dim,), dtype=self.X.dtype, device=self.X.device)
        if self.evals_include_reg:
            require(self.num_ops == 1, "diagonal with per-column μ is "
                    "ambiguous")
            d = d + self.mus[0]
        return d

    def columns(self, idx: torch.Tensor):
        cols = squared_exp_kernel(self.X, self.X[:, idx], self.bandwidth)
        if self.evals_include_reg:
            require(self.num_ops == 1, "column eval with per-column μ is "
                    "ambiguous")
            onehots = (torch.arange(self.dim, device=self.X.device)[:, None]
                       == idx[None, :])
            cols = cols + self.mus[0] * onehots.to(cols.dtype)
        return cols

    def _add_reg(self, out, V):
        if self.evals_include_reg:
            if self.num_ops == 1:
                out = out + self.mus[0] * V
            else:
                require(V.shape[1] == self.num_ops,
                        f"{V.shape[1]} columns for {self.num_ops} μ")
                out = out + V * self.mus[None, :]
        return out

    def matmat(self, V: torch.Tensor, precision=STABLE_PRECISION):
        """K V (+ per-column μ V). CUDA: the fused kernel K4, always (it
        ignores ``precision``, as the Pallas kernel does). CPU: column
        blocks of K (clipped indices, masked tail), so the n×n kernel
        matrix never fully materializes."""
        resolve_precision(precision)
        if _device_route(self.X):
            require(V.device == self.X.device, "V must be on X's device")
            require_kernel_operands("K4", V)
            return self._add_reg(
                kernel_matmat(self.X.contiguous(), V.contiguous(),
                              self.bandwidth), V)
        return self._add_reg(kernel_matmat_reference(
            self.X, V, self.bandwidth, block=self.block), V)

    tmatmat = matmat

    def fro_nrm(self):
        raise NotImplementedError("implicit kernel operator")
