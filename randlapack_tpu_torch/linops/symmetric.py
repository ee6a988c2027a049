"""Symmetric operators + spectral preconditioner (counterpart of
``randlapack_tpu/linops/symmetric.py``; reference: rl_sym_linops.hh —
ExplicitSymLinOp :55, RegExplicitSymLinOp :135, SpectralPrecond :228).
"""
from __future__ import annotations

import torch

from ..config import STABLE_PRECISION
from ..errors import require
from ..ops.util import matmul


class ExplicitSymLinOp:
    """Symmetric operator backed by a dense symmetric matrix."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat

    @property
    def dim(self):
        return self.mat.shape[0]

    n_rows = n_cols = dim

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def matmat(self, X, precision=STABLE_PRECISION):
        return matmul(self.mat, X, precision)

    tmatmat = matmat

    def fro_nrm(self):
        return torch.linalg.norm(self.mat)

    def entry(self, i, j):
        return self.mat[i, j]

    def columns(self, idx):
        """K[:, idx] — the RPCholesky column-evaluation hook."""
        return self.mat[:, idx]

    def diagonal(self):
        return torch.diagonal(self.mat).clone()


class RegExplicitSymLinOp:
    """Family of regularized operators {A + μ_i I} applied columnwise:
    (G X)[:, i] = (A + μ_i I) X[:, i] (reference: rl_sym_linops.hh:135,
    per-column regularization :178-184). ``evals_include_reg`` mirrors
    ``set_eval_includes_reg`` — here it is a constructor flag; use
    ``with_reg(flag)`` to flip.
    """

    def __init__(self, mat: torch.Tensor, mus,
                 evals_include_reg: bool = True):
        self.mat = mat
        self.mus = torch.atleast_1d(torch.as_tensor(
            mus, dtype=mat.dtype, device=mat.device))
        self.evals_include_reg = evals_include_reg

    def with_reg(self, flag: bool):
        return RegExplicitSymLinOp(self.mat, self.mus, flag)

    @property
    def dim(self):
        return self.mat.shape[0]

    n_rows = n_cols = dim

    @property
    def num_ops(self):
        return self.mus.shape[0]

    @property
    def dtype(self):
        return self.mat.dtype

    @property
    def device(self):
        return self.mat.device

    def _col_mus(self, ncols):
        if self.num_ops == 1:
            return self.mus.expand(ncols)
        require(ncols == self.num_ops,
                f"{ncols} columns for {self.num_ops} μ")
        return self.mus

    def matmat(self, X, precision=STABLE_PRECISION):
        out = matmul(self.mat, X, precision)
        if self.evals_include_reg:
            out = out + X * self._col_mus(X.shape[1])[None, :]
        return out

    tmatmat = matmat

    def fro_nrm(self):
        return torch.linalg.norm(self.mat)

    def columns(self, idx):
        cols = self.mat[:, idx]
        if self.evals_include_reg:
            # add μ on the diagonal entries of the selected columns
            require(self.num_ops == 1,
                    "column eval with per-column μ is ambiguous")
            onehots = (torch.arange(self.dim, device=self.mat.device)[:, None]
                       == idx[None, :])
            cols = cols + self.mus[0] * onehots.to(cols.dtype)
        return cols

    def diagonal(self):
        d = torch.diagonal(self.mat).clone()
        if self.evals_include_reg:
            require(self.num_ops == 1, "diagonal with per-column μ is "
                    "ambiguous")
            d = d + self.mus[0]
        return d


class SpectralPrecond:
    """P = V diag(D) Vᵀ + I with D = (λ_min + μ)/(λ + μ) − 1
    (reference: rl_sym_linops.hh:228, prep :318, 2-GEMM apply :339-377).

    Supports one μ (D shape (k,)) or per-column μ (D shape (k, s) and the
    apply regards column i of X as belonging to system i).
    """

    def __init__(self, V: torch.Tensor, D: torch.Tensor):
        self.V = V
        self.D = D

    @classmethod
    def prep(cls, eigvecs: torch.Tensor, eigvals: torch.Tensor, mus,
             min_eig=None):
        mus = torch.atleast_1d(torch.as_tensor(
            mus, dtype=eigvals.dtype, device=eigvals.device))
        lam_min = eigvals[-1] if min_eig is None else min_eig
        # broadcast: (k, s)
        D = (lam_min + mus[None, :]) / (eigvals[:, None] + mus[None, :]) - 1.0
        if mus.shape[0] == 1:
            D = D[:, 0]
        return cls(eigvecs, D)

    @property
    def dim(self):
        return self.V.shape[0]

    n_rows = n_cols = dim

    @property
    def dtype(self):
        return self.V.dtype

    @property
    def device(self):
        return self.V.device

    def matmat(self, X, precision=STABLE_PRECISION):
        W = matmul(self.V.T, X, precision)          # (k, s)
        if self.D.dim() == 1:
            W = W * self.D[:, None]
        else:
            require(X.shape[1] == self.D.shape[1],
                    f"{X.shape[1]} columns for D {tuple(self.D.shape)}")
            W = W * self.D
        return X + matmul(self.V, W, precision)

    tmatmat = matmat

    def fro_nrm(self):
        # ‖VDVᵀ+I‖_F = sqrt(Σ(1+d)² + (n−k)) for orthonormal V, single-μ D
        if self.D.dim() == 1:
            n, k = self.V.shape
            return torch.sqrt(torch.sum((1.0 + self.D) ** 2) + (n - k))
        raise NotImplementedError
