"""Dense sketching operators (counterpart of ``randlapack_tpu/sketching/
dense.py``; the RandBLAS ``DenseDist``/``DenseSkOp`` capability,
SURVEY.md §2.9: ``DenseDist``, ``ScalarDist::{Gaussian, Uniform}``,
``fill_dense``, ``DenseSkOp``).

A dense sketch is a tensor drawn from an ``RNGState``; its entries have
unit variance, so ``S/√(short axis)`` is an isometry in expectation.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import torch

from ..rng import RNGState


class ScalarDist(enum.Enum):
    Gaussian = "gaussian"
    Uniform = "uniform"


@dataclasses.dataclass(frozen=True)
class DenseDist:
    """Distribution over dense n_rows × n_cols sketching operators."""

    n_rows: int
    n_cols: int
    family: ScalarDist = ScalarDist.Gaussian

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def isometry_scale(self) -> float:
        # unit-variance entries: the isometry scale is 1/√(short axis)
        return 1.0 / math.sqrt(min(self.n_rows, self.n_cols))


def fill_dense(dist: DenseDist, state: RNGState, dtype=torch.float32,
               device="cuda"):
    """Sample S ~ dist on ``device`` from a generator spawned from
    ``state``. Returns ``(S, next_state)``.

    Entries are iid unit-variance: N(0,1) for Gaussian, U(-√3, √3) for
    Uniform (the RandBLAS convention of unit second moment)."""
    gen, nxt = state.spawn(device)
    if dist.family == ScalarDist.Gaussian:
        s = torch.randn(dist.shape, generator=gen, dtype=dtype,
                        device=device)
    elif dist.family == ScalarDist.Uniform:
        r = math.sqrt(3.0)
        s = (2.0 * torch.rand(dist.shape, generator=gen, dtype=dtype,
                              device=device) - 1.0) * r
    else:  # pragma: no cover
        raise ValueError(f"unknown family {dist.family}")
    return s, nxt


@dataclasses.dataclass(frozen=True)
class DenseSkOp:
    """A sampled dense sketching operator (materialized)."""

    dist: DenseDist
    mat: torch.Tensor = None  # (n_rows, n_cols)

    @property
    def n_rows(self):
        return self.dist.n_rows

    @property
    def n_cols(self):
        return self.dist.n_cols


def dense_skop(dist: DenseDist, state: RNGState, dtype=torch.float32,
               device="cuda"):
    s, nxt = fill_dense(dist, state, dtype, device)
    return DenseSkOp(dist, s), nxt
