"""Subsampled Randomized Hadamard Transform (counterpart of
``randlapack_tpu/sketching/srht.py``).

S = sqrt(m_pad/d) · R · H · D with D = diag(±1), H the m_pad-point
Walsh-Hadamard transform (m_pad = next power of two ≥ m) and R a uniform
row sampler, scaled so E[SᵀS] = I. The transform factorizes into dense
±1 Hadamard blocks of order 128 (a smaller tail as needed): each stage is
a reshape and one batched product with the block, so an m×n input costs
⌈log₁₂₈ m⌉ products and as many copies of the operand.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..config import STABLE_PRECISION
from ..ops.util import matmul, product_form
from ..rng import RNGState


def _hadamard_matrix(k: int, dtype, device="cuda"):
    """Dense k×k Hadamard matrix (k a power of two), unnormalized."""
    h = torch.ones((1, 1), dtype=dtype, device=device)
    while h.shape[0] < k:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h


def fwht(x: torch.Tensor, precision=STABLE_PRECISION) -> torch.Tensor:
    """Walsh-Hadamard transform along axis 0 (length a power of two):
    radix 128, the last stage's radix what is left. Each stage's product
    at ``precision`` (``ops.util.matmul``)."""
    form = product_form(precision, x)
    m = x.shape[0]
    assert m & (m - 1) == 0, "fwht length must be a power of two"
    radix = 128
    rest = x.shape[1:]
    width = math.prod(rest)
    done = 1
    while done < m:
        r = min(radix, m // done)
        # view as (m // (done*r), r, done·rest) and transform the r axis
        h = _hadamard_matrix(r, x.dtype, x.device)
        x3 = x.reshape(m // (done * r), r, done * width)
        if form == "highest":
            x = torch.matmul(h, x3)
        else:
            # one 2-D product over the stacked blocks
            y = matmul(h, x3.transpose(0, 1).reshape(r, -1), form)
            x = y.reshape(r, x3.shape[0], -1).transpose(0, 1)
        x = x.reshape(m, *rest)
        done *= r
    return x


@dataclasses.dataclass(frozen=True)
class SRHTSkOp:
    """Sampled SRHT operator: d×m (sketches the length-m axis down to d)."""

    n_rows: int                 # d
    n_cols: int                 # m
    signs: torch.Tensor = None  # (m,) ±1
    rows: torch.Tensor = None   # (d,) sampled indices into [0, m_pad)

    @property
    def m_pad(self) -> int:
        return 1 << max(0, (self.n_cols - 1).bit_length())


def srht_skop(d: int, m: int, state: RNGState, dtype=torch.float32,
              device="cuda"):
    """Sample an SRHT operator on ``device``. Returns
    ``(SRHTSkOp, next_state)``."""
    m_pad = 1 << max(0, (m - 1).bit_length())
    gen, state = state.spawn(device)
    signs = (2 * torch.randint(0, 2, (m,), generator=gen, device=device)
             - 1).to(dtype)
    gen, state = state.spawn(device)
    rows = torch.randint(0, m_pad, (d,), generator=gen, device=device)
    return SRHTSkOp(d, m, signs, rows), state


def srht_left_apply(S: SRHTSkOp, A: torch.Tensor,
                    precision=STABLE_PRECISION) -> torch.Tensor:
    """S @ A (d×m · m×n), scaled so E[SᵀS] = I: H/√m_pad is orthogonal
    and sampling d of m_pad rows with scale √(m_pad/d) is an isometry in
    expectation, so the raw H takes 1/√d."""
    m, n = A.shape
    assert m == S.n_cols
    x = A * S.signs[:, None]
    if S.m_pad != m:
        x = torch.nn.functional.pad(x, (0, 0, 0, S.m_pad - m))
    x = fwht(x, precision)
    return x[S.rows] * (1.0 / math.sqrt(S.n_rows))
