"""Global numerics configuration for randlapack_tpu_torch
(counterpart of ``randlapack_tpu/config.py``).

One policy: every matmul on the factorization path runs in true fp32
(or f64), never TF32. ``STABLE_PRECISION`` names that policy, and the
drivers refuse to run when PyTorch is set to round fp32 matmul inputs
to TF32, because CholeskyQR and the WY updates are precision-critical
(the JAX package runs the same products at ``Precision.HIGHEST``).
"""
from __future__ import annotations

import torch

from .errors import require

# Precision of every numerically sensitive matmul (Gram matrices, CholQR,
# trailing updates, sketch application).
STABLE_PRECISION = "highest"

# Precision of sketch application (S @ A): the JAX package names it apart
# and sets it to HIGHEST too, so here it is the same single rule.
SKETCH_PRECISION = STABLE_PRECISION

# the JAX precision names (``jax.lax.Precision`` members and their string
# forms) that mean full fp32 products: the only ones the port runs
_FP32_NAMES = ("highest", "float32")


def require_fp32_matmul() -> None:
    """Raise unless fp32 matmuls run in full fp32 (no TF32 anywhere)."""
    require(torch.get_float32_matmul_precision() == STABLE_PRECISION,
            "torch.get_float32_matmul_precision() must be 'highest', got "
            f"{torch.get_float32_matmul_precision()!r}")
    require(not torch.backends.cuda.matmul.allow_tf32,
            "torch.backends.cuda.matmul.allow_tf32 must be False")


def eps(dtype) -> float:
    """Machine epsilon of a torch dtype, or of anything ``numpy.dtype``
    takes."""
    if isinstance(dtype, torch.dtype):
        return float(torch.finfo(dtype).eps)
    import numpy as np
    return float(np.finfo(np.dtype(dtype)).eps)


def resolve_precision(precision):
    """None → ``STABLE_PRECISION``. A JAX precision name (or a
    ``jax.lax.Precision`` member, by its name) that means full fp32
    products → ``STABLE_PRECISION``; any other (``default``, ``high``,
    ``bfloat16``, ``tensorfloat32``) raises ``NotImplementedError``: the
    port has one rule, true fp32/f64 products, which the drivers enforce
    with ``require_fp32_matmul``."""
    if precision is None:
        return STABLE_PRECISION
    name = str(getattr(precision, "name", precision)).lower()
    if name not in _FP32_NAMES:
        raise NotImplementedError(
            f"precision {precision!r}: only full fp32 products "
            f"({STABLE_PRECISION!r}) are ported")
    return STABLE_PRECISION
