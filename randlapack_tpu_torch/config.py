"""Global numerics configuration for randlapack_tpu_torch
(counterpart of ``randlapack_tpu/config.py``).

Two rules. PyTorch's process-wide switches stay at true fp32 (no TF32
anywhere): the drivers refuse to run otherwise, because CholeskyQR and
the WY updates are precision-critical. A driver's ``precision`` (default
``STABLE_PRECISION``, "highest") then sets, call by call, the products
the JAX package writes as ``jnp.matmul(..., precision=precision)``:
``resolve_precision`` maps JAX's names, ``ops.util.matmul`` computes them.
The hand-written kernels ignore it, as the Pallas kernels do.
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

# every name JAX takes for a precision (``jax.lax.Precision`` members and
# their string forms), by the port's three names: "highest" (true fp32
# products), "high" (TF32 inputs, fp32 accumulate) and "default" (bf16
# inputs, fp32 accumulate)
_PRECISION_NAMES = {
    "highest": "highest", "float32": "highest",
    "high": "high", "tensorfloat32": "high",
    "default": "default", "bfloat16": "default", "fastest": "default",
}


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
    """The port's name for a JAX precision: None, "highest" and
    "float32" → "highest"; "high" and "tensorfloat32" → "high";
    "default", "bfloat16" and "fastest" → "default". A
    ``jax.lax.Precision`` member counts by its name (``Precision.HIGH``
    → "high"). Anything else raises ``ValueError``, as
    ``jax.lax.Precision`` does. ``ops.util.matmul`` says what each name
    computes: on the CPU and in f64 every name is the plain product."""
    if precision is None:
        return STABLE_PRECISION
    name = getattr(precision, "name", precision)
    resolved = (_PRECISION_NAMES.get(name.lower())
                if isinstance(name, str) else None)
    if resolved is None:
        raise ValueError(f"Unknown precision: {precision!r}; expected one "
                         f"of {sorted(_PRECISION_NAMES)}")
    return resolved
