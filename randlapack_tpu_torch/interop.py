"""Factors across the two packages, through numpy: the JAX package's
``BQRRPFactors`` (one array per field) become the port's and back, so
either package's ``bqrrp_q``/``bqrrp_apply_qt`` can consume factors the
other made; HQRRP's GEQP3-format ``(packed, taus, R, J)`` crosses the same
way."""
from __future__ import annotations

import numpy as np
import torch

from .drivers.bqrrp import BQRRPFactors


def factors_from_numpy(arrays: dict, device="cuda") -> BQRRPFactors:
    """``{"V", "T", "R", "J", "rank", "fail"}`` numpy arrays → factors on
    ``device`` (J as int64, rank int32, fail bool)."""
    def t(name, dtype=None):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)
    return BQRRPFactors(V=t("V"), T=t("T"), R=t("R"),
                        J=t("J", torch.int64), rank=t("rank", torch.int32),
                        fail=t("fail", torch.bool))


def factors_to_numpy(fac: BQRRPFactors) -> dict:
    """Factors → a dict of numpy arrays, one per field."""
    return {name: getattr(fac, name).detach().cpu().numpy()
            for name in BQRRPFactors._fields}


LAPACK_FORMAT_FIELDS = ("packed", "taus", "R", "J")


def lapack_format_from_numpy(arrays: dict, device="cuda"):
    """``{"packed", "taus", "R", "J"}`` numpy arrays (as
    ``hqrrp_lapack_format`` returns them) → the tuple
    ``(packed, taus, R, J)`` on ``device`` (J as int64)."""
    return tuple(torch.tensor(np.asarray(arrays[name]),
                              dtype=torch.int64 if name == "J" else None,
                              device=device)
                 for name in LAPACK_FORMAT_FIELDS)


def lapack_format_to_numpy(packed, taus, R, J) -> dict:
    """HQRRP's GEQP3-format output → a dict of numpy arrays."""
    return {name: t.detach().cpu().numpy()
            for name, t in zip(LAPACK_FORMAT_FIELDS, (packed, taus, R, J))}
