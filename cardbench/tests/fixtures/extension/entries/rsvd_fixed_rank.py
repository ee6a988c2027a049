"""``drivers.rsvd_fixed_rank``: a truncated SVD at rank ``k``, QB blocks of
``block_size``, products at ``precision``. Its input is the maker's
``(A, s)``; its output ``(U, S, Vt)`` has no permutation, so it names
numbers of its own, judged by its own reference, and a fault of its
own."""
from __future__ import annotations

import importlib

from .. import reference_svd

NUMBERS = ("triplet_residual", "orthogonality", "spectrum_error")
LIMITED = ("triplet_residual", "spectrum_error")


def prepare(settings: dict):
    from randlapack_tpu_torch.comps.qb import QBConfig
    from randlapack_tpu_torch.drivers import RSVDConfig
    return (RSVDConfig(qb=QBConfig(block_size=settings["block_size"])),
            settings["k"], settings["precision"])


def call(inp, state, prep):
    from randlapack_tpu_torch.drivers import rsvd_fixed_rank
    A, _ = inp
    cfg, k, precision = prep
    U, S, Vt, _, state = rsvd_fixed_rank(A, k, cfg, state, precision)
    return (U, S, Vt), state


def check(inp, out, settings: dict) -> dict:
    A, s = inp
    return reference_svd.svd_numbers(A, *out, s)


def schedule(shape, settings: dict) -> list[dict]:
    return []


def sigma_altered(setattr, cell):
    """An answer altered where it is produced: the small SVD's first
    singular value × 1.5, inside the driver."""
    mod = importlib.import_module("randlapack_tpu_torch.drivers.rsvd")
    orig = mod.svd_econ

    def svd_econ(B, method, precision):
        Ub, S, Vt = orig(B, method, precision)
        S = S.clone()
        S[0] *= 1.5
        return Ub, S, Vt
    setattr(mod, "svd_econ", svd_econ)


FAULTS = {"sigma_altered": sigma_altered}
