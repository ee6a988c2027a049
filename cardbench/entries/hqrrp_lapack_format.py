"""``drivers.hqrrp_lapack_format``: HQRRP in LAPACK's GEQP3 layout, K5/K6
with cuBLAS's trailing products ("highest") or K1/K2's forms (the other
trailing precisions). Settings: ``block_size``, ``oversample``,
``update_defer``, ``trailing_precision``, ``precision``."""
from __future__ import annotations

from .. import reference, yardstick

NUMBERS = ("residual", "orthogonality", "permutation", "below_diagonal",
           "fail", "pivot_gap", "panel_order")
LIMITED = ("residual", "permutation", "fail")


def prepare(settings: dict):
    from randlapack_tpu_torch.drivers import HQRRPConfig
    cfg = HQRRPConfig(block_size=settings["block_size"],
                      oversample=settings["oversample"],
                      update_defer=settings["update_defer"],
                      trailing_precision=settings["trailing_precision"])
    return cfg, settings["precision"]


def call(A, state, prep):
    from randlapack_tpu_torch.drivers import hqrrp_lapack_format
    cfg, precision = prep
    packed, taus, R, J, state = hqrrp_lapack_format(A, cfg, state, precision)
    return (packed, taus, R, J), state


def check(A, out, settings: dict) -> dict:
    """Q from the packed reflectors and taus, then
    ``reference.qr_numbers`` (the layout has no breakdown flag), and
    ``reference.pivot_numbers`` with the panel's width: K5's choice of
    each block and K6's greedy order inside it."""
    packed, taus, R, J = out
    Q = reference.q_from_householder(packed, taus)
    nums = reference.qr_numbers(A, J, Q, R, False)
    del Q
    nums.update(reference.pivot_numbers(R, settings["block_size"]))
    return nums


def schedule(shape, settings: dict) -> list[dict]:
    m, n = shape
    return yardstick.hqrrp_schedule(
        m, n, settings["block_size"], settings["oversample"],
        settings["update_defer"],
        yardstick.form_of(settings["trailing_precision"]))
