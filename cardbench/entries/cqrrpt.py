"""``drivers.cqrrpt``: CholQR with a sketch-preconditioned pivoted QR of
tall A. Settings: the ``CQRRPTConfig`` fields the cell names (``qrcp`` by
its ``QRCPKind`` value) and ``precision``; the sketch QRCP by HQRRP runs
K5/K6 at ``bqrrp_block`` with HQRRP's other defaults (oversample 10, one
block a trailing update). A control may add ``cholqr_precision``: the
CholQR phase (the Gram, Q and R) at that precision, the sketch and its
QRCP at ``precision``."""
from __future__ import annotations

import contextlib
import importlib

from .. import reference, yardstick

_CONFIG_KEYS = ("d_factor", "vec_nnz", "sketch", "qrcp", "bqrrp_block",
                "gram_block", "trsm_mode", "q_form")
HQRRP_OVERSAMPLE = 10
NUMBERS = ("residual", "orthogonality", "permutation", "below_diagonal",
           "fail", "pivot_gap", "rank_deficit")
LIMITED = ("residual", "permutation", "fail")


def prepare(settings: dict):
    from randlapack_tpu_torch.drivers import CQRRPTConfig
    from randlapack_tpu_torch.drivers.cqrrpt import QRCPKind
    kw = {k: settings[k] for k in _CONFIG_KEYS if k in settings}
    kw["qrcp"] = QRCPKind(kw["qrcp"])
    return (CQRRPTConfig(**kw), settings["precision"],
            settings.get("cholqr_precision"))


@contextlib.contextmanager
def _cholqr_at(precision):
    """The driver's CholQR phase run at ``precision`` (None: as called)."""
    if precision is None:
        yield
        return
    mod = importlib.import_module("randlapack_tpu_torch.drivers.cqrrpt")
    orig = mod._cholqr_phase

    def phase(A_pre, keep, R_sk_safe, q_form, _precision, gram_block=0):
        return orig(A_pre, keep, R_sk_safe, q_form, precision, gram_block)
    mod._cholqr_phase = phase
    try:
        yield
    finally:
        mod._cholqr_phase = orig


def call(A, state, prep):
    from randlapack_tpu_torch.drivers import cqrrpt
    cfg, precision, cholqr_precision = prep
    with _cholqr_at(cholqr_precision):
        Q, R, J, rank, fail, state = cqrrpt(A, cfg, state, precision)
    return (Q, R, J, rank, fail), state


def phases(A, state, prep):
    """One call with ``timing=True`` (a synchronize at each phase edge):
    its phase seconds by name, and the next state."""
    from randlapack_tpu_torch.drivers import cqrrpt
    cfg, precision, _ = prep
    *_, state, times = cqrrpt(A, cfg, state, precision, timing=True)
    return times, state


def check(A, out, settings: dict) -> dict:
    """The leading ``rank`` columns of Q and rows of R (the rest are
    undefined past the rank), then ``reference.qr_numbers`` and
    ``reference.pivot_numbers``' ``pivot_gap`` (the sketch QRCP's
    pivots, judged on A's R), with the rank's shortfall from n beside
    them."""
    Q, R, J, rank, fail = out
    k = int(rank)
    Qk = Q[:, :k].double()
    nums = reference.qr_numbers(A, J, Qk, R[:k, :], fail)
    del Qk
    nums.update(reference.pivot_numbers(R[:k, :]))
    nums["rank_deficit"] = float(A.shape[1] - k)
    return nums


def schedule(shape, settings: dict) -> list[dict]:
    """K5/K6 of the sketch QRCP on the d×n sketch (``qrcp`` "hqrrp"
    only; the other QRCPs list none)."""
    m, n = shape
    if settings["qrcp"] != "hqrrp":
        return []
    d = int(settings["d_factor"] * n)
    return yardstick.hqrrp_schedule(d, n, settings["bqrrp_block"],
                                    HQRRP_OVERSAMPLE, 1, "highest")
