"""Faults planted in the program's timed path: the CPU tests see a run with
each read ``correct`` false (``tests/test_cardbench_run.py``), and
``control.py --fault`` reads them on the card at a cell's own size.

``FAULTS`` holds those of the pivoted QRs; an entry brings the others in
its own ``FAULTS`` under names not in this one, and ``find`` looks in
both. ``answer_altered`` and ``answer_nan`` find R in a QR's output.

Each fault is ``fault(setattr, cell)``: it replaces a function of the
program, or the cell's entry, through ``setattr(owner, name, value)``
(pytest's ``monkeypatch.setattr``, or ``control.patched``'s, which puts
the originals back). The benchmark's own runs never plant one.
"""
from __future__ import annotations

import importlib

import torch

from . import harness


def driver(name: str):
    """The program's driver module ``drivers/<name>.py`` (the package
    exports functions of the same names)."""
    return importlib.import_module(f"randlapack_tpu_torch.drivers.{name}")


def _entry(cell: str):
    return harness.entry(harness.workload(cell)["entry"])


def _r_index(out) -> int:
    return 2 if len(out) == 4 else 1     # (packed, taus, R, J) / (Q, R, …)


def _scale_first_row(out):
    out = list(out)
    i = _r_index(out)
    R = out[i].clone()
    R[0] *= 1.5
    out[i] = R
    return tuple(out)


def answer_altered(setattr, cell):
    """An answer altered where it is produced: R's first row × 1.5."""
    ent = _entry(cell)
    orig = ent.call

    def call(A, state, prep):
        out, state = orig(A, state, prep)
        return _scale_first_row(out), state
    setattr(ent, "call", call)


def answer_nan(setattr, cell):
    """An answer made NaN where it is produced: R[0, 0]."""
    ent = _entry(cell)
    orig = ent.call

    def call(A, state, prep):
        out, state = orig(A, state, prep)
        out = _scale_first_row(out)
        out[_r_index(out)][0, 0] = float("nan")
        return out, state
    setattr(ent, "call", call)


def k2_unchanged(setattr, cell):
    """K2 returns the matrix it should update unchanged."""
    setattr(driver("hqrrp"), "a_minus_vz_masked_mixed",
            lambda A, V, Z, mask, tp="highest": A)


def k2_half(setattr, cell):
    """K2 updates the first half of the columns and leaves the rest."""
    mod = driver("hqrrp")
    orig = mod.a_minus_vz_masked_mixed

    def half(A, V, Z, mask, tp="highest"):
        full = orig(A.clone(), V, Z, mask, tp)
        h = A.shape[1] // 2
        A[:, :h] = full[:, :h]
        return A
    setattr(mod, "a_minus_vz_masked_mixed", half)


def panel_unchanged(setattr, cell):
    """HQRRP's panel step returns its panel unfactored."""
    def panel(P, c, cfg, precision, mesh=None):
        b = P.shape[1]
        return (P.clone(), torch.zeros_like(P),
                torch.zeros(b, dtype=P.dtype, device=P.device),
                torch.arange(b, device=P.device),
                torch.zeros((), dtype=torch.bool, device=P.device))
    setattr(driver("hqrrp"), "_panel", panel)


def panel_half(setattr, cell):
    """HQRRP's panel step sees only the top half of its rows."""
    mod = driver("hqrrp")
    orig = mod._panel

    def panel(P, c, cfg, precision, mesh=None):
        Ph = P.clone()
        Ph[P.shape[0] // 2:] = 0.0
        return orig(Ph, c, cfg, precision, mesh)
    setattr(mod, "_panel", panel)


def k5_first_live(setattr, cell):
    """K5 returns the first live columns, whatever their norms: HQRRP's
    blocks (and CQRRPT's sketch QRCP) without pivot selection."""
    def first_live(Y, nsteps, live, precision="highest", use_pallas="auto"):
        return torch.nonzero(live > 0.5).flatten()[:nsteps]
    setattr(driver("hqrrp"), "qrcp_select_pivots_routed", first_live)


def k6_unpivoted(setattr, cell):
    """K6 factors its panel without column pivoting: the block's columns
    in the order K5 chose them."""
    mod = driver("hqrrp")
    orig = mod.qrcp_panel_routed

    def unpivoted(panel, row0, pivot=True, precision="highest",
                  use_pallas="auto"):
        return orig(panel, row0, False, precision, use_pallas)
    setattr(mod, "qrcp_panel_routed", unpivoted)


def cholqr_unchanged(setattr, cell):
    """CQRRPT's CholQR returns its preconditioned input as Q."""
    def phase(A_pre, keep, R_sk_safe, q_form, precision, gram_block=0):
        return A_pre, R_sk_safe, torch.zeros((), dtype=torch.bool,
                                             device=A_pre.device)
    setattr(driver("cqrrpt"), "_cholqr_phase", phase)


def gram_half(setattr, cell):
    """CQRRPT's Gram over the first half of the rows only."""
    mod = driver("cqrrpt")
    orig = mod._cholqr_gram

    def gram(A_pre, keep, precision, gram_block=0):
        Ah = A_pre.clone()
        Ah[A_pre.shape[0] // 2:] = 0.0
        _, G, s, nonfin = orig(Ah, keep, precision, gram_block)
        A_s, _, _, _ = orig(A_pre, keep, precision, gram_block)
        return A_s, G, s, nonfin
    setattr(mod, "_cholqr_gram", gram)


FAULTS = {f.__name__: f for f in (
    answer_altered, answer_nan, k2_unchanged, k2_half, panel_unchanged,
    panel_half, k5_first_live, k6_unpivoted, cholqr_unchanged, gram_half)}


def find(cell: str, name: str):
    """The fault ``name`` for ``cell``: from ``FAULTS``, or else from the
    ``FAULTS`` of the cell's entry."""
    if name in FAULTS:
        return FAULTS[name]
    return getattr(_entry(cell), "FAULTS", {})[name]
