"""CQRRPT's ``qrcp`` phase (the sketch's pivoted QR), ms a call: the
median over the traced run's ``timing=True`` calls
(``utils.timing.PhaseTimer``, synchronized only at the phase's edges)."""
import statistics


def read(rec):
    times = rec["phases"].get("qrcp")
    return statistics.median(times) * 1e3 if times else None
