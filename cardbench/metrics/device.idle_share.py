"""The share of the traced stretch, %, in which no device activity ran
(the complement of the union of the device events' intervals)."""
from cardbench import trace


def read(rec):
    if not rec["device"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(rec) / rec["window_s"])
