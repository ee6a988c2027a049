"""A kernel group's share of its roofline from a traced record: the work
of its kind in the record's schedule, at ``yardstick``'s least time, over
the device time of the named source files' kernels."""
from __future__ import annotations

from . import trace, yardstick


def share(rec: dict, kind: str, files) -> float | None:
    """100 × (calls × the least time of a call's ``kind`` work) / (device
    seconds of the kernels of ``files``); None when the schedule has no
    such work or the trace no such kernel."""
    items = [w for w in rec["work"] if w["kind"] == kind]
    if not items or not rec["calls"]:
        return None
    spent = trace.device_seconds(rec, trace.program_kernels(rec, files))
    if spent <= 0:
        return None
    least = rec["calls"] * sum(yardstick.item_bound(w) for w in items)
    return 100.0 * least / spent
