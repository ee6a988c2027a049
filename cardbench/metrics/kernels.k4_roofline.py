"""K4's share of its roofline, %: the calls' least time for the K4
products the schedule lists (``yardstick_sqexp``: REVD2's at s = k and at
s = 1), over the device time of ``csrc/kernel_matmat.cu``'s kernels in
the traced calls."""
from cardbench import trace, yardstick_sqexp


def read(rec):
    items = [w for w in rec["work"] if w["kind"] == "k4"]
    if not items or not rec["calls"]:
        return None
    spent = trace.device_seconds(rec, trace.program_kernels(
        rec, ("kernel_matmat",)))
    if spent <= 0:
        return None
    least = rec["calls"] * sum(yardstick_sqexp.bound(w) for w in items)
    return 100.0 * least / spent
