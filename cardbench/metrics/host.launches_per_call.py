"""Device activities a call: every kernel, copy and fill the profiler
placed on the card over the traced calls, over their number. Each one is
a launch the host had to issue."""


def read(rec):
    if not rec["device"] or not rec["calls"]:
        return None
    return len(rec["device"]) / rec["calls"]
