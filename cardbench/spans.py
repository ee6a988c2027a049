"""The program's spans beside a traced record: what the span readers
(``metrics/driver.*_device_ms.py``, ``host.syncs_per_call.py``,
``device.idle_in_driver_share.py``, ``setup.*_s.py``) take their numbers
from.

The spans come from ``randlapack_tpu_torch.utils.timing``: ``spans()``
for the traced calls (the switch is on while the profiler runs, so the
buffer holds what the traced stretch recorded) and ``setup_spans()`` for
the process's set-up. A record that carries its own ``spans`` and
``setup_spans`` (a fixture) is read from those. A program without spans
gives nothing, and every reader then returns None.

One clock with the trace: each span edge on the card stamps the host
clock just before its ``cudaEventRecord``, and the CUDA-only profiler
lists those calls among the record's ``host`` events. ``align`` pairs
the stamps with the calls in order and checks the pairing: the median
of (call start − stamp) is the offset, and no call may start more than
``TOLERANCE_S`` before its stamp or after the next stamp, both on the
trace's clock. A root span's interval on the trace's clock runs from the
start of its first edge's call to the end of its last's.
"""
from __future__ import annotations

import bisect
import statistics

from cardbench import trace

TOLERANCE_S = 20e-6
# the host API calls that wait for the card: every synchronize, and the
# copy that blocks (cudaMemcpy; cudaMemcpyAsync returns at once)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy",
                        "cudaMemcpy2D"})


def _program(name: str):
    """``randlapack_tpu_torch.utils.timing``'s reader ``name``, None in a
    program without spans."""
    from randlapack_tpu_torch.utils import timing
    return getattr(timing, name, None)


def of(rec: dict):
    """The spans of the record's calls (the last ``calls`` root spans
    and everything under them, as ``timing.spans()`` gives them), or
    None: no traced stretch, no spans, or fewer roots than calls."""
    if not rec["device"] or not rec["calls"]:
        return None
    if "spans" in rec:
        sp = rec["spans"]
    else:
        spans = _program("spans")
        if spans is None:
            return None
        sp = spans()
    roots = [s["id"] for s in sp if s["parent"] is None]
    if len(roots) < rec["calls"]:
        return None
    keep = set(roots[len(roots) - rec["calls"]:])
    return [s for s in sp if s["call"] in keep]


def setup_of(rec: dict):
    """The process's set-up spans, or None (as ``of``)."""
    if not rec["device"]:
        return None
    if "setup_spans" in rec:
        return rec["setup_spans"]
    setup_spans = _program("setup_spans")
    return None if setup_spans is None else setup_spans()


def setup_seconds(rec: dict, name: str):
    """Host seconds of the set-up span ``name`` (summed, were there more
    than one), None where there is none."""
    sp = setup_of(rec)
    found = [s["host_ms"] for s in (sp or []) if s["name"] == name]
    return sum(found) * 1e-3 if found else None


def device_ms(rec: dict, pick):
    """Device ms a call of the spans for which ``pick(span, parent)``
    holds (``parent`` the enclosing span's dict, None for a root); None
    where no span holds it or one has no device time."""
    sp = of(rec)
    if sp is None:
        return None
    by_id = {s["id"]: s for s in sp}
    chosen = [s for s in sp if pick(s, by_id.get(s["parent"]))]
    if not chosen or any(s["device_ms"] is None for s in chosen):
        return None
    return sum(s["device_ms"] for s in chosen) / rec["calls"]


def _edges(sp: list) -> list:
    """The host stamps of the spans' edges in time order, each with its
    span's id and whether it is the span's start."""
    out = [(s["start_ns"], s["id"], True) for s in sp]
    out += [(s["end_ns"], s["id"], False) for s in sp]
    return sorted(out)


def align(rec: dict, sp: list):
    """The spans' edges on the trace's clock, ``{(id, is_start): (call
    start, call end)}`` in the record's seconds, or None where the stamps
    and the record's ``cudaEventRecord`` calls do not pair (module
    docstring)."""
    calls = [h for h in rec["host"] if h[0].startswith("cudaEventRecord")]
    edges = _edges(sp)
    if not edges or len(calls) != len(edges):
        return None
    stamps = [e[0] * 1e-9 for e in edges]
    offset = statistics.median(c[1] - t for c, t in zip(calls, stamps))
    for i, (c, t) in enumerate(zip(calls, stamps)):
        nxt = stamps[i + 1] if i + 1 < len(stamps) else float("inf")
        if not t - TOLERANCE_S <= c[1] - offset <= nxt + TOLERANCE_S:
            return None
    return {(e[1], e[2]): (c[1], c[1] + c[2]) for e, c in zip(edges, calls)}


def root_intervals(rec: dict):
    """Each traced call's root span on the trace's clock, ``[(start,
    end)]`` in the record's seconds sorted by start, or None."""
    sp = of(rec)
    if sp is None:
        return None
    at = align(rec, sp)
    if at is None:
        return None
    return sorted((at[s["id"], True][0], at[s["id"], False][1])
                  for s in sp if s["parent"] is None)


def _inside(t: float, spans_: list, starts: list) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans_[i][1]


def syncs_per_call(rec: dict):
    """Synchronizing host API calls (``SYNC_CALLS``) that start inside a
    root span, a call."""
    roots = root_intervals(rec)
    if roots is None:
        return None
    starts = [a for a, _ in roots]
    n = sum(1 for name, s, _ in rec["host"]
            if name in SYNC_CALLS and _inside(s, roots, starts))
    return n / rec["calls"]


def idle_in_roots_share(rec: dict):
    """% of the traced stretch idle on the card while a root span was open
    on the host: the gaps between device activity whose middle lies in a
    root span (the gaps as ``trace.breakdown`` takes them)."""
    roots = root_intervals(rec)
    if roots is None or rec["window_s"] <= 0:
        return None
    starts = [a for a, _ in roots]
    idle, prev = 0.0, 0.0
    for a, b in trace.intervals(rec) + [(rec["window_s"], None)]:
        if a > prev and _inside(0.5 * (prev + a), roots, starts):
            idle += a - prev
        if b is None:
            break
        prev = b
    return 100.0 * idle / rec["window_s"]
