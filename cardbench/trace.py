"""The traced stretch: ``torch.profiler`` (CUDA activity only, so the host
is slowed as little as the profiler allows) over a few calls of the
window, reduced to a plain record that the per-layer readers
(``metrics/*.py``) take their numbers from.

The record (JSON-serializable, so tests can keep one as a fixture):

- ``calls``: the calls traced; ``window_s``: the traced stretch's length,
  from its first to its last recorded event;
- ``device``: ``[name, start_s, dur_s]`` of every kernel, copy and fill
  on the card, from the stretch's start;
- ``host``: ``[name, start_s, dur_s]`` of the host's CUDA API calls
  (launches, copies, synchronizes), for ``breakdown``'s idle gaps;
- ``kernel_files``: the program's kernel names by source file
  (``csrc/<file>.cu`` or ``.cuh``), from its ``__global__`` declarations;
- ``work``: the work items a call's block schedule gives
  (``yardstick``), a call's worth;
- ``phases``: phase name → seconds of each ``timing=True`` call, where
  the entry has such calls.
"""
from __future__ import annotations

import bisect
import re
from pathlib import Path

_IDENT = re.compile(r"[A-Za-z_]\w*")


def global_names(source: str) -> list[str]:
    """The names of the ``__global__`` functions declared in CUDA source
    text: the identifier before the first ``(`` after each ``__global__``,
    past its return type and a ``__launch_bounds__(…)`` (whose arguments
    may hold parentheses)."""
    names = set()
    for m in re.finditer(r"__global__\b", source):
        i = m.end()
        while True:
            w = re.compile(r"\s*(\w+)\s*").match(source, i)
            if w is None:
                break
            i = w.end()
            if w.group(1) == "__launch_bounds__":
                depth = 0
                while i < len(source):
                    depth += {"(": 1, ")": -1}.get(source[i], 0)
                    i += 1
                    if depth == 0:
                        break
                continue
            if source.startswith("(", i):
                names.add(w.group(1))
                break
    return sorted(names)


def kernel_files(csrc: Path) -> dict:
    """Each ``csrc/*.cu`` and ``*.cuh`` file's kernel names (its
    ``__global__`` functions), by the file's stem."""
    return {p.stem: global_names(p.read_text())
            for p in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])}


def matches(name: str, kernels) -> bool:
    """Whether a device event's name is one of ``kernels`` (compared as
    whole identifiers: ``void wy_tc_kernel<true, 0>(…)`` is
    ``wy_tc_kernel``)."""
    return not set(kernels).isdisjoint(_IDENT.findall(name))


def _ns(e, what: str) -> float:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(e, f"{what}_us")()) * 1e3


def events(prof):
    """(device, host) event lists ``[name, start_ns, dur_ns]`` of a
    finished profiler: device events are those the profiler places on the
    card (kernels, copies, fills), host events the CUDA API calls it
    recorded."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = [e.name(), _ns(e, "start"), _ns(e, "duration")]
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return device, host


def record(device, host, calls: int, kernels: dict, work: list,
           phases: dict) -> dict:
    """The record of a traced stretch (module docstring) from raw event
    lists in ns."""
    starts = [s for _, s, _ in device + host]
    ends = [s + d for _, s, d in device + host]
    t0 = min(starts) if starts else 0.0
    t1 = max(ends) if ends else 0.0

    def rel(items):
        return [[n, (s - t0) * 1e-9, d * 1e-9] for n, s, d in items]

    return dict(calls=calls, window_s=(t1 - t0) * 1e-9,
                device=rel(sorted(device, key=lambda x: x[1])),
                host=rel(sorted(host, key=lambda x: x[1])),
                kernel_files=kernels, work=work, phases=phases)


def intervals(rec: dict):
    """The union of the device events' intervals, clipped to the stretch:
    a sorted list of disjoint (start, end) in seconds."""
    out = []
    W = rec["window_s"]
    for _, s, d in sorted(rec["device"], key=lambda x: x[1]):
        a, b = max(s, 0.0), min(s + d, W)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(rec: dict) -> float:
    """Seconds of the stretch in which some device activity ran."""
    return sum(b - a for a, b in intervals(rec))


def device_seconds(rec: dict, kernels=None, exclude=None) -> float:
    """Summed device seconds of the events that are one of ``kernels``
    (all events when None), leaving out those that are one of
    ``exclude``."""
    total = 0.0
    for name, _, d in rec["device"]:
        if kernels is not None and not matches(name, kernels):
            continue
        if exclude is not None and matches(name, exclude):
            continue
        total += d
    return total


def program_kernels(rec: dict, files=None) -> set:
    """The program's kernel names, of the source files ``files`` (by stem)
    or of all."""
    return {k for f, names in rec["kernel_files"].items()
            if files is None or f in files for k in names}


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by
    the host's CUDA API call under way at each gap's middle ("host" when
    none was: Python and the library's host code between calls), each
    longest first, at most ``top`` of each."""
    by_op: dict = {}
    for name, _, d in rec["device"]:
        by_op[name] = by_op.get(name, 0.0) + d
    gaps = []
    prev = 0.0
    for a, b in intervals(rec):
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if rec["window_s"] > prev:
        gaps.append((prev, rec["window_s"]))
    host = rec["host"]
    starts = [s for _, s, _ in host]
    by_host: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        # the latest API call to start before the middle, if it covers it
        i = bisect.bisect_right(starts, mid) - 1
        name = "host"
        if i >= 0 and host[i][1] + host[i][2] >= mid:
            name = host[i][0]
        by_host[name] = by_host.get(name, 0.0) + (b - a)

    def top_of(d):
        return [[_short(k), v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return dict(device_ops=top_of(by_op), idle_gaps=top_of(by_host))


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
