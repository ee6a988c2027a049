"""Phase timing, spans and profiling (counterpart of
``randlapack_tpu/utils/timing.py``; reference: the per-driver fixed-slot
timing vectors, e.g. BQRRP's 10 slots rl_bqrrp.hh:584-607, reported as a
named-phase dict).

**Spans.** ``span(name)`` marks a phase of a driver call and adds no
synchronize. A span opened while none is open is the call's root; it
reads the switch once for the whole call. The switch is on while a
``torch.profiler`` session runs and inside a ``tracing()`` block. Off,
every span of the call is one shared object that reads no clock, makes
no CUDA call and allocates nothing. On, each span records its name, its
call (the root's id), its parent, and its host start and end on
``time.perf_counter_ns``, and opens a profiler range of its name (as
``torch.profiler.record_function`` does) so that a profiler's trace
shows the phases over the kernels. Under a root given a CUDA device,
each span also records a timing-enabled CUDA event at each edge,
stamping the host clock just before the record (the ``cudaEventRecord``
calls a device trace lists are then the anchor that puts the spans on
its clock). ``spans()`` returns what was recorded
since the switch last turned on; it resolves the events there, after
the caller's own synchronize. The recorder is the process's and follows
one thread's calls.

**Counters.** ``count(name, n, of)`` adds ``n`` to a counter, and ``of``
to the whole it is a part of, while a recording span is open; with the
switch off it does nothing. ``counters()`` returns them, cleared with the
spans when the switch turns on.

**Set-up spans** (``setup_span``, ``setup_spans()``) are host times
recorded once a process whatever the switch: the package's import
(``setup.import``), the kernels' build and load (``setup.kernels``,
``_build.lib``) and the process's first root span (``setup.first_call``).

**Phase timing.** PyTorch launches CUDA work asynchronously, so a
``PhaseTimer`` phase is a span with a synchronize of the current CUDA
device at each edge, timed on the host clock between them (the drivers'
``timing=True`` dicts). ``profile_trace`` gives the device-level
breakdown (``torch.profiler``), ``debug_checks`` the fail-fast NaN mode
of the JAX package's ``jax_debug_nans``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.overrides import TorchFunctionMode

_now_ns = time.perf_counter_ns
# a profiler range over a span: the C++ context manager where PyTorch has
# it (about 1 µs a range against ``torch.profiler.record_function``'s 12)
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           None) or torch.profiler.record_function


def device_sync(out: torch.Tensor) -> None:
    """Wait for the device that holds ``out``; a no-op on the CPU."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


class _Recorder:
    """The process's span state (module docstring)."""

    def __init__(self):
        self.forced = 0          # depth of open ``tracing()`` blocks
        self.root_open = False   # a root span, on or off, is open
        self.was_on = False      # what the last root read of the switch
        self.open = None         # the innermost open recording span
        self.closed = []         # recording spans closed since the switch
                                 # last turned on
        self.counts = {}         # counters added to since then
        self.first_call = True   # no root span opened yet
        self.setup = []          # closed set-up spans
        self.setup_open = None   # the innermost open set-up span
        self.pool = []           # free timing-enabled CUDA events
        self.next_id = 0

    def new_id(self) -> int:
        self.next_id += 1
        return self.next_id

    def event(self):
        if self.pool:
            return self.pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def release(self, s) -> None:
        if s.ev0 is not None:
            self.pool += [s.ev0, s.ev1]
            s.ev0 = s.ev1 = None


_REC = _Recorder()


class _NoSpan:
    """The span of a call whose root read the switch off: one shared
    object that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _OffRoot(_NoSpan):
    """The root span of a call with the switch off: it only marks the
    call open, so the call's other spans do not read the switch."""
    __slots__ = ()

    def __enter__(self):
        _REC.root_open = True
        return self

    def __exit__(self, *exc):
        _REC.root_open = False
        return False


_NO_SPAN = _NoSpan()
_OFF_ROOT = _OffRoot()


class _Span:
    """A recording span (module docstring); with a ``stream`` (its root's
    CUDA stream) it records CUDA events there at its edges."""
    __slots__ = ("name", "stream", "id", "call", "parent", "outer",
                 "start_ns", "end_ns", "ev0", "ev1", "device_ms", "rf")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream
        self.ev0 = self.ev1 = self.device_ms = None

    def __enter__(self):
        r = _REC
        self.outer = r.open
        self.id = r.new_id()
        if self.outer is None:
            self.parent, self.call = None, self.id
            r.root_open = True
        else:
            self.parent, self.call = self.outer.id, self.outer.call
        r.open = self
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        if self.stream is not None:
            self.ev0 = r.event()
            self.start_ns = _now_ns()
            self.ev0.record(self.stream)
        else:
            self.start_ns = _now_ns()
        return self

    def __exit__(self, *exc):
        r = _REC
        if self.stream is not None:
            self.ev1 = r.event()
            self.end_ns = _now_ns()
            self.ev1.record(self.stream)
        else:
            self.end_ns = _now_ns()
        self.rf.__exit__(*exc)
        self.rf = None
        r.closed.append(self)
        r.open, self.outer = self.outer, None
        if r.open is None:
            r.root_open = False
        return False


def _switch() -> bool:
    return _REC.forced > 0 or torch.autograd._profiler_enabled()


def span(name: str, device=None):
    """The span ``name`` (module docstring), a context manager. A root
    records CUDA events when ``device`` (a ``torch.device`` or its name)
    is a CUDA device, or, with ``device`` None, when CUDA is in use; the
    other spans follow their root."""
    r = _REC
    if r.root_open:
        return _NO_SPAN if r.open is None else _Span(name, r.open.stream)
    on = _switch()
    if on and not r.was_on:
        for s in r.closed:
            r.release(s)
        r.closed = []
        r.counts = {}
    r.was_on = on
    if on:
        cuda = (torch.cuda.is_initialized() if device is None
                else torch.device(device).type == "cuda")
        root = _Span(name, torch.cuda.current_stream(device) if cuda
                     else None)
    else:
        root = _OFF_ROOT
    if r.first_call:
        r.first_call = False
        return _first_call(root)
    return root


@contextlib.contextmanager
def _first_call(root):
    with setup_span("setup.first_call"), root:
        yield root


@contextlib.contextmanager
def tracing():
    """Turn the switch on for the scope, with or without a profiler."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def _as_dicts(items, device: bool) -> list[dict]:
    """Spans as dicts (``spans``' docstring), self times filled in."""
    out = {s.id: dict(name=s.name, id=s.id, call=s.call, parent=s.parent,
                      start_ns=s.start_ns, end_ns=s.end_ns,
                      host_ms=(s.end_ns - s.start_ns) * 1e-6,
                      device_ms=s.device_ms if device else None)
           for s in items}
    for d in out.values():
        d["self_host_ms"] = d["host_ms"]
        d["self_device_ms"] = d["device_ms"]
    for d in out.values():
        p = out.get(d["parent"])
        if p is None:
            continue
        p["self_host_ms"] -= d["host_ms"]
        if p["self_device_ms"] is not None and d["device_ms"] is not None:
            p["self_device_ms"] -= d["device_ms"]
    return sorted(out.values(), key=lambda d: d["id"])


def spans() -> list[dict]:
    """The spans closed since the switch last turned on, in the order
    they opened, each a dict: ``name``, ``id``, ``call`` (its root's
    id), ``parent`` (id, None for a root), ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``), ``host_ms``, ``device_ms`` (between its
    CUDA events; None without them) and ``self_host_ms`` /
    ``self_device_ms`` (less its children's). Synchronizes the current
    device first where events are unresolved."""
    r = _REC
    if any(s.ev0 is not None for s in r.closed):
        torch.cuda.synchronize()
        for s in r.closed:
            if s.ev0 is not None:
                s.device_ms = s.ev0.elapsed_time(s.ev1)
                r.release(s)
    return _as_dicts(r.closed, device=True)


def count(name: str, n: int = 1, of: int = 0) -> None:
    """Add ``n`` to the counter ``name`` and ``of`` to its whole (what
    ``n`` is a part of; 0 for a plain count) while a recording span is
    open; nothing otherwise."""
    r = _REC
    if r.open is not None:
        c = r.counts.get(name)
        if c is None:
            r.counts[name] = [n, of]
        else:
            c[0] += n
            c[1] += of


def counters() -> dict[str, list[int]]:
    """The counters added to since the switch last turned on, each
    ``name: [count, whole]``."""
    return {k: list(v) for k, v in _REC.counts.items()}


class _SetupSpan:
    __slots__ = ("name", "id", "call", "parent", "start_ns", "end_ns",
                 "device_ms")


def add_setup_span(name: str, start_ns: int, end_ns: int) -> None:
    """Record the set-up span ``name`` over host times already taken,
    inside the innermost open set-up span."""
    r = _REC
    s = _SetupSpan()
    s.name, s.id, s.start_ns, s.end_ns = name, r.new_id(), start_ns, end_ns
    s.parent = None if r.setup_open is None else r.setup_open.id
    s.call, s.device_ms = None, None
    r.setup.append(s)


@contextlib.contextmanager
def setup_span(name: str):
    """Record the scope as the set-up span ``name`` (host time only),
    whatever the switch."""
    r = _REC
    s = _SetupSpan()
    s.name, s.id, s.call, s.device_ms = name, r.new_id(), None, None
    s.parent = None if r.setup_open is None else r.setup_open.id
    outer, r.setup_open = r.setup_open, s
    s.start_ns = _now_ns()
    try:
        yield
    finally:
        s.end_ns = _now_ns()
        r.setup_open = outer
        r.setup.append(s)


def setup_spans() -> list[dict]:
    """The process's set-up spans, as ``spans()`` gives spans (``call``
    and the device times None)."""
    return _as_dicts(_REC.setup, device=False)


class PhaseTimer:
    """Accumulates named phase durations in seconds::

        t = PhaseTimer()
        with t.phase("sketch"):
            out = sketch_fn(...)
        t.report()  # {'sketch': seconds, ...}

    Each phase is the span ``name`` with a synchronize of the current
    CUDA device at its edges, timed on the host clock between them."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        cuda = torch.cuda.is_initialized()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with span(name):
            yield
            if cuda:
                torch.cuda.synchronize()
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self) -> dict[str, float]:
        return dict(self.times)


class _Untimed:
    """A ``PhaseTimer`` that times nothing: each phase is the span alone
    (no synchronize, nothing accumulated). Drivers take it when called
    without ``timing=True``."""

    @staticmethod
    def phase(name: str):
        return span(name)

    @staticmethod
    def report() -> dict[str, float]:
        return {}


UNTIMED = _Untimed()


class _NaNCheck(TorchFunctionMode):
    """Raise ``FloatingPointError`` at the first torch call that returns
    a floating-point tensor holding a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN produced by {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_checks():
    """Fail fast on NaNs for the scope — the analogue of the reference's
    sanitizer CI lanes: every torch call that produces a NaN raises
    ``FloatingPointError`` there (as ``jax_debug_nans`` makes JAX do),
    instead of the NaN reaching the breakdown-flag logic, and autograd's
    anomaly mode checks the backward pass. Tests and debugging only: each
    call reads its result back from the device."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        with _NaNCheck():
            yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the scope (host calls, and device kernels
    where there is a CUDA device), its Chrome trace written to
    ``log_dir/trace.json`` on exit; yields the profiler, whose
    ``key_averages()`` give the breakdown by kernel. The drivers' spans
    are on for the scope and show as ranges over their kernels."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def format_phase_breakdown(times: dict, title: str = "") -> str:
    """A phase-metrics dict as the reference's percentage breakdown block
    (rl_bqrrp.hh:586-607 prints each subroutine's µs and share of the
    total); feed it any driver's ``timing=True`` dict::

        fac, st, t = bqrrp_factored(A, cfg, st, timing=True)
        print(format_phase_breakdown(t, "BQRRP"))
    """
    total = sum(times.values())
    head = f"/// {title + ' ' if title else ''}phase breakdown ///"
    lines = [head]
    for k, v in sorted(times.items(), key=lambda kv: -kv[1]):
        lines.append(f"{k:<24}{v * 1e6:>14.0f} us"
                     f"{100.0 * v / max(total, 1e-12):>7.1f}%")
    lines.append(f"{'total':<24}{total * 1e6:>14.0f} us{100.0:>7.1f}%")
    return "\n".join(lines)
