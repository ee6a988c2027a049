"""One run of one cell: set-up, the measured window, the traced stretch,
and the check of what the timed calls returned.

Everything a cell is sits in files found by name: ``workloads/<cell>.json``
(its configuration, entry, the entry's settings, its controls' settings,
the calls it checks and traces, its limits, its ``why``),
``configs/<config>.json`` (the input's source, shape, type and generator),
``makers/<kind>.py`` (a generator of its own, where ``inputs.MAKERS`` has
none), ``entries/<entry>.py`` (how to call the program and judge its
output; ``entries/__init__.py``) and ``metrics/<metric>.py`` (a per-layer
reader). The harness takes the input as whatever object the maker
returns, and hands it to the entry alone. ``BENCHMARK.json`` says which
metrics a cell reports.

The loop is closed with one caller: each call ends in
``torch.cuda.synchronize()`` before the next starts, and the state a
call returns feeds the next, so every call draws its own sketch of the
same matrix. ``call_ms`` is the window's seconds over the calls it
completed; ``call_p95_ms`` the 95th percentile of the calls' own times.
"""
from __future__ import annotations

import importlib
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from . import inputs, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CSRC = ROOT / "randlapack_tpu_torch" / "csrc"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def entry(name: str):
    return importlib.import_module(f"cardbench.entries.{name}")


def reader(metric: str):
    """The per-layer metric's ``read`` function, from
    ``metrics/<metric>.py``."""
    return inputs.module_at(HERE / "metrics" / f"{metric}.py").read


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metrics_of(cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics of BENCHMARK.json that
    ``cell`` reports: those that list it, or list no cells."""
    return [m for m in benchmark()[kind]
            if "workloads" not in m or cell in m["workloads"]]


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95 % of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def sample_calls(seed: int, spec: dict) -> set:
    """The window's calls whose outputs are kept and checked, besides its
    last: ``count`` indices drawn from the seed among the first
    ``first``."""
    rng = np.random.default_rng(inputs.derive(seed, 4))
    k = min(spec["count"], spec["first"])
    return {int(i) for i in rng.choice(spec["first"], size=k, replace=False)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, traced: bool, t0: float,
             device="cuda", log=None) -> dict:
    """Run cell ``name`` once (module docstring) and return its result
    line as a dict, ``checks`` last. ``t0`` is the process's start on
    ``time.perf_counter``'s clock."""
    wl = workload(name)
    cfg = config(wl["config"])
    settings = wl["settings"]
    ent = entry(wl["entry"])
    from randlapack_tpu_torch import RNGState

    # -- set-up: the program's kernels (built on a checkout's first run),
    # the input, and warm calls of the cell's own shape: as many as the
    # window holds outputs at once (the sampled ones and the current), each
    # held, so the allocator's cache has the window's memory before it
    prep = ent.prepare(settings)
    inp = inputs.make(cfg, seed, device)
    state = RNGState(inputs.derive(seed, 3))
    warm = []
    for _ in range(wl["sample"]["count"] + 1):
        out, state = ent.call(inp, state, prep)
        warm.append(out)
    _sync(device)
    del warm, out
    t_setup = time.perf_counter() - t0

    # -- the window
    keep_at = sample_calls(seed, wl["sample"])
    kept, times = [], []
    trace_at = 1 if traced else -1
    n_trace = wl["trace_calls"]
    prof = None
    start = time.perf_counter()
    calls = 0
    while True:
        if calls == trace_at:
            from torch.profiler import ProfilerActivity, profile
            act = (ProfilerActivity.CUDA if torch.device(device).type ==
                   "cuda" else ProfilerActivity.CPU)
            prof = profile(activities=[act])
            prof.start()
        c0 = time.perf_counter()
        out, state = ent.call(inp, state, prep)
        _sync(device)
        c1 = time.perf_counter()
        if prof is not None and calls == trace_at + n_trace - 1:
            prof.stop()
        times.append(c1 - c0)
        if calls in keep_at:
            kept.append(out)
        calls += 1
        if c1 - start >= seconds and (not traced
                                      or calls >= trace_at + n_trace):
            break
        del out
    window = c1 - start
    if calls - 1 not in keep_at:
        kept.append(out)
    del out

    # -- the traced run's phases and record
    phases = {}
    if traced and hasattr(ent, "phases"):
        for _ in range(wl["phase_calls"]):
            times_i, state = ent.phases(inp, state, prep)
            for k, v in times_i.items():
                phases.setdefault(k, []).append(v)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)

    result = dict(correct=False, attempted=calls, failed=0, metrics={},
                  device=dict(platform="gpu" if torch.device(device).type
                              == "cuda" else torch.device(device).type,
                              kind=(torch.cuda.get_device_name()
                                    if torch.device(device).type == "cuda"
                                    else "cpu"),
                              count=wl["chips"], memory_peak_bytes=peak))
    if traced:
        dev_ev, host_ev = trace.events(prof)
        del prof
        rec = trace.record(dev_ev, host_ev, n_trace, trace.kernel_files(CSRC),
                           ent.schedule(cfg["shape"], settings), phases)
        del dev_ev, host_ev
        result["device"]["busy_s"] = trace.busy_seconds(rec)
        result["device"]["window_s"] = rec["window_s"]
        for m in metrics_of(name, "per_layer"):
            value = reader(m["name"])(rec)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value,
                                                    unit=m["unit"])
        result["breakdown"] = trace.breakdown(rec)
        del rec
    else:
        own = dict(call_ms=window / calls * 1e3, call_p95_ms=p95(times) * 1e3,
                   setup_s=t_setup)
        for m in metrics_of(name, "end_to_end"):
            result["metrics"][m["name"]] = dict(value=own[m["name"]],
                                                unit=m["unit"])
    if log is not None:
        q = (statistics.quantiles(times, n=4) if len(times) > 1
             else times * 3)
        print(f"[cardbench] {name} seed {seed}: {calls} calls in "
              f"{window:.4f} s, first timed call {times[0]:.4f} s, call "
              f"quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f} s, longest "
              f"{max(times):.4f} s, setup {t_setup:.3f} s, peak {peak} "
              f"bytes", file=log, flush=True)

    # -- the check: the program's state freed, the reference in float64
    del state, prep
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    worst: dict = {}
    for out in kept:
        for k, v in ent.check(inp, out, settings).items():
            if math.isnan(v) or not v <= worst.get(k, -math.inf):
                worst[k] = v
    del kept
    checks = {k: (worst.get(k, math.inf), lim)
              for k, lim in wl["limits"].items()}
    result["correct"] = calls > 0 and all(v <= lim
                                          for v, lim in checks.values())
    # a number that is not finite (a NaN residual) is written as text
    result["checks"] = {k: dict(value=v if math.isfinite(v) else repr(v),
                                limit=lim) for k, (v, lim) in checks.items()}
    return result
