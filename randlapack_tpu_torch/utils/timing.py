"""Phase timing and profiling (counterpart of
``randlapack_tpu/utils/timing.py``; reference: the per-driver fixed-slot
timing vectors, e.g. BQRRP's 10 slots rl_bqrrp.hh:584-607, reported as a
named-phase dict).

PyTorch launches CUDA work asynchronously, so a phase is timed on the
host clock between two ``device_sync`` barriers. ``profile_trace`` gives
the device-level breakdown (``torch.profiler``), ``debug_checks`` the
fail-fast NaN mode of the JAX package's ``jax_debug_nans``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.overrides import TorchFunctionMode


def device_sync(out: torch.Tensor) -> None:
    """Wait for the device that holds ``out``; a no-op on the CPU."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


class PhaseTimer:
    """Accumulates named phase durations in seconds::

        t = PhaseTimer()
        with t.phase("sketch"):
            out = sketch_fn(...); device_sync(out)
        t.report()  # {'sketch': seconds, ...}
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self) -> dict[str, float]:
        return dict(self.times)


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
    ``key_averages()`` give the breakdown by kernel."""
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
