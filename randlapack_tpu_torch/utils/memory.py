"""Memory tracking (counterpart of ``randlapack_tpu/utils/memory.py``;
reference: RandLAPACK/testing/rl_memory_tracker.hh — ``get_rss_kb``
/proc reader :20, ``PeakRSSTracker`` background sampler :41-77,
analytical peak-memory formulas per algorithm :87-129).

Device memory comes from PyTorch's caching allocator
(``torch.cuda.memory_stats``), the number that matters for
device-resident algorithms.
"""
from __future__ import annotations

import threading
import time

import torch


def get_rss_kb() -> int:
    """Current host RSS in kB (reads /proc/self/status, like the
    reference); -1 where there is no such file."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


def device_memory_stats(device=None) -> dict:
    """Device memory statistics of a CUDA device (the current one by
    default), in bytes: ``bytes_in_use`` (allocated tensors),
    ``peak_bytes_in_use`` (their peak since the last
    ``torch.cuda.reset_peak_memory_stats``), ``bytes_limit`` (the card's
    memory) and every counter of ``torch.cuda.memory_stats``. An empty
    dict where there is no CUDA device, as the JAX package returns for a
    backend without statistics."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda") if device is None else torch.device(device)
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.get_device_properties(
                dev).total_memory,
            **torch.cuda.memory_stats(dev)}


class PeakRSSTracker:
    """Background-thread peak host-RSS sampler (reference :41-77)."""

    def __init__(self, interval_s: float = 0.005):
        self.interval = interval_s
        self.peak_kb = -1
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        self._stop.clear()
        self.peak_kb = get_rss_kb()

        def loop():
            while not self._stop.is_set():
                self.peak_kb = max(self.peak_kb, get_rss_kb())
                time.sleep(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.peak_kb = max(self.peak_kb, get_rss_kb())
        return False


def analytical_peak_bytes(algorithm: str, m: int, n: int,
                          block: int | None = None, dtype_bytes: int = 4,
                          d_factor: float = 1.25) -> int:
    """Analytical peak device-memory models per algorithm (reference
    :87-129 ports; the JAX package's models, buffer for buffer)."""
    b = block or 256
    K = min(m, n)
    if algorithm == "cholqr_linops":
        # operator block (m·b) + Gram (n²) + R (n²)
        return dtype_bytes * (m * b + 2 * n * n)
    if algorithm == "scholqr3_linops":
        return dtype_bytes * (m * b + 3 * n * n)
    if algorithm == "cqrrt":
        d = int(d_factor * n)
        return dtype_bytes * (m * n + d * n + 2 * n * n + m * n)
    if algorithm == "cqrrpt":
        d = int(d_factor * n)
        return dtype_bytes * (2 * m * n + d * n + 2 * n * n)
    if algorithm == "bqrrp":
        d = int(d_factor * b)
        return dtype_bytes * (2 * m * n + m * K + K * n + d * n)
    if algorithm == "rsvd":
        return dtype_bytes * (2 * m * n + 2 * m * b + b * n)
    if algorithm == "abrik":
        return dtype_bytes * (m * n + (m + n) * K + K * K)
    raise ValueError(f"no model for {algorithm}")
