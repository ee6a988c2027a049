"""Auxiliary subsystems: phase timing, spans, profiling, memory
tracking."""
from .timing import (PhaseTimer, debug_checks, device_sync,
                     format_phase_breakdown, profile_trace, setup_spans,
                     span, spans, tracing)
from .memory import (PeakRSSTracker, analytical_peak_bytes,
                     device_memory_stats, get_rss_kb)

__all__ = ["PhaseTimer", "debug_checks", "device_sync",
           "format_phase_breakdown", "profile_trace", "setup_spans", "span",
           "spans", "tracing", "PeakRSSTracker", "analytical_peak_bytes",
           "device_memory_stats", "get_rss_kb"]
