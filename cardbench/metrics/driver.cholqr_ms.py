"""CQRRPT's ``cholqr`` phase (the Gram, its Cholesky factor, Q and R on
the preconditioned A), ms a call: the median over the traced run's
``timing=True`` calls."""
import statistics


def read(rec):
    times = rec["phases"].get("cholqr")
    return statistics.median(times) * 1e3 if times else None
