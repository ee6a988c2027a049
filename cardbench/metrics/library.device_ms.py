"""Device ms a call of everything that is not one of the program's own
kernels (``csrc/*.cu``): cuBLAS, cuSOLVER, ATen's kernels, copies and
fills."""
from cardbench import trace


def read(rec):
    if not rec["device"] or not rec["calls"]:
        return None
    s = trace.device_seconds(rec, exclude=trace.program_kernels(rec))
    return s * 1e3 / rec["calls"]
