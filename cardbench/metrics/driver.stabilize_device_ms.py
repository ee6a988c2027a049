"""REVD2's bases between products, device ms a call: SYPS's ``stabilize``
spans (the PLU stabilization of each pass: the LU, its swaps read on the
host, the rows put back) and SYRF's ``syrf_orth`` (CholQR2, and its
Householder fallback where the flag read on the host asks for it),
between their CUDA events (``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    return spans.device_ms(
        rec, lambda s, up: s["name"] in ("stabilize", "syrf_orth"))
