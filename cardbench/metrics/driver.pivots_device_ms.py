"""HQRRP's pivot selection and panel factorization, device ms a call: the
``qrcp`` (K5 on the sketch) and ``qr`` (the panel's gather, its deferred
correction and K6) spans of every block, between their CUDA events
(``cardbench.spans``). In the tall cell they are the sketch QRCP's,
nested in CQRRPT's ``qrcp`` phase."""
from cardbench import spans


def read(rec):
    return spans.device_ms(
        rec, lambda s, up: s["name"] in ("qrcp", "qr")
        and up is not None and up["name"] == "block")
