"""CQRRPT's CholQR of the preconditioned A (the Gram, its Cholesky
factor, Q and R), device ms a call on the untimed path: the ``cholqr``
span under the ``cqrrpt`` root, between its CUDA events
(``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    return spans.device_ms(
        rec, lambda s, up: s["name"] == "cholqr"
        and up is not None and up["name"] == "cqrrpt")
