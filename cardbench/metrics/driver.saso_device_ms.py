"""CQRRPT's sketch, device ms a call: the ``saso`` span (the sparse
operator's draw and its product with A) under the ``cqrrpt`` root,
between its CUDA events (``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    return spans.device_ms(
        rec, lambda s, up: s["name"] == "saso"
        and up is not None and up["name"] == "cqrrpt")
