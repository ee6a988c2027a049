"""HQRRP's trailing update of A, device ms a call: the ``updating_A``
spans (each block's Vᵀ·(A ⊙ live) and U, and each group's update of A),
between their CUDA events (``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    return spans.device_ms(rec, lambda s, up: s["name"] == "updating_A")
