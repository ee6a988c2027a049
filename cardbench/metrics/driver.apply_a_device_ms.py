"""REVD2's products with the operator (K4 on the card), device ms a call:
every ``apply_a`` span (SYPS's passes, SYRF's A·Ω, Y = A·Q and the power
estimate's passes) under the ``revd2`` root, between its CUDA events
(``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    sp = spans.of(rec)
    if sp is None:
        return None
    root = {s["id"]: s["name"] for s in sp if s["parent"] is None}
    return spans.device_ms(
        rec, lambda s, up: s["name"] == "apply_a"
        and root.get(s["call"]) == "revd2")
