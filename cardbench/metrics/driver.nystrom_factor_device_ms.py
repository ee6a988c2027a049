"""REVD2's Nyström factor, device ms a call: the ``nystrom_factor`` span
under the ``revd2`` root (the shift, QᵀY, its Cholesky factor, the
triangular solve, the SVD and λ), between its CUDA events
(``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    return spans.device_ms(
        rec, lambda s, up: s["name"] == "nystrom_factor"
        and up is not None and up["name"] == "revd2")
