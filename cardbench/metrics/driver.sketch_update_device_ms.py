"""HQRRP's sketch updates, device ms a call: the ``updating_sketch_g``
(G·Q of each block, and each group's update of G) and
``updating_sketch_y`` (Y's downdate) spans, between their CUDA events
(``cardbench.spans``)."""
from cardbench import spans


def read(rec):
    return spans.device_ms(
        rec, lambda s, up: s["name"] in ("updating_sketch_g",
                                         "updating_sketch_y"))
