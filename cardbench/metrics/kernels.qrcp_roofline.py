"""Pivot selection and panel factorization's share of their roofline, %:
the least time of the K5 and K6 work the block schedule needs
(``yardstick``), over the device time of ``csrc/qrcp.cu``'s kernels in
the traced calls."""
from cardbench import roofline


def read(rec):
    return roofline.share(rec, "qrcp", ("qrcp",))
