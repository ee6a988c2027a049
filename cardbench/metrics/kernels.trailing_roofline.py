"""The trailing updates' share of their roofline, %: the least time the
card could take for the K1/K2 products that the cell's block schedule
needs (``yardstick``, at the products' form), over the device time of
``csrc/wy.cu``'s, ``csrc/wy_ring.cu``'s and ``csrc/tc.cuh``'s kernels (the
products, their pre-passes and the fold of split parts) in the traced
calls."""
from cardbench import roofline


def read(rec):
    return roofline.share(rec, "trailing", ("wy", "wy_ring", "tc"))
