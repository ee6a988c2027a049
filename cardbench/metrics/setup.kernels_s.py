"""Host seconds of the kernels' build and load (the set-up span
``setup.kernels``, ``_build.lib()``: the sources' check, ``nvcc`` where a
library is stale, the ``ctypes`` loads and the binding)."""
from cardbench import spans


def read(rec):
    return spans.setup_seconds(rec, "setup.kernels")
