"""Host seconds of the process's first driver call (the set-up span
``setup.first_call``, the first root span, to its return: lazy module
loads, the libraries' handles, and ``setup.kernels`` inside it where the
kernels load on first use)."""
from cardbench import spans


def read(rec):
    return spans.setup_seconds(rec, "setup.first_call")
