"""Host seconds of the package's import (the set-up span
``setup.import``: ``randlapack_tpu_torch/__init__.py``, torch already
imported by the harness)."""
from cardbench import spans


def read(rec):
    return spans.setup_seconds(rec, "setup.import")
