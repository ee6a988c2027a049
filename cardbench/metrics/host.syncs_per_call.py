"""Host API calls that wait for the card (every synchronize, and the
blocking ``cudaMemcpy``) starting inside a driver call's root span, a
call: the host reads of device values that stop the host mid-call. The
root spans are put on the trace's clock by ``cardbench.spans.align``."""
from cardbench import spans


def read(rec):
    return spans.syncs_per_call(rec)
