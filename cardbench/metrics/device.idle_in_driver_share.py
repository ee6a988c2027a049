"""The share of the traced stretch, %, in which the card was idle while a
driver call's root span was open on the host (a gap between device
activity counts where its middle lies in a root span, as
``trace.breakdown`` places gaps): the idle that the driver's own host
work causes, apart from the loop's turnaround between calls."""
from cardbench import spans


def read(rec):
    return spans.idle_in_roots_share(rec)
