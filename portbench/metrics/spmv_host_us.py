"""The host's time inside a ``best_spmv`` call (us): the median ``host_s``
of the port's ``spsparse.best_spmv`` records over the window. The call does
not wait for the card, so this is its issue time."""

import statistics


def read(ctx):
    h = [e["host_s"] for e in ctx["events"] if e["op"] == "spsparse.best_spmv"]
    return 1e6 * statistics.median(h) if h else None
