"""95th percentile of the jobs' wall times, issue to result read on the
host (ms); needs 20 jobs or more."""

import statistics


def read(ctx):
    t = ctx["times"]
    if len(t) < 20:
        return None
    return 1000.0 * statistics.quantiles(t, n=20)[18]
