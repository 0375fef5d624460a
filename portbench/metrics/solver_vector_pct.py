"""Share of the traced window's device time spent outside the benchmark's
spans around ``best_spmv`` (%): the solver layer's vector operations."""

from portbench import devtrace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["spans"].get("portbench.spmv"):
        return None
    total = devtrace.device_time(tr)
    if total <= 0:
        return None
    return 100.0 * (total - devtrace.device_time(tr, "portbench.spmv")) / total
