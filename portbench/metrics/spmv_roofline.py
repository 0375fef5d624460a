"""The SpMV's share of its roofline (%): one SpMV's least bytes at the
card's peak rate, times the SpMVs, over the device time of the operations
launched inside the benchmark's spans around ``best_spmv``."""

from portbench import devtrace
from portbench.metrics import _roofline


def read(ctx):
    tr = ctx["trace"]
    least = _roofline.spmv_seconds(ctx["cfg"], ctx["device_name"])
    if tr is None or least is None:
        return None
    calls = tr["spans"].get("portbench.spmv", 0)
    dt = devtrace.device_time(tr, "portbench.spmv")
    if not calls or dt <= 0:
        return None
    return 100.0 * calls * least / dt
