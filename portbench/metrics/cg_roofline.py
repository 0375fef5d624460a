"""K4's share of its roofline (%): ``iters`` times one SpMV's least bytes
at the card's peak rate, a solve, over the device time of the operations
launched inside the benchmark's span around each ``cg_solve_dia``."""

from portbench import devtrace
from portbench.metrics import _roofline


def read(ctx):
    tr = ctx["trace"]
    least = _roofline.spmv_seconds(ctx["cfg"], ctx["device_name"])
    if tr is None or least is None:
        return None
    solves = tr["spans"].get("portbench.cg_solve", 0)
    dt = devtrace.device_time(tr, "portbench.cg_solve")
    if not solves or dt <= 0:
        return None
    return 100.0 * solves * int(ctx["mix"]["iters"]) * least / dt
