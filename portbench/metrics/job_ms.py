"""Wall time of the window over the jobs completed in it (ms)."""


def read(ctx):
    if not ctx["times"]:
        return None
    return 1000.0 * ctx["window_s"] / len(ctx["times"])
