"""The window's wall time over all its Bellman-Ford rounds (ms/round)."""


def read(ctx):
    r = sum(e["rounds"] for e in ctx["events"]
            if e["op"] == "graph.bellman_ford")
    return 1000.0 * ctx["window_s"] / r if r else None
