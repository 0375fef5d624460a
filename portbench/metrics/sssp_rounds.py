"""Bellman-Ford rounds a job over the window, from the port's event log
(``graph.bellman_ford``)."""


def read(ctx):
    r = [e["rounds"] for e in ctx["events"] if e["op"] == "graph.bellman_ford"]
    return sum(r) / len(r) if r else None
