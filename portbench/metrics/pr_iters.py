"""PageRank iterations a trial: the port's ``spsparse.best_spmv`` records
(one SpMV an iteration) over the jobs of the window."""


def read(ctx):
    k = sum(e["op"] == "spsparse.best_spmv" for e in ctx["events"])
    return k / len(ctx["times"]) if k and ctx["times"] else None
