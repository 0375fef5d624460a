"""K4's share of time in its grid exchanges (%): 100 x the cycles its CTAs
spent waiting for the other CTAs' slots in the two exchanges an iteration,
over their cycles from entry to exit, summed over the window's solves (the
``cycles`` of the port's ``spsparse.cg_solve_dia`` records, which K4 itself
counts). None where no record holds them."""


def read(ctx):
    import torch

    c = [e["cycles"] for e in ctx["events"]
         if e["op"] == "spsparse.cg_solve_dia" and e.get("cycles") is not None]
    if not c:
        return None
    pap, rr, total = torch.cat(c).sum(dim=0).tolist()
    return 100.0 * (pap + rr) / total if total else None
