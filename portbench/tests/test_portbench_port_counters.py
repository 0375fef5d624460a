"""The metrics that read the port's own event records (``cg_exchange_pct``,
``spmv_host_us``, ``pr_iters``), on hand-made logs: their values, and None
where the log holds nothing of theirs (as on a program without them)."""

import pytest
import torch

from portbench import harness as h


def _ctx(events, jobs=4):
    return {"events": events, "times": [0.03] * jobs, "trace": None}


def _spmv(host_s):
    return {"op": "spsparse.best_spmv", "host_s": host_s, "t_ns": 1,
            "path": "shuffle"}


def test_cg_exchange_pct_sums_every_cta_of_every_solve():
    # Two solves of two CTAs: waits (p.Ap, r.r) and entry-to-exit cycles.
    a = torch.tensor([[10, 30, 200], [20, 20, 200]], dtype=torch.int64)
    b = torch.tensor([[0, 20, 100], [40, 0, 100]], dtype=torch.int64)
    ev = [{"op": "spsparse.cg_solve_dia", "host_s": 1e-4, "t_ns": 1,
           "iters": 50, "mode": "device_memory", "grid": 2, "cycles": c}
          for c in (a, b)]
    ev.append({"op": "spsparse.cg_solve_dia", "host_s": 1e-4, "t_ns": 2,
               "iters": 50, "mode": "reference"})   # no counters: skipped
    got = h.metric_module("cg_exchange_pct").read(_ctx(ev))
    assert got == pytest.approx(100.0 * 140 / 600)


def test_spmv_host_us_is_the_median_call():
    ev = [_spmv(s) for s in (3e-6, 1e-6, 2e-6, 50e-6)]
    ev.append({"op": "spsparse.pcg_solve", "host_s": 1.0, "t_ns": 1,
               "iters": 50})
    assert h.metric_module("spmv_host_us").read(_ctx(ev)) == pytest.approx(
        2.5)


def test_pr_iters_counts_spmv_calls_a_job():
    ev = [_spmv(1e-6)] * 30 + [{"op": "graph.bellman_ford", "rounds": 3,
                                "syncs": 2}]
    assert h.metric_module("pr_iters").read(_ctx(ev, jobs=4)) == 7.5


@pytest.mark.parametrize("name", ["cg_exchange_pct", "spmv_host_us",
                                  "pr_iters"])
def test_nothing_to_read_gives_none(name):
    read = h.metric_module(name).read
    assert read(_ctx([])) is None
    # A program whose ops carry no scope of their own logs only the graph
    # tier's loops.
    assert read(_ctx([{"op": "graph.bellman_ford", "rounds": 40,
                       "syncs": 39}])) is None
