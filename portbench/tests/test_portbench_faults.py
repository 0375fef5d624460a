"""``correct`` has to come out false when the timed path is broken, and
the control (the reference in bfloat16 in the program's place) has to
fail a limit. The runs skip the harness's look for a card and drive the
rest of a run on the CPU at a tiny size; the fault is planted in the port
call that the job drives. The exchange between chips is not a fault these
one-chip cells can have."""

import time

import pytest
import torch

from portbench import harness as h


def _run(cell, cfg, seed=2 ** 31 + 11, seconds=0.3):
    spec = h.load_spec()
    w = h.find_cell(spec, cell)
    return h.run_cell(cell, cfg[w["config"]], h.load_mix(w["traffic"]), [],
                      seed=seed, seconds=seconds, trace=False, device="cpu",
                      t_start=time.perf_counter())


def _cell(job):
    """The cell of BENCHMARK.json whose mix drives ``job``."""
    return next(w["name"] for w in h.load_spec()["workloads"]
                if h.load_mix(w["traffic"])["job"] == job)


def _unchanged_x(x):          # the solve returns its starting state
    return torch.zeros_like(x)


def _half_x(x):               # half of the answer left out
    x = x.clone()
    x[x.shape[-1] // 2:] = 0
    return x


def _altered_x(x):            # one element altered where it is produced
    x = x.clone()
    x[x.shape[-1] // 3] += 1.0
    return x


FAULTS = {"unchanged": _unchanged_x, "half": _half_x, "altered": _altered_x}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  h.load_spec()["workloads"]])
def test_a_sound_run_is_correct(tiny, cell):
    assert _run(cell, tiny)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cg_faults(tiny, monkeypatch, fault):
    from portbench.jobs import hpcg_cg
    real = hpcg_cg.cg_solve_dia

    def broken(prep, b, *, iters):
        x, rs = real(prep, b, iters=iters)
        return FAULTS[fault](x), rs

    monkeypatch.setattr(hpcg_cg, "cg_solve_dia", broken)
    assert _run(_cell("hpcg_cg"), tiny)["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_pcg_faults(tiny, monkeypatch, fault):
    from portbench.jobs import hpcg_pcg
    real = hpcg_pcg.best_spmv
    if fault == "unchanged":      # the SpMV returns its operand
        monkeypatch.setattr(hpcg_pcg, "best_spmv", lambda a, x: x.clone())
    elif fault == "half":
        monkeypatch.setattr(hpcg_pcg, "best_spmv",
                            lambda a, x: _half_x(real(a, x)))
    else:
        solve = hpcg_pcg.pcg_solve

        def broken(*args, **kw):
            x, rr = solve(*args, **kw)
            return _altered_x(x), rr

        monkeypatch.setattr(hpcg_pcg, "pcg_solve", broken)
    assert _run(_cell("hpcg_pcg"), tiny)["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_pr_faults(tiny, monkeypatch, fault):
    from portbench.jobs import gap_pr
    real = gap_pr.best_spmv

    def broken(a, x):
        y = real(a, x)
        if fault == "unchanged":
            return x.clone()
        if fault == "half":
            return _half_x(y)
        y = y.clone()
        y[y.shape[0] // 3] *= 2.0
        return y

    monkeypatch.setattr(gap_pr, "best_spmv", broken)
    assert _run(_cell("gap_pr"), tiny)["correct"] is False


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_sssp_faults(tiny, monkeypatch, fault):
    from portbench.jobs import gap_sssp
    real = gap_sssp.bellman_ford

    def broken(g, roots):
        d = real(g, roots)
        if fault == "unchanged":      # the starting distances
            d0 = torch.full_like(d, float("inf"))
            d0[0, roots[0]] = 0
            return d0
        d = d.clone()
        if fault == "half":
            d[:, d.shape[1] // 2:] = float("inf")
        else:
            k = int(torch.nonzero(torch.isfinite(d[0]) & (d[0] > 0))[0, 0])
            d[0, k] *= 1.5
        return d

    monkeypatch.setattr(gap_sssp, "bellman_ford", broken)
    assert _run(_cell("gap_sssp"), tiny)["correct"] is False


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  h.load_spec()["workloads"]])
def test_the_control_fails_a_limit(tiny, cell):
    w = h.find_cell(h.load_spec(), cell)
    mix = h.load_mix(w["traffic"])
    mod = h.job_module(mix)
    seen = {}

    def control(cfg, mix_, seed, dev, samples):
        seen.update(mod.check(cfg, mix_, seed, dev, samples, control=True))
        return seen

    r = h.run_cell(cell, tiny[w["config"]], mix, [], seed=77, seconds=0.3,
                   trace=False, device="cpu", t_start=time.perf_counter(),
                   checker=control)
    assert r["correct"] is False
    assert any(seen[k] > v for k, v in mix["limits"].items())
