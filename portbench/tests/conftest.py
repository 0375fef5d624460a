"""Shared fixtures of the benchmark's CPU tests: tiny copies of the
configurations (the widths of the stencil and the degree of the graph
kept, the scale cut) and a one-thread torch."""

import pytest
import torch

from portbench import harness as h


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {"hpcg27": {"nx": 12, "ny": 10, "nz": 8}, "urand": {"scale": 10}}


@pytest.fixture
def tiny():
    """Every configuration of BENCHMARK.json, cut to a tiny size."""
    out = {}
    for c in h.load_spec()["configs"]:
        cfg = h.load_config(c["name"])
        out[c["name"]] = dict(cfg, **TINY[cfg["kind"]])
    return out
