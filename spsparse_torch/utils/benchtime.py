"""Device timing of chained calls.

Counterpart of :func:`spsparse_tpu.utils.benchtime.bench_chained`.
:func:`bench_chained` chains ``iters`` calls through a data dependency
(each call consumes the previous call's output) and fetches a scalar that
depends on every element of the last output, so the chain cannot be cut
short. On CUDA tensors each rep's chain is timed by CUDA events on the
current stream; on CPU tensors by the host clock.

The JAX module's ``bench_fori`` and ``bench_slope`` are not ported: they
work around a remote-execution runtime's fixed per-loop costs, which a
CUDA stream does not have (ROADMAP "Do not port").
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["bench_chained"]


def _leaves(y) -> list:
    if isinstance(y, dict):
        return [v for k in y for v in _leaves(y[k])]
    if isinstance(y, (tuple, list)):
        return [v for item in y for v in _leaves(item)]
    return [] if y is None else [y]


def _force(y) -> float:
    """Fetch a scalar that depends on every element of y (tensors inside
    tuples, lists and dicts too)."""
    tot = 0.0
    for leaf in _leaves(y):
        tot += float(torch.as_tensor(leaf).to(torch.float32).sum())
    return tot


def _cuda_device(y):
    for leaf in _leaves(y):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def bench_chained(step: Callable[[Any], Any], init: Any, *, iters: int = 10,
                  warmup: int = 2, reps: int = 3) -> float:
    """Median per-iteration time in seconds of ``y = step(y)`` chains.

    ``step`` must map its output type to its input type (shape/dtype
    preserved) so calls chain through a true data dependency. ``warmup``
    chained calls and a fetch come first; then, ``reps`` times, ``iters``
    calls from ``init`` and a fetch. Where ``init`` holds a CUDA tensor the
    chain is timed by CUDA events recorded around it (the fetch follows
    the end event); otherwise by ``time.perf_counter`` around the chain and
    its fetch.
    """
    dev = _cuda_device(init)
    y = init
    for _ in range(warmup):
        y = step(y)
    _force(y)

    times = []
    for _ in range(reps):
        y = init
        if dev is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                y = step(y)
            _force(y)
            times.append((time.perf_counter() - t0) / iters)
            continue
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                y = step(y)
            end.record()
            _force(y)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / iters)
    return float(np.median(times))
