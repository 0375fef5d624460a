"""Tracing hooks: profiler ranges plus an optional host event log.

Counterpart of :mod:`spsparse_tpu.utils.trace`. Every public op runs inside
a ``torch.profiler.record_function`` range, so ``torch.profiler`` traces
attribute host and device time to framework ops, and, on a CUDA build with
a card, inside an NVTX range of the same name, so that an NVTX-aware
profiler (Nsight Systems) sees the ops on its timeline. The event log
records op launches with their host time for quick audits without a full
profile.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable

import torch

__all__ = ["traced", "trace_scope", "enable_event_log", "get_event_log",
           "log_event"]

_EVENTS: list | None = None

# NVTX ranges need a CUDA build of torch (the CPU build's NVTX functions
# raise) and a card; decided once, at import.
_NVTX: bool = torch.version.cuda is not None and torch.cuda.is_available()


def enable_event_log(on: bool = True) -> None:
    """Start/stop recording host-side op-launch events."""
    global _EVENTS
    _EVENTS = [] if on else None


def get_event_log() -> list:
    return list(_EVENTS or [])


def log_event(op: str, **meta) -> None:
    """Record one host-side event (no profiler range) while the log is on:
    the graph tier's loops log their rounds and host syncs here."""
    if _EVENTS is not None:
        _EVENTS.append({"op": op, **meta})


@contextlib.contextmanager
def trace_scope(name: str, **meta):
    """``record_function`` range + NVTX range (CUDA builds with a card) +
    optional host event record. The NVTX range is popped however the body
    ends, so a raising op leaves the ranges balanced."""
    t0 = time.perf_counter() if _EVENTS is not None else 0.0
    with torch.profiler.record_function(name):
        if not _NVTX:
            yield
        else:
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
    if _EVENTS is not None:
        _EVENTS.append({"op": name, "host_s": time.perf_counter() - t0,
                        **meta})


def traced(name: str) -> Callable:
    """Decorator: run an op inside a named profiler range."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            with trace_scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
