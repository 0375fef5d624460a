"""Tracing hooks: profiler ranges plus an optional host event log.

Counterpart of :mod:`spsparse_tpu.utils.trace`. Every public op runs inside
a ``torch.profiler.record_function`` range, so ``torch.profiler`` traces
attribute host and device time to framework ops; the event log records op
launches with their host time for quick audits without a full profile.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable

import torch

__all__ = ["traced", "trace_scope", "enable_event_log", "get_event_log"]

_EVENTS: list | None = None


def enable_event_log(on: bool = True) -> None:
    """Start/stop recording host-side op-launch events."""
    global _EVENTS
    _EVENTS = [] if on else None


def get_event_log() -> list:
    return list(_EVENTS or [])


@contextlib.contextmanager
def trace_scope(name: str, **meta):
    """``record_function`` range + optional host event record."""
    t0 = time.perf_counter() if _EVENTS is not None else 0.0
    with torch.profiler.record_function(name):
        yield
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
