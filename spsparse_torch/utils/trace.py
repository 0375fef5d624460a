"""Tracing hooks: profiler and NVTX ranges, and a host event log.

Counterpart of :mod:`spsparse_tpu.utils.trace`. The ops that run inside a
named scope (:func:`trace_scope` or :func:`traced`) are the hot entry
points ``spsparse.best_spmv``, ``spsparse.cg_solve_dia``,
``spsparse.pcg_solve`` and ``spsparse.bellman_ford``, and
``spsparse.consolidate``, ``spsparse.spmv``, ``spsparse.spmm``,
``spsparse.multiply_mm``, ``spsparse.multiply_mv``,
``spsparse.best_spgemm`` and ``spsparse.spgemm_tiled``.

A scope emits a range only while something records it: while a
``torch.profiler`` profile is recording, and after :func:`enable_ranges`
(for an NVTX-aware tool such as Nsight Systems, which PyTorch cannot see).
The range is a ``torch.profiler.record_function`` range and, on a CUDA
build with a card, an NVTX range of the same name. Otherwise a scope tests
two flags and the event log, and calls neither.

While :func:`enable_event_log` is on, each scope whose body returns
appends one record: ``op`` (the scope's name), ``host_s`` (the host's time
in the body; the ops do not wait for the card, so for most this is their
issue time), ``t_ns`` (the body's start in Unix nanoseconds, the clock of
the profiler's Chrome trace, whose events start at ``ts * 1000 +
baseTimeNanoseconds``) and the fields the op adds to the dict the scope
yields. :func:`log_event` appends a record with no range: the graph tier's
loops log their rounds and host syncs there.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import torch
from torch.autograd import profiler as _profiler

__all__ = ["traced", "trace_scope", "enable_event_log", "get_event_log",
           "log_event", "enable_ranges", "event_log_on"]

_EVENTS: list | None = None
_RANGES = False

# NVTX ranges need a CUDA build of torch (the CPU build's NVTX functions
# raise) and a card; decided once, at import.
_NVTX: bool = torch.version.cuda is not None and torch.cuda.is_available()


def enable_event_log(on: bool = True) -> None:
    """Start/stop recording host-side op-launch events."""
    global _EVENTS
    _EVENTS = [] if on else None


def event_log_on() -> bool:
    return _EVENTS is not None


def get_event_log() -> list:
    return list(_EVENTS or [])


def log_event(op: str, **meta) -> None:
    """Record one host-side event (no profiler range) while the log is on:
    the graph tier's loops log their rounds and host syncs here."""
    if _EVENTS is not None:
        _EVENTS.append({"op": op, **meta})


def enable_ranges(on: bool = True) -> None:
    """Emit every scope's ranges with no profiler recording: for a tool
    that reads NVTX ranges from outside the process (Nsight Systems)."""
    global _RANGES
    _RANGES = bool(on)


class _Scope:
    __slots__ = ("name", "meta", "_range", "_t0", "_t_ns")

    def __init__(self, name: str, meta: dict):
        self.name, self.meta = name, meta

    def __enter__(self) -> dict:
        self._range = None
        if _RANGES or _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if _NVTX:
                torch.cuda.nvtx.range_push(self.name)
        self._t0 = None
        if _EVENTS is not None:
            self._t_ns = time.time_ns()
            self._t0 = time.perf_counter()
        return self.meta

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._t0 is not None:
            host_s = time.perf_counter() - self._t0
        if self._range is not None:
            if _NVTX:
                torch.cuda.nvtx.range_pop()
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is None and self._t0 is not None and _EVENTS is not None:
            _EVENTS.append({"op": self.name, "host_s": host_s,
                            "t_ns": self._t_ns, **self.meta})
        return False


def trace_scope(name: str, **meta) -> _Scope:
    """A context manager around one op: its ranges while something records
    them, and its event record (``meta`` plus what the body adds to the
    dict it yields) while the log is on. A body that raises leaves the
    ranges balanced and no record."""
    return _Scope(name, meta)


def traced(name: str) -> Callable:
    """Decorator: run an op inside :func:`trace_scope`."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any):
            with trace_scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco
