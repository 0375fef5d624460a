"""Utilities: profiler ranges and the host event log."""

from .trace import (traced, trace_scope, enable_event_log, get_event_log,
                    log_event)

__all__ = ["traced", "trace_scope", "enable_event_log", "get_event_log",
           "log_event"]
