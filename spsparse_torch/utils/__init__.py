"""Utilities: profiler and NVTX ranges, the host event log, roofline
accounting."""

from .trace import (traced, trace_scope, enable_event_log, get_event_log,
                    log_event)
from .roofline import OpStats, roofline, device_hbm_bandwidth, SOL_BW

__all__ = ["traced", "trace_scope", "OpStats", "roofline",
           "device_hbm_bandwidth", "SOL_BW", "enable_event_log",
           "get_event_log", "log_event"]
