"""The device trace of a traced window, read from ``torch.profiler``'s
Chrome trace: device operations (kernels, copies, sets) with the
benchmark's spans that were open on the host when each was launched
(matched through the launch's correlation id), device busy time, and the
idle gaps between operations with the span the host was in."""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "portbench."
JOB_SPAN = "portbench.job"


def _stacks(spans, points):
    """For each time in ``points``: the names of the spans open at it,
    outermost first. ``spans``: ``(start, end, name)`` on one host thread,
    so they nest."""
    ev = []
    for i, (s, e, _) in enumerate(spans):
        ev.append((s, 1, i))
        ev.append((e, 0, i))
    for j, t in enumerate(points):
        ev.append((t, 2, j))
    ev.sort()
    open_, out = [], [()] * len(points)
    for _, kind, i in ev:
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            if i in open_:
                open_.remove(i)
        else:
            out[i] = tuple(spans[k][2] for k in open_)
    return out


def summarize(events: list) -> dict | None:
    """``{"window_s", "busy_s", "ops": [(name, seconds, stack)],
    "spans": {name: count}, "idle": {innermost span: seconds}}`` over the
    traced window, from the first job span's start to the last one's end
    (None if the trace holds no job span)."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    jobs = [(s, e) for s, e, n in spans if n == JOB_SPAN]
    if not jobs:
        return None
    w0, w1 = min(s for s, _ in jobs), max(e for _, e in jobs)
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = e["ts"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1]
    stacks = _stacks(spans, [launch.get(e.get("args", {}).get("correlation"),
                                        float("-inf")) for e in dev])
    ops = [(e["name"], e["dur"] * 1e-6, st) for e, st in zip(dev, stacks)]
    # Busy: the union of the operations' intervals, clipped to the window.
    iv = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = defaultdict(float)
    for (g0, g1), st in zip(gaps, _stacks(spans, [(a + b) / 2
                                                  for a, b in gaps])):
        idle[st[-1] if st else "(no span)"] += (g1 - g0) * 1e-6
    count = defaultdict(int)
    for s, e, n in spans:
        if w0 <= s <= w1:
            count[n] += 1
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6, "ops": ops,
            "spans": dict(count), "idle": dict(idle)}


def load(path) -> dict | None:
    with open(path) as f:
        return summarize(json.load(f).get("traceEvents", []))


def device_time(summary: dict, span: str | None = None) -> float:
    """Seconds of device operations, all of them or those launched inside
    ``span``."""
    return sum(d for _, d, st in summary["ops"] if span is None or span in st)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time, by name, and the idle time by the span the host was in."""
    by_name = defaultdict(float)
    for name, d, _ in summary["ops"]:
        by_name[name[:160]] += d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
