"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, the metrics, and the result line.

Everything specific to a configuration, a mix or a metric is found by
name: ``configs/<config>.json``, ``mixes/<traffic>.json`` (its ``"job"``
names ``jobs/<job>.py``), ``metrics/<metric>.py`` (``read(ctx)`` returns
a number, or None where it finds nothing to read).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
from pathlib import Path

from . import devtrace

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
CONFIG_DIR = PKG / "configs"
MIX_DIR = PKG / "mixes"
METRIC_DIR = PKG / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "spsparse_tpu")

# The traced part of a --trace 1 window: the first jobs until both hold.
TRACE_MIN_S = 2.0
TRACE_MIN_JOBS = 3
# A run whose jobs keep raising stops after this many.
MAX_FAILED_JOBS = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(CONFIG_DIR / f"{name}.json")


def load_mix(name: str) -> dict:
    return load_json(MIX_DIR / f"{name}.json")


def job_module(mix: dict):
    return importlib.import_module(f"portbench.jobs.{mix['job']}")


def metric_module(name: str, directory: Path = METRIC_DIR):
    """``metrics/<name>.py``, loaded from its file (a name may hold dots)."""
    path = directory / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: end-to-end ones untraced,
    per-layer ones traced, each where its ``workloads`` (if any) name the
    cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m
            or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Spans:
    """The benchmark's spans: profiler ranges while a run is traced,
    nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


def _stop_trace(prof, device) -> str:
    """Stop the profiler and write its Chrome trace to a temporary file."""
    from .jobs.common import sync
    sync(device)
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


class Reservoir:
    """A uniform sample of ``size`` jobs' answers over however many jobs
    the window runs, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(
            seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def run_cell(cell: str, cfg: dict, mix: dict, metrics: list[dict], *,
             seed: int, seconds: float, trace: bool, device,
             t_start: float, checker=None) -> dict:
    """One run on ``device``; returns the result line's object. The caller
    has checked the device. ``checker`` replaces the job's reference check
    (the control runs use it)."""
    import torch

    from spsparse_torch.utils.trace import enable_event_log, get_event_log

    from .jobs.common import sync

    cuda = torch.device(device).type == "cuda"
    mod = job_module(mix)
    span = Spans(trace)
    job = mod.Job(cfg, mix, seed, device, span)
    job.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sample = Reservoir(int(mix["samples"]), seed)
    times, failed = [], 0
    enable_event_log(True)
    prof = None
    trace_path = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    paused = 0.0
    w0 = time.perf_counter()
    k = 0
    while True:
        t0 = time.perf_counter()
        try:
            with span("portbench.job"):
                out = job.run(k)
        except Exception as exc:  # a failed job counts; the run goes on
            print(f"portbench: job {k} failed: {exc!r}", file=sys.stderr)
            failed += 1
            out = None
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if out is not None:
            sample.offer(out)
        k += 1
        done = t1 - w0 - paused >= seconds or failed > MAX_FAILED_JOBS
        if prof is not None and (done or (t1 - w0 >= TRACE_MIN_S
                                          and k >= TRACE_MIN_JOBS)):
            trace_path = _stop_trace(prof, device)
            prof = None
            paused = time.perf_counter() - t1
        if done:
            break
    window_s = time.perf_counter() - w0 - paused
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    events = get_event_log()
    enable_event_log(False)
    prepare_s = getattr(job, "prepare_s", None)
    job.close()
    del job
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    check = checker or mod.check
    readings = check(cfg, mix, seed, device, sample.items)
    limits = mix["limits"]
    checks = {name: {"value": readings[name], "limit": limits[name]}
              for name in limits}
    correct = (failed == 0 and bool(sample.items)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    summary = None
    if trace_path is not None:
        summary = devtrace.load(trace_path)
        os.unlink(trace_path)
    ctx = {"cell": cell, "cfg": cfg, "mix": mix, "times": times,
           "window_s": window_s, "setup_s": setup_s,
           "prepare_s": prepare_s,
           "peak_bytes": peak, "events": events, "trace": summary,
           "device_name": (torch.cuda.get_device_name(device) if cuda
                           else "cpu")}
    values = {}
    for m in metrics:
        v = metric_module(m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": ctx["device_name"], "count": 1,
           "memory_peak_bytes": max(setup_peak, peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": len(times), "failed": failed,
              "metrics": values, "device": dev}
    if summary is not None:
        result["breakdown"] = devtrace.breakdown(summary)
    result["checks"] = checks
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds
    its kernels into ``spsparse_torch/_kernels/<hash>`` by itself; these
    cover any PyTorch extension or Triton cache."""
    base = REPO / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    spec = load_spec()
    cell = find_cell(spec, args.workload)
    cache_env()
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; nothing is measured on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(args.workload, load_config(cell["config"]),
                      load_mix(cell["traffic"]),
                      cell_metrics(spec, args.workload, bool(args.trace)),
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
