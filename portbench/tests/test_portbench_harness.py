"""The harness: BENCHMARK.json against the benchmark's contract, files
found by name, the result line, the refusal without a card, and the
import rules."""

import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness as h

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "breakdown", "checks"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_meets_the_contract():
    raw = (h.REPO / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= len(spec["command"]) <= 32 and all(map(_line,
                                                       spec["command"]))
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # A full check of 24 cells fits in its 43,200 s.
    assert ((2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    cfgs = {c["name"]: c for c in spec["configs"]}
    assert 1 <= len(cfgs) == len(spec["configs"]) <= 24
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and (h.REPO / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        own = json.loads((h.REPO / c["file"]).read_text())
        assert own["reduced"] == c["reduced"] and own["source"]
        assert "assumed" in own
    cells = [w["name"] for w in spec["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(cells) // 4)
    assert {w["config"] for w in spec["workloads"]} == set(cfgs)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        # Every cell it names reports the metric it moves.
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert any(x["name"] == m["moves"]
                       for x in h.cell_metrics(spec, cell, False))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        e = [m["name"] for m in h.cell_metrics(spec, cell, False)]
        assert "setup_s" in e and len(e) >= 2
        assert h.cell_metrics(spec, cell, True)


def test_every_named_file_is_found():
    spec = h.load_spec()
    for w in spec["workloads"]:
        cfg = h.load_config(w["config"])
        assert cfg["name"] == w["config"]
        mix = h.load_mix(w["traffic"])
        mod = h.job_module(mix)
        assert callable(mod.check) and hasattr(mod, "Job")
        assert set(mix["limits"]) and int(mix["samples"]) >= 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(h.metric_module(m["name"]).read)


def test_an_added_metric_file_is_picked_up(tmp_path):
    (tmp_path / "dummy.rate-x.py").write_text(
        "def read(ctx):\n    return 2.0 * len(ctx['times'])\n")
    mod = h.metric_module("dummy.rate-x", tmp_path)
    assert mod.read({"times": [1, 2, 3]}) == 6.0


def test_a_metric_with_nothing_to_read_is_left_out():
    ctx = {"trace": None, "events": [], "times": [0.1] * 5, "cfg": {},
           "mix": {}, "device_name": "cpu", "peak_bytes": 0}
    for name in ("cg_roofline", "spmv_roofline", "solver_vector_pct",
                 "device_idle_pct", "sssp_rounds", "sssp_round_ms",
                 "job_ms_p95", "peak_mem_gib"):
        assert h.metric_module(name).read(ctx) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_has_only_the_contract_keys(tiny, trace):
    spec = h.load_spec()
    cell = "gap_urand_24.pr"
    r = h.run_cell(cell, tiny["gap_urand_24"], h.load_mix("pr"),
                   h.cell_metrics(spec, cell, bool(trace)), seed=2 ** 33 + 1,
                   seconds=0.3, trace=bool(trace), device="cpu",
                   t_start=time.perf_counter())
    keys = list(r)
    assert set(keys) <= set(RESULT_KEYS)
    assert keys[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"}
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hpcg_256.cg",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_a_run_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(h.REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_a_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copytree(h.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(h.REPO / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _imports(path: Path):
    """Top-level names a file imports, relative imports resolved inside
    the package."""
    tree = ast.parse(path.read_text())
    rel = path.relative_to(h.REPO).with_suffix("").parts
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(rel[:-node.level])
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for f in h.PKG.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in h.FORBIDDEN, (f, name)


def test_the_reference_and_the_generators_import_nothing_of_the_port():
    for sub in ("reference", "gen"):
        for f in (h.PKG / sub).rglob("*.py"):
            for name in _imports(f):
                top = name.split(".")
                assert top[0] != "spsparse_torch", (f, name)
                assert top[:2] not in (["portbench", "jobs"],
                                       ["portbench", "harness"]), (f, name)


def test_the_module_guard_compares_whole_top_level_names(monkeypatch):
    assert "spsparse_torch" in sys.modules or True
    assert h.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spsparse_tpu_like", object())
    assert h.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert h.forbidden_modules() == ["jax"]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hpcg_256.cg",
         "--seed", "3000000003", "--seconds", "2", "--trace", "0"],
        cwd=h.REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
