"""Parity of the port's ``utils`` (roofline, benchtime, trace) and
``core/validate.py`` with the JAX package.

The traffic models must give the JAX package's integers exactly, and
``roofline`` its floats to rtol 1e-12 at the JAX package's CPU rate.
``bench_chained`` must make the same calls on the same inputs. The eager
checks must give the checkified JAX checks' verdicts and message text on
one battery of containers (one jitted checkify a checked function).
``trace_scope``'s NVTX ranges are held balanced through a stand-in NVTX
module; the CPU build's NVTX (which raises) is never called. The hot entry
points' scopes (no JAX): no range while nothing records, ``spsparse.*``
ranges under ``torch.profiler`` with each record's ``t_ns`` inside its
range, and the records' fields.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_tpu.core import validate as jval
from spsparse_tpu.utils import benchtime as jbench
from spsparse_torch.convert import dia_from_numpy
from spsparse_torch.core import validate as tval
from spsparse_torch.utils import benchtime as tbench
from spsparse_torch.utils import trace as ttrace
from port_threads import one_torch_thread  # noqa: F401 (autouse)

jroof = importlib.import_module("spsparse_tpu.utils.roofline")
troof = importlib.import_module("spsparse_torch.utils.roofline")

DTYPES = ["float16", "float32", "float64", "int32"]
SHAPES = [(1, 1), (3, 1000), (11, 1 << 20), (27, 12345)]


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------
def _models(a, b, dtype):
    return [
        ("spmv_dia_stats", (a, b), dict(dtype=dtype)),
        ("spmv_ell_stats", (b, a), dict(dtype=dtype)),
        ("spmv_ell_stats", (b, a), dict(dtype=dtype, index_size=8)),
        ("spmv_csr_stats", (a * b, b), dict(dtype=dtype)),
        ("spmv_csr_stats", (a * b, b), dict(dtype=dtype, index_size=8)),
        ("spmm_ell_stats", (b, a, 64), dict(dtype=dtype)),
        ("spmm_ell_stats", (b, a, 8), dict(dtype=dtype, x_dtype="float16")),
        ("spgemm_esc_stats", (a * b, b, 3 * a * b, a * b // 2),
         dict(dtype=dtype)),
        ("spgemm_esc_stats", (a * b, b, 3 * a * b, a * b // 2),
         dict(dtype=dtype, index_size=8, sort_passes=6)),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_traffic_models_equal_jax(shape, dtype):
    for name, args, kw in _models(*shape, dtype):
        want = dataclasses.asdict(getattr(jroof, name)(*args, **kw))
        got = dataclasses.asdict(getattr(troof, name)(*args, **kw))
        assert got == want, (name, args, kw)
        assert all(type(got[k]) is int for k in ("nnz", "bytes_moved",
                                                 "flops"))


def test_k1_bound_bytes():
    # K1's f32 bound at config 2 (11 diagonals of 2^20 rows): the stored
    # diagonals, x in and y out.
    st = troof.spmv_dia_stats(11, 1 << 20)
    assert st.bytes_moved == 11 * (1 << 20) * 4 + 2 * (1 << 20) * 4
    assert st.bytes_moved == 54525952
    assert st.sol_time(3.35e12) == pytest.approx(1.6276e-5, rel=1e-4)


@pytest.mark.parametrize("time_s", [1e-6, 3.7e-4, 2.0])
def test_roofline_equals_jax_on_cpu_rate(time_s):
    kind, bw = jroof.device_hbm_bandwidth(jax.devices("cpu")[0])
    assert (kind, bw) == ("cpu", 5e10)
    for name, args, kw in _models(11, 4096, "float32"):
        want = jroof.roofline(getattr(jroof, name)(*args, **kw), time_s,
                              jax.devices("cpu")[0])
        got = troof.roofline(getattr(troof, name)(*args, **kw), time_s,
                             torch.device("cpu"), bw=5e10)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
            else:
                assert got[k] == v, k


def test_rate_table_holds_no_tpu_figure(monkeypatch):
    assert troof.SOL_BW["NVIDIA H100 80GB HBM3"] == 3.35e12
    assert not [k for k in troof.SOL_BW if "TPU" in k.upper()]
    assert "cpu" not in troof.SOL_BW
    with pytest.raises(ValueError, match="'cpu'"):
        troof.device_hbm_bandwidth(torch.device("cpu"))
    with pytest.raises(ValueError, match="'cpu'"):
        troof.roofline(troof.spmv_dia_stats(3, 8), 1.0, "cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        troof.device_hbm_bandwidth(torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert troof.device_hbm_bandwidth(torch.device("cuda", 0)) == (
        "NVIDIA H100 80GB HBM3", 3.35e12)
    row = troof.roofline(troof.spmv_dia_stats(11, 1 << 20), 2e-5,
                         torch.device("cuda", 0))
    assert row["device"] == "NVIDIA H100 80GB HBM3"
    assert row["pct_of_roofline"] == pytest.approx(100 * 1.6276e-5 / 2e-5,
                                                   rel=1e-4)


def test_current_device_without_cuda_raises():
    # This build has no card: None (the current CUDA device) cannot be
    # resolved, and no default figure stands in for it.
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="no CUDA device"):
        troof.device_hbm_bandwidth()
    with pytest.raises(ValueError, match="no CUDA device"):
        troof.roofline(troof.spmv_dia_stats(3, 8), 1.0, bw=1e9)


def test_utils_exports():
    import spsparse_tpu.utils as ju

    want = set(ju.__all__) - {"enable_persistent_cache", "default_cache_dir"}
    want |= {"enable_event_log", "get_event_log", "log_event"}
    assert set(tsp.utils.__all__) == want
    assert tsp.utils.SOL_BW is troof.SOL_BW


# --------------------------------------------------------------------------
# benchtime
# --------------------------------------------------------------------------
def _counting_run(bench, as_array, item, iters, warmup, reps):
    seen = []

    def step(y):
        seen.append(item(y))
        return y + 1

    t = bench(step, as_array(0.0), iters=iters, warmup=warmup, reps=reps)
    return seen, t


@pytest.mark.parametrize("iters,warmup,reps", [(10, 2, 3), (1, 0, 1),
                                                (4, 3, 5)])
def test_bench_chained_call_sequence(iters, warmup, reps):
    jseen, jt = _counting_run(jbench.bench_chained,
                              lambda v: jnp.asarray(v, jnp.float32),
                              lambda y: float(y), iters, warmup, reps)
    tseen, tt = _counting_run(tbench.bench_chained,
                              lambda v: torch.tensor(v, dtype=torch.float32),
                              lambda y: float(y), iters, warmup, reps)
    assert tseen == jseen
    assert len(tseen) == warmup + reps * iters
    assert tt > 0 and jt > 0


def test_bench_chained_pytree_and_force():
    # A step over a tuple of a dict and a list: every leaf is fetched.
    init = ({"a": torch.zeros(3)}, [torch.ones(2, dtype=torch.float64),
                                    None])

    def step(y):
        d, (v, none) = y
        return ({"a": d["a"] + 1}, [v * 2, none])

    assert tbench.bench_chained(step, init, iters=3, warmup=1, reps=2) > 0
    assert tbench._force(init) == 2.0
    assert tbench._force(step(step(init))) == 6.0 + 8.0


# --------------------------------------------------------------------------
# trace: NVTX ranges
# --------------------------------------------------------------------------
class _FakeNvtx:
    def __init__(self):
        self.calls = []
        self.depth = 0

    def range_push(self, name):
        self.calls.append(("push", name))
        self.depth += 1
        return self.depth - 1

    def range_pop(self):
        self.calls.append(("pop",))
        self.depth -= 1
        return self.depth


def _fake_nvtx(monkeypatch, on):
    fake = _FakeNvtx()
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", fake.range_push)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", fake.range_pop)
    monkeypatch.setattr(ttrace, "_NVTX", on)
    return fake


def test_nvtx_not_used_on_the_cpu_build(monkeypatch):
    # Decided at import: this build has no CUDA, and its NVTX raises.
    assert torch.version.cuda is None and ttrace._NVTX is False
    with pytest.raises(RuntimeError, match="NVTX"):
        torch.cuda.nvtx.range_push("x")
    fake = _fake_nvtx(monkeypatch, False)
    with ttrace.trace_scope("spmv"):
        pass
    a = tsp.SparseCOO.from_dense(np.eye(4), device="cpu")
    tsp.ops.spmv(a, torch.ones(4, dtype=torch.float64))
    assert fake.calls == []


def test_nvtx_ranges_balanced(monkeypatch):
    fake = _fake_nvtx(monkeypatch, True)
    ttrace.enable_ranges(True)
    tsp.utils.enable_event_log(True)
    try:
        with ttrace.trace_scope("outer"):
            depth_in = torch.cuda.nvtx.range_push("probe")
            torch.cuda.nvtx.range_pop()
            with ttrace.trace_scope("inner"):
                assert fake.depth == 2
        assert depth_in == 1 and fake.depth == 0
        with pytest.raises(ZeroDivisionError):
            with ttrace.trace_scope("raises"):
                1 / 0
        assert fake.depth == 0
        f = ttrace.traced("traced_op")(lambda: fake.depth)
        assert f() == 1 and fake.depth == 0
        a = tsp.SparseCOO.from_dense(np.eye(4), device="cpu")
        tsp.ops.spmv(a, torch.ones(4, dtype=torch.float64))
        assert fake.depth == 0
        log = [e["op"] for e in tsp.utils.get_event_log()]
    finally:
        tsp.utils.enable_event_log(False)
        ttrace.enable_ranges(False)
    pushes = [c[1] for c in fake.calls if c[0] == "push"]
    assert pushes[:4] == ["outer", "probe", "inner", "raises"]
    assert "traced_op" in pushes and "spsparse.spmv" in pushes
    assert len(pushes) == sum(c[0] == "pop" for c in fake.calls)
    # The raising body is in no event record; the others are.
    assert "raises" not in log
    assert {"outer", "inner", "traced_op", "spsparse.spmv"} <= set(log)


# --------------------------------------------------------------------------
# trace: scopes of the hot entry points
# --------------------------------------------------------------------------
HOT = ("spsparse.best_spmv", "spsparse.pcg_solve", "spsparse.cg_solve_dia",
       "spsparse.bellman_ford")


def _band(n=64, dtype=np.float32):
    """A float SPD tridiagonal (4 on the diagonal, -1 beside it)."""
    data = np.stack([np.full(n, -1.0), np.full(n, 4.0), np.full(n, -1.0)])
    data[0, 0] = data[2, -1] = 0.0
    return dia_from_numpy(data.astype(dtype), (-1, 0, 1), (n, n),
                          device="cpu")


def _hot_calls():
    """One tiny call of each hot entry point, on the CPU."""
    prep = tsp.ops.prepare_dia(_band())
    b = torch.linspace(-1.0, 1.0, 64)
    tsp.ops.best_spmv(prep, b)
    tsp.solvers.pcg_solve(lambda v: tsp.ops.best_spmv(prep, v), b, iters=3,
                          minv=torch.full((64,), 0.25))
    tsp.ops.cg_solve_dia(prep, b, iters=3)
    g = tsp.SparseCOO.from_dense(np.diag(np.ones(7), 1), device="cpu")
    tsp.graph.bellman_ford(g, [0])


class _CountingRange:
    entered = 0

    def __init__(self, name):
        pass

    def __enter__(self):
        _CountingRange.entered += 1

    def __exit__(self, *exc):
        return False


def test_scopes_off_path_calls_no_range(monkeypatch):
    """No profiler recording and ranges off: no ``record_function`` and no
    NVTX call, with the event log off or on; with ranges on, both."""
    monkeypatch.setattr(_CountingRange, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    fake = _fake_nvtx(monkeypatch, True)
    with ttrace.trace_scope("off"):
        pass
    tsp.utils.enable_event_log(True)
    try:
        _hot_calls()
        assert {e["op"] for e in tsp.utils.get_event_log()} >= set(HOT)
        assert _CountingRange.entered == 0 and fake.calls == []
        ttrace.enable_ranges(True)
        with ttrace.trace_scope("on"):
            pass
    finally:
        ttrace.enable_ranges(False)
        tsp.utils.enable_event_log(False)
    assert _CountingRange.entered == 1
    assert fake.calls == [("push", "on"), ("pop",)]


def test_hot_scopes_under_the_profiler(tmp_path):
    """Under ``torch.profiler`` each hot entry point is a ``spsparse.*``
    range of the Chrome trace, and each of its log records starts inside
    its range (``t_ns`` on the trace's clock, within 1 ms)."""
    tsp.utils.enable_event_log(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _hot_calls()
        log = [e for e in tsp.utils.get_event_log() if e["op"] in HOT]
    finally:
        tsp.utils.enable_event_log(False)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = [(e["name"], base + 1000 * e["ts"],
               base + 1000 * (e["ts"] + e["dur"]))
              for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"] in HOT]
    assert {r[0] for r in ranges} == set(HOT)
    assert sorted(e["op"] for e in log) == sorted(r[0] for r in ranges)
    slack = 1_000_000
    for e in log:
        assert any(name == e["op"] and s0 - slack <= e["t_ns"] <= s1 + slack
                   for name, s0, s1 in ranges), e


def _spmv_operand(path):
    dense = np.diag(np.full(16, 2.0)) + np.diag(np.ones(15), 1)
    coo = tsp.SparseCOO.from_dense(dense.astype(np.float32), device="cpu")
    return {"dia_f64": lambda: _band(16, np.float64),
            "dia_stream": lambda: tsp.ops.prepare_dia(_band(16)),
            "shuffle": lambda: tsp.ops.prepare_shuffle_spmv(coo),
            "general": lambda: tsp.ops.prepare_general(coo),
            "ell": lambda: tsp.to_ell(coo),
            "generic": lambda: coo}[path]()


@pytest.mark.parametrize("path", ["dia_f64", "dia_stream", "shuffle",
                                  "general", "ell", "generic"])
def test_best_spmv_record_names_its_path(path):
    a = _spmv_operand(path)
    tsp.utils.enable_event_log(True)
    try:
        tsp.ops.best_spmv(a, torch.ones(16, dtype=torch.float64
                                        if path == "dia_f64" else None))
        log = [e for e in tsp.utils.get_event_log()
               if e["op"] == "spsparse.best_spmv"]
    finally:
        tsp.utils.enable_event_log(False)
    assert len(log) == 1
    rec = log[0]
    assert set(rec) == {"op", "host_s", "t_ns", "path"}
    assert rec["path"] == path and rec["host_s"] >= 0


def test_hot_records_fields():
    """``iters`` and ``mode`` of the solves, and the Bellman-Ford scope
    beside its loop's untouched ``graph.bellman_ford`` record."""
    tsp.utils.enable_event_log(True)
    try:
        _hot_calls()
        log = tsp.utils.get_event_log()
    finally:
        tsp.utils.enable_event_log(False)
    by = {}
    for e in log:
        by.setdefault(e["op"], []).append(e)
    assert [e["path"] for e in by["spsparse.best_spmv"]] == ["dia_stream"] * 5
    (pcg,), (cg,), (bf,) = (by[k] for k in HOT[1:])
    assert pcg["iters"] == 3 and set(pcg) == {"op", "host_s", "t_ns",
                                              "iters"}
    assert cg["iters"] == 3 and cg["mode"] == "reference" and set(cg) == {
        "op", "host_s", "t_ns", "iters", "mode"}
    assert set(bf) == {"op", "host_s", "t_ns"}
    assert by["graph.bellman_ford"] == [{"op": "graph.bellman_ford",
                                         "rounds": 8, "syncs": 7}]
    assert not any("route" in e for e in log)


# --------------------------------------------------------------------------
# validate
# --------------------------------------------------------------------------
SHAPE = (6, 5)
CAP = 8
SENT = [SHAPE] * CAP
# name -> (nnz, index tuples of all CAP slots)
BATTERY = {
    "valid": (5, [(0, 0), (1, 4), (5, 0), (5, 4), (2, 3)] + SENT[5:]),
    "full": (8, [(i % 6, i % 5) for i in range(8)]),
    "padded_garbage": (3, [(0, 0), (1, 1), (2, 2), (99, -7), (-1, 5),
                           (6, 5), (1000, 1000), (-3, -3)]),
    "empty": (0, [(-1, -1)] * CAP),
    "negative_row": (4, [(0, 0), (-1, 2), (1, 1), (2, 2)] + SENT[4:]),
    "negative_col": (4, [(0, 0), (1, 1), (2, -2), (2, 2)] + SENT[4:]),
    "high_row": (4, [(0, 0), (1, 1), (6, 0), (2, 2)] + SENT[4:]),
    "high_col": (4, [(0, 0), (1, 1), (2, 2), (3, 5)] + SENT[4:]),
    "last_live_bad": (8, [(0, 0)] * 7 + [(0, 5)]),
    "over_capacity": (9, [(0, 0)] * CAP),
    "over_capacity_and_oob": (12, [(0, 0), (7, 7)] + [(1, 1)] * 6),
    "negative_nnz": (-1, [(0, 0)] * CAP),
    "negative_nnz_and_oob": (-2, [(9, 9)] * CAP),
}


@pytest.fixture(scope="module")
def jax_verdicts():
    f = jax.jit(checkify.checkify(jval.validate_coo))
    out = {}
    for name, (nnz, idx) in BATTERY.items():
        a = jsp.SparseCOO(indices=jnp.asarray(idx, jnp.int32),
                          vals=jnp.ones(CAP, jnp.float32),
                          nnz=jnp.asarray(nnz, jnp.int32), shape=SHAPE)
        err, _ = f(a)
        out[name] = err.get()
    assert f._cache_size() == 1
    return out


@pytest.mark.parametrize("name", list(BATTERY))
def test_validate_coo_equals_checkify(name, jax_verdicts):
    nnz, idx = BATTERY[name]
    a = tsp.SparseCOO(indices=torch.tensor(idx, dtype=torch.int32),
                      vals=torch.ones(CAP), nnz=nnz, shape=SHAPE)
    want = jax_verdicts[name]
    if want is None:
        tval.validate_coo(a)
        return
    with pytest.raises(tsp.SpSparseError) as e:
        tval.validate_coo(a)
    assert want == f"{e.value} (`check` failed)"


def test_validate_coo_valid_builds_pass():
    rng = np.random.default_rng(3)
    for shape in ((7,), (5, 9), (3, 4, 6)):
        idx = np.stack([rng.integers(0, s, 20) for s in shape], 1)
        b = tsp.CooBuilder(shape, dtype=np.float32)
        b.add_many(idx, rng.uniform(-1, 1, 20))
        a = b.build(device="cpu")
        tval.validate_coo(a)
        tval.validate_coo(tsp.consolidate(a))
        tval.validate_coo(a.with_capacity(64))


CAPACITY_CASES = [(0, 8), (7, 8), (8, 8), (9, 8), (100, 8), (0, 0), (1, 0)]


@pytest.fixture(scope="module")
def jax_capacity_verdicts():
    # The JAX check formats ``what`` as a checkify argument, which must be
    # an array (its default string raises TypeError there; ROADMAP, "How
    # parity is judged"): parity is held with a numeric ``what``.
    g = jax.jit(checkify.checkify(jval.check_capacity), static_argnums=(1,))
    out = {}
    for n_needed, cap in CAPACITY_CASES:
        err, _ = g(jnp.asarray(n_needed, jnp.int32), cap, jnp.asarray(3))
        out[n_needed, cap] = err.get()
    return out


@pytest.mark.parametrize("n_needed,cap", CAPACITY_CASES)
def test_check_capacity_equals_checkify(n_needed, cap,
                                        jax_capacity_verdicts):
    want = jax_capacity_verdicts[n_needed, cap]
    for n in (n_needed, torch.tensor(n_needed)):
        if want is None:
            tval.check_capacity(n, cap, what=3)
            tval.check_capacity(n, cap)
            continue
        with pytest.raises(tsp.SpSparseError) as e:
            tval.check_capacity(n, cap, what=3)
        assert want == f"{e.value} (`check` failed)"
        with pytest.raises(tsp.SpSparseError,
                           match="^spsparse esc output overflowed static "
                                 "capacity$"):
            tval.check_capacity(n, cap, what="esc output")


def test_validate_raises_through_the_handler():
    seen = []

    def handler(code, msg):
        seen.append((code, msg))
        raise KeyError(msg)

    tsp.set_error_handler(handler)
    try:
        with pytest.raises(KeyError):
            tval.check_capacity(5, 4)
        bad = tsp.SparseCOO(indices=torch.tensor([[0, 9]]),
                            vals=torch.ones(1), nnz=1, shape=(2, 2))
        with pytest.raises(KeyError):
            tval.validate_coo(bad)
    finally:
        tsp.set_error_handler(None)
    assert seen == [(-1, "spsparse output overflowed static capacity"),
                    (-1, "Sparse index out of bounds among live entries")]


# --------------------------------------------------------------------------
# chip_smoke's utils path, rehearsed on the CPU
# --------------------------------------------------------------------------
def test_chip_smoke_utils_path_rehearsal():
    """``chip_smoke.utils_path`` at 4096 rows on the CPU (its memory rate
    stated, as the table names no CPU): every phase's checks pass, U1's
    traffic model is the JAX package's, and U4 raises the JAX checks'
    messages."""
    import chip_smoke as cs

    st = cs.utils_path(torch, tsp, "cpu", n=4096, bw=5e10, smi="cpu")
    assert st["u1"]["stats"] == troof.spmv_dia_stats(11, 4096)
    assert dataclasses.asdict(st["u1"]["stats"]) == dataclasses.asdict(
        jroof.spmv_dia_stats(11, 4096))
    assert st["u2"]["bench_ms"] > 0 and st["u2"]["time_ms"] > 0
    assert {"U3 traced op", "spsparse.spmv"} <= set(st["u3"]["ops"])
    assert st["u4"]["raised"]["high"] == (
        "Sparse index out of bounds among live entries")
    assert set(st["wall_s"]) == {"U0", "U1", "U2", "U3", "U4"}
