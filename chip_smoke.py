#!/usr/bin/env python3
"""Drive the spsparse_torch main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failed check raises,
so the script exits non-zero and prints no result line):

1. Build the CUDA kernels from ``spsparse_torch/csrc`` (nvcc, sm_90a) and
   report the card.
2. Ingest the banded benchmark matrix (n = 2**20 rows, offsets -5..5,
   float32, values from ``default_rng(0)``) through ``CooBuilder.add_many``
   with every entry added twice, and consolidate it on the card: the result
   must hold each entry once with its value doubled.
3. Run ``multiply`` and ``multiply_mv`` with dense scale vectors on the
   2**18-row matrix of the same family and hold them against a scipy.sparse
   float64 oracle on the host.
4. ``to_dia`` + ``prepare_dia`` (float32 and bfloat16) + ``best_spmv``:
   kernel K1 against its plain PyTorch version on the card.
5. ``spmv_dia_chain`` (64 iterations, scale 0.3): kernel K2 against its
   plain version on the card.
6. NetCDF round trip of the phase-3 product: exact ``to_lists()`` equality.
7. Time K1 and K2 against their plain versions with CUDA events.

The launch counters of the kernel wrappers are reset before phase 2 and
read after phase 6; a kernel of the path launched no time there fails the
run. The last lines are a JSON line per timing, the ``{"kernels": [...]}``
line, the card's name and power limit from nvidia-smi, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N = 1 << 20          # rows of the banded benchmark matrix (config 2)
MM_N = 1 << 18       # rows of the matrix of the multiply phase
BAND = 5             # offsets -BAND..BAND: 11 diagonals
CHAIN_ITERS = 64
CHAIN_SCALE = 0.3

KERNELS = {
    "spmv_dia_stream": dict(
        route="cuda", source="spsparse_torch/csrc/dia.cu",
        replaces="spsparse_tpu/ops/pallas_dia.py:51"),
    "spmv_dia_chain": dict(
        route="cuda", source="spsparse_torch/csrc/dia.cu",
        replaces="spsparse_tpu/ops/pallas_dia_chain.py:35"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def banded_entries(n: int, band: int = BAND, seed: int = 0):
    """Row-major (rows, cols, vals) of the benchmark's banded matrix: the
    in-range slots of offsets -band..band, values uniform(-1, 1) float32
    from ``default_rng(seed)`` (the generator of ``bench.py``)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    vals = np.where(valid, rng.uniform(-1, 1, (n, 2 * band + 1)),
                    0).astype(np.float32)
    rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)
    return (rows[valid].astype(np.int32), cols[valid].astype(np.int32),
            vals[valid])


def close(got, ref, rtol: float, atol_rel: float) -> tuple[bool, float]:
    """``|got - ref| <= rtol*|ref| + atol_rel*max|ref|`` elementwise, plus
    the max abs error."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    atol = atol_rel * float(np.max(np.abs(ref), initial=0.0))
    return bool(np.all(err <= rtol * np.abs(ref) + atol)), float(
        np.max(err, initial=0.0))


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_ingest(torch, sp, dev, n):
    """Phase 2: double ingest + consolidate."""
    r, c, v = banded_entries(n)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    idx = np.stack([r, c], axis=1)
    b.add_many(idx, v)
    b.add_many(idx, v)
    raw = b.build(device=dev)
    A = sp.consolidate(raw)
    sync(torch, dev)
    nz = v != 0
    require(A.nnz == int(nz.sum()), f"consolidated nnz {A.nnz}")
    require(np.array_equal(A.indices[: A.nnz].cpu().numpy(), idx[nz]),
            "consolidated indices")
    require(np.array_equal(A.vals[: A.nnz].cpu().numpy(), 2 * v[nz]),
            "consolidated values are not the doubled inputs")
    return {"A": A, "vals": v, "raw_entries": raw.nnz}


def scipy_banded(n):
    import scipy.sparse as ssp

    r, c, v = banded_entries(n)
    return ssp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))


def _csr_of(coo):
    import scipy.sparse as ssp

    idx = coo.indices[: coo.nnz].cpu().numpy().astype(np.int64)
    vals = coo.vals[: coo.nnz].cpu().numpy().astype(np.float64)
    return ssp.csr_matrix((vals, (idx[:, 0], idx[:, 1])), shape=coo.shape)


def phase_multiply(torch, sp, dev, n):
    """Phase 3: scaled MM and MV chains against a scipy float64 oracle."""
    import scipy.sparse as ssp
    from spsparse_torch.ops import multiply, multiply_mv

    r, c, v = banded_entries(n)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([r, c], axis=1), v)
    A = b.build(device=dev)
    rng = np.random.default_rng(2)
    si, sj, sk = (rng.uniform(0.5, 1.5, n).astype(np.float32)
                  for _ in range(3))
    vec = rng.uniform(-1, 1, n).astype(np.float32)

    def dense_vector(vals):
        vb = sp.coo_vector(n, dtype=np.float32)
        vb.add_many(np.arange(n, dtype=np.int32), vals)
        return vb.build(device=dev)

    S_i, S_j, S_k, V = (dense_vector(s) for s in (si, sj, sk, vec))
    P = multiply(0.5, A, A, scalei=S_i, scalej=S_j, scalek=S_k)
    y = multiply_mv(0.5, A, V, scalei=S_i, scalej=S_j)
    sync(torch, dev)

    As = scipy_banded(n)
    D = [ssp.diags(s.astype(np.float64)) for s in (si, sj, sk)]
    P_ref = (0.5 * (D[0] @ As @ D[1] @ As @ D[2])).tocsr()
    P_ref.sort_indices()
    P_got = _csr_of(P)
    P_got.sort_indices()
    require(P.nnz == P_ref.nnz, f"MM nnz {P.nnz} vs oracle {P_ref.nnz}")
    require(np.array_equal(P_got.indptr, P_ref.indptr)
            and np.array_equal(P_got.indices, P_ref.indices),
            "MM structure differs from the oracle")
    ok_mm, err_mm = close(P_got.data, P_ref.data, 1e-5, 1e-5)
    require(ok_mm, f"MM values off the oracle (max abs err {err_mm})")

    y_ref = 0.5 * si.astype(np.float64) * (
        As @ (sj.astype(np.float64) * vec.astype(np.float64)))
    keep = y_ref != 0
    require(y.nnz == int(keep.sum()), f"MV nnz {y.nnz}")
    require(np.array_equal(y.indices[: y.nnz, 0].cpu().numpy(),
                           np.nonzero(keep)[0]), "MV structure")
    ok_mv, err_mv = close(y.vals[: y.nnz].cpu().numpy(), y_ref[keep],
                          1e-5, 1e-5)
    require(ok_mv, f"MV values off the oracle (max abs err {err_mv})")
    return {"P": P, "mm_max_abs_err": err_mm, "mv_max_abs_err": err_mv}


def phase_dia(torch, sp, dev, A, vals):
    """Phase 4: to_dia + prepare_dia + best_spmv (K1) vs the plain K1.

    ``A`` holds the benchmark matrix doubled (phase 2); halving its
    diagonals, which is exact, gives the benchmark matrix itself, the
    operand of the SpMV and the chain."""
    from spsparse_torch.ops import (best_spmv, prepare_dia,
                                    spmv_dia_stream_reference)

    n = A.shape[0]
    doubled = sp.to_dia(A)
    require(doubled.offsets == tuple(range(-BAND, BAND + 1)),
            f"to_dia offsets {doubled.offsets}")
    band = np.zeros((n, 2 * BAND + 1), np.float32)
    cols = np.arange(n)[:, None] + np.arange(-BAND, BAND + 1)[None, :]
    band[(cols >= 0) & (cols < n)] = 2 * vals
    require(np.array_equal(doubled.data.cpu().numpy(), band.T),
            "to_dia data differs from the doubled band")
    dia = sp.SparseDIA(data=doubled.data * 0.5, offsets=doubled.offsets,
                       shape=doubled.shape)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, n)
                         .astype(np.float32)).to(dev)
    out = {"dia": dia, "x": x, "err": {}}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(dia, dtype=dtype)
        y = best_spmv(prep, x)
        ref = spmv_dia_stream_reference(prep, x)
        sync(torch, dev)
        ok, err = close(y.cpu().numpy(), ref.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K1 {name} off its plain version (max abs err {err})")
        out[name] = prep
        out["err"][name] = err
    y = best_spmv(dia, x)        # SparseDIA operand: prepared on the fly
    sync(torch, dev)
    ok, err = close(y.cpu().numpy(),
                    spmv_dia_stream_reference(out["f32"], x).cpu().numpy(),
                    1e-5, 1e-5)
    require(ok, f"K1 on a SparseDIA operand (max abs err {err})")
    return out


def phase_chain(torch, dev, prep, x):
    """Phase 5: K2 against the plain chain."""
    from spsparse_torch.ops import spmv_dia_chain, spmv_dia_chain_reference

    z = spmv_dia_chain(prep, x, CHAIN_ITERS, CHAIN_SCALE)
    ref = spmv_dia_chain_reference(prep, x, CHAIN_ITERS, CHAIN_SCALE)
    sync(torch, dev)
    zn, rn = z.cpu().numpy(), ref.cpu().numpy()
    require(bool(np.all(np.isfinite(zn))), "K2 output is not finite")
    # 64 iterations amplify f32 rounding (FMA vs separate multiply-add):
    # hold the error to 1e-4 of the iterate's scale.
    ok, err = close(zn, rn, 1e-4, 1e-4)
    require(ok, f"K2 off its plain version (max abs err {err})")
    return err


def phase_netcdf(torch, dev, P):
    """Phase 6: save + load the product; exact equality."""
    from spsparse_torch.io import load_netcdf, save_netcdf

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "product.nc")
        save_netcdf(path, {"P": P})
        Q = load_netcdf(path, "P", rank=2, dtype=np.float32, device=dev)
    sync(torch, dev)
    require(Q.shape == P.shape and Q.to_lists() == P.to_lists(),
            "NetCDF round trip is not exact")


def main_path(torch, sp, dev, n=N, mm_n=MM_N) -> dict:
    """Phases 2-6 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    ing = phase_ingest(torch, sp, dev, n)
    log(f"phase 2 ingest+consolidate: {ing['raw_entries']} entries -> "
        f"nnz {ing['A'].nnz} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    mm = phase_multiply(torch, sp, dev, mm_n)
    log(f"phase 3 multiply: MM nnz {mm['P'].nnz}, max abs err "
        f"{mm['mm_max_abs_err']!r}; MV max abs err {mm['mv_max_abs_err']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    dia = phase_dia(torch, sp, dev, ing["A"], ing["vals"])
    log(f"phase 4 DIA SpMV: K1 max abs err {dia['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    chain_err = phase_chain(torch, dev, dia["f32"], dia["x"])
    log(f"phase 5 DIA chain: K2 max abs err {chain_err!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    phase_netcdf(torch, dev, mm["P"])
    log(f"phase 6 NetCDF round trip exact ({time.perf_counter() - t0:.3f} s)")
    return {"dia": dia, "chain_err": chain_err, "nnz": ing["A"].nnz}


def time_ms(torch, fn, *, reps: int = 15, inner: int = 10,
            warmup: int = 3) -> list[float]:
    """Per-call milliseconds of ``reps`` CUDA-event-timed runs of ``inner``
    calls each, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def compare_times(torch, kernel, plain) -> tuple[float, float]:
    """Median ms of the kernel and of the plain version, timed in turns
    (plain, kernel, kernel, plain)."""
    p1 = time_ms(torch, plain)
    k1 = time_ms(torch, kernel)
    k2 = time_ms(torch, kernel)
    p2 = time_ms(torch, plain)
    return float(np.median(k1 + k2)), float(np.median(p1 + p2))


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import spsparse_torch as sp
    from spsparse_torch import backend
    from spsparse_torch.ops import (spmv_dia_chain, spmv_dia_chain_reference,
                                    spmv_dia_stream,
                                    spmv_dia_stream_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # Phase 1: build and report.
    t0 = time.perf_counter()
    lib_path = backend.build(verbose=True)
    backend.load_kernels()
    log(f"phase 1 build: {lib_path.name} in {time.perf_counter() - t0:.3f} s;"
        f" {json.dumps(backend.device_report())}; nvidia-smi: {smi}")

    torch.cuda.reset_peak_memory_stats()
    spmv_dia_stream.launches = 0
    spmv_dia_chain.launches = 0
    state = main_path(torch, sp, dev)
    launches = {"spmv_dia_stream": spmv_dia_stream.launches,
                "spmv_dia_chain": spmv_dia_chain.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path kernel launches: {launches}; peak device memory "
        f"{peak} bytes")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # Phase 7: timing, kernel against plain version, in turns.
    dia = state["dia"]
    x = dia["x"]
    rows = []
    for dname in ("f32", "bf16"):
        prep = dia[dname]
        ms, plain_ms = compare_times(
            torch, lambda: spmv_dia_stream(prep, x),
            lambda: spmv_dia_stream_reference(prep, x))
        rows.append(dict(name="spmv_dia_stream", dtype=dname,
                         **KERNELS["spmv_dia_stream"],
                         launches=launches["spmv_dia_stream"],
                         max_abs_err=dia["err"][dname], ms=ms,
                         plain_ms=plain_ms))
    prep = dia["f32"]
    ms, plain_ms = compare_times(
        torch, lambda: spmv_dia_chain(prep, x, CHAIN_ITERS, CHAIN_SCALE),
        lambda: spmv_dia_chain_reference(prep, x, CHAIN_ITERS, CHAIN_SCALE))
    rows.append(dict(name="spmv_dia_chain", dtype="f32",
                     **KERNELS["spmv_dia_chain"],
                     launches=launches["spmv_dia_chain"],
                     max_abs_err=state["chain_err"], ms=ms / CHAIN_ITERS,
                     plain_ms=plain_ms / CHAIN_ITERS))
    torch.cuda.synchronize()

    nnz = state["nnz"]
    for row in rows:
        item = 2 if row["dtype"] == "bf16" else 4
        stream_bytes = nnz * item + 8 * N
        print(json.dumps({
            "timing": row["name"], "dtype": row["dtype"], "n": N,
            "nnz": nnz, "ms_per_spmv": row["ms"],
            "plain_ms_per_spmv": row["plain_ms"],
            "stream_bytes": stream_bytes,
            "gb_per_s": stream_bytes / (row["ms"] * 1e-3) / 1e9,
            "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
