#!/usr/bin/env python3
"""Device time of each CUDA kernel of the port at the shapes of chip_smoke.py.

    python3 tests_gpu/profile_kernels.py

Builds the banded benchmark matrix ``B`` (n = 2**20, offsets -5..5, f32,
values from ``default_rng(0)``) and ``S = (B + B^T)/2``, and bench config
3's regridding matrix (m = 2**18, 50 entries a row, X of 128 columns) with
its tiled layouts, the one_hot route's layout of ``chip_smoke.py``'s
phase 14, and bench config 4's matrix (2**17 rows) with its band plan and
pair plans (A A^T, and C C for C = A A^T), and bench config 2c (2**20 rows,
10 uniform-random columns a row) with its shuffle layout and CSR products
and the (1024, 64, 128) block sort, as ``chip_smoke.py`` does; runs each
wrapper (and the
library calls that ``chip_smoke.py`` uses as yardsticks) 10 times under
``torch.profiler``, and prints one JSON line per workload: the CUDA kernels
it ran, their count and device time, and the device time per call. Needs
one CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import spsparse_torch as sp  # noqa: E402
from spsparse_torch.ops import (best_spgemm, cg_solve_dia,  # noqa: E402
                                densify_tiled, plan_tiled_spgemm,
                                plan_window_spgemm, prepare_dia,
                                prepare_general, prepare_tiled_dense,
                                prepare_tiled_rows,
                                prepare_tiled_window, spgemm_tiled_pairs,
                                spgemm_tiled_stream, spgemm_window,
                                spmm_dia_mrhs,
                                spmm_tiled_dense, spmm_tiled_onehot,
                                spmm_tiled_window, spmv_dia_chain,
                                spmv_dia_stream)
from spsparse_torch.ops import (csr_products,  # noqa: E402
                                prepare_shuffle_spmv, segmented_row_sums,
                                shuffle_gather, sort_blocks, spmv_shuffle)

CALLS = 10


def device_kernels(prof) -> list[dict]:
    """CUDA kernel events of a profile, by name."""
    out = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        out.append({"kernel": e.key[:120], "count": e.count,
                    "device_us": us})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    dev, n = "cuda", cs.N
    smi = cs.nvidia_smi_line()
    band = cs.band_of(n)
    B = sp.SparseDIA(data=torch.from_numpy(band.T.copy()).to(dev),
                     offsets=tuple(range(-cs.BAND, cs.BAND + 1)),
                     shape=(n, n))
    prep_s = cs.phase_spd(torch, sp, dev, n)["prep"]
    pf, pb = prepare_dia(B), prepare_dia(B, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    X = torch.from_numpy(rng.uniform(-1, 1, (cs.RHS, n))
                         .astype(np.float32)).to(dev)
    A_csr = cs.library_csr(torch, n, dev)
    m = cs.SPMM_M
    rr, cc, vals, Xh = cs.regrid_entries(m)
    tl = sp.to_tiled(cs.build_coo(sp, dev, (m, 2 * m), rr, cc, vals))
    X3 = torch.from_numpy(Xh).to(dev)
    w32 = prepare_tiled_window(tl, dtype=torch.float32)
    w16 = prepare_tiled_window(tl, group=cs.WINDOW_GROUP)
    d32 = prepare_tiled_dense(tl)
    d16 = prepare_tiled_dense(tl, dtype=torch.bfloat16)
    rows = prepare_tiled_rows(tl)
    A3_csr = cs.library_csr_of(torch, rr, cc, vals, (m, 2 * m), dev)
    ro, co, vo = cs.onehot_entries(m)
    pg = prepare_general(cs.build_coo(sp, dev, (m, m), ro, co, vo))
    assert pg.kernel == "one_hot" and pg.order is None, pg.kernel
    Xo = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (m, cs.SPMM_N)).astype(np.float32)).to(dev)
    Ao_csr = cs.library_csr_of(torch, ro, co, vo, (m, m), dev)
    n4 = cs.CFG4_N
    r4, c4, v4 = cs.cfg4_entries(n4)
    b4 = sp.CooBuilder((n4, 2 * n4), dtype=np.float32)
    b4.add_many(np.stack([r4, c4], 1), v4)
    A4 = sp.consolidate(b4.build(device=dev))
    tl4 = sp.to_tiled(A4)
    band = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_tiled_dense(tl4, dtype=dt)
        band[name] = (plan_window_spgemm(prep.tcols, prep.tcols,
                                         nbc=prep.nbc, out_shape=(n4, n4),
                                         dtype=dt), prep.blocks)
    ta = {name: densify_tiled(tl4, dtype=dt) for name, dt in
          (("f32", torch.float32), ("bf16", torch.bfloat16))}
    plan_t = plan_tiled_spgemm(ta["f32"], ta["f32"], transpose_b=True)
    tc = densify_tiled(sp.to_tiled(best_spgemm(A4, A4, transpose_b=True)))
    plan_n = plan_tiled_spgemm(tc, tc)
    A64 = cs._csr_of(A4)
    L4, R4 = cs.torch_csr(torch, A64, dev), cs.torch_csr(torch, A64.T, dev)
    r2, c2, v2, x2 = cs.cfg2c_entries(n)
    A2 = cs.build_coo(sp, dev, (n, n), r2, c2, v2)
    shuf = prepare_shuffle_spmv(A2)
    csr2 = sp.to_csr(A2)
    x2 = torch.from_numpy(x2).to(dev)
    prod2 = csr_products(csr2, x2)
    A2_csr = cs.torch_csr(torch, cs.csr_host(r2, c2, v2, (n, n)), dev)
    keys = torch.from_numpy(rng.integers(0, 1 << 30, (
        cs.SORT_NBLK, 64, 128)).astype(np.int32)).to(dev)
    pay = torch.from_numpy(rng.uniform(-1, 1, keys.shape).astype(
        np.float32)).to(dev)
    fk, fp = keys.reshape(cs.SORT_NBLK, -1), pay.reshape(cs.SORT_NBLK, -1)
    work = {
        "K1 f32": lambda: spmv_dia_stream(pf, x),
        "K1 bf16": lambda: spmv_dia_stream(pb, x),
        "K2 f32, 64 iterations": lambda: spmv_dia_chain(
            pf, x, cs.CHAIN_ITERS, cs.CHAIN_SCALE),
        "K3 f32, 8 RHS": lambda: spmm_dia_mrhs(pf, X),
        "K3 bf16, 8 RHS": lambda: spmm_dia_mrhs(pb, X),
        "K4 f32, 50 iterations": lambda: cg_solve_dia(
            prep_s, x, iters=cs.CG_ITERS, shift=cs.SHIFT),
        "library A_csr @ x": lambda: A_csr @ x,
        "library A_csr @ X.T": lambda: A_csr @ X.T,
        "K5 f32, config 3 (group 16)": lambda: spmm_tiled_window(w32, X3),
        "K5 bf16, config 3 (group 32)": lambda: spmm_tiled_window(w16, X3),
        "K6 f32, config 3": lambda: spmm_tiled_dense(d32, X3),
        "K6 bf16, config 3": lambda: spmm_tiled_dense(d16, X3),
        "K7 f32, config 3": lambda: spmm_tiled_onehot(rows, X3),
        "library A3_csr @ X, config 3": lambda: A3_csr @ X3,
        "K7 f32, one_hot route": lambda: spmm_tiled_onehot(pg.prep, Xo),
        "library Ao_csr @ X, one_hot route": lambda: Ao_csr @ Xo,
        "K8 f32, config 4 A A^T band": lambda: spgemm_window(*band["f32"]),
        "K8 bf16, config 4 A A^T band": lambda: spgemm_window(*band["bf16"]),
        "K9 f32, config 4 A A^T pairs": lambda: spgemm_tiled_pairs(
            ta["f32"], ta["f32"], plan_t),
        "K9 bf16, config 4 A A^T pairs": lambda: spgemm_tiled_pairs(
            ta["bf16"], ta["bf16"], plan_t),
        "K13 f32, config 4 A A^T pairs": lambda: spgemm_tiled_stream(
            ta["f32"], ta["f32"], plan_t),
        "K13 bf16, config 4 A A^T pairs": lambda: spgemm_tiled_stream(
            ta["bf16"], ta["bf16"], plan_t),
        "K9 f32, config 4 C C pairs": lambda: spgemm_tiled_pairs(tc, tc,
                                                                 plan_n),
        "K13 f32, config 4 C C pairs": lambda: spgemm_tiled_stream(tc, tc,
                                                                   plan_n),
        "library A4_csr @ A4T_csr, config 4": lambda: L4 @ R4,
        "K10 f32, config 2c CSR products": lambda: segmented_row_sums(
            prod2, csr2.row_ptr, nrows=n, rows_per_block=256,
            entries_per_block=1024),
        "K11 f32, config 2c shuffle layout": lambda: shuffle_gather(shuf,
                                                                    x2),
        "spmv_shuffle, config 2c": lambda: spmv_shuffle(shuf, x2),
        "library A2_csr @ x, config 2c": lambda: A2_csr @ x2,
        "K12 (1024, 64, 128) key + payload": lambda: sort_blocks((keys,
                                                                  pay)),
        "library torch.sort + gather, (1024, 8192)": lambda: fp.gather(
            1, torch.sort(fk, dim=-1).indices),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        print(json.dumps({
            "work": name, "calls": CALLS, "kernels": kernels,
            "device_us_per_call": sum(k["device_us"] for k in kernels)
            / CALLS,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
