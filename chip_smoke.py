#!/usr/bin/env python3
"""Drive the spsparse_torch main path, solve path, SpMM path, SpGEMM path and
unstructured SpMV path once on one CUDA card and check them.

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

The solve path (``solve_path``), on the SPD operator ``S = (B + B^T)/2`` of
the same banded matrix ``B`` with ``shift = 11`` (``S + 11 I`` is SPD by
Gershgorin: off-diagonal row sums below 10, diagonal above -1):

7. Build ``S`` through ``CooBuilder`` (every entry of ``B`` at 0.5 plus its
   transpose at 0.5), ``consolidate``, ``to_dia``, ``prepare_dia``.
8. ``spmm_dia_mrhs`` (K3) on ``B`` and ``X (8, n)``, float32 and bfloat16
   data, against its plain version and 8 K1 calls; ``R = 7`` and a 1-D ``x``.
9. ``cg_solve_dia`` (K4), 50 iterations, against its plain version, the
   composed ``cg_solve`` over K1 and a float64 scipy residual; ``b = 0``
   gives ``x = 0`` and ``rs = 0``.
10. ``cg_solve_mrhs`` over K3 with a Jacobi preconditioner, 8 right-hand
    sides, 50 iterations: per-column float64 residuals, and one column
    against ``pcg_solve`` over K1.

The SpMM path (``spmm_path``), general sparse x dense products at bench
config 3's widths (``bench.py:_regrid_matrix``: m = 2**18 rows, 50 entries
a row within 128 columns of column 2r, 2m columns, X of 128 columns, all
from ``default_rng(0)``):

11. Build A through ``CooBuilder`` and ``to_tiled``: 8190 tiles of cap
    4096, as the JAX package records for config 3.
12. K5: ``prepare_tiled_window(tl, group=32)`` in bfloat16 (config 3's
    layout) and ``prepare_general(A)`` in float32, which must route to
    ``dense_window``; ``spmm_tiled_window`` and ``spmm_general`` against
    the plain version and a float64 scipy product on 4096 sampled rows.
13. K6: ``spmm_tiled_dense`` on ``to_tiled_dense`` of the window layout and
    on ``prepare_tiled_dense`` (float32, bfloat16), against its plain
    version and against K5.
14. K7: ``spmm_tiled_onehot`` on ``prepare_tiled_rows`` of the same tiles,
    against its plain version and K6; a one-hot-tier matrix (40-48 entries
    in the diagonal tile of each block row) through ``prepare_general``
    (route ``one_hot``); bench config 3b's scattered matrix (route
    ``gather_ell``) against scipy.
15. One backward through ``spmm_general`` on the dense-window layout at
    2**13 rows, against the plain backward on the CPU.

The SpGEMM path (``spgemm_path``), sparse x sparse products at bench config
4's widths (``bench.py:685-696``: 2**17 rows, zipf(2.0) row lengths capped
at 24, columns ``2r + U{0,1,2}`` of 2**18, values uniform(0, 1), all from
``default_rng(0)``), against float64 scipy products of the consolidated
operand:

16. Build A through ``CooBuilder``, ``consolidate`` (193,565 entries) and
    ``to_tiled`` (2,540 tiles); ``plan_spgemm_caps``.
17. K8: ``best_spgemm(A, A, transpose_b=True)`` (routes ``tiled`` and
    ``window``) in float32 and ``spgemm_tiled`` with bfloat16 blocks
    against scipy; the band of ``plan_window_spgemm`` through K8 against
    its plain version in both types, its dead slots exactly zero.
18. K9 and K13: ``spgemm_tiled(A, A, transpose_b=True, use_window=False)``
    (config 4's pair plan), ``C = A A^T``, ``best_spgemm(C, C)`` and
    ``coo_matrix_power(C, 3)`` (the routes of each product logged) against
    scipy; K9 and K13 on both pair plans, in float32 and bfloat16, against
    the plain version and each other.
19. ESC: ``spgemm_aat`` and ``plan_esc`` (device and host) +
    ``spgemm_planned`` against scipy.
20. Hand-off: the band's ``TiledBlocks.to_prepared_dense()`` through K6
    with X of 128 columns, against scipy.
The unstructured path (``unstructured_path``), bench config 2c's widths
(``bench.py:config2c_unstructured``: 2**20 x 2**20, 10 uniform-random
columns a row, values uniform(-1, 1), x uniform(-1, 1), all from
``default_rng(0)``), against float64 scipy products:

21. Build the matrix through ``CooBuilder`` and ``prepare_shuffle_spmv``;
    log B, n_vrows, gather_fill and the prepare's host wall.
22. K11: ``best_spmv(prep, x)``; K11's ELL slot grid against its plain
    version (the JAX sort pipeline) bit for bit on an allocation left full
    of NaN, ``y`` against the plain ``spmv_shuffle`` and scipy; the same on
    a heavy-row matrix (2**16 rows, one row of 4096 and 100 of 90 entries,
    ``ell_k`` 16: split rows).
23. K10: ``segmented_row_sums`` on the CSR products against its plain
    version, ``spmv_csr_segsum`` against scipy, and K10 on a skewed row
    pointer (empty rows, one row of 4096).
24. K12: ``sort_blocks`` on (1024, 64, 128) int32 keys with a float32
    payload, two keys, R = 1, (8, 256, 128) with three arrays (past the
    shared-memory chunk); ``sort_blocks_stable`` packed and not. Keys
    exact, payloads exact when stable and otherwise as a multiset within
    each run of equal keys.
25. Time every kernel against its plain version (CUDA events, in turns:
    plain, kernel, kernel, plain), and one PyTorch library call computing
    the same function where there is one (``torch.sparse_csr_tensor``
    products; none for K4, whose solve is no single library call). K7 is
    timed on config 3's tiles and on the one_hot route's layout of phase
    14, the traffic ``prepare_general`` sends it. K8, K9 and K13 at config
    4, with cuSPARSE's CSR x CSR SpGEMM as the yardstick; ``spgemm_tiled``
    end to end, the ESC ``spgemm_aat`` and the planned apply. K10 and K11
    at config 2c against cuSPARSE's CSR SpMV, with ``spmv_shuffle`` and
    ``spmv_csr_segsum`` end to end in nnz/s; K12 against ``torch.sort``
    carrying the payload through ``gather``.

The launch counters of the kernel wrappers are reset before each path and
read after it; a kernel of the path launched no time there fails the run.
The last lines are a JSON line per timing, the ``{"kernels": [...]}`` line,
the card's name and power limit from nvidia-smi, and the result line
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
SHIFT = 11.0         # S + 11 I is SPD by Gershgorin
CG_ITERS = 50
RHS = 8              # right-hand sides of K3 and the block solve
SPMM_M = 1 << 18     # rows of bench config 3's regridding matrix
SPMM_K = 50          # entries a row
SPMM_N = 128         # columns of the dense block X
SPREAD = 128
WINDOW_GROUP = 32    # config 3's super-row group
CFG3B_M = 1 << 14    # rows of bench config 3b's scattered matrix
TILE_SIDE = 128
TILE_ELEMS = TILE_SIDE * TILE_SIDE
SAMPLED_ROWS = 4096
GRAD_M = 1 << 13
CFG4_N = 1 << 17     # rows of bench config 4's regridding matrix
SPGEMM_X = 128       # columns of X in the SpGEMM hand-off to K6
CFG2C_K = 10         # entries a row of bench config 2c (n = N)
HEAVY_N = 1 << 16    # rows of the heavy-row shuffle matrix
SORT_NBLK = 1024     # (1024, 64, 128) blocks: the TPU sort probe's size
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bfloat16 on the tensor cores

KERNELS = {
    "spmv_dia_stream": dict(
        route="cuda", source="spsparse_torch/csrc/dia.cu",
        replaces="spsparse_tpu/ops/pallas_dia.py:51"),
    "spmv_dia_chain": dict(
        route="cuda", source="spsparse_torch/csrc/dia.cu",
        replaces="spsparse_tpu/ops/pallas_dia_chain.py:35"),
    "spmm_dia_mrhs": dict(
        route="cuda", source="spsparse_torch/csrc/dia_mrhs.cu",
        replaces="spsparse_tpu/ops/pallas_dia_mrhs.py:42"),
    "cg_solve_dia": dict(
        route="cuda", source="spsparse_torch/csrc/dia_cg.cu",
        replaces="spsparse_tpu/ops/pallas_cg.py:71"),
    "spmm_tiled_window": dict(
        route="cuda", source="spsparse_torch/csrc/tiled_window.cu",
        replaces="spsparse_tpu/ops/pallas_tiled_window.py:145"),
    "spmm_tiled_dense": dict(
        route="cuda", source="spsparse_torch/csrc/tiled.cu",
        replaces="spsparse_tpu/ops/pallas_tiled.py:367"),
    "spmm_tiled_onehot": dict(
        route="cuda", source="spsparse_torch/csrc/tiled.cu",
        replaces="spsparse_tpu/ops/pallas_tiled.py:112"),
    "spgemm_window": dict(
        route="cuda", source="spsparse_torch/csrc/spgemm.cu",
        replaces="spsparse_tpu/ops/spgemm_window.py:227"),
    "spgemm_tiled_pairs": dict(
        route="cuda", source="spsparse_torch/csrc/spgemm.cu",
        replaces="spsparse_tpu/ops/spgemm_tiled.py:303"),
    "spgemm_tiled_stream": dict(
        route="cuda", source="spsparse_torch/csrc/spgemm.cu",
        replaces="spsparse_tpu/ops/spgemm_tiled.py:350"),
    "segmented_row_sums": dict(
        route="cuda", source="spsparse_torch/csrc/segsum.cu",
        replaces="spsparse_tpu/ops/pallas_segsum.py:48"),
    "shuffle_gather": dict(
        route="cuda", source="spsparse_torch/csrc/spmv_shuffle.cu",
        replaces="spsparse_tpu/ops/spmv_shuffle.py:199"),
    "sort_blocks": dict(
        route="cuda", source="spsparse_torch/csrc/block_sort.cu",
        replaces="spsparse_tpu/ops/pallas_sort.py:85"),
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
    return csr_host(*banded_entries(n), (n, n))


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


def band_of(n):
    """``(n, 2*BAND+1)`` float32 band of ``B``: column ``d`` holds
    ``B[i, i + d - BAND]``, zero out of range."""
    r, c, v = banded_entries(n)
    band = np.zeros((n, 2 * BAND + 1), np.float32)
    band[r, c - r + BAND] = v
    return band


def phase_spd(torch, sp, dev, n):
    """Phase 7: S = (B + B^T)/2 through the builder, consolidate, to_dia."""
    from spsparse_torch.ops import prepare_dia

    r, c, v = banded_entries(n)
    half = (np.float32(0.5) * v).astype(np.float32)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([r, c], axis=1), half)
    b.add_many(np.stack([c, r], axis=1), half)
    S = sp.to_dia(sp.consolidate(b.build(device=dev)))
    sync(torch, dev)
    offs = tuple(range(-BAND, BAND + 1))
    require(S.offsets == offs, f"S offsets {S.offsets}")
    want = sum(n - abs(o) for o in offs)
    require(S.nnz_stored == want, f"S stores {S.nnz_stored} slots, not {want}")
    band = band_of(n)
    sband = np.zeros_like(band)
    for d, o in enumerate(offs):
        lo, hi = max(0, -o), min(n, n - o)
        mirror = band[lo + o:hi + o, 2 * BAND - d]     # B[i + o, i]
        sband[lo:hi, d] = (np.float32(0.5) * band[lo:hi, d]
                           + np.float32(0.5) * mirror)
    ok, err = close(S.data.cpu().numpy(), sband.T, 1e-6, 1e-7)
    require(ok, f"S differs from (B + B^T)/2 (max abs err {err})")
    Bs = scipy_banded(n)
    return {"S": S, "prep": prepare_dia(S), "band": band,
            "S_host": (0.5 * (Bs + Bs.T)).tocsr(), "stored": S.nnz_stored}


def phase_mrhs(torch, sp, dev, band):
    """Phase 8: K3 on the config 2b operand B against its plain version,
    against 8 K1 calls, and for R = 7 and a 1-D x."""
    from spsparse_torch.ops import (prepare_dia, spmm_dia_mrhs,
                                    spmm_dia_mrhs_reference, spmv_dia_stream)

    n = band.shape[0]
    dia = sp.SparseDIA(data=torch.from_numpy(band.T.copy()).to(dev),
                       offsets=tuple(range(-BAND, BAND + 1)), shape=(n, n))
    X = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (RHS, n))
                         .astype(np.float32)).to(dev)
    out = {"X": X, "err": {}}
    # Tolerance, as K1's: rtol and atol 1e-5 of max|ref| (the kernel fuses
    # multiply-adds; the plain version rounds every product).
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(dia, dtype=dtype)
        Y = spmm_dia_mrhs(prep, X)
        ref = spmm_dia_mrhs_reference(prep, X)
        sync(torch, dev)
        require(tuple(Y.shape) == (RHS, n), f"K3 shape {tuple(Y.shape)}")
        ok, err = close(Y.cpu().numpy(), ref.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K3 {name} off its plain version (max abs err {err})")
        rows = torch.stack([spmv_dia_stream(prep, X[i]) for i in range(RHS)])
        ok, err_k1 = close(Y.cpu().numpy(), rows.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K3 {name} off 8 K1 calls (max abs err {err_k1})")
        out[name] = prep
        out["err"][name] = max(err, err_k1)
    prep = out["f32"]
    for got, ref in ((spmm_dia_mrhs(prep, X[:7]),
                      spmm_dia_mrhs_reference(prep, X[:7])),
                     (spmm_dia_mrhs(prep, X[0]),
                      spmm_dia_mrhs_reference(prep, X[:1])[0])):
        sync(torch, dev)
        ok, err = close(got.cpu().numpy(), ref.cpu().numpy(), 1e-5, 1e-5)
        require(ok and got.shape == ref.shape,
                f"K3 on {tuple(ref.shape)} off its plain version ({err})")
    return out


def residual_inf(S_host, x, rhs) -> np.ndarray:
    """``max|(S + SHIFT I) x - rhs|`` per column, in float64 on the host."""
    x = np.asarray(x, np.float64)
    rhs = np.asarray(rhs, np.float64)
    r = S_host @ x + SHIFT * x - rhs
    return np.abs(r).max(axis=0)


def phase_cg(torch, dev, spd):
    """Phase 9: K4 against its plain version, the composed solve over K1
    and a float64 residual; b = 0."""
    from spsparse_torch.ops import (best_spmv, cg_solve_dia,
                                    cg_solve_dia_reference)
    from spsparse_torch.solvers import cg_solve

    prep = spd["prep"]
    n = prep.shape[0]
    b = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, n)
                         .astype(np.float32)).to(dev)
    x, rs = cg_solve_dia(prep, b, iters=CG_ITERS, shift=SHIFT)
    x_ref, _ = cg_solve_dia_reference(prep, b, iters=CG_ITERS, shift=SHIFT)
    x_cmp, _ = cg_solve(lambda v: best_spmv(prep, v) + SHIFT * v, b,
                        iters=CG_ITERS)
    sync(torch, dev)
    xn = x.cpu().numpy()
    require(bool(np.all(np.isfinite(xn))) and xn.shape == (n,)
            and rs.shape == () and rs.device == x.device,
            "K4 output is not a finite (n,) vector with a 0-d device rs")
    # 50 iterations compound f32 rounding (fused vs separate multiply-adds,
    # block-ordered vs library-ordered dot products): 1e-4 of max|x|, as K2.
    ok, err = close(xn, x_ref.cpu().numpy(), 0.0, 1e-4)
    require(ok, f"K4 off its plain version (max abs err {err})")
    ok, err_cmp = close(xn, x_cmp.cpu().numpy(), 0.0, 1e-4)
    require(ok, f"K4 off the composed cg_solve over K1 ({err_cmp})")
    bn = b.cpu().numpy()
    # The float64 residual of a converged float32 solve is set by the f32
    # rounding of x and of S (about 1e-6 here); 1e-4 of max|b| bounds it
    # with margin and still fails an unconverged or wrong solve.
    res = float(residual_inf(spd["S_host"], xn, bn))
    bound = 1e-4 * float(np.abs(bn).max())
    require(res <= bound, f"K4 residual {res} above {bound}")
    x0, rs0 = cg_solve_dia(prep, torch.zeros_like(b), iters=5, shift=SHIFT)
    sync(torch, dev)
    require(not bool(x0.any()) and float(rs0) == 0.0,
            "K4 with b = 0 did not give x = 0 and rs = 0")
    return {"b": b, "x": x, "err": err, "err_composed": err_cmp,
            "residual": res, "rs": float(rs)}


def phase_block_cg(torch, dev, spd):
    """Phase 10: cg_solve_mrhs over K3, Jacobi-preconditioned."""
    from spsparse_torch.ops import best_spmv, spmm_dia_mrhs
    from spsparse_torch.solvers import (cg_solve_mrhs, extract_diagonal,
                                        jacobi_preconditioner, pcg_solve)

    prep = spd["prep"]
    n = prep.shape[0]
    B = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (n, RHS))
                         .astype(np.float32)).to(dev)
    minv = jacobi_preconditioner(extract_diagonal(spd["S"]) + SHIFT)
    X, rs = cg_solve_mrhs(
        lambda M: spmm_dia_mrhs(prep, M.T).T + SHIFT * M, B, iters=CG_ITERS,
        minv=minv)
    x0, _ = pcg_solve(lambda v: best_spmv(prep, v) + SHIFT * v, B[:, 0],
                      iters=CG_ITERS, minv=minv)
    sync(torch, dev)
    Xn, Bn = X.cpu().numpy(), B.cpu().numpy()
    require(Xn.shape == (n, RHS) and tuple(rs.shape) == (RHS,)
            and bool(np.all(np.isfinite(Xn))), "block CG output")
    # Per column, the same residual bound as phase 9; column 0 against
    # pcg_solve over K1 at 1e-4 of max|x|, as K4 against the composed solve.
    res = residual_inf(spd["S_host"], Xn, Bn)
    bound = 1e-4 * np.abs(Bn).max(axis=0)
    require(bool(np.all(res <= bound)),
            f"block CG residuals {res.tolist()} above {bound.tolist()}")
    ok, err = close(Xn[:, 0], x0.cpu().numpy(), 0.0, 1e-4)
    require(ok, f"block CG column 0 off pcg_solve over K1 ({err})")
    return {"B": B, "X": X, "minv": minv, "residual": float(res.max()),
            "err_column": err}


def solve_path(torch, sp, dev, n=N) -> dict:
    """Phases 7-10 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    spd = phase_spd(torch, sp, dev, n)
    log(f"phase 7 SPD operator: S stores {spd['stored']} slots in "
        f"{len(spd['S'].offsets)} diagonals "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    mrhs = phase_mrhs(torch, sp, dev, spd["band"])
    log(f"phase 8 K3 SpMM: max abs err {mrhs['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    cg = phase_cg(torch, dev, spd)
    log(f"phase 9 K4 CG ({CG_ITERS} iterations, shift {SHIFT}): max abs err "
        f"{cg['err']!r} vs plain, {cg['err_composed']!r} vs composed; "
        f"residual inf-norm {cg['residual']!r}; final rs {cg['rs']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    blk = phase_block_cg(torch, dev, spd)
    log(f"phase 10 block CG over K3: max residual {blk['residual']!r}; "
        f"column 0 vs pcg_solve {blk['err_column']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    return {"spd": spd, "mrhs": mrhs, "cg": cg, "block": blk,
            "nnz": spd["stored"]}


def regrid_entries(m: int, seed: int = 0):
    """Bench config 3's matrix and dense block (``bench.py:_regrid_matrix``
    and ``config3_spmm``): row r holds SPMM_K entries at columns
    ``clip(2r + U{-SPREAD..SPREAD}, 0, 2m-1)`` with values uniform(-1, 1),
    then X uniform(-1, 1) of shape ``(2m, SPMM_N)``, all from one
    ``default_rng(seed)``. Returns ``(rows, cols, vals, X)``."""
    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(m), SPMM_K)
    cc = np.clip(rr * 2 + rng.integers(-SPREAD, SPREAD + 1, rr.size), 0,
                 2 * m - 1)
    vals = rng.uniform(-1, 1, rr.size).astype(np.float32)
    X = rng.uniform(-1, 1, (2 * m, SPMM_N)).astype(np.float32)
    return rr, cc, vals, X


def build_coo(sp, dev, shape, rows, cols, vals):
    b = sp.CooBuilder(shape, dtype=np.float32)
    b.add_many(np.stack([rows, cols], axis=1), vals)
    return b.build(device=dev)


def sampled_rows_ref(rr, cc, vals, X, m, nrows=SAMPLED_ROWS, seed=7):
    """``(rows, float64 A[rows] @ X)`` on sampled rows, by scipy.sparse
    (rows of ``rr`` are sorted and of equal length)."""
    import scipy.sparse as ssp

    rows = np.sort(np.random.default_rng(seed).choice(
        m, min(nrows, m), replace=False))
    sel = (rows[:, None] * SPMM_K + np.arange(SPMM_K)).reshape(-1)
    part = ssp.csr_matrix(
        (vals[sel].astype(np.float64),
         (np.repeat(np.arange(rows.size), SPMM_K), cc[sel])),
        shape=(rows.size, X.shape[0]))
    return rows, part @ X.astype(np.float64)


def csr_host(rows, cols, vals, shape):
    import scipy.sparse as ssp

    return ssp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                          shape=shape)


def check_pair(got, ref, what: str, bf16: bool) -> float:
    """A kernel against its plain version: float32 rtol 1e-5 with atol
    1e-5 of max|ref| (the two sum in another order); bfloat16 blocks atol
    1e-4 of max|ref| (exact products, float32 sums of many terms)."""
    ok, err = close(got.cpu().numpy(), ref.cpu().numpy(),
                    0.0 if bf16 else 1e-5, 1e-4 if bf16 else 1e-5)
    require(ok, f"{what} off (max abs err {err})")
    return err


def check_sampled(Y, rows, ref, what: str, bf16: bool) -> float:
    """Against the float64 scipy rows: float32 rtol/atol 1e-5 of max|ref|;
    bfloat16 operands 2e-2 of max|ref| (bfloat16 rounds A and X)."""
    got = Y.cpu().numpy()[rows]
    ok, err = close(got, ref, 0.0 if bf16 else 1e-5, 2e-2 if bf16 else 1e-5)
    require(ok, f"{what} off the float64 scipy rows (max abs err {err})")
    return err


def phase_regrid(torch, sp, dev, m):
    """Phase 11: config 3's matrix through CooBuilder and to_tiled."""
    rr, cc, vals, X = regrid_entries(m)
    A = build_coo(sp, dev, (m, 2 * m), rr, cc, vals)
    tl = sp.to_tiled(A)
    sync(torch, dev)
    if m == SPMM_M:
        require(tl.n_tiles == 8190 and tl.tile_cap == 4096,
                f"config 3 tiles: n_tiles {tl.n_tiles}, tile_cap "
                f"{tl.tile_cap} (expected 8190 and 4096)")
    nnz = int((tl.vals != 0).sum())
    require(nnz == rr.size, f"tiled nnz {nnz} vs {rr.size} entries")
    return {"A": A, "tl": tl, "X": torch.from_numpy(X).to(dev),
            "entries": (rr, cc, vals), "X_host": X, "m": m,
            "fill": rr.size / tl.n_tiles}


def phase_window(torch, sp, dev, reg):
    """Phase 12: K5 in bfloat16 (group 32) and through prepare_general in
    float32 (route dense_window)."""
    from spsparse_torch.ops import (best_spmm, prepare_general,
                                    prepare_tiled_window, spmm_general,
                                    spmm_tiled_window,
                                    spmm_tiled_window_reference)

    X, m = reg["X"], reg["m"]
    rows, ref = sampled_rows_ref(*reg["entries"], reg["X_host"], m)
    prep_w = prepare_tiled_window(reg["tl"], group=WINDOW_GROUP)
    pg = prepare_general(reg["A"])
    require(pg.kernel == "dense_window",
            f"prepare_general routed config 3 to {pg.kernel}")
    Xp = X if pg.order is None else X[pg.order]
    out = {"prep_bf16": prep_w, "prep_f32": pg.prep, "pg": pg, "Xp": Xp,
           "err": {}, "sampled": rows, "sampled_ref": ref}
    Y_w = spmm_tiled_window(prep_w, X)
    Y_g = spmm_general(pg, X)
    Y_b = best_spmm(pg, X)
    sync(torch, dev)
    for Y in (Y_w, Y_g):
        require(tuple(Y.shape) == (m, SPMM_N) and bool(torch.isfinite(Y)
                                                       .all()),
                "K5 output is not a finite (m, 128) block")
    out["err"]["bf16"] = check_pair(
        Y_w, spmm_tiled_window_reference(prep_w, X), "K5 bf16 vs plain",
        True)
    out["err"]["f32"] = check_pair(
        Y_g, spmm_tiled_window_reference(pg.prep, Xp), "K5 f32 vs plain",
        False)
    require(torch.equal(Y_g, Y_b), "best_spmm and spmm_general differ")
    out["sampled_err"] = {
        "f32": check_sampled(Y_g, rows, ref, "K5 f32", False),
        "bf16": check_sampled(Y_w, rows, ref, "K5 bf16", True)}
    out["Y_bf16"], out["Y_f32"] = Y_w, Y_g
    return out


def phase_dense(torch, sp, dev, reg, win):
    """Phase 13: K6 on the window layout's blocks and on
    prepare_tiled_dense, float32 and bfloat16."""
    from spsparse_torch.ops import (prepare_tiled_dense, spmm_tiled_dense,
                                    spmm_tiled_dense_reference,
                                    to_tiled_dense)

    X = reg["X"]
    out = {"err": {}}
    rec = to_tiled_dense(win["prep_bf16"])
    Y = spmm_tiled_dense(rec, X)
    sync(torch, dev)
    check_pair(Y, spmm_tiled_dense_reference(rec, X), "K6 bf16 (window "
               "blocks) vs plain", True)
    check_pair(Y, win["Y_bf16"], "K6 bf16 vs K5 bf16", True)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_tiled_dense(reg["tl"], dtype=dtype)
        Y = spmm_tiled_dense(prep, X)
        sync(torch, dev)
        bf16 = name == "bf16"
        err = check_pair(Y, spmm_tiled_dense_reference(prep, X),
                         f"K6 {name} vs plain", bf16)
        out["err"][name] = max(err, check_pair(Y, win[f"Y_{name}"],
                                               f"K6 {name} vs K5", bf16))
        out[name] = prep
        out[f"Y_{name}"] = Y
    return out


def onehot_entries(m: int, seed: int = 5):
    """A one-hot-tier matrix: 40-48 entries on the diagonal of each block
    row's diagonal tile (one tile a block row, so packing cannot lower the
    tile count), values uniform(-1, 1)."""
    rng = np.random.default_rng(seed)
    nbr = -(-m // 128)
    k = rng.integers(40, 49, nbr)
    r = np.concatenate([b * 128 + np.arange(kk) for b, kk in enumerate(k)])
    r = r[r < m]
    return r, r.copy(), rng.uniform(-1, 1, r.size).astype(np.float32)


def cfg3b_entries(m: int, seed: int = 0):
    """Bench config 3b (``bench.py:config3b_packed_general``): 8 uniform
    random columns a row of 8m, values uniform(-1, 1), then X of 128
    columns, from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    ncols = 8 * m
    rr = np.repeat(np.arange(m), 8)
    cc = rng.integers(0, ncols, rr.size)
    vals = rng.uniform(-1, 1, rr.size).astype(np.float32)
    X = rng.uniform(-1, 1, (ncols, SPMM_N)).astype(np.float32)
    return rr, cc, vals, X


def phase_onehot(torch, sp, dev, reg, dense, m_onehot, m_3b):
    """Phase 14: K7 on config 3's tiles; the one_hot and gather_ell
    routes of prepare_general."""
    from spsparse_torch.ops import (prepare_general, prepare_tiled_rows,
                                    spmm_general, spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    X = reg["X"]
    prep = prepare_tiled_rows(reg["tl"])
    Y = spmm_tiled_onehot(prep, X)
    sync(torch, dev)
    err = check_pair(Y, spmm_tiled_onehot_reference(prep, X),
                     "K7 vs plain", False)
    err = max(err, check_pair(Y, dense["Y_f32"], "K7 vs K6 f32", False))

    r, c, v = onehot_entries(m_onehot)
    pg = prepare_general(build_coo(sp, dev, (m_onehot, m_onehot), r, c, v))
    require(pg.kernel == "one_hot",
            f"the one-hot-tier matrix routed to {pg.kernel}")
    Xo = np.random.default_rng(6).uniform(-1, 1, (m_onehot, SPMM_N)).astype(
        np.float32)
    Xo_dev = torch.from_numpy(Xo).to(dev)
    Xo_p = Xo_dev if pg.order is None else Xo_dev[pg.order]
    Yo = spmm_general(pg, Xo_dev)
    sync(torch, dev)
    err_k = check_pair(Yo, spmm_tiled_onehot_reference(pg.prep, Xo_p),
                       "K7 (one_hot route) vs plain", False)
    ok, err_o = close(Yo.cpu().numpy(), csr_host(r, c, v, (m_onehot,
                                                           m_onehot)) @ Xo,
                      1e-5, 1e-5)
    require(ok, f"one_hot route off scipy (max abs err {err_o})")

    rr, cc, vals, X3 = cfg3b_entries(m_3b)
    pg3 = prepare_general(build_coo(sp, dev, (m_3b, 8 * m_3b), rr, cc,
                                    vals))
    require(pg3.kernel == "gather_ell",
            f"config 3b routed to {pg3.kernel}")
    Y3 = spmm_general(pg3, torch.from_numpy(X3).to(dev))
    sync(torch, dev)
    ok, err_3b = close(Y3.cpu().numpy(), csr_host(
        rr, cc, vals, (m_3b, 8 * m_3b)) @ X3, 1e-5, 1e-5)
    require(ok, f"gather_ell route off scipy (max abs err {err_3b})")
    return {"prep": prep, "err": err, "err_onehot_route": err_o,
            "err_gather_ell": err_3b, "onehot_tiles": pg.prep.nbr,
            "ell_kmax": pg3.prep.cols.shape[1], "route": {
                "prep": pg.prep, "X": Xo_dev, "Xp": Xo_p, "entries": (r, c, v),
                "m": m_onehot, "err": err_k}}


def phase_grad(torch, sp, dev, m):
    """Phase 15: one backward through spmm_general on the dense-window
    layout (K5 forward), against the plain forward and backward on the
    CPU; gradients rtol 1e-4 (atol 1e-4 of max|grad|)."""
    import dataclasses

    from spsparse_torch.ops import prepare_general, spmm_general

    rr, cc, vals, X = regrid_entries(m)
    W = np.random.default_rng(8).uniform(-1, 1, (m, SPMM_N)).astype(
        np.float32)
    grads = {}
    for d in (dev, "cpu"):
        pg = prepare_general(build_coo(sp, d, (m, 2 * m), rr, cc, vals))
        require(pg.kernel == "dense_window", f"grad route {pg.kernel}")
        blocks = pg.prep.blocks.clone().requires_grad_(True)
        pg = dataclasses.replace(pg, prep=dataclasses.replace(
            pg.prep, blocks=blocks))
        Xt = torch.from_numpy(X).to(d).requires_grad_(True)
        (torch.from_numpy(W).to(d) * spmm_general(pg, Xt)).sum().backward()
        grads[str(d)] = (blocks.grad.cpu().numpy(), Xt.grad.cpu().numpy())
    sync(torch, dev)
    err = 0.0
    for got, ref in zip(grads[str(dev)], grads["cpu"]):
        ok, e = close(got, ref, 1e-4, 1e-4)
        require(ok, f"spmm_general gradient off the plain backward ({e})")
        err = max(err, e)
    return err


def spmm_path(torch, sp, dev, m=SPMM_M, m_onehot=SPMM_M, m_3b=CFG3B_M,
              m_grad=GRAD_M) -> dict:
    """Phases 11-15 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    reg = phase_regrid(torch, sp, dev, m)
    log(f"phase 11 config 3 tiles: n_tiles {reg['tl'].n_tiles}, tile_cap "
        f"{reg['tl'].tile_cap}, fill {reg['fill']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    win = phase_window(torch, sp, dev, reg)
    log(f"phase 12 K5: route {win['pg'].kernel}, ws "
        f"{win['prep_bf16'].ws} (group {WINDOW_GROUP}, bf16) / "
        f"{win['prep_f32'].ws} (group {win['prep_f32'].group}, f32); max "
        f"abs err vs plain {win['err']}, vs float64 rows "
        f"{win['sampled_err']} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    dense = phase_dense(torch, sp, dev, reg, win)
    log(f"phase 13 K6: max abs err {dense['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    onehot = phase_onehot(torch, sp, dev, reg, dense, m_onehot, m_3b)
    log(f"phase 14 K7: max abs err {onehot['err']!r}; one_hot route over "
        f"{onehot['onehot_tiles']} block rows err "
        f"{onehot['err_onehot_route']!r}; gather_ell route (Kmax "
        f"{onehot['ell_kmax']}) err {onehot['err_gather_ell']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    grad_err = phase_grad(torch, sp, dev, m_grad)
    log(f"phase 15 spmm_general backward at m = {m_grad}: max abs err "
        f"{grad_err!r} ({time.perf_counter() - t0:.3f} s)")
    return {"reg": reg, "win": win, "dense": dense, "onehot": onehot}


def cfg4_entries(n: int, seed: int = 0):
    """Bench config 4's matrix (``bench.py:config4_spgemm``): row r holds
    ``min(zipf(2.0), 24)`` entries at columns ``min(2r + U{0,1,2}, 2n-1)``
    with values uniform(0, 1), all from one ``default_rng(seed)``. Returns
    ``(rows, cols, vals)``; the builder stores the values as float32."""
    rng = np.random.default_rng(seed)
    k = np.minimum(rng.zipf(2.0, n), 24).astype(np.int64)
    r = np.repeat(np.arange(n), k)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), n * 2 - 1)
    return r, c, rng.uniform(0, 1, r.size)


def traced_routes(fn):
    """``(fn(), [(entry point, route), ...])``: the routes that the SpGEMM
    entry points record in the host event log while ``fn`` runs, in the
    order they finish."""
    from spsparse_torch.utils.trace import enable_event_log, get_event_log

    enable_event_log(True)
    try:
        out = fn()
        events = get_event_log()
    finally:
        enable_event_log(False)
    return out, [(e["op"].split(".")[-1], e["route"]) for e in events
                 if "route" in e]


def check_coo(got, ref, what: str, rtol: float, atol_rel: float) -> float:
    """A sparse result against a float64 scipy product: the same pattern
    and values within ``rtol*|ref| + atol_rel*max|ref|``."""
    g = _csr_of(got)
    g.sort_indices()
    ref = ref.tocsr()
    ref.sort_indices()
    require(g.nnz == ref.nnz and np.array_equal(g.indptr, ref.indptr)
            and np.array_equal(g.indices, ref.indices),
            f"{what}: pattern differs from scipy (nnz {g.nnz} vs {ref.nnz})")
    ok, err = close(g.data, ref.data, rtol, atol_rel)
    require(ok, f"{what} off the float64 scipy product (max abs err {err})")
    return err


def phase_cfg4(torch, sp, dev, n):
    """Phase 16: config 4's A through CooBuilder, consolidate, to_tiled."""
    from spsparse_torch.ops import plan_spgemm_caps

    r, c, v = cfg4_entries(n)
    b = sp.CooBuilder((n, 2 * n), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), v)
    raw = b.build(device=dev)
    A = sp.consolidate(raw)
    tl = sp.to_tiled(A)
    caps = plan_spgemm_caps(raw, raw, transpose_b=True)
    sync(torch, dev)
    if n == CFG4_N:
        require((A.nnz, tl.n_tiles, caps[0]) == (193565, 2540, 262144),
                f"config 4: nnz {A.nnz}, tiles {tl.n_tiles}, products "
                f"{caps[0]} (expected 193565, 2540, 262144)")
    A64 = _csr_of(A)
    return {"A": A, "tl": tl, "caps": caps, "n": n, "raw_entries": r.size,
            "AAT": (A64 @ A64.T).tocsr(),
            "fill": int((tl.vals != 0).sum()) / tl.n_tiles}


def phase_band(torch, sp, dev, cfg):
    """Phase 17: K8 through best_spgemm (f32) and spgemm_tiled (bf16)
    against scipy; the planned band against its plain version, dead slots
    exactly zero."""
    from spsparse_torch.ops import (best_spgemm, plan_window_spgemm,
                                    prepare_tiled_dense, spgemm_tiled,
                                    spgemm_window, spgemm_window_reference)

    A, n = cfg["A"], cfg["n"]
    C, routes = traced_routes(lambda: best_spgemm(A, A, transpose_b=True))
    sync(torch, dev)
    require(routes == [("spgemm_tiled", "window"), ("best_spgemm", "tiled")],
            f"best_spgemm(A, A^T) routes {routes}")
    err = {"f32": check_coo(C, cfg["AAT"], "best_spgemm(A, A^T)", 1e-5,
                            1e-5)}
    Cb = spgemm_tiled(A, A, transpose_b=True, dtype=torch.bfloat16)
    sync(torch, dev)
    # bfloat16 rounds A's values; the check allows 2e-2 of max|ref|.
    err["bf16"] = check_coo(Cb, cfg["AAT"], "spgemm_tiled bf16 A A^T", 0.0,
                            2e-2)
    out = {"C": C, "err": err, "band": {}, "plan": {}, "prep": {}}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_tiled_dense(cfg["tl"], dtype=dtype)
        plan = plan_window_spgemm(prep.tcols, prep.tcols, nbc=prep.nbc,
                                  out_shape=(n, n), dtype=dtype)
        band = spgemm_window(plan, prep.blocks)
        ref = spgemm_window_reference(plan, prep.blocks)
        sync(torch, dev)
        err[f"band_{name}"] = check_pair(band, ref, f"K8 {name} vs plain",
                                         name == "bf16")
        dead = torch.from_numpy(plan.cnt == 0).to(band.device)
        require(not bool(band.reshape(-1, TILE_ELEMS)[dead].any()),
                f"K8 {name}: a band slot with no pair is not exactly zero")
        out["band"][name], out["plan"][name] = band, plan
        out["prep"][name] = prep
    return out


def phase_pairs(torch, sp, dev, cfg, k8):
    """Phase 18: K9 through spgemm_tiled (config 4's pair plan),
    best_spgemm(C, C) and coo_matrix_power(C, 3) against scipy; K9 and K13
    on both pair plans against the plain version and each other."""
    from spsparse_torch.ops import (best_spgemm, coo_matrix_power,
                                    densify_tiled, plan_tiled_spgemm,
                                    spgemm_tiled, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream)
    from spsparse_torch.ops.spgemm_tiled import tiled_blocks_to_coo

    A, C = cfg["A"], k8["C"]
    P, routes = traced_routes(lambda: spgemm_tiled(
        A, A, transpose_b=True, use_window=False))
    sync(torch, dev)
    require(routes == [("spgemm_tiled", "pairs")],
            f"spgemm_tiled(use_window=False) routes {routes}")
    err = {"aat": check_coo(P, cfg["AAT"], "spgemm_tiled pairs A A^T", 1e-5,
                            1e-5)}
    C64 = _csr_of(C)
    CC_ref = (C64 @ C64).tocsr()
    CC, cc_routes = traced_routes(lambda: best_spgemm(C, C))
    sync(torch, dev)
    require(cc_routes == [("spgemm_tiled", "pairs"), ("best_spgemm",
                                                      "tiled")],
            f"best_spgemm(C, C) routes {cc_routes}")
    err["cc"] = check_coo(CC, CC_ref, "best_spgemm(C, C)", 1e-5, 1e-5)
    C3, power_routes = traced_routes(lambda: coo_matrix_power(C, 3))
    sync(torch, dev)
    err["c3"] = check_coo(C3, C64 @ CC_ref, "coo_matrix_power(C, 3)", 1e-5,
                          1e-5)

    tc = densify_tiled(sp.to_tiled(C))
    ta = {"f32": densify_tiled(cfg["tl"]),
          "bf16": densify_tiled(cfg["tl"], dtype=torch.bfloat16)}
    plans = {"A A^T": plan_tiled_spgemm(ta["f32"], ta["f32"],
                                        transpose_b=True),
             "C C": plan_tiled_spgemm(tc, tc)}
    runs = [("A A^T", "f32", ta["f32"], cfg["AAT"]),
            ("A A^T", "bf16", ta["bf16"], None),
            ("C C", "f32", tc, CC_ref)]
    out = {"err": err, "routes": {"A A^T": routes, "C C": cc_routes,
                                  "C^3": power_routes},
           "plans": plans, "blocks": {}, "bitwise_k9_k13": {}}
    for label, dname, X, oracle in runs:
        plan = plans[label]
        bf16 = dname == "bf16"
        k9 = spgemm_tiled_pairs(X, X, plan)
        k13 = spgemm_tiled_stream(X, X, plan)
        ref = spgemm_tiled_reference(X, X, plan)
        sync(torch, dev)
        what = f"{label} {dname}"
        e = max(check_pair(k9.blocks, ref.blocks, f"K9 {what} vs plain",
                           bf16),
                check_pair(k13.blocks, ref.blocks, f"K13 {what} vs plain",
                           bf16),
                check_pair(k13.blocks, k9.blocks, f"K13 {what} vs K9", bf16))
        if oracle is not None:
            e = max(e, check_coo(tiled_blocks_to_coo(k13), oracle,
                                 f"K13 {what}", 1e-5, 1e-5))
        err[f"{label} {dname}"] = e
        out["bitwise_k9_k13"][what] = bool(torch.equal(k9.blocks,
                                                       k13.blocks))
        out["blocks"][(label, dname)] = X
    return out


def phase_esc(torch, sp, dev, cfg):
    """Phase 19: the ESC Gram product and the planned ESC (device and host
    plans) against scipy."""
    from spsparse_torch.ops import plan_esc, spgemm_aat, spgemm_planned

    A = cfg["A"]
    E = spgemm_aat(A)
    sync(torch, dev)
    err = {"spgemm_aat": check_coo(E, cfg["AAT"], "spgemm_aat", 1e-5, 1e-5)}
    plans = {}
    for host in (False, True):
        plan, acon, bcon = plan_esc(A, A, transpose_b=True, host=host)
        Q = spgemm_planned(plan, acon.vals, bcon.vals)
        sync(torch, dev)
        key = "host" if host else "device"
        err[key] = check_coo(Q, cfg["AAT"], f"spgemm_planned ({key} plan)",
                             1e-5, 1e-5)
        plans[key] = (plan, acon, bcon)
    return {"err": err, "plans": plans}


def phase_handoff(torch, sp, dev, cfg, k8):
    """Phase 20: C's band as TiledBlocks -> to_prepared_dense -> K6."""
    from spsparse_torch.ops import spmm_tiled_dense
    from spsparse_torch.ops.spgemm_window import band_to_tiled_blocks

    n = cfg["n"]
    prep = band_to_tiled_blocks(k8["band"]["f32"],
                                k8["plan"]["f32"]).to_prepared_dense()
    X = np.random.default_rng(9).uniform(-1, 1, (n, SPGEMM_X)).astype(
        np.float32)
    Y = spmm_tiled_dense(prep, torch.from_numpy(X).to(dev))
    sync(torch, dev)
    ok, err = close(Y.cpu().numpy(), cfg["AAT"] @ X.astype(np.float64),
                    1e-5, 1e-5)
    require(ok, f"C = A A^T blocks through K6 off scipy (max abs err {err})")
    return {"err": err, "tiles": int((prep.tcols < prep.nbc).sum())}


def spgemm_path(torch, sp, dev, n=CFG4_N) -> dict:
    """Phases 16-20 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    cfg = phase_cfg4(torch, sp, dev, n)
    log(f"phase 16 config 4: {cfg['raw_entries']} entries -> nnz "
        f"{cfg['A'].nnz} in {cfg['tl'].n_tiles} tiles (fill "
        f"{cfg['fill']!r}); plan_spgemm_caps {cfg['caps']}; A A^T nnz "
        f"{cfg['AAT'].nnz} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    k8 = phase_band(torch, sp, dev, cfg)
    plan = k8["plan"]["f32"]
    log(f"phase 17 K8: W {plan.W}, live pairs {plan.n_live}, n_dots "
        f"{plan.n_dots}, band {plan.nbr_pad} x {plan.nband}; max abs err "
        f"{k8['err']} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    pairs = phase_pairs(torch, sp, dev, cfg, k8)
    pt = pairs["plans"]
    log(f"phase 18 K9/K13: pair plans A A^T {pt['A A^T'].n_pairs} pairs -> "
        f"{pt['A A^T'].n_out_tiles} tiles, C C {pt['C C'].n_pairs} pairs -> "
        f"{pt['C C'].n_out_tiles} tiles; routes {pairs['routes']}; K13 == "
        f"K9 bitwise {pairs['bitwise_k9_k13']}; max abs err {pairs['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    esc = phase_esc(torch, sp, dev, cfg)
    log(f"phase 19 ESC: max abs err {esc['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    hand = phase_handoff(torch, sp, dev, cfg, k8)
    log(f"phase 20 hand-off to K6: {hand['tiles']} tiles, max abs err "
        f"{hand['err']!r} ({time.perf_counter() - t0:.3f} s)")
    return {"cfg": cfg, "k8": k8, "pairs": pairs, "esc": esc}


def cfg2c_entries(n: int, k: int = CFG2C_K, seed: int = 0):
    """Bench config 2c (``bench.py:config2c_unstructured``): row r holds
    ``k`` entries at uniform-random columns of n, values uniform(-1, 1)
    float32, then x uniform(-1, 1), all from one ``default_rng(seed)``.
    Returns ``(rows, cols, vals, x)``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, rows.size)
    vals = rng.uniform(-1, 1, rows.size).astype(np.float32)
    return rows, cols, vals, rng.uniform(-1, 1, n).astype(np.float32)


def heavy_entries(n: int, seed: int = 10):
    """A heavy-row matrix of n x n: 10 uniform-random columns a row, plus
    4096 distinct columns in row 0 and 90 in each of 100 other rows, so
    that ``ell_k = 16`` splits rows (``extra_rows`` non-empty)."""
    rng = np.random.default_rng(seed)
    r = [np.repeat(np.arange(n), CFG2C_K), np.zeros(4096, np.int64)]
    c = [rng.integers(0, n, n * CFG2C_K), rng.permutation(n)[:4096]]
    for row in rng.choice(np.arange(1, n), 100, replace=False):
        r.append(np.full(90, row))
        c.append(rng.permutation(n)[:90])
    r, c = np.concatenate(r), np.concatenate(c)
    return (r, c, rng.uniform(-1, 1, r.size).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32))


def dirty_cache(torch, dev, nbytes: int) -> None:
    """Leave NaN in the caching allocator's free blocks, so that an output
    slot a kernel fails to write shows (a no-op off the card)."""
    if torch.device(dev).type == "cuda":
        junk = torch.full((nbytes // 4 + 1,), float("nan"), device=dev)
        del junk


def check_shuffle(torch, dev, prep, x, host, what: str) -> dict:
    """K11's slot grid against its plain version bit for bit (on an
    allocation left full of NaN), ``best_spmv`` against the plain
    ``spmv_shuffle`` (rtol 1e-5, atol 1e-5 of max|ref|: the same slot
    sums) and against the float64 scipy product (1e-5 of max|y|)."""
    from spsparse_torch.ops import (best_spmv, shuffle_gather,
                                    shuffle_gather_reference,
                                    spmv_shuffle_reference)

    y = best_spmv(prep, x)
    dirty_cache(torch, dev, prep.n_slots * 4)
    slots = shuffle_gather(prep, x)
    ref_slots = shuffle_gather_reference(prep, x)
    sync(torch, dev)
    require(not bool(torch.isnan(slots).any()),
            f"K11 {what}: a slot was left unwritten (NaN)")
    require(torch.equal(slots, ref_slots),
            f"K11 {what}: the slot grid differs from the plain sort pipeline")
    ok, err_plain = close(y.cpu().numpy(),
                          spmv_shuffle_reference(prep, x).cpu().numpy(),
                          1e-5, 1e-5)
    require(ok, f"spmv_shuffle {what} off its plain version ({err_plain})")
    y_ref = host @ x.cpu().numpy().astype(np.float64)
    ok, err = close(y.cpu().numpy(), y_ref, 0.0, 1e-5)
    require(ok and tuple(y.shape) == (prep.shape[0],),
            f"spmv_shuffle {what} off the float64 scipy product ({err})")
    return {"y": y, "err_plain": err_plain, "err": err}


def phase_2c(torch, sp, dev, n):
    """Phase 21: config 2c through CooBuilder and prepare_shuffle_spmv."""
    from spsparse_torch.ops import prepare_shuffle_spmv

    rows, cols, vals, x = cfg2c_entries(n)
    A = build_coo(sp, dev, (n, n), rows, cols, vals)
    sync(torch, dev)
    t0 = time.perf_counter()
    prep = prepare_shuffle_spmv(A)
    sync(torch, dev)
    prep_s = time.perf_counter() - t0
    return {"A": A, "prep": prep, "x": torch.from_numpy(x).to(dev),
            "host": csr_host(rows, cols, vals, (n, n)), "n": n,
            "nnz": rows.size, "prepare_s": prep_s,
            "fill": rows.size / (prep.n_batches * 1024)}


def phase_shuffle(torch, sp, dev, c2, heavy_n):
    """Phase 22: K11 through best_spmv at config 2c and on the heavy-row
    matrix (ell_k 16, split rows)."""
    from spsparse_torch.ops import prepare_shuffle_spmv

    out = {"2c": check_shuffle(torch, dev, c2["prep"], c2["x"], c2["host"],
                               "config 2c")}
    r, c, v, xh = heavy_entries(heavy_n)
    prep = prepare_shuffle_spmv(build_coo(sp, dev, (heavy_n, heavy_n), r, c,
                                          v), ell_k=16)
    require(prep.extra_rows.shape[0] > 0, "the heavy-row matrix split no row")
    out["heavy"] = check_shuffle(torch, dev, prep, torch.from_numpy(xh).to(
        dev), csr_host(r, c, v, (heavy_n, heavy_n)), "heavy rows")
    out["heavy_extra"] = int(prep.extra_rows.shape[0])
    return out


def phase_segsum(torch, sp, dev, c2):
    """Phase 23: K10 on config 2c's CSR products against its plain version
    (rtol 1e-5, atol 1e-5 of max|ref|: another sum order),
    ``spmv_csr_segsum`` against scipy float64 (1e-5 of max|y|), and K10
    on a skewed row pointer (empty rows, one row of 4096)."""
    from spsparse_torch.ops import (csr_products, segmented_row_sums,
                                    segmented_row_sums_reference,
                                    spmv_csr_segsum)

    n, x = c2["n"], c2["x"]
    csr = sp.to_csr(c2["A"])
    prod = csr_products(csr, x)
    y10 = segmented_row_sums(prod, csr.row_ptr, nrows=n, rows_per_block=256,
                             entries_per_block=1024)
    ref10 = segmented_row_sums_reference(prod, csr.row_ptr, n)
    ys = spmv_csr_segsum(csr, x)
    sync(torch, dev)
    err = {"k10": check_pair(y10, ref10, "K10 vs plain", False)}
    ok, err["csr_spmv"] = close(ys.cpu().numpy(), c2["host"] @ x.cpu().numpy()
                                .astype(np.float64), 0.0, 1e-5)
    require(ok, f"spmv_csr_segsum off scipy (max abs err {err['csr_spmv']})")

    rng = np.random.default_rng(11)
    ns = min(1 << 16, n)
    counts = rng.integers(0, 4, ns) * (np.arange(ns) % 5 != 0)
    counts[ns // 3] = 4096
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ph = rng.uniform(-1, 1, int(rp[-1])).astype(np.float32)
    ys = segmented_row_sums(torch.from_numpy(ph).to(dev),
                            torch.from_numpy(rp).to(dev), nrows=ns,
                            rows_per_block=8, entries_per_block=128)
    sync(torch, dev)
    want = np.add.reduceat(np.append(ph.astype(np.float64), 0.0), rp[:-1])
    want[counts == 0] = 0.0
    ok, err["skewed"] = close(ys.cpu().numpy(), want, 1e-5, 1e-5)
    require(ok, f"K10 on the skewed row pointer ({err['skewed']})")
    return {"csr": csr, "prod": prod, "err": err}


def same_up_to_ties(torch, got, ref, num_keys: int, what: str) -> None:
    """Keys exactly equal; payloads equal as a multiset within each run of
    equal keys (a bitonic network is not stable): both sides canonicalised
    by a stable sort over keys and payload bits."""
    from spsparse_torch.ops import sort_blocks_reference

    for g, r in zip(got[:num_keys], ref[:num_keys]):
        require(torch.equal(g, r), f"K12 {what}: keys differ")

    def canon(arrs):
        bits = tuple(a.view(torch.int32) for a in arrs)
        return sort_blocks_reference(bits, num_keys=len(bits))

    require(all(torch.equal(a, b) for a, b in zip(canon(got), canon(ref))),
            f"K12 {what}: payloads differ within runs of equal keys")


def phase_sort(torch, dev, nblk):
    """Phase 24: K12 on (nblk, 64, 128) int32 keys with a float32 payload,
    two keys, sort_blocks_stable packed and not (exact), R = 1, and
    (8, 256, 128) with three arrays (past the shared-memory chunk)."""
    from spsparse_torch.ops import (sort_blocks, sort_blocks_reference,
                                    sort_blocks_stable)

    rng = np.random.default_rng(12)

    def t(a):
        return torch.from_numpy(a).to(dev)

    def ints(hi, shape):
        return t(rng.integers(0, hi, shape).astype(np.int32))

    def floats(shape):
        return t(rng.uniform(-1, 1, shape).astype(np.float32))

    main = (ints(1 << 30, (nblk, 64, 128)), floats((nblk, 64, 128)))
    cases = [("(nblk, 64, 128) key + payload", main, 1),
             ("two keys", (ints(8, (nblk // 4, 32, 128)),
                           ints(1 << 20, (nblk // 4, 32, 128)),
                           floats((nblk // 4, 32, 128))), 2),
             ("R = 1", (ints(1 << 12, (nblk, 1, 128)),
                        floats((nblk, 1, 128))), 1),
             ("(8, 256, 128) three arrays", (ints(64, (8, 256, 128)),
                                             ints(1 << 30, (8, 256, 128)),
                                             floats((8, 256, 128))), 2)]
    for what, arrays, nk in cases:
        dirty_cache(torch, dev, sum(a.numel() for a in arrays) * 4)
        got = sort_blocks(arrays, num_keys=nk)
        ref = sort_blocks_reference(arrays, num_keys=nk)
        sync(torch, dev)
        same_up_to_ties(torch, got, ref, nk, what)
    kk, pay = ints(8, (nblk // 4, 8, 128)), floats((nblk // 4, 8, 128))
    ref = sort_blocks_reference((kk, pay))
    for bound in (8, None):
        got = sort_blocks_stable(kk, (pay,), key_bound=bound)
        sync(torch, dev)
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"K12 sort_blocks_stable (key_bound {bound}) is not the "
                "stable sort")
    return {"main": main, "cases": [c[0] for c in cases]}


def unstructured_path(torch, sp, dev, n=N, heavy_n=HEAVY_N,
                      sort_nblk=SORT_NBLK) -> dict:
    """Phases 21-24 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    c2 = phase_2c(torch, sp, dev, n)
    p = c2["prep"]
    log(f"phase 21 config 2c: {c2['nnz']} entries, B {p.n_batches}, n_vrows "
        f"{p.n_vrows}, fillers {p.filler_dest.shape[0]}, gather_fill "
        f"{c2['fill']!r}; prepare_shuffle_spmv {c2['prepare_s']!r} s "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    sh = phase_shuffle(torch, sp, dev, c2, heavy_n)
    log(f"phase 22 K11: config 2c max abs err {sh['2c']['err']!r} vs scipy, "
        f"{sh['2c']['err_plain']!r} vs plain; heavy rows ({sh['heavy_extra']}"
        f" split) {sh['heavy']['err']!r} vs scipy; slot grids bitwise "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    seg = phase_segsum(torch, sp, dev, c2)
    log(f"phase 23 K10: max abs err {seg['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    srt = phase_sort(torch, dev, sort_nblk)
    log(f"phase 24 K12: {srt['cases']}, stable packed and not: keys exact, "
        f"payloads by runs ({time.perf_counter() - t0:.3f} s)")
    return {"c2": c2, "shuffle": sh, "segsum": seg, "sort": srt}


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


def compare_times(torch, kernel, plain, **kw) -> tuple[float, float]:
    """Median ms of the kernel and of the plain version, timed in turns
    (plain, kernel, kernel, plain)."""
    p1 = time_ms(torch, plain, **kw)
    k1 = time_ms(torch, kernel, **kw)
    k2 = time_ms(torch, kernel, **kw)
    p2 = time_ms(torch, plain, **kw)
    return float(np.median(k1 + k2)), float(np.median(p1 + p2))


def per_iteration_ms(torch, solves: dict, long: int = 72,
                     short: int = 8) -> dict:
    """ms per CG iteration of each solver in ``solves`` (name -> function
    of ``iters``), as the difference of ``long`` and ``short`` solves over
    ``long - short``: the per-solve set-up cancels. Timed in turns, in the
    order given and then reversed."""
    kw = dict(reps=7, inner=3, warmup=1)
    times = {name: {long: [], short: []} for name in solves}
    for name in list(solves) + list(reversed(solves)):
        for iters in (long, short):
            times[name][iters] += time_ms(
                torch, lambda: solves[name](iters), **kw)
    return {name: (float(np.median(t[long])) - float(np.median(t[short])))
            / (long - short) for name, t in times.items()}


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time on an H100 SXM for the work: the larger of the bytes over
    the memory rate and the operations over their type's rate (float32
    outside the tensor cores unless ``flops_per_s`` says otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def torch_csr(torch, M, dev):
    """``torch.sparse_csr_tensor`` (float32, on ``dev``) of a scipy matrix:
    the library yardsticks' operand, used nowhere in the port."""
    M = M.tocsr().astype(np.float32)
    M.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(M.indices.astype(np.int64)).to(dev),
        torch.from_numpy(M.data).to(dev), size=M.shape,
        check_invariants=True)


def library_csr_of(torch, rows, cols, vals, shape, dev):
    """:func:`torch_csr` of an entry list."""
    return torch_csr(torch, csr_host(rows, cols, vals, shape), dev)


def tile_counts(torch, prep) -> tuple[int, int]:
    """``(live tiles, occupied column blocks)`` of a prepared tiled layout,
    read from its own tile columns (a packed or window layout may hold
    other tiles than ``to_tiled`` gave)."""
    tc = prep.tcols
    tc = tc[tc < prep.nbc]
    return int(tc.numel()), int(torch.unique(tc).numel())


def spmm_timings(torch, spmm, launches: dict) -> list[dict]:
    """Rows of the kernels line for K5, K6 and K7 at config 3, and for K7
    on the one_hot route's layout (the traffic prepare_general sends it):
    kernel and plain version in turns, the bound from each timed layout,
    and one ``torch.sparse_csr_tensor`` product as the library yardstick.

    Every bound counts the bytes the product needs, from the timed layout:
    the live A tiles once (dense blocks, or K7's slot values and each
    entry's row and column), X once per occupied column block (K7: once
    per X row an entry names), Y once in float32."""
    from spsparse_torch.ops import (spmm_tiled_dense,
                                    spmm_tiled_dense_reference,
                                    spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference,
                                    spmm_tiled_window,
                                    spmm_tiled_window_reference)

    reg, win, dense = spmm["reg"], spmm["win"], spmm["dense"]
    X, m = reg["X"], reg["m"]
    nnz = reg["entries"][0].size
    route = spmm["onehot"]["route"]

    def library_ms(entries, shape, Xl):
        A_csr = library_csr_of(torch, *entries, shape, Xl.device)
        return float(np.median(time_ms(torch, lambda: A_csr @ Xl, reps=7,
                                       inner=5)))

    lib_ms = library_ms(reg["entries"], (m, 2 * m), X)
    route_lib_ms = library_ms(route["entries"], (route["m"], route["m"]),
                              route["X"])
    kw = dict(reps=5, inner=3, warmup=2)
    rows = []

    def add(name, dtype, matrix, prep, Xk, kernel, plain, item, rate, err,
            lib, nnz, timing_kw=kw):
        ms, plain_ms = compare_times(torch, lambda: kernel(prep, Xk),
                                     lambda: plain(prep, Xk), **timing_kw)
        live, occupied = tile_counts(torch, prep)
        n_rhs = Xk.shape[1]
        x_bytes = occupied * TILE_SIDE * n_rhs * item
        y_bytes = prep.shape[0] * n_rhs * 4
        if name == "spmm_tiled_onehot":
            # Every slot's value of the live tiles (a padding slot is known
            # only by its zero value), each entry's row and column, and the
            # X rows the entries name (an entry product needs no whole X
            # tile); 2 operations per entry and column.
            tc = prep.tcols.long()[:, :, None]
            keep = (prep.vals != 0) & (tc < prep.nbc)
            entries = int(keep.sum())
            x_rows = int(torch.unique((tc * TILE_SIDE + prep.cols)[keep])
                         .numel())
            x_bytes = x_rows * n_rhs * item
            a_bytes = live * prep.tile_cap * 4 + entries * 8
            flops = 2 * entries * n_rhs
        else:
            a_bytes = live * TILE_ELEMS * item
            flops = 2 * TILE_ELEMS * n_rhs * live
        b_ms, b_by = bound_ms(a_bytes + x_bytes + y_bytes, flops, rate)
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, matrix=matrix, n=prep.shape[0],
                         nnz=nnz, live_tiles=live,
                         occupied_column_blocks=occupied))

    c3 = "config 3"
    add("spmm_tiled_window", "f32", c3 + " (prepare_general)",
        win["prep_f32"], win["Xp"], spmm_tiled_window,
        spmm_tiled_window_reference, 4, F32_FLOPS_PER_S, win["err"]["f32"],
        lib_ms, nnz)
    add("spmm_tiled_window", "bf16", c3, win["prep_bf16"], X,
        spmm_tiled_window, spmm_tiled_window_reference, 2, BF16_FLOPS_PER_S,
        win["err"]["bf16"], lib_ms, nnz)
    for dname, item, rate in (("f32", 4, F32_FLOPS_PER_S),
                              ("bf16", 2, BF16_FLOPS_PER_S)):
        add("spmm_tiled_dense", dname, c3, dense[dname], X,
            spmm_tiled_dense, spmm_tiled_dense_reference, item, rate,
            dense["err"][dname], lib_ms, nnz)
    add("spmm_tiled_onehot", "f32", c3, spmm["onehot"]["prep"], X,
        spmm_tiled_onehot, spmm_tiled_onehot_reference, 4, F32_FLOPS_PER_S,
        spmm["onehot"]["err"], lib_ms, nnz,
        timing_kw=dict(reps=3, inner=2, warmup=1))
    add("spmm_tiled_onehot", "f32", "one_hot route", route["prep"],
        route["Xp"], spmm_tiled_onehot, spmm_tiled_onehot_reference, 4,
        F32_FLOPS_PER_S, route["err"], route_lib_ms,
        int(route["entries"][0].size))
    return rows


def library_spgemm_ms(torch, left, right, dev):
    """``(ms, error)`` of one ``torch.sparse`` CSR x CSR float32 product on
    the card (cuSPARSE's SpGEMM, the whole product, output pattern
    included) of scipy operands: the yardstick of K8, K9 and K13, used
    nowhere in the port. ``(None, message)`` where this PyTorch refuses
    it."""
    try:
        L, R = torch_csr(torch, left, dev), torch_csr(torch, right, dev)
        return float(np.median(time_ms(torch, lambda: L @ R, reps=5,
                                       inner=3, warmup=2))), None
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host milliseconds of ``fn`` ending in a synchronize (after
    one warm-up call): a call of an eager entry point, host work
    included."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def spgemm_timings(torch, spg, launches: dict) -> tuple[list[dict], dict]:
    """Rows of the kernels line for K8, K9 and K13 at config 4, and the
    end-to-end times of the SpGEMM entry points.

    Bounds count what the product needs: K8 reads A's live blocks once
    (the plan is shared) and writes the band once in float32, and does
    2*128^3 operations per live pair; K9 and K13 read the distinct operand
    tiles of their plan once, write the output tiles once, and do 2*128^3
    operations per pair. The library yardstick is cuSPARSE's CSR x CSR
    SpGEMM of the same operands, extraction of the output included."""
    from spsparse_torch.ops import (plan_esc, spgemm_aat, spgemm_planned_vals,
                                    spgemm_tiled, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream, spgemm_window,
                                    spgemm_window_reference)

    cfg, k8, pairs = spg["cfg"], spg["k8"], spg["pairs"]
    A, n = cfg["A"], cfg["n"]
    A64 = _csr_of(A)
    C64 = _csr_of(k8["C"])
    lib = {"A A^T": library_spgemm_ms(torch, A64, A64.T, "cuda"),
           "C C": library_spgemm_ms(torch, C64, C64, "cuda")}
    kw = dict(reps=5, inner=3, warmup=2)
    flops_pair = 2 * TILE_SIDE ** 3
    rows = []

    def row(name, dtype, matrix, ms, plain_ms, nbytes, flops, err, label):
        rate = BF16_FLOPS_PER_S if dtype == "bf16" else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        lib_ms, lib_err = lib[label]
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_error=lib_err,
                         matrix=matrix, n=n, nnz=A.nnz))

    for dname in ("f32", "bf16"):
        plan, prep = k8["plan"][dname], k8["prep"][dname]
        ms, plain_ms = compare_times(
            torch, lambda: spgemm_window(plan, prep.blocks),
            lambda: spgemm_window_reference(plan, prep.blocks), **kw)
        live = int((prep.tcols < prep.nbc).sum())
        nbytes = (live * TILE_ELEMS * prep.blocks.element_size()
                  + plan.nbr_pad * plan.nband * TILE_ELEMS * 4)
        row("spgemm_window", dname, "config 4 A A^T (band)", ms, plain_ms,
            nbytes, plan.n_live * flops_pair, k8["err"][f"band_{dname}"],
            "A A^T")
    for label, dname in (("A A^T", "f32"), ("A A^T", "bf16"),
                         ("C C", "f32")):
        plan = pairs["plans"][label]
        X = pairs["blocks"][(label, dname)]
        tiles = np.unique(np.concatenate([plan.pa, plan.pb])).size
        nbytes = (tiles * TILE_ELEMS * X.blocks.element_size()
                  + plan.n_out_tiles * TILE_ELEMS * 4)
        for name, fn in (("spgemm_tiled_pairs", spgemm_tiled_pairs),
                         ("spgemm_tiled_stream", spgemm_tiled_stream)):
            ms, plain_ms = compare_times(
                torch, lambda: fn(X, X, plan),
                lambda: spgemm_tiled_reference(X, X, plan), **kw)
            row(name, dname, f"config 4 {label} (pair plan)", ms, plain_ms,
                nbytes, plan.n_pairs * flops_pair,
                pairs["err"][f"{label} {dname}"], label)

    plan, acon, bcon = spg["esc"]["plans"]["device"]
    ends = {
        "spgemm_tiled(A, A, transpose_b=True) end to end (K8 route)":
            host_ms(torch, lambda: spgemm_tiled(A, A, transpose_b=True)),
        "spgemm_tiled(..., use_window=False) end to end (K9 route)":
            host_ms(torch, lambda: spgemm_tiled(A, A, transpose_b=True,
                                                use_window=False)),
        "spgemm_aat (ESC) end to end": host_ms(torch, lambda: spgemm_aat(A)),
        "plan_esc host plan": host_ms(torch, lambda: plan_esc(
            A, A, transpose_b=True, host=True), reps=1),
        "spgemm_planned_vals apply (events)": float(np.median(time_ms(
            torch, lambda: spgemm_planned_vals(plan, acon.vals, bcon.vals),
            **kw))),
    }
    return rows, {"end_to_end_ms": ends, "library_ms": lib}


def unstructured_timings(torch, un, launches: dict) -> tuple[list, dict]:
    """Rows of the kernels line for K10, K11 and K12, and the end-to-end
    times of the unstructured SpMV entry points at config 2c.

    Bounds count what each function needs, from the timed inputs: K10 reads
    the products and row_ptr once and writes y (one add an entry); K11
    reads the layout (octet, idx, vals, dest, fillers) and x once and
    writes every ELL slot once (one multiply a gather slot); K12 reads and
    writes each array once, and does a compare a key and two selects an
    array for each of the network's n/2 pairs a stage (on the SIMT units,
    counted at the float32 rate). Library yardsticks: cuSPARSE's CSR SpMV
    (``torch.sparse_csr_tensor @ x``) of the 2c matrix for K10 and K11;
    ``torch.sort`` of the flattened blocks carrying the payload through
    ``gather`` for K12 (unstable; the stable variant beside it)."""
    from spsparse_torch.ops import (plan_stages, segmented_row_sums,
                                    segmented_row_sums_reference,
                                    shuffle_gather, shuffle_gather_reference,
                                    sort_blocks, sort_blocks_reference,
                                    spmv_csr_segsum, spmv_shuffle)

    c2, seg = un["c2"], un["segsum"]
    prep, x, n, nnz = c2["prep"], c2["x"], c2["n"], c2["nnz"]
    A_csr = torch_csr(torch, c2["host"], x.device)
    lib_ms = float(np.median(time_ms(torch, lambda: A_csr @ x)))
    rows = []

    def row(name, matrix, ms, plain_ms, nbytes, ops, err, lib, dtype="f32",
            **extra):
        b_ms, b_by = bound_ms(nbytes, ops)
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, matrix=matrix, **extra))

    prod, csr = seg["prod"], seg["csr"]
    ms, plain_ms = compare_times(
        torch, lambda: segmented_row_sums(prod, csr.row_ptr, nrows=n,
                                          rows_per_block=256,
                                          entries_per_block=1024),
        lambda: segmented_row_sums_reference(prod, csr.row_ptr, n))
    row("segmented_row_sums", "config 2c (CSR products)", ms, plain_ms,
        4 * csr.nnz + 4 * (n + 1) + 4 * n, csr.nnz, seg["err"]["k10"],
        lib_ms, n=n, nnz=csr.nnz)
    ms, plain_ms = compare_times(torch, lambda: shuffle_gather(prep, x),
                                 lambda: shuffle_gather_reference(prep, x),
                                 reps=7, inner=5)
    gslots = prep.n_batches * 1024
    isz = prep.dest.element_size()
    nbytes = (4 * prep.n_batches + gslots * (8 + isz)
              + prep.filler_dest.shape[0] * isz + 4 * n + 4 * prep.n_slots)
    row("shuffle_gather", "config 2c (shuffle layout)", ms, plain_ms, nbytes,
        gslots, 0.0, lib_ms, n=n, nnz=nnz, batches=prep.n_batches,
        gather_fill=c2["fill"])
    keys, pay = un["sort"]["main"]
    nblk, R, _ = keys.shape
    nel = keys.numel()
    ms, plain_ms = compare_times(
        torch, lambda: sort_blocks((keys, pay)),
        lambda: sort_blocks_reference((keys, pay)), reps=7, inner=5)
    flat_k, flat_p = keys.reshape(nblk, -1), pay.reshape(nblk, -1)

    def library_sort(stable):
        s, order = torch.sort(flat_k, dim=-1, stable=stable)
        return s, flat_p.gather(1, order)

    sort_lib = float(np.median(time_ms(torch, lambda: library_sort(False),
                                       reps=7, inner=5)))
    sort_lib_stable = float(np.median(time_ms(
        torch, lambda: library_sort(True), reps=7, inner=5)))
    stages = plan_stages(R * 128)[2]
    row("sort_blocks", f"({nblk}, {R}, 128) int32 key + float32 payload",
        ms, plain_ms, 2 * 2 * 4 * nel, stages * (nel // 2) * (1 + 2 * 2),
        0.0, sort_lib, dtype="i32 key, f32 payload",
        library_stable_ms=sort_lib_stable, n=nel, nnz=nel)
    ends = {
        "spmv_shuffle (best_spmv) ms": float(np.median(time_ms(
            torch, lambda: spmv_shuffle(prep, x), reps=7, inner=5))),
        "spmv_csr_segsum ms": float(np.median(time_ms(
            torch, lambda: spmv_csr_segsum(csr, x), reps=7, inner=5))),
        "library csr @ x ms": lib_ms, "nnz": nnz,
        "prepare_shuffle_spmv host s": c2["prepare_s"]}
    for key in ("spmv_shuffle (best_spmv) ms", "spmv_csr_segsum ms",
                "library csr @ x ms"):
        ends[key.replace(" ms", " Gnnz/s")] = nnz / ends[key] / 1e6
    return rows, ends


def library_csr(torch, n, dev):
    """``torch.sparse_csr_tensor`` of the benchmark matrix ``B`` on the
    card: the library yardstick, timed here and used nowhere in the port."""
    return library_csr_of(torch, *banded_entries(n), (n, n), dev)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def run_path(torch, wrappers: dict, path, *args) -> tuple[dict, dict]:
    """Run ``path`` with every launch counter set to 0 just before it;
    return its state and the counts read just after it."""
    for fn in wrappers.values():
        fn.launches = 0
    state = path(*args)
    torch.cuda.synchronize()
    return state, {name: fn.launches for name, fn in wrappers.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import spsparse_torch as sp
    from spsparse_torch import backend
    from spsparse_torch.ops import (best_spmv, cg_solve_dia,
                                    cg_solve_dia_reference, spmm_dia_mrhs,
                                    spmm_dia_mrhs_reference, spmv_dia_chain,
                                    spmv_dia_chain_reference,
                                    spmv_dia_stream,
                                    spmv_dia_stream_reference)
    from spsparse_torch.ops import (spgemm_tiled_pairs, spgemm_tiled_stream,
                                    spgemm_window, spmm_tiled_dense,
                                    spmm_tiled_onehot, spmm_tiled_window)
    from spsparse_torch.ops import (segmented_row_sums, shuffle_gather,
                                    sort_blocks)
    from spsparse_torch.solvers import cg_solve

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

    wrappers = {"spmv_dia_stream": spmv_dia_stream,
                "spmv_dia_chain": spmv_dia_chain,
                "spmm_dia_mrhs": spmm_dia_mrhs,
                "cg_solve_dia": cg_solve_dia,
                "spmm_tiled_window": spmm_tiled_window,
                "spmm_tiled_dense": spmm_tiled_dense,
                "spmm_tiled_onehot": spmm_tiled_onehot,
                "spgemm_window": spgemm_window,
                "spgemm_tiled_pairs": spgemm_tiled_pairs,
                "spgemm_tiled_stream": spgemm_tiled_stream,
                "segmented_row_sums": segmented_row_sums,
                "shuffle_gather": shuffle_gather,
                "sort_blocks": sort_blocks}
    torch.cuda.reset_peak_memory_stats()
    state, main_counts = run_path(torch, wrappers, main_path, torch, sp, dev)
    log(f"main path kernel launches: {main_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    for name in ("spmv_dia_stream", "spmv_dia_chain"):
        require(main_counts[name] > 0,
                f"kernel {name} was not launched on the main path")
    torch.cuda.reset_peak_memory_stats()
    solve, solve_counts = run_path(torch, wrappers, solve_path, torch, sp,
                                   dev)
    log(f"solve path kernel launches: {solve_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    for name in ("spmm_dia_mrhs", "cg_solve_dia"):
        require(solve_counts[name] > 0,
                f"kernel {name} was not launched on the solve path")
    torch.cuda.reset_peak_memory_stats()
    spmm, spmm_counts = run_path(torch, wrappers, spmm_path, torch, sp, dev)
    log(f"spmm path kernel launches: {spmm_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    spmm_kernels = ("spmm_tiled_window", "spmm_tiled_dense",
                    "spmm_tiled_onehot")
    for name in spmm_kernels:
        require(spmm_counts[name] > 0,
                f"kernel {name} was not launched on the spmm path")
    torch.cuda.reset_peak_memory_stats()
    spg, spgemm_counts = run_path(torch, wrappers, spgemm_path, torch, sp,
                                  dev)
    log(f"spgemm path kernel launches: {spgemm_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    spgemm_kernels = ("spgemm_window", "spgemm_tiled_pairs",
                      "spgemm_tiled_stream")
    for name in spgemm_kernels:
        require(spgemm_counts[name] > 0,
                f"kernel {name} was not launched on the spgemm path")
    torch.cuda.reset_peak_memory_stats()
    un, un_counts = run_path(torch, wrappers, unstructured_path, torch, sp,
                             dev)
    log(f"unstructured path kernel launches: {un_counts}; peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes")
    un_kernels = ("segmented_row_sums", "shuffle_gather", "sort_blocks")
    for name in un_kernels:
        require(un_counts[name] > 0,
                f"kernel {name} was not launched on the unstructured path")
    launches = {**main_counts, **{k: solve_counts[k] for k in
                                  ("spmm_dia_mrhs", "cg_solve_dia")},
                **{k: spmm_counts[k] for k in spmm_kernels},
                **{k: spgemm_counts[k] for k in spgemm_kernels},
                **{k: un_counts[k] for k in un_kernels}}

    # Phase 25: timing, kernel against plain version, in turns; the
    # library call where one PyTorch call computes the same function.
    t_timing = time.perf_counter()
    dia, mrhs = state["dia"], solve["mrhs"]
    x, X = dia["x"], mrhs["X"]
    nnz = state["nnz"]
    A_csr = library_csr(torch, N, dev)
    spmv_lib = float(np.median(time_ms(torch, lambda: A_csr @ x)))
    mrhs_lib = float(np.median(time_ms(torch, lambda: A_csr @ X.T)))
    rows = []
    for dname, item in (("f32", 4), ("bf16", 2)):
        prep = dia[dname]
        ms, plain_ms = compare_times(
            torch, lambda: spmv_dia_stream(prep, x),
            lambda: spmv_dia_stream_reference(prep, x))
        b_ms, b_by = bound_ms(nnz * item + 8 * N, 2 * nnz)
        rows.append(dict(name="spmv_dia_stream", dtype=dname,
                         **KERNELS["spmv_dia_stream"],
                         launches=launches["spmv_dia_stream"],
                         max_abs_err=dia["err"][dname], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=spmv_lib))
    prep = dia["f32"]
    ms, plain_ms = compare_times(
        torch, lambda: spmv_dia_chain(prep, x, CHAIN_ITERS, CHAIN_SCALE),
        lambda: spmv_dia_chain_reference(prep, x, CHAIN_ITERS, CHAIN_SCALE))
    b_ms, b_by = bound_ms((CHAIN_ITERS * nnz * 4 + 8 * N) / CHAIN_ITERS,
                          2 * nnz)
    # Per iteration; the library yardstick is one SpMV, one iteration.
    rows.append(dict(name="spmv_dia_chain", dtype="f32",
                     **KERNELS["spmv_dia_chain"],
                     launches=launches["spmv_dia_chain"],
                     max_abs_err=state["chain_err"], ms=ms / CHAIN_ITERS,
                     plain_ms=plain_ms / CHAIN_ITERS, bound_ms=b_ms,
                     bound_by=b_by, library_ms=spmv_lib))
    for dname, item in (("f32", 4), ("bf16", 2)):
        prep = mrhs[dname]
        ms, plain_ms = compare_times(
            torch, lambda: spmm_dia_mrhs(prep, X),
            lambda: spmm_dia_mrhs_reference(prep, X))
        b_ms, b_by = bound_ms(nnz * item + 2 * RHS * N * 4, 2 * nnz * RHS)
        rows.append(dict(name="spmm_dia_mrhs", dtype=dname,
                         **KERNELS["spmm_dia_mrhs"],
                         launches=launches["spmm_dia_mrhs"],
                         max_abs_err=mrhs["err"][dname], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=mrhs_lib))
    prep_s, b = solve["spd"]["prep"], solve["cg"]["b"]
    cg_ms = per_iteration_ms(torch, {
        "plain": lambda it: cg_solve_dia_reference(prep_s, b, iters=it,
                                                   shift=SHIFT),
        "kernel": lambda it: cg_solve_dia(prep_s, b, iters=it, shift=SHIFT),
        "composed": lambda it: cg_solve(
            lambda v: best_spmv(prep_s, v) + SHIFT * v, b, iters=it)})
    # Per iteration: the diagonals once (b in and x out are per solve and
    # cancel in the difference); 2 flops per stored slot plus the shift.
    b_ms, b_by = bound_ms(nnz * 4, 2 * nnz + 2 * N)
    rows.append(dict(name="cg_solve_dia", dtype="f32",
                     **KERNELS["cg_solve_dia"],
                     launches=launches["cg_solve_dia"],
                     max_abs_err=solve["cg"]["err"], ms=cg_ms["kernel"],
                     plain_ms=cg_ms["plain"], bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))
    rows += spmm_timings(torch, spmm, launches)
    spgemm_rows, spgemm_ends = spgemm_timings(torch, spg, launches)
    rows += spgemm_rows
    un_rows, un_ends = unstructured_timings(torch, un, launches)
    rows += un_rows
    torch.cuda.synchronize()
    log(f"phase 25 timing ({time.perf_counter() - t_timing:.3f} s)")

    for row in rows:
        print(json.dumps({
            "timing": row["name"], "dtype": row["dtype"],
            "matrix": row.get("matrix", "banded"), "n": row.get("n", N),
            "nnz": row.get("nnz", nnz), "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "library_ms": row["library_ms"],
            "roofline_share": row["bound_ms"] / row["ms"],
            "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({
        "timing": "cg_solve over K1 (composed)", "n": N, "nnz": nnz,
        "ms_per_iteration": cg_ms["composed"],
        "k4_ms_per_iteration": cg_ms["kernel"], "device": card,
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"timing": "spgemm entry points, config 4",
                      **spgemm_ends, "device": card, "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"timing": "unstructured SpMV entry points, config 2c",
                      **un_ends, "device": card, "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
