#!/usr/bin/env python3
"""Drive the spsparse_torch main path and solve path once on one CUDA card
and check them.

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
11. Time every kernel against its plain version (CUDA events, in turns:
    plain, kernel, kernel, plain), and one PyTorch library call computing
    the same function where there is one (``torch.sparse_csr_tensor``
    products; none for K4, whose solve is no single library call).

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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on an H100 SXM for the work: the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_csr(torch, n, dev):
    """``torch.sparse_csr_tensor`` of the benchmark matrix ``B`` on the
    card: the library yardstick, timed here and used nowhere in the port."""
    Bs = scipy_banded(n).astype(np.float32)
    return torch.sparse_csr_tensor(
        torch.from_numpy(Bs.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(Bs.indices.astype(np.int64)).to(dev),
        torch.from_numpy(Bs.data).to(dev), size=(n, n),
        check_invariants=True)


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
                "cg_solve_dia": cg_solve_dia}
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
    launches = {**main_counts, **{k: solve_counts[k] for k in
                                  ("spmm_dia_mrhs", "cg_solve_dia")}}

    # Phase 11: timing, kernel against plain version, in turns; the
    # library call where one PyTorch call computes the same function.
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
    torch.cuda.synchronize()

    for row in rows:
        print(json.dumps({
            "timing": row["name"], "dtype": row["dtype"], "n": N,
            "nnz": nnz, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "library_ms": row["library_ms"],
            "roofline_share": row["bound_ms"] / row["ms"],
            "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({
        "timing": "cg_solve over K1 (composed)", "n": N, "nnz": nnz,
        "ms_per_iteration": cg_ms["composed"],
        "k4_ms_per_iteration": cg_ms["kernel"], "device": card,
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
