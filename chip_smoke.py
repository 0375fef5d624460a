#!/usr/bin/env python3
"""Drive the spsparse_torch main path, solve path, SpMM path, SpGEMM path,
unstructured SpMV path and core path once on one CUDA card and check them.

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
   kernel K1 against its plain PyTorch version on the card; a float64
   ``SparseDIA`` through ``best_spmv`` (plain PyTorch in float64, the JAX
   package's route) against scipy float64.
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
9. ``cg_solve_dia`` (K4, one cooperative launch a solve), 50 iterations,
   against its plain version, the composed ``cg_solve`` over K1 and a
   float64 scipy residual; ``b = 0`` gives ``x = 0`` and ``rs = 0``. Then
   S with bfloat16 diagonals, a symmetric 11-diagonal matrix of 4n rows
   built on the card (too large for the kernel's resident mode: the
   device-memory mode), offsets (-n/2, -1, 0, 1, n/2), n = 100 (below the
   grid of one CTA an SM) and n = 2**14, each against its plain version
   and a float64 residual (1e-4 of max|x|, 1e-4 of max|b|). On the card
   each also gives the same x and rs bit for bit on a second solve, and
   the launch geometry the kernel reports (``sps_dia_cg_geometry``) must
   equal the Python mirror's (``cg_geometry``) from the card's
   properties.
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
    version, against K5 and against the float64 scipy rows.
14. K7: ``spmm_tiled_onehot`` on ``prepare_tiled_rows`` of the same tiles,
    against its plain version and K6, and on the same layout with each
    tile's slots shuffled (no tile in row order); two one-hot-tier
    matrices through ``prepare_general`` (route ``one_hot``; 40-48 entries
    in the diagonal tile of each block row, and 8 tiles of 40-48 entries a
    block row, past one 256-slot piece) against scipy; bench config 3b's
    scattered matrix (route ``gather_ell``) against scipy. On all four K7
    layouts the kernel must equal a second call bit for bit.
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
    its plain version in both types, its dead slots exactly zero, and a
    second call bit for bit.
18. K9 and K13: ``spgemm_tiled(A, A, transpose_b=True, use_window=False)``
    (config 4's pair plan), ``C = A A^T``, ``best_spgemm(C, C)`` and
    ``coo_matrix_power(C, 3)`` (the routes of each product logged) against
    scipy; K9 and K13 on both pair plans, in float32 and bfloat16, against
    the plain version and each other; float32 K9 must equal K13 bit for
    bit, and two K9 and two K13 calls must agree bit for bit.
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
    shared-memory chunk), float32 keys (with ties, -0.0 and infinities) and
    ten arrays (keys through K12 with a position payload, then a gather);
    ``sort_blocks_stable`` packed and not. Keys exact, payloads exact when
    stable and otherwise as a multiset within each run of equal keys; on
    all six shapes, keys and payloads equal to a second call bit for bit;
    the chunk geometry the kernel reports equal to the host replay's.
The core path (``core_path``), the rest of ``core/`` at the main path's
width (the band ``B`` of phase 2: 2**20 rows, offsets -5..5, float32,
``default_rng(0)``, 11,534,306 entries, consolidated):

C1. Joins: the row-major keys of ``B`` and of the consolidated ``B^T``
    through ``join2`` (``n_match`` = nnz: the pattern is symmetric; the
    matched positions gather ``B[i, j]`` and ``B[j, i]``, 10**5 of them
    held against scipy), ``join3`` with the main diagonal of
    ``coo_diags`` (``n_match`` = n), and ``intersect_mask`` of 10**6
    random keys near the band against ``np.isin``.
C2. Algebra: ``coo_add(B, B^T, 0.5, 0.5)`` against phase 7's ``S``
    (indices exact, values rtol 1e-6); ``coo_add(tril(S), triu(S, 1))``
    equal to ``S``; ``row_sums(B)`` and ``col_sums(B)`` against K1's
    ``B 1`` and ``B^T 1`` (rtol 1e-5, atol 1e-5 of the max);
    ``scale_rows``/``scale_cols`` with phase 3's scale vectors, the
    stacking of ``B``'s two halves (``coo_slice``) and ``coo_kron`` of two
    512-row bands against scipy.
C3. Accumulators: ``scatter_to_dense`` of a 4096 x 4096 ``coo_slice`` of
    phase 2's doubled stream under ADD, and of the slice with each entry
    twice more at -3x under LEAVE_ALONE (first wins), REPLACE (last wins)
    and ADD, against numpy; ``scalar_sum(B)`` against a float64 host sum
    (rtol 1e-5); ``permute_output`` and ``project_output`` on a rank-3
    array of 10**6 entries.
C4. Reorder to K1: ``B`` scrambled by ``coo_permute`` with a permutation
    from ``default_rng(1)`` (bandwidth near n), ``rcm_permutation`` on the
    host (its time logged), ``coo_permute`` back (bandwidth b with
    ``2b + 1 <= MAX_DIAGS``), ``to_dia``, ``prepare_dia`` in float32 and
    bfloat16 and ``best_spmv`` (K1), against the plain K1 and the scipy
    float64 product of the scrambled matrix with x and y permuted.
C5. Interop: config 2c's matrix through ``to_scipy`` and ``from_scipy``;
    indices and values exact.

25. Time every kernel against its plain version (CUDA events, in turns:
    plain, kernel, kernel, plain), and one PyTorch library call computing
    the same function where there is one (``torch.sparse_csr_tensor``
    products; none for K4, whose solve is no single library call). K4 per
    iteration (solves of 72 and 8 iterations) on S in float32 and bfloat16,
    in the device-memory mode at 4n rows and at n = 2**14, where the two
    grid-wide exchanges of an iteration set its time. K7 is
    timed on the four layouts of phase 14: config 3's tiles, sorted and
    shuffled, and the two one_hot route layouts, the traffic
    ``prepare_general`` sends it. K8, K9 and K13 at config
    4, with cuSPARSE's CSR x CSR SpGEMM as the yardstick; ``spgemm_tiled``
    end to end, the ESC ``spgemm_aat`` and the planned apply. K10 and K11
    at config 2c against cuSPARSE's CSR SpMV, with ``spmv_shuffle`` and
    ``spmv_csr_segsum`` end to end in nnz/s; K12 against ``torch.sort``
    carrying the payload through ``gather``. K11 is also timed against its
    earlier scatter design, kept in the kernel library as a yardstick and
    called only here and in ``tests_gpu/``, and K13 against K9 in turns. K10's library call is ``torch.segment_reduce`` of the
    same products by the row pointer (cuSPARSE's whole CSR SpMV beside
    it). The K7 and K12 rows carry ptxas's registers and spill bytes for
    their kernels. K8, K9 and K13 carry two bounds: the dense one
    (every tile product whole) and the occupied one (``bound_ms``: only
    the (warp block, k-chunk) units whose two sides hold a nonzero, which
    is the work the kernels cannot skip).

The launch counters of the kernel wrappers are reset before each path and
read after it; a kernel of the path launched no time there fails the run.
The last lines are a JSON line per timing, the ``{"kernels": [...]}`` line,
the card's name and power limit from nvidia-smi, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
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
CG_TINY_N = 100      # K4 below the grid (264 CTAs on an H100)
CG_SMALL_N = 1 << 14  # K4 where the grid barriers dominate
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
CORE_KRON_N = 512    # rows of each band in C2's coo_kron
CORE_SLICE_M = 4096  # C3's square slice of phase 2's stream
CORE_R3_NNZ = 10 ** 6  # entries of C3's rank-3 array
CORE_QUERIES = 10 ** 6  # random keys C1 probes with intersect_mask
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
    # A float64 operand takes the plain float64 route (K1 never took
    # float64): float64 out, within 1e-12 of scipy float64 (the same
    # products summed in another order).
    dia64 = sp.SparseDIA(data=dia.data.double(), offsets=dia.offsets,
                         shape=dia.shape)
    y64 = best_spmv(dia64, x.double())
    sync(torch, dev)
    require(y64.dtype == torch.float64, f"float64 DIA SpMV gave {y64.dtype}")
    ok, out["err"]["f64"] = close(
        y64.cpu().numpy(), scipy_banded(n) @ x.cpu().numpy().astype(
            np.float64), 1e-12, 1e-12)
    require(ok, f"float64 DIA best_spmv off scipy ({out['err']['f64']})")
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


def spd_coo(sp, dev, n):
    """Phase 7's ``S = (B + B^T)/2`` through the builder, consolidated."""
    r, c, v = banded_entries(n)
    half = (np.float32(0.5) * v).astype(np.float32)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([r, c], axis=1), half)
    b.add_many(np.stack([c, r], axis=1), half)
    return sp.consolidate(b.build(device=dev))


def phase_spd(torch, sp, dev, n):
    """Phase 7: S = (B + B^T)/2 through the builder, consolidate, to_dia."""
    from spsparse_torch.ops import prepare_dia

    S = sp.to_dia(spd_coo(sp, dev, n))
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


def spd_dia(torch, dev, n, offsets, seed):
    """A symmetric DIA built on ``dev`` (float32 diagonals from a seeded
    generator): off-diagonals uniform(-0.5, 0.5), ``A[i, i+o] = A[i+o, i]``,
    the main diagonal uniform(0, 1); with 10 off-diagonals at most,
    ``A + SHIFT I`` is SPD by Gershgorin."""
    from spsparse_torch.ops.dia_stream import PreparedDIA

    g = torch.Generator(device=dev).manual_seed(seed)
    offsets = tuple(offsets)
    data = torch.zeros((len(offsets), n), device=dev)
    for k, o in enumerate(offsets):
        if 0 < o < n:
            v = torch.rand(n - o, generator=g, device=dev) - 0.5
            data[k, :n - o] = v
            data[offsets.index(-o), o:] = v
    if 0 in offsets:
        data[offsets.index(0)] = torch.rand(n, generator=g, device=dev)
    return PreparedDIA(data=data, offsets=offsets, shape=(n, n))


def dia_residual_inf(torch, prep, x, b) -> float:
    """``max|(A + SHIFT I) x - b|`` in float64 on the operand's device, for
    the diagonals as stored (bfloat16 ones as rounded: the operator the
    kernel solves)."""
    n = prep.shape[0]
    data, x = prep.data.double(), x.double()
    r = SHIFT * x - b.double()
    for k, o in enumerate(prep.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        if hi > lo:
            r[lo:hi] += data[k, lo:hi] * x[lo + o:hi + o]
    return float(r.abs().max())


def cg_geometry_pair(torch, n, dtype):
    """K4's launch geometry for ``n`` rows as the kernel reports it, and as
    the Python mirror computes it from the card's properties."""
    from spsparse_torch.ops.dia_cg import cg_geometry, cg_kernel_geometry

    props = torch.cuda.get_device_properties(0)
    mirror = cg_geometry(
        n, sms=props.multi_processor_count,
        smem_per_sm=props.shared_memory_per_multiprocessor,
        smem_per_block=props.shared_memory_per_block_optin)
    return cg_kernel_geometry(n, dtype), mirror


def check_cg_case(torch, dev, what, prep, b, *, resident=None):
    """K4 on ``prep`` and ``b`` against its plain version (1e-4 of max|x|)
    and a float64 residual (1e-4 of max|b|); on the card, a second solve
    equal bit for bit and the geometry the kernel reports equal to the
    mirror's (and its mode, where ``resident`` names it)."""
    from spsparse_torch.ops import cg_solve_dia, cg_solve_dia_reference

    n = prep.shape[0]
    x, rs = cg_solve_dia(prep, b, iters=CG_ITERS, shift=SHIFT)
    x_ref, _ = cg_solve_dia_reference(prep, b, iters=CG_ITERS, shift=SHIFT)
    sync(torch, dev)
    require(tuple(x.shape) == (n,) and bool(torch.isfinite(x).all())
            and rs.shape == () and rs.device == x.device,
            f"K4 {what}: not a finite (n,) x with a 0-d device rs")
    scale = float(x_ref.abs().max())
    err = float((x - x_ref).abs().max())
    require(err <= 1e-4 * scale, f"K4 {what} off its plain version "
            f"(max abs err {err}, max|x| {scale})")
    res = dia_residual_inf(torch, prep, x, b)
    bound = 1e-4 * float(b.abs().max())
    require(res <= bound, f"K4 {what}: residual {res} above {bound}")
    out = {"x": x, "err": err, "residual": res, "rs": float(rs)}
    if dev != "cpu":
        x2, rs2 = cg_solve_dia(prep, b, iters=CG_ITERS, shift=SHIFT)
        sync(torch, dev)
        require(torch.equal(x, x2) and torch.equal(rs, rs2),
                f"K4 {what}: two solves differ in some bit")
        kernel_geo, mirror_geo = cg_geometry_pair(torch, n, prep.data.dtype)
        require(kernel_geo == mirror_geo, f"K4 {what}: the kernel's geometry "
                f"{kernel_geo} is not the mirror's {mirror_geo}")
        require(resident is None or kernel_geo.resident == resident,
                f"K4 {what}: geometry {kernel_geo}, not the expected mode")
        out["geometry"] = tuple(kernel_geo)
    return out


def phase_cg(torch, dev, spd):
    """Phase 9: K4 on S against its plain version, the composed solve over
    K1 and a float64 residual; b = 0; then S with bfloat16 diagonals, a
    matrix of 4n rows (the device-memory mode on an H100), offsets of
    +-n/2, n = 100 (below the grid) and n = 2^14, each against its plain
    version and a float64 residual, bit for bit from one solve to the next,
    with the geometry the kernel reports equal to the mirror's."""
    from spsparse_torch.ops import best_spmv, cg_solve_dia, prepare_dia
    from spsparse_torch.solvers import cg_solve

    prep = spd["prep"]
    n = prep.shape[0]
    b = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, n)
                         .astype(np.float32)).to(dev)
    main = check_cg_case(torch, dev, "S", prep, b, resident=True)
    x_cmp, _ = cg_solve(lambda v: best_spmv(prep, v) + SHIFT * v, b,
                        iters=CG_ITERS)
    sync(torch, dev)
    xn = main["x"].cpu().numpy()
    # 50 iterations compound f32 rounding (fused vs separate multiply-adds,
    # block-ordered vs library-ordered dot products): 1e-4 of max|x|, as K2.
    ok, err_cmp = close(xn, x_cmp.cpu().numpy(), 0.0, 1e-4)
    require(ok, f"K4 off the composed cg_solve over K1 ({err_cmp})")
    bn = b.cpu().numpy()
    # The float64 residual of a converged float32 solve is set by the f32
    # rounding of x and of S (about 1e-6 here); 1e-4 of max|b| bounds it
    # with margin and still fails an unconverged or wrong solve.
    res = float(residual_inf(spd["S_host"], xn, bn))
    bound = 1e-4 * float(np.abs(bn).max())
    require(res <= bound, f"K4 residual {res} above scipy's {bound}")
    x0, rs0 = cg_solve_dia(prep, torch.zeros_like(b), iters=5, shift=SHIFT)
    sync(torch, dev)
    require(not bool(x0.any()) and float(rs0) == 0.0,
            "K4 with b = 0 did not give x = 0 and rs = 0")

    def rhs(m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand(m, generator=g, device=dev) * 2 - 1

    big, small = 4 * n, CG_SMALL_N
    band = tuple(range(-BAND, BAND + 1))
    # name: (operand, b, the mode the geometry must report, timed in
    # phase 25)
    cases = {
        "S bf16": (prepare_dia(spd["S"], dtype=torch.bfloat16), b, True,
                   True),
        f"device-memory mode, n = {big}": (
            spd_dia(torch, dev, big, band, 5), rhs(big, 6), False, True),
        "offsets -n/2, -1, 0, 1, n/2": (
            spd_dia(torch, dev, n, (-n // 2, -1, 0, 1, n // 2), 7),
            rhs(n, 8), None, False),
        f"n = {CG_TINY_N}, below the grid": (
            spd_dia(torch, dev, CG_TINY_N, (-3, -1, 0, 1, 3), 9),
            rhs(CG_TINY_N, 10), True, False),
        f"n = {small}": (spd_dia(torch, dev, small, band, 11),
                         rhs(small, 12), True, True),
    }
    checked = {what: {**check_cg_case(torch, dev, what, p, bb, resident=mode),
                      "prep": p, "b": bb, "timed": timed}
               for what, (p, bb, mode, timed) in cases.items()}
    return {"b": b, "x": main["x"], "err": main["err"],
            "err_composed": err_cmp, "residual": res, "rs": main["rs"],
            "geometry": main.get("geometry"), "cases": checked}


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
    cases = {what: {k: c[k] for k in ("err", "residual", "rs", "geometry")
                    if k in c} for what, c in cg["cases"].items()}
    log(f"phase 9 K4 CG ({CG_ITERS} iterations, shift {SHIFT}): max abs err "
        f"{cg['err']!r} vs plain, {cg['err_composed']!r} vs composed; "
        f"residual inf-norm {cg['residual']!r}; final rs {cg['rs']!r}; "
        f"(grid, CTAs an SM, rows a CTA, resident, smem, scratch) "
        f"{cg['geometry']}; cases {cases} "
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
    out = {"err": {}, "sampled_err": {}}
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
        out["sampled_err"][name] = check_sampled(
            Y, win["sampled"], win["sampled_ref"], f"K6 {name}", bf16)
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


def onehot_tiles_entries(m: int, tiles: int = 8, seed: int = 7):
    """A one-hot-tier matrix of several live tiles a block row: ``tiles``
    distinct random block columns a block row, 40-48 entries at random
    (row, column) offsets in each (duplicates summed), values
    uniform(-1, 1); rt * cap > 256 slots a block row, so that K7 takes a
    block row in several pieces."""
    rng = np.random.default_rng(seed)
    nbr = -(-m // 128)
    nbc = nbr
    bc = np.argsort(rng.random((nbr, nbc)), axis=1)[:, :tiles]
    k = rng.integers(40, 49, (nbr, tiles))
    tile_of = np.repeat(np.arange(nbr * tiles), k.ravel())
    br, tc = tile_of // tiles, bc.ravel()[tile_of]
    r = br * 128 + rng.integers(0, 128, tile_of.size)
    c = tc * 128 + rng.integers(0, 128, tile_of.size)
    keep = (r < m) & (c < m)
    r, c = r[keep], c[keep]
    return r, c, rng.uniform(-1, 1, r.size).astype(np.float32)


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


def unsorted_tiles(torch, prep, seed: int = 9):
    """``prep`` (a ``PreparedTiledRows``) with each tile's slots (row,
    column and value together) in a random order: the same product, with
    no tile's entries in row order."""
    import dataclasses

    dev = prep.vals.device
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.rand(tuple(prep.vals.shape), generator=g,
                      device=dev).argsort(dim=-1)
    return dataclasses.replace(prep, rows=prep.rows.gather(2, perm),
                               cols=prep.cols.gather(2, perm),
                               vals=prep.vals.gather(2, perm))


def phase_onehot(torch, sp, dev, reg, dense, m_onehot, m_3b):
    """Phase 14: K7 on config 3's tiles, as built (each tile's entries in
    row order) and with each tile's slots shuffled; the one_hot and
    gather_ell routes of prepare_general."""
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
    # The card's K7 against a second call, bit for bit (on the CPU both
    # sides would be the plain version).
    on_card = dev != "cpu"
    bitwise = {}
    if on_card:
        bitwise["config 3"] = bitwise_equal(torch, Y,
                                            spmm_tiled_onehot(prep, X))
        require(bitwise["config 3"], "K7 at config 3 differs from a second "
                "call, bit for bit")
    unsorted = unsorted_tiles(torch, prep)
    Yu = spmm_tiled_onehot(unsorted, X)
    sync(torch, dev)
    err = max(err, check_pair(Yu, Y, "K7 on unsorted tiles vs sorted",
                              False))
    if on_card:
        bitwise["config 3, rows unsorted"] = bitwise_equal(
            torch, Yu, spmm_tiled_onehot(unsorted, X))
        require(bitwise["config 3, rows unsorted"], "K7 on config 3's "
                "unsorted tiles differs from a second call, bit for bit")

    route = {}
    for what, entries in (("one_hot route", onehot_entries(m_onehot)),
                          ("one_hot route, 8 tiles a block row",
                           onehot_tiles_entries(m_onehot))):
        route[what] = onehot_route(torch, sp, dev, m_onehot, entries, what)
        if on_card:
            bitwise[what] = route[what]["bitwise"]
    require(route["one_hot route, 8 tiles a block row"]["slots"] > 256,
            "the several-tile one_hot layout fits one 256-slot piece")

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
    return {"prep": prep, "unsorted": unsorted, "err": err,
            "err_gather_ell": err_3b,
            "bitwise_repeat": bitwise, "ell_kmax": pg3.prep.cols.shape[1],
            "route": route}


def onehot_route(torch, sp, dev, m, entries, what):
    """``prepare_general`` of a one-hot-tier matrix (it must route to K7)
    and its product: against the plain version and scipy, and on the card
    against a second call, bit for bit."""
    from spsparse_torch.ops import (prepare_general, spmm_general,
                                    spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    r, c, v = entries
    pg = prepare_general(build_coo(sp, dev, (m, m), r, c, v))
    require(pg.kernel == "one_hot", f"the {what} matrix routed to {pg.kernel}")
    Xo = np.random.default_rng(6).uniform(-1, 1, (m, SPMM_N)).astype(
        np.float32)
    Xo_dev = torch.from_numpy(Xo).to(dev)
    Xo_p = Xo_dev if pg.order is None else Xo_dev[pg.order]
    Yo = spmm_general(pg, Xo_dev)
    sync(torch, dev)
    err_k = check_pair(Yo, spmm_tiled_onehot_reference(pg.prep, Xo_p),
                       f"K7 ({what}) vs plain", False)
    bitwise = None
    if dev != "cpu":
        Yk = spmm_tiled_onehot(pg.prep, Xo_p)
        bitwise = bitwise_equal(torch, Yk, spmm_tiled_onehot(pg.prep, Xo_p))
        require(bitwise, f"K7 on the {what} differs from a second call, bit "
                "for bit")
    ok, err_o = close(Yo.cpu().numpy(), csr_host(r, c, v, (m, m)) @ Xo,
                      1e-5, 1e-5)
    require(ok, f"{what} off scipy (max abs err {err_o})")
    return {"prep": pg.prep, "X": Xo_dev, "Xp": Xo_p, "entries": (r, c, v),
            "m": m, "err": err_k, "err_scipy": err_o, "bitwise": bitwise,
            "block_rows": pg.prep.nbr,
            "slots": pg.prep.tiles_per_row * pg.prep.tile_cap}


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
    log(f"phase 13 K6: max abs err {dense['err']} vs plain and K5, "
        f"{dense['sampled_err']} vs float64 rows "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    onehot = phase_onehot(torch, sp, dev, reg, dense, m_onehot, m_3b)
    routes = {what: {k: rt[k] for k in ("block_rows", "slots", "err_scipy")}
              for what, rt in onehot["route"].items()}
    log(f"phase 14 K7: max abs err {onehot['err']!r}; bit for bit with a "
        f"second call {onehot['bitwise_repeat']}; one_hot "
        f"routes (block rows, slots a block row, err vs scipy) {routes}; "
        f"gather_ell route (Kmax {onehot['ell_kmax']}) err "
        f"{onehot['err_gather_ell']!r} ({time.perf_counter() - t0:.3f} s)")
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
        require(torch.equal(spgemm_window(plan, prep.blocks), band),
                f"K8 {name}: two calls differ")
        out["band"][name], out["plan"][name] = band, plan
        out["prep"][name] = prep
    return out


def phase_pairs(torch, sp, dev, cfg, k8):
    """Phase 18: K9 through spgemm_tiled (config 4's pair plan),
    best_spgemm(C, C) and coo_matrix_power(C, 3) against scipy; K9 and K13
    on both pair plans, in both types, against the plain version and each
    other (float32 K13 equal to K9 bit for bit)."""
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

    tc = {"f32": densify_tiled(sp.to_tiled(C)),
          "bf16": densify_tiled(sp.to_tiled(C), dtype=torch.bfloat16)}
    ta = {"f32": densify_tiled(cfg["tl"]),
          "bf16": densify_tiled(cfg["tl"], dtype=torch.bfloat16)}
    plans = {"A A^T": plan_tiled_spgemm(ta["f32"], ta["f32"],
                                        transpose_b=True),
             "C C": plan_tiled_spgemm(tc["f32"], tc["f32"])}
    runs = [("A A^T", "f32", ta["f32"], cfg["AAT"]),
            ("A A^T", "bf16", ta["bf16"], None),
            ("C C", "f32", tc["f32"], CC_ref),
            ("C C", "bf16", tc["bf16"], None)]
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
        # float32 K13 sums each element in K9's order: equal bit for bit.
        require(bf16 or out["bitwise_k9_k13"][what],
                f"K13 {what} differs from K9 in some bit")
        require(torch.equal(spgemm_tiled_stream(X, X, plan).blocks,
                            k13.blocks), f"K13 {what}: two calls differ")
        require(torch.equal(spgemm_tiled_pairs(X, X, plan).blocks,
                            k9.blocks), f"K9 {what}: two calls differ")
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
        f"{k8['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
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


def float_keys(rng, shape):
    """float32 keys with ties, both zeros, infinities and subnormals."""
    pool = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.5, -1.5],
                    np.float32)
    k = rng.uniform(-4, 4, shape).astype(np.float32).round(1)
    pick = rng.random(shape) < 0.1
    k[pick] = pool[rng.integers(0, pool.size, int(pick.sum()))]
    return k


def phase_sort(torch, dev, nblk):
    """Phase 24: K12 on (nblk, 64, 128) int32 keys with a float32 payload,
    two keys, sort_blocks_stable packed and not (exact), R = 1,
    (8, 256, 128) with three arrays (past the shared-memory chunk), float32
    keys and ten arrays."""
    from spsparse_torch.ops import (sort_blocks, sort_blocks_reference,
                                    sort_blocks_stable)
    from spsparse_torch.ops.block_sort import MAX_ARRAYS, block_sort_geometry

    rng = np.random.default_rng(12)

    def t(a):
        return torch.from_numpy(a).to(dev)

    def ints(hi, shape):
        return t(rng.integers(0, hi, shape).astype(np.int32))

    def floats(shape):
        return t(rng.uniform(-1, 1, shape).astype(np.float32))

    main = (ints(1 << 30, (nblk, 64, 128)), floats((nblk, 64, 128)))
    nb8 = max(nblk // 8, 1)
    cases = [("(nblk, 64, 128) key + payload", main, 1),
             ("two keys", (ints(8, (nblk // 4, 32, 128)),
                           ints(1 << 20, (nblk // 4, 32, 128)),
                           floats((nblk // 4, 32, 128))), 2),
             ("R = 1", (ints(1 << 12, (nblk, 1, 128)),
                        floats((nblk, 1, 128))), 1),
             ("(8, 256, 128) three arrays", (ints(64, (8, 256, 128)),
                                             ints(1 << 30, (8, 256, 128)),
                                             floats((8, 256, 128))), 2),
             ("float32 keys", (t(float_keys(rng, (nblk // 4, 64, 128))),
                               floats((nblk // 4, 64, 128))), 1),
             ("ten arrays", (ints(16, (nb8, 16, 128)),
                             t(float_keys(rng, (nb8, 16, 128))))
              + tuple(floats((nb8, 16, 128)) for _ in range(8)), 2)]
    bitwise, geometry = {}, {}
    for what, arrays, nk in cases:
        dirty_cache(torch, dev, sum(a.numel() for a in arrays) * 4)
        got = sort_blocks(arrays, num_keys=nk)
        ref = sort_blocks_reference(arrays, num_keys=nk)
        sync(torch, dev)
        same_up_to_ties(torch, got, ref, nk, what)
        if dev != "cpu":
            bitwise[what] = bitwise_equal(
                torch, got, sort_blocks(arrays, num_keys=nk))
            require(bitwise[what], f"K12 {what}: differs from a second call "
                    "bit for bit (keys or payloads)")
            # The arrays K12 sorts: these, or the keys and a position.
            na = (len(arrays) if len(arrays) <= MAX_ARRAYS and all(
                a.dtype == torch.int32 for a in arrays[:nk]) else nk + 1)
            n = arrays[0][0].numel()
            geometry[what] = k12_geometry(n, na, nk)
            require(geometry[what] == block_sort_geometry(n, na, nk),
                    f"K12 {what}: the kernel's chunk {geometry[what]} is not "
                    "block_sort_geometry's")
    kk, pay = ints(8, (nblk // 4, 8, 128)), floats((nblk // 4, 8, 128))
    ref = sort_blocks_reference((kk, pay))
    for bound in (8, None):
        got = sort_blocks_stable(kk, (pay,), key_bound=bound)
        sync(torch, dev)
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"K12 sort_blocks_stable (key_bound {bound}) is not the "
                "stable sort")
    return {"main": main, "cases": [c[0] for c in cases],
            "bitwise_repeat": bitwise, "geometry": geometry}


def unstructured_path(torch, sp, dev, n=N, heavy_n=HEAVY_N,
                      sort_nblk=SORT_NBLK) -> dict:
    """Phases 21-24 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    c2 = phase_2c(torch, sp, dev, n)
    p = c2["prep"]
    slot_bytes = sum(t.numel() * t.element_size()
                     for t in (p.ell_cols, p.ell_vals))
    log(f"phase 21 config 2c: {c2['nnz']} entries, B {p.n_batches}, n_vrows "
        f"{p.n_vrows}, fillers {p.filler_dest.shape[0]}, gather_fill "
        f"{c2['fill']!r}; slot-order arrays {slot_bytes} bytes; "
        f"prepare_shuffle_spmv {c2['prepare_s']!r} s "
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
        f"payloads by runs; bit for bit with a second call "
        f"{srt['bitwise_repeat']}; (C, E, threads) as the kernel reports "
        f"them, equal to block_sort_geometry's {srt['geometry']} "
        f"({time.perf_counter() - t0:.3f} s)")
    return {"c2": c2, "shuffle": sh, "segsum": seg, "sort": srt}


def band_coo(sp, dev, n):
    """The benchmark's banded matrix ``B`` through ``CooBuilder``,
    consolidated (row-major, each entry once)."""
    r, c, v = banded_entries(n)
    return sp.consolidate(build_coo(sp, dev, (n, n), r, c, v))


def same_as_scipy(torch, sp, got, ref, what: str, rtol: float = 0.0):
    """``got`` (consolidated on the card) against a scipy matrix: the same
    rows, columns and count exactly; values exactly, or within ``rtol``."""
    c = sp.consolidate(got)
    ref = ref.tocsr()
    ref.sum_duplicates()
    require(c.shape == ref.shape and c.nnz == ref.nnz,
            f"{what}: shape {c.shape} nnz {c.nnz} vs scipy {ref.shape} "
            f"{ref.nnz}")
    idx = c.indices[: c.nnz].cpu().numpy()
    require(np.array_equal(np.bincount(idx[:, 0], minlength=c.shape[0]),
                           np.diff(ref.indptr))
            and np.array_equal(idx[:, 1], ref.indices),
            f"{what}: structure differs from scipy")
    vals = c.vals[: c.nnz].cpu().numpy().astype(np.float64)
    if rtol:
        ok, err = close(vals, ref.data, rtol, 0.0)
        require(ok, f"{what}: values off scipy (max abs err {err})")
    else:
        require(np.array_equal(vals, ref.data), f"{what}: values differ")


def phase_joins(torch, sp, dev, B, n_query: int):
    """Phase C1: join2 / join3 / intersect_mask on the band's keys."""
    n, nnz = B.shape[0], B.nnz
    Bt = sp.consolidate(B.T)
    sent = n * n

    def keys(a, m):
        return a.indices[:m, 0].long() * n + a.indices[:m, 1].long()

    kB, kT = keys(B, nnz), keys(Bt, nnz)
    j2 = sp.join2(kB, nnz, kT, nnz, sentinel=sent)
    require(j2.n_match == nnz, f"join2 n_match {j2.n_match} != nnz {nnz}")
    p1, p2 = j2.pos[0].long(), j2.pos[1].long()
    require(bool(torch.equal(kB[p1], kT[p2])), "join2 matched keys differ")
    r, c, v = banded_entries(n)
    host = csr_host(r, c, v, (n, n))
    pick = torch.from_numpy(np.random.default_rng(3).choice(
        nnz, min(100_000, nnz), replace=False)).to(dev)
    ij = B.indices[p1[pick]].long().cpu().numpy()
    want_ij = np.asarray(host[ij[:, 0], ij[:, 1]]).ravel()
    want_ji = np.asarray(host[ij[:, 1], ij[:, 0]]).ravel()
    require(np.array_equal(B.vals[p1[pick]].cpu().numpy(), want_ij)
            and np.array_equal(Bt.vals[p2[pick]].cpu().numpy(), want_ji),
            "join2 positions do not gather B[i, j] and B[j, i]")
    D = sp.coo_diags([np.ones(n)], [0], (n, n), device=dev)
    j3 = sp.join3(kB, nnz, kT, nnz, keys(D, n), n, sentinel=sent)
    require(j3.n_match == n, f"join3 with the diagonal: n_match {j3.n_match}")
    rng = np.random.default_rng(4)
    qr = rng.integers(0, n, n_query)
    qc = qr + rng.integers(-2 * BAND, 2 * BAND + 1, n_query)
    ok = (qc >= 0) & (qc < n)
    q = np.unique(qr[ok] * n + qc[ok])
    match, pos = sp.core.intersect_mask(torch.from_numpy(q).to(dev), q.size,
                                        kB, nnz, sent)
    kh = kB.cpu().numpy()
    want = np.isin(q, kh)
    m_host = match.cpu().numpy()
    require(np.array_equal(m_host, want), "intersect_mask differs from isin")
    require(np.array_equal(kh[pos.cpu().numpy()[m_host]], q[m_host]),
            "intersect_mask positions do not hold the keys")
    return {"Bt": Bt, "host": host, "n_match": j2.n_match,
            "n_query": int(q.size), "n_found": int(want.sum())}


def phase_algebra(torch, sp, dev, B, Bt, host, kron_n: int):
    """Phase C2: coo_add, tril/triu, row/col sums against K1, scaling,
    stacking and kron, each against its reference."""
    import scipy.sparse as ssp
    from spsparse_torch.ops import best_spmv, prepare_dia

    n, nnz = B.shape[0], B.nnz
    S = sp.coo_add(B, B.T, alpha=0.5, beta=0.5)
    S7 = spd_coo(sp, dev, n)
    m = S.nnz
    require(m == S7.nnz and bool(torch.equal(S.indices[:m], S7.indices[:m])),
            "coo_add(B, B^T)/2 indices differ from phase 7's S")
    ok, err_s = close(S.vals[:m].cpu().numpy(), S7.vals[:m].cpu().numpy(),
                      1e-6, 0.0)
    require(ok, f"coo_add(B, B^T)/2 values off phase 7's S ({err_s})")
    T = sp.coo_add(sp.coo_tril(S), sp.coo_triu(S, 1))
    require(T.nnz == m and bool(torch.equal(T.indices[:m], S.indices[:m]))
            and bool(torch.equal(T.vals[:m], S.vals[:m])),
            "coo_add(tril(S), triu(S, 1)) is not S")
    ones = torch.ones(n, device=dev)
    err = {"coo_add": err_s}
    for what, sums, op in (("row_sums", sp.row_sums(B), B),
                           ("col_sums", sp.col_sums(B), Bt)):
        y = best_spmv(prepare_dia(sp.to_dia(op)), ones)
        ok, err[what] = close(sums.cpu().numpy(), y.cpu().numpy(), 1e-5,
                              1e-5)
        require(ok, f"{what} off K1 (max abs err {err[what]})")
    rng = np.random.default_rng(2)       # phase 3's scale vectors si, sj
    si, sj = (rng.uniform(0.5, 1.5, n).astype(np.float32) for _ in range(2))
    scaled = sp.scale_cols(sp.scale_rows(B, torch.from_numpy(si).to(dev)),
                           torch.from_numpy(sj).to(dev))
    ref = (ssp.diags(si.astype(np.float64)) @ host
           @ ssp.diags(sj.astype(np.float64)))
    same_as_scipy(torch, sp, scaled, ref, "scale_rows/scale_cols", 1e-6)
    h = n // 2
    top = sp.coo_slice(B, (0, 0), (h, n))
    bot = sp.coo_slice(B, (h, 0), (n, n))
    ht, hb = host[:h], host[h:]
    for what, got, want in (
            ("coo_hstack", sp.coo_hstack(top, bot), ssp.hstack([ht, hb])),
            ("coo_vstack", sp.coo_vstack(top, bot), ssp.vstack([ht, hb])),
            ("coo_block_diag", sp.coo_block_diag(top, bot),
             ssp.block_diag([ht, hb]))):
        same_as_scipy(torch, sp, got, want, what)
    small = band_coo(sp, dev, kron_n)
    r, c, v = banded_entries(kron_n)
    hs = csr_host(r, c, v, (kron_n, kron_n))
    K = sp.coo_kron(small, small)
    same_as_scipy(torch, sp, K, ssp.kron(hs, hs, format="csr"), "coo_kron",
                  1e-6)
    return {"S_nnz": m, "err": err, "kron_nnz": K.nnz}


def phase_accum(torch, sp, dev, B, n, m: int, r3_nnz: int):
    """Phase C3: scatter_to_dense on a slice of phase 2's doubled stream,
    scalar_sum, and permute/project on a rank-3 array."""
    r, c, v = banded_entries(n)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    idx = np.stack([r, c], axis=1)
    b.add_many(idx, v)
    b.add_many(idx, v)
    sl = sp.coo_slice(b.build(device=dev), (0, 0), (m, m))
    inside = (r < m) & (c < m)
    require(sl.nnz == 2 * int(inside.sum()), f"slice nnz {sl.nnz}")
    dense = np.zeros((m, m), np.float32)
    dense[r[inside], c[inside]] = v[inside]
    add = sp.scatter_to_dense(sl)
    require(np.array_equal(add.cpu().numpy(), 2 * dense),
            "scatter_to_dense ADD is not the doubled entries")
    # Each entry twice more at -3x: first wins v, last wins -3v.
    sl = sl.compact()
    four = sp.coo_concat(sl, sp.coo_scale(sl, -3.0))
    P = sp.DuplicatePolicy
    first = sp.scatter_to_dense(four, duplicate_policy=P.LEAVE_ALONE)
    last = sp.scatter_to_dense(four, duplicate_policy=P.REPLACE)
    total = sp.scatter_to_dense(four, duplicate_policy=P.ADD)
    require(np.array_equal(first.cpu().numpy(), dense),
            "scatter_to_dense LEAVE_ALONE is not first-wins")
    require(np.array_equal(last.cpu().numpy(), np.float32(-3) * dense),
            "scatter_to_dense REPLACE is not last-wins")
    ok, err_add = close(total.cpu().numpy(), -4.0 * dense.astype(np.float64),
                        1e-6, 0.0)
    require(ok, f"scatter_to_dense ADD of four copies ({err_add})")
    got = float(sp.scalar_sum(B))
    want = float(np.sum(v.astype(np.float64)))
    require(abs(got - want) <= 1e-5 * abs(want),
            f"scalar_sum {got!r} vs float64 {want!r}")
    rng = np.random.default_rng(6)
    shape = (128, 256, 64)
    i3 = np.stack([rng.integers(0, s, r3_nnz) for s in shape], 1)
    v3 = rng.uniform(-1, 1, r3_nnz).astype(np.float32)
    b3 = sp.CooBuilder(shape, dtype=np.float32)
    b3.add_many(i3, v3)
    a3 = b3.build(device=dev)
    pm = sp.permute_output(a3, (2, 0, 1))
    require(pm.shape == (64, 128, 256) and np.array_equal(
        pm.indices[:r3_nnz].cpu().numpy(), i3[:, [2, 0, 1]])
        and np.array_equal(pm.vals[:r3_nnz].cpu().numpy(), v3),
        "permute_output differs")
    pr = sp.consolidate(sp.project_output(a3, (0, 2)))
    want2 = np.zeros((128, 64))
    np.add.at(want2, (i3[:, 0], i3[:, 2]), v3.astype(np.float64))
    ok, err_pr = close(pr.to_dense().cpu().numpy(), want2, 1e-5, 1e-5)
    require(ok, f"project_output + consolidate ({err_pr})")
    return {"slice_nnz": sl.nnz, "scalar_sum": got, "scalar_sum_f64": want,
            "err_add": err_add, "err_project": err_pr}


def phase_reorder(torch, sp, dev, B):
    """Phase C4: scramble, RCM on the host, permute back, to_dia, K1."""
    from spsparse_torch.ops import (best_spmv, prepare_dia,
                                    spmv_dia_stream_reference)
    from spsparse_torch.ops.dia_stream import MAX_DIAGS

    n = B.shape[0]
    scramble = np.random.default_rng(1).permutation(n)
    Bs = sp.coo_permute(B, torch.from_numpy(scramble).to(dev))
    bw_scrambled = sp.bandwidth(Bs)
    require(bw_scrambled > 0.99 * n,
            f"scrambled bandwidth {bw_scrambled} is not near n = {n}")
    sync(torch, dev)
    t0 = time.perf_counter()
    perm = sp.rcm_permutation(Bs)
    rcm_s = time.perf_counter() - t0
    R = sp.coo_permute(Bs, torch.from_numpy(perm).to(dev))
    bw = sp.bandwidth(R)
    require(2 * bw + 1 <= MAX_DIAGS,
            f"RCM bandwidth {bw}: {2 * bw + 1} diagonals > {MAX_DIAGS}")
    dia = sp.to_dia(R)
    idx = Bs.indices[: Bs.nnz].cpu().numpy()
    vals = Bs.vals[: Bs.nnz].cpu()
    x_s = np.random.default_rng(5).uniform(-1, 1, n).astype(np.float32)
    x = torch.from_numpy(x_s[perm]).to(dev)
    err = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(dia, dtype=dtype)
        y = best_spmv(prep, x)
        plain = spmv_dia_stream_reference(prep, x)
        sync(torch, dev)
        ok, e = close(y.cpu().numpy(), plain.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K1 {name} after RCM off its plain version ({e})")
        # scipy float64 on the scrambled matrix in the operand's precision,
        # x and y permuted.
        v64 = vals.to(dtype).double().numpy()
        ref = csr_host(idx[:, 0], idx[:, 1], v64, (n, n)) @ x_s.astype(
            np.float64)
        ok, err[name] = close(y.cpu().numpy(), ref[perm], 1e-5, 1e-5)
        require(ok, f"K1 {name} after RCM off scipy float64 ({err[name]})")
    return {"n": n, "bw_scrambled": bw_scrambled, "bw": bw,
            "diags": len(dia.offsets), "rcm_s": rcm_s, "err": err}


def phase_interop(torch, sp, dev, n):
    """Phase C5: config 2c through to_scipy and back through from_scipy."""
    rows, cols, vals, _ = cfg2c_entries(n)
    A = build_coo(sp, dev, (n, n), rows, cols, vals)
    M = sp.core.to_scipy(A)
    require(np.array_equal(M.row, rows) and np.array_equal(M.col, cols)
            and np.array_equal(M.data, vals.astype(np.float64)),
            "to_scipy entries differ")
    k = A.nnz
    for dtype in (np.float32, None):
        back = sp.core.from_scipy(M, dtype=dtype, device=dev)
        require(back.nnz == k and back.shape == A.shape
                and bool(torch.equal(back.indices[:k], A.indices[:k]))
                and bool(torch.equal(back.vals[:k],
                                     A.vals[:k].to(back.vals.dtype))),
                f"from_scipy(to_scipy(A)) differs ({dtype})")
    return {"nnz": k}


def core_path(torch, sp, dev, n=N, kron_n=CORE_KRON_N, slice_m=CORE_SLICE_M,
              r3_nnz=CORE_R3_NNZ, n_query=CORE_QUERIES) -> dict:
    """Phases C1-C5 on ``dev``: joins, algebra and constructors,
    accumulators, the reorder-to-K1 path and scipy interop at the main
    path's width. Each phase logs its host wall time and the path's peak
    device memory so far."""
    def done(what, t0, state):
        sync(torch, dev)
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(dev).type == "cuda" else None)
        log(f"phase {what} ({time.perf_counter() - t0:.3f} s; peak device "
            f"memory {peak} bytes)")
        state.setdefault("wall_s", {})[what.split()[0]] = (
            time.perf_counter() - t0)
        state.setdefault("peak_bytes", {})[what.split()[0]] = peak

    st: dict = {}
    t0 = time.perf_counter()
    B = band_coo(sp, dev, n)
    j = phase_joins(torch, sp, dev, B, n_query)
    done(f"C1 joins: join2 n_match {j['n_match']} = nnz, join3 with the "
         f"diagonal n; intersect_mask {j['n_found']} of {j['n_query']} "
         f"queries", t0, st)
    t0 = time.perf_counter()
    alg = phase_algebra(torch, sp, dev, B, j["Bt"], j["host"], kron_n)
    done(f"C2 algebra: S nnz {alg['S_nnz']}, max abs err {alg['err']}; "
         f"stacking exact; kron nnz {alg['kron_nnz']}", t0, st)
    t0 = time.perf_counter()
    acc = phase_accum(torch, sp, dev, B, n, slice_m, r3_nnz)
    done(f"C3 accumulators: slice nnz {acc['slice_nnz']}; scalar_sum "
         f"{acc['scalar_sum']!r} vs {acc['scalar_sum_f64']!r}; ADD err "
         f"{acc['err_add']!r}, project err {acc['err_project']!r}", t0, st)
    del j
    t0 = time.perf_counter()
    ro = phase_reorder(torch, sp, dev, B)
    done(f"C4 reorder: n {ro['n']}, bandwidth {ro['bw_scrambled']} "
         f"scrambled -> {ro['bw']} after RCM ({ro['diags']} diagonals); host "
         f"rcm_permutation {ro['rcm_s']!r} s; K1 max abs err vs scipy "
         f"{ro['err']}", t0, st)
    t0 = time.perf_counter()
    io = phase_interop(torch, sp, dev, n)
    done(f"C5 interop: config 2c {io['nnz']} entries through to_scipy and "
         f"from_scipy exact", t0, st)
    st.update(reorder=ro, nnz=B.nnz)
    return st


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


def k12_geometry(n: int, n_arrays: int, num_keys: int) -> tuple:
    """``(C, E, threads)`` that ``sps_block_sort`` launches for blocks of
    ``n`` elements, as the library reports them
    (``sps_block_sort_geometry``): what the host replay's
    ``block_sort_geometry`` must equal."""
    import ctypes

    from spsparse_torch import backend

    out = (ctypes.c_longlong * 3)()
    backend.check(backend.load_kernels().sps_block_sort_geometry(
        n_arrays, num_keys, n, ctypes.cast(out, ctypes.c_void_p)),
        "sps_block_sort_geometry")
    return tuple(int(v) for v in out)


def bitwise_equal(torch, got, want) -> bool:
    """Two tuples of tensors (or two tensors) equal bit for bit."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape
        and torch.equal(g.view(torch.int32) if g.element_size() == 4 else g,
                        w.view(torch.int32) if w.element_size() == 4 else w)
        for g, w in zip(got, want))


def k11_pr5(prep, x):
    """PR 5's K11 (``sps_shuffle_gather_scatter``: each gather slot's
    product stored straight to its ELL slot, from the column-block ordered
    batches) on a float32 ``x``: the timing yardstick of the slot-order
    pass. Used nowhere in the port."""
    import torch
    from spsparse_torch import backend

    out = torch.empty(prep.n_slots, dtype=torch.float32, device=x.device)
    err = backend.load_kernels().sps_shuffle_gather_scatter(
        0 if prep.dest.dtype == torch.int32 else 1, prep.octet.data_ptr(),
        prep.idx.data_ptr(), prep.vals.data_ptr(), prep.dest.data_ptr(),
        prep.filler_dest.data_ptr(), prep.n_batches,
        prep.filler_dest.shape[0], x.data_ptr(), prep.shape[1],
        prep.n_slots, out.data_ptr(), backend.current_stream(x.device))
    backend.check(err, "sps_shuffle_gather_scatter")
    return out.reshape(prep.n_vrows, prep.ell_k)


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


def cg_timings(torch, cases: dict, launches: dict) -> list[dict]:
    """Rows of the kernels line for K4 beyond S in float32: S with
    bfloat16 diagonals, the device-memory mode at 4n rows and n = 2^14,
    where the two grid-wide exchanges of an iteration take most of its
    time, each per iteration against its plain version in turns. The bound
    is the diagonals once an iteration (stored slots times 4 or 2 bytes)."""
    from spsparse_torch.ops import cg_solve_dia, cg_solve_dia_reference

    rows = []
    for what, case in cases.items():
        if not case["timed"]:
            continue
        prep, b = case["prep"], case["b"]
        ms = per_iteration_ms(torch, {
            "plain": lambda it: cg_solve_dia_reference(prep, b, iters=it,
                                                       shift=SHIFT),
            "kernel": lambda it: cg_solve_dia(prep, b, iters=it,
                                              shift=SHIFT)})
        n = prep.shape[0]
        stored = sum(n - abs(o) for o in prep.offsets)
        item = prep.data.element_size()
        b_ms, b_by = bound_ms(stored * item, 2 * stored + 2 * n)
        row = dict(name="cg_solve_dia",
                   dtype="bf16" if item == 2 else "f32",
                   **KERNELS["cg_solve_dia"],
                   launches=launches["cg_solve_dia"],
                   max_abs_err=case["err"], ms=ms["kernel"],
                   plain_ms=ms["plain"], bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, matrix=what, n=n, nnz=stored,
                   geometry=case.get("geometry"))
        if ms["kernel"] < b_ms:
            row["note"] = (f"under the device-memory bound: the "
                           f"{stored * item / 1e6:.1f} MB of diagonals stay "
                           "in the 50 MB L2 from one iteration to the next")
        rows.append(row)
    return rows


def spmm_timings(torch, spmm, launches: dict) -> list[dict]:
    """Rows of the kernels line for K5, K6 and K7 at config 3 (K7 also on
    its tiles shuffled), and for K7 on the two one_hot route layouts (the
    traffic prepare_general sends it):
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

    def library_ms(entries, shape, Xl):
        A_csr = library_csr_of(torch, *entries, shape, Xl.device)
        return float(np.median(time_ms(torch, lambda: A_csr @ Xl, reps=7,
                                       inner=5)))

    lib_ms = library_ms(reg["entries"], (m, 2 * m), X)
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
        extra = {}
        if name == "spmm_tiled_onehot":
            extra["ptxas"] = ptxas_of(("onehot_kernel", "onehot_small"))
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
                         occupied_column_blocks=occupied, **extra))

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
    for what, key in ((c3, "prep"),
                      (c3 + ", rows unsorted within tiles", "unsorted")):
        add("spmm_tiled_onehot", "f32", what, spmm["onehot"][key], X,
            spmm_tiled_onehot, spmm_tiled_onehot_reference, 4,
            F32_FLOPS_PER_S, spmm["onehot"]["err"], lib_ms, nnz,
            timing_kw=dict(reps=3, inner=2, warmup=1))
    for what, route in spmm["onehot"]["route"].items():
        add("spmm_tiled_onehot", "f32", what, route["prep"], route["Xp"],
            spmm_tiled_onehot, spmm_tiled_onehot_reference, 4,
            F32_FLOPS_PER_S, route["err"],
            library_ms(route["entries"], (route["m"], route["m"]),
                       route["X"]),
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


def occupied_flops(torch, a_blocks, b_blocks, a_idx, b_idx, transpose_b,
                   bf16) -> int:
    """Operations of the pairs ``a_blocks[a_idx[p]] . b_blocks[b_idx[p]]``
    (``^T`` when ``transpose_b``) over the (warp block, k-chunk) units that
    hold a nonzero on both sides, in the kernels' layout: 32 x 64 output
    blocks and 32-deep chunks in float32, 64 x 32 and 64-deep in bfloat16.
    The other units are exact zeros, which the kernels skip."""
    rm, cn, kd = (64, 32, 64) if bf16 else (32, 64, 32)
    T = TILE_SIDE

    def units(blocks, rows, rows_are_k):
        nz = blocks.reshape(-1, T, T) != 0
        if rows_are_k:     # B of A B: k x n
            u = nz.reshape(-1, T // kd, kd, T // rows, rows).any(4).any(2)
            return u.transpose(1, 2).float()
        return nz.reshape(-1, T // rows, rows, T // kd, kd).any(4).any(
            2).float()

    ua = units(a_blocks, rm, False)
    ub = units(b_blocks, cn, not transpose_b)
    live = 0
    for sl in range(0, a_idx.numel(), 1 << 16):
        live += int(torch.einsum("prk,pnk->", ua[a_idx[sl:sl + (1 << 16)]],
                                 ub[b_idx[sl:sl + (1 << 16)]]).item())
    return live * 2 * rm * cn * kd


def spgemm_timings(torch, spg, launches: dict) -> tuple[list[dict], dict]:
    """Rows of the kernels line for K8, K9 and K13 at config 4, and the
    end-to-end times of the SpGEMM entry points.

    Bounds count what the product needs: K8 reads A's live blocks once
    (the plan is shared) and writes the band once in float32; K9 and K13
    read the distinct operand tiles of their plan once and write the
    output tiles once. ``bound_ms`` takes the operations of the occupied
    (warp block, k-chunk) units (:func:`occupied_flops`), the work that
    the kernels cannot skip; ``dense_bound_ms`` 2*128^3 operations a
    pair. K13 is timed in turns against K9. The library yardstick is cuSPARSE's CSR x CSR SpGEMM of
    the same operands, extraction of the output included."""
    from spsparse_torch.ops import (plan_esc, spgemm_aat, spgemm_planned_vals,
                                    spgemm_tiled, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream, spgemm_window,
                                    spgemm_window_reference)
    from spsparse_torch.ops.spgemm_window import band_pair_stream

    cfg, k8, pairs = spg["cfg"], spg["k8"], spg["pairs"]
    A, n = cfg["A"], cfg["n"]
    A64 = _csr_of(A)
    C64 = _csr_of(k8["C"])
    lib = {"A A^T": library_spgemm_ms(torch, A64, A64.T, "cuda"),
           "C C": library_spgemm_ms(torch, C64, C64, "cuda")}
    kw = dict(reps=5, inner=3, warmup=2)
    flops_pair = 2 * TILE_SIDE ** 3
    rows = []

    def row(name, dtype, matrix, ms, plain_ms, nbytes, flops, dense_flops,
            err, label, **extra):
        rate = BF16_FLOPS_PER_S if dtype == "bf16" else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        d_ms, d_by = bound_ms(nbytes, dense_flops, rate)
        lib_ms, lib_err = lib[label]
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_error=lib_err,
                         dense_bound_ms=d_ms, dense_bound_by=d_by,
                         occupied_flops=flops, dense_flops=dense_flops,
                         matrix=matrix, n=n, nnz=A.nnz, **extra))

    for dname in ("f32", "bf16"):
        plan, prep = k8["plan"][dname], k8["prep"][dname]
        ms, plain_ms = compare_times(
            torch, lambda: spgemm_window(plan, prep.blocks),
            lambda: spgemm_window_reference(plan, prep.blocks), **kw)
        live = int((prep.tcols < prep.nbc).sum())
        nbytes = (live * TILE_ELEMS * prep.blocks.element_size()
                  + plan.nbr_pad * plan.nband * TILE_ELEMS * 4)
        _, a_idx, b_idx = (torch.from_numpy(v).to(prep.blocks.device)
                           for v in band_pair_stream(plan))
        flops = occupied_flops(torch, prep.blocks, prep.blocks, a_idx, b_idx,
                               True, dname == "bf16")
        row("spgemm_window", dname, "config 4 A A^T (band)", ms, plain_ms,
            nbytes, flops, plan.n_live * flops_pair,
            k8["err"][f"band_{dname}"], "A A^T")
    for label, dname in (("A A^T", "f32"), ("A A^T", "bf16"),
                         ("C C", "f32"), ("C C", "bf16")):
        plan = pairs["plans"][label]
        X = pairs["blocks"][(label, dname)]
        tiles = np.unique(np.concatenate([plan.pa, plan.pb])).size
        nbytes = (tiles * TILE_ELEMS * X.blocks.element_size()
                  + plan.n_out_tiles * TILE_ELEMS * 4)
        t = plan.tensors(X.device)
        flops = occupied_flops(torch, X.blocks, X.blocks, t["pa"].long(),
                               t["pb"].long(), plan.transpose_b,
                               dname == "bf16")
        for name, fn in (("spgemm_tiled_pairs", spgemm_tiled_pairs),
                         ("spgemm_tiled_stream", spgemm_tiled_stream)):
            ms, plain_ms = compare_times(
                torch, lambda: fn(X, X, plan),
                lambda: spgemm_tiled_reference(X, X, plan), **kw)
            extra = {}
            if fn is spgemm_tiled_stream:
                # K9, K13's yardstick, in turns with K13 in the same run.
                extra["ms_again"], extra["k9_ms"] = compare_times(
                    torch, lambda: fn(X, X, plan),
                    lambda: spgemm_tiled_pairs(X, X, plan), **kw)
            row(name, dname, f"config 4 {label} (pair plan)", ms, plain_ms,
                nbytes, flops, plan.n_pairs * flops_pair,
                pairs["err"][f"{label} {dname}"], label, **extra)

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
    # One PyTorch call computing K10's function: per-row sums of the
    # products by the row pointer.
    live_prod, offsets = prod[:csr.nnz], csr.row_ptr[:n + 1]
    seg_lib = torch.segment_reduce(live_prod, "sum", offsets=offsets)
    ok, seg_lib_err = close(seg_lib.cpu().numpy(), segmented_row_sums(
        prod, csr.row_ptr, nrows=n, rows_per_block=256,
        entries_per_block=1024).cpu().numpy(), 1e-5, 1e-5)
    require(ok, f"segment_reduce differs from K10 ({seg_lib_err})")
    seg_lib_ms = float(np.median(time_ms(
        torch, lambda: torch.segment_reduce(live_prod, "sum",
                                            offsets=offsets))))
    row("segmented_row_sums", "config 2c (CSR products)", ms, plain_ms,
        4 * csr.nnz + 4 * (n + 1) + 4 * n, csr.nnz, seg["err"]["k10"],
        seg_lib_ms, n=n, nnz=csr.nnz, library_call="torch.segment_reduce",
        library_csr_spmv_ms=lib_ms)
    ms, plain_ms = compare_times(torch, lambda: shuffle_gather(prep, x),
                                 lambda: shuffle_gather_reference(prep, x),
                                 reps=7, inner=5)
    require(torch.equal(k11_pr5(prep, x), shuffle_gather(prep, x)),
            "K11: the earlier design's slot grid differs")
    ms_again, prior_ms = compare_times(torch, lambda: shuffle_gather(prep, x),
                                       lambda: k11_pr5(prep, x), reps=7,
                                       inner=5)
    # The slot-order layout: each slot's column and value read once, each
    # slot written once, x read once; one multiply a live slot.
    nbytes = (prep.n_slots * (prep.ell_cols.element_size() + 4 + 4)
              + 4 * n)
    row("shuffle_gather", "config 2c (slot-order layout)", ms, plain_ms,
        nbytes, nnz, 0.0, lib_ms, n=n, nnz=nnz, n_slots=prep.n_slots,
        batches=prep.n_batches, gather_fill=c2["fill"], ms_again=ms_again,
        prior_design_ms=prior_ms)
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
        library_stable_ms=sort_lib_stable, n=nel, nnz=nel,
        ptxas=ptxas_of(("reg17sort_chunk_kernel",)))
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


def ptxas_of(patterns) -> dict:
    """Registers and spill bytes that ptxas reported for the kernels whose
    (mangled) names hold one of ``patterns``, from the build's log
    (``backend.PTXAS_LOG``), demangled where ``c++filt`` is on PATH."""
    from spsparse_torch import backend

    path = backend.build().parent / backend.PTXAS_LOG
    out, cur = {}, None
    for line in (path.read_text() if path.exists() else "").splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$.]+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    keep = {k: v for k, v in out.items() if any(p in k for p in patterns)}
    if keep and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(keep),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        keep = dict(zip(names, keep.values()))
    return keep


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
    k4_ptxas = ptxas_of(("cg_kernel",))
    rows.append(dict(name="cg_solve_dia", dtype="f32",
                     **KERNELS["cg_solve_dia"],
                     launches=launches["cg_solve_dia"],
                     max_abs_err=solve["cg"]["err"], ms=cg_ms["kernel"],
                     plain_ms=cg_ms["plain"], bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, matrix="S = (B + B^T)/2",
                     geometry=solve["cg"]["geometry"], ptxas=k4_ptxas))
    rows += cg_timings(torch, solve["cg"]["cases"], launches)
    rows += spmm_timings(torch, spmm, launches)
    spgemm_rows, spgemm_ends = spgemm_timings(torch, spg, launches)
    rows += spgemm_rows
    un_rows, un_ends = unstructured_timings(torch, un, launches)
    rows += un_rows
    torch.cuda.synchronize()
    log(f"phase 25 timing ({time.perf_counter() - t_timing:.3f} s)")

    # The core path runs after the timing so that its host work and the
    # device memory it leaves cached do not reach the kernels' times.
    torch.cuda.reset_peak_memory_stats()
    core, core_counts = run_path(torch, wrappers, core_path, torch, sp, dev)
    log(f"core path kernel launches: {core_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    require(core_counts["spmv_dia_stream"] > 0,
            "kernel spmv_dia_stream was not launched on the core path")
    for row in rows:
        if row["name"] == "spmv_dia_stream":
            row["launches_core_path"] = core_counts["spmv_dia_stream"]

    for row in rows:
        print(json.dumps({
            "timing": row["name"], "dtype": row["dtype"],
            "matrix": row.get("matrix", "banded"), "n": row.get("n", N),
            "nnz": row.get("nnz", nnz), "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "library_ms": row["library_ms"],
            "prior_design_ms": row.get("prior_design_ms"),
            "geometry": row.get("geometry"), "note": row.get("note"),
            "k9_ms": row.get("k9_ms"),
            "dense_bound_ms": row.get("dense_bound_ms"),
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
    print(json.dumps({"timing": "core path, phases C1-C5",
                      "wall_s": core["wall_s"],
                      "peak_bytes": core["peak_bytes"],
                      "n": core["reorder"]["n"],
                      "rcm_host_s": core["reorder"]["rcm_s"],
                      "bandwidth_scrambled": core["reorder"]["bw_scrambled"],
                      "bandwidth_rcm": core["reorder"]["bw"],
                      "k1_launches": core_counts["spmv_dia_stream"],
                      "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
