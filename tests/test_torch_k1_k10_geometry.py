"""The launch geometry of kernels K1 (banded SpMV) and K10 (CSR row sums),
replayed on the host.

``dia_spmv_geometry`` and ``segsum_geometry`` are the host copies of what
``sps_dia_spmv_geometry`` and ``sps_segsum_geometry`` report on the card
(``chip_smoke.py`` and ``tests_gpu/`` hold the two equal there). These
tests walk the replayed launches: every row (K1) and every entry (K10) is
covered once, every x index K1 reads lies in [0, m) and in its CTA's
window (its rows plus the offsets' span), and K10's tiles, row marks,
segmented scan and carries between tiles give the row sums. The replayed K1 product sums each row's
diagonals in ascending order as the plain version does, so it equals
``spmv_dia_stream_reference`` bit for bit, and it equals the JAX
``spmv_dia_pallas(..., interpret=True)`` at ``test_torch_dia.py``'s rtol
and atol of 2e-5; the replayed K10 sums equal
``segmented_row_sums_reference`` and the JAX ``segmented_row_sums``
(interpret mode) at ``test_torch_unstructured.py``'s rtol and atol of
2e-5 (another sum order).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spsparse_torch.convert import dia_from_numpy
from spsparse_torch.ops import (prepare_dia, segmented_row_sums_reference,
                                spmv_dia_stream_reference)
from spsparse_torch.ops.dia_stream import dia_spmv_geometry
from spsparse_torch.ops.segsum import segsum_geometry
from spsparse_tpu.core.dia import SparseDIA as JDIA
from spsparse_tpu.ops.pallas_dia import prepare_dia as j_prepare
from spsparse_tpu.ops.pallas_dia import spmv_dia_pallas
from spsparse_tpu.ops.pallas_segsum import max_entries_per_rowblock
from spsparse_tpu.ops.pallas_segsum import pad_products as j_pad
from spsparse_tpu.ops.pallas_segsum import segmented_row_sums as j_segsum
from port_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
WIN = 1024   # kWin in csrc/segsum.cu: row pointers a K10 tile reads at once


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

# name: (n, m, offsets, dtype, byte offset of data, 16-byte path)
K1_CASES = {
    "config-2 band": (4096, 4096, range(-5, 6), "float32", 0, True),
    "bf16 band": (4096, 4096, range(-5, 6), "bfloat16", 0, True),
    "n % 4 != 0": (1003, 1003, (-3, -1, 0, 2, 5), "float32", 0, False),
    "odd base": (1024, 1024, (-3, 0, 4), "float32", 4, False),
    "odd base bf16": (2048, 2048, (-3, 0, 4), "bfloat16", 2, False),
    "span 2048": (5000, 5000, (-1024, -1, 0, 1, 1024), "float32", 0, True),
    "span 4200": (6000, 6000, (-2100, 0, 2100), "float32", 0, True),
    "m < n, offsets past m": (3000, 1000, (-1500, -2, 0, 7, 1200), "float32",
                              0, True),
    "m > n": (700, 2000, (0, 3, 1500), "bfloat16", 0, False),
    "n = 100": (100, 100, range(-5, 6), "float32", 0, True),
}


def k1_operand(case):
    n, m, offsets, dtype, _, _ = K1_CASES[case]
    rng = np.random.default_rng(n + m)
    offs = tuple(int(o) for o in offsets)
    cols = np.arange(n)[:, None] + np.asarray(offs)[None, :]
    valid = (cols >= 0) & (cols < m)
    data = np.where(valid, rng.uniform(-1, 1, (n, len(offs))), 0)
    data = data.T.astype(np.float32).copy()
    x = rng.uniform(-1, 1, m).astype(np.float32)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, m), device="cpu"),
                       dtype=getattr(torch, dtype))
    return data, offs, x, prep


def k1_ctas(prep, geo):
    """``(r0, r1, rows of each thread, window start, window end)`` of each
    CTA of the replayed launch."""
    n = prep.shape[0]
    V, T = geo.rows, geo.threads
    lo, hi = min(prep.offsets), max(prep.offsets)
    for c in range(geo.ctas):
        r0 = c * T * V
        r1 = min(r0 + T * V, n)
        threads = [np.arange(r0 + t * V, min(r0 + (t + 1) * V, n))
                   for t in range(T) if r0 + t * V < n]
        yield r0, r1, threads, r0 + lo, r1 + hi


def k1_replay(prep, x, geo):
    """K1's product through the replayed launch: each thread's rows sum
    their in-range diagonals in ascending order, as the kernel does (with
    a separate multiply and add, as the plain version does)."""
    n, m = prep.shape
    y = torch.zeros(n, dtype=torch.float32)
    for r0, r1, threads, w0, w1 in k1_ctas(prep, geo):
        rows = torch.from_numpy(np.concatenate(threads))
        acc = torch.zeros(rows.numel(), dtype=torch.float32)
        for k, off in enumerate(prep.offsets):
            j = rows + off
            ok = (j >= 0) & (j < m)
            acc[ok] += prep.data[k, rows[ok]].float() * x[j[ok]]
        y[rows] = acc
    return y


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_replay_covers_rows_and_window(case):
    n, m, _, dtype, byte_off, vector = K1_CASES[case]
    _, offs, x, prep = k1_operand(case)
    geo = dia_spmv_geometry(getattr(torch, dtype), n, n, 4096 + byte_off,
                            8192)
    assert geo.vector == vector
    assert geo.threads == 256 and geo.rows == (4 if dtype == "float32"
                                               else 8)
    assert geo.ctas == -(-n // (geo.threads * geo.rows))
    seen = np.zeros(n, np.int64)
    span = max(offs) - min(offs)
    for r0, r1, threads, w0, w1 in k1_ctas(prep, geo):
        assert w1 - w0 == (r1 - r0) + span
        for rows in threads:
            seen[rows] += 1
            j = rows[:, None] + np.asarray(offs)[None, :]
            read = j[(j >= 0) & (j < m)]
            assert ((read >= w0) & (read < w1)).all()
    assert (seen == 1).all()


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_replay_product_is_the_plain_versions(case):
    n, _, _, dtype, byte_off, _ = K1_CASES[case]
    _, offs, x, prep = k1_operand(case)
    geo = dia_spmv_geometry(getattr(torch, dtype), n, n, byte_off, 0)
    xt = torch.from_numpy(x)
    y = k1_replay(prep, xt, geo)
    ref = spmv_dia_stream_reference(prep, xt)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("case", ["config-2 band", "n % 4 != 0"])
def test_k1_replay_product_matches_pallas_interpret(case):
    n, m, _, _, _, _ = K1_CASES[case]
    data, offs, x, prep = k1_operand(case)
    geo = dia_spmv_geometry(torch.float32, n, n, 0, 0)
    y = k1_replay(prep, torch.from_numpy(x), geo).numpy()
    jp = j_prepare(JDIA(data=jnp.asarray(data), offsets=offs, shape=(n, m)),
                   block=128)
    y_j = np.asarray(spmv_dia_pallas(jp, x, interpret=True))
    np.testing.assert_allclose(y, y_j, **TOL)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

def k10_pointer(case):
    """``(row_ptr int32, prod float32 of numel entries)``."""
    rng = np.random.default_rng(len(case))
    head = 0
    if case == "random rows":
        counts = rng.integers(0, 20, 1500)
    elif case == "empty rows":
        counts = rng.integers(0, 3, 6000) * (rng.random(6000) < 0.3)
        counts[:50] = 0
        counts[-70:] = 0
    elif case == "rows across tiles":
        counts = rng.integers(0, 12, 6000)
        counts[3000] = 20000               # over five tiles of 4096
    elif case == "rp[0] != 0":
        counts = rng.integers(0, 30, 800)
        head = 4101
    elif case == "a 4096-entry row":
        counts = rng.integers(0, 4, 3000) * (np.arange(3000) % 5 != 0)
        counts[1000] = 4096
    else:                                  # "nnz = 0"
        counts = np.zeros(300, np.int64)
    rp = (head + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    prod = rng.uniform(-1, 1, int(rp[-1]) + 7).astype(np.float32)
    return rp, prod


K10_CASES = ["random rows", "empty rows", "rows across tiles", "rp[0] != 0",
             "a 4096-entry row", "nnz = 0"]


def k10_replay(prod, rp, nrows, geo):
    """K10's launch on the host, tile by tile as the kernel runs it:
    ``(y, writes a row, reads an entry, (interior, rows from the window)
    of each live tile)``. A live tile reads the row pointers where an even
    spread of the entries over the rows puts its rows; it owns the rows
    whose last entry it holds (empty rows by position), marks their ends
    (from the window when it holds them all, else after a search), sums
    each thread's entries in order cutting at the marks, scans the
    threads' (sum, ended) pairs in order, and adds to a row begun in
    earlier tiles their carries, from the nearest back."""
    f32 = np.float32
    T, I, tile = geo.threads, geo.items, geo.tile
    numel = prod.shape[0]
    y = np.full(nrows, np.nan, f32)
    writes = np.zeros(nrows, np.int64)
    reads = np.zeros(numel, np.int64)
    E0, E1 = int(rp[0]), int(rp[nrows])
    c_first = min(E0 // tile, geo.ctas - 1)
    c_last = (E1 - 1) // tile if E1 > E0 else c_first
    carries, paths = {}, []
    for c in range(geo.ctas):
        a, b = c * tile, (c + 1) * tile
        if not c_first <= c <= c_last:
            continue
        first, last = c == c_first, c == c_last
        interior = a >= E0 and b <= E1
        w = 0 if first else max(0, min(
            nrows, (a - E0) * nrows // (E1 - E0) - WIN // 8))
        win = [int(rp[w + j]) if w + j <= nrows else 2**31 - 1
               for j in range(WIN)]
        v = np.zeros(tile, f32)
        lo, hi = max(a, E0), min(b, E1)
        v[lo - a:hi - a] = prod[lo:hi]
        reads[lo:hi] += 1
        marks = np.full(tile, -1, np.int64)
        lead = a
        from_window = ((w == 0 if first else win[0] <= a)
                       and (nrows <= w + WIN - 1 if last else win[-1] > b))
        paths.append((interior, from_window))
        if from_window:
            owned = [(w + j - 1, win[j - 1], win[j]) for j in range(1, WIN)
                     if w + j - 1 < nrows
                     and (first or win[j] > a) and (last or win[j] <= b)]
            for r, start, end in owned:
                if start <= a < end:
                    lead = start
        else:
            r = 0 if first else int(np.searchsorted(
                rp[1:nrows + 1], a, side="right"))
            if not first:
                lead = int(rp[r])
            owned = []
            while r < nrows and (last or rp[r + 1] <= b):
                owned.append((r, int(rp[r]), int(rp[r + 1])))
                r += 1
        for r, start, end in owned:
            if start == end:
                y[r] = 0
                writes[r] += 1
            else:
                marks[end - 1 - a] = r
        runs, heads = [], []
        for t in range(T):
            run, head = f32(0), None
            for i in range(t * I, (t + 1) * I):
                run = f32(run + v[i])
                if marks[i] >= 0:
                    if head is None:
                        head = (int(marks[i]), run)
                    else:
                        y[marks[i]] = run
                        writes[marks[i]] += 1
                    run = f32(0)
            runs.append(run)
            heads.append(head)
        before_s, before_f = f32(0), False
        for t in range(T):
            if heads[t] is not None:
                row, part = heads[t]
                total = f32(before_s + part)
                if not before_f and lead < a:
                    assert int(rp[row]) == lead
                    for cc in range(c - 1, lead // tile - 1, -1):
                        total = f32(total + carries[cc])
                y[row] = total
                writes[row] += 1
                before_s, before_f = runs[t], True
            else:
                before_s = f32(before_s + runs[t])
        carries[c] = before_s
    return y, writes, reads, paths


@functools.cache
def k10_case(case):
    rp, prod = k10_pointer(case)
    nrows = rp.shape[0] - 1
    geo = segsum_geometry(prod.shape[0], nrows, 0)
    return rp, prod, nrows, geo, k10_replay(prod, rp, nrows, geo)


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_replay_covers_entries_and_rows(case):
    rp, prod, nrows, geo, (y, writes, reads, _) = k10_case(case)
    assert geo.ctas == max(1, -(-prod.shape[0] // geo.tile))
    assert geo.tile == geo.threads * geo.items and geo.vector
    assert (writes == 1).all()
    inside = np.zeros(prod.shape[0], np.int64)
    inside[rp[0]:rp[nrows]] = 1
    assert np.array_equal(reads, inside)
    if case == "rows across tiles":
        assert (np.diff(rp) > 2 * geo.tile).any()



def test_k10_replay_walks_every_kind_of_tile():
    """Interior and edge tiles, each with its rows from the window and by
    the search (many empty rows; the even-spread guess thrown off by a
    long row)."""
    kinds = {kind for case in K10_CASES for kind in k10_case(case)[4][3]}
    assert kinds == {(True, True), (True, False), (False, True),
                     (False, False)}


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_replay_sums_match_plain_and_pallas(case):
    rp, prod, nrows, geo, (y, _, _, _) = k10_case(case)
    ref = segmented_row_sums_reference(torch.from_numpy(prod),
                                       torch.from_numpy(rp), nrows).numpy()
    np.testing.assert_allclose(y, ref, **TOL)
    if case in ("rows across tiles", "rp[0] != 0"):
        E = max_entries_per_rowblock(rp, 64)
        y_j = np.asarray(j_segsum(
            j_pad(jnp.asarray(prod), E), jnp.asarray(rp), nrows=nrows,
            rows_per_block=64, entries_per_block=E, interpret=True))
        np.testing.assert_allclose(y, y_j, **TOL)


def test_empty_replays():
    assert segsum_geometry(0, 0, 0).ctas == 0
    assert segsum_geometry(10, 0, 4).ctas == 0
    assert segsum_geometry(0, 5, 0).ctas == 1
    assert not segsum_geometry(10, 3, 4).vector
    geo = dia_spmv_geometry(torch.float32, 0, 0, 0, 0)
    assert geo.ctas == 0 and geo.vector
