"""The port's unstructured SpMV slice against the JAX package, at small size.

The same seeded numpy inputs go through ``spsparse_tpu`` (Pallas kernels in
interpret mode, as ``tests/test_spmv_shuffle.py`` and
``tests/test_pallas.py`` run them) and through ``spsparse_torch`` on
``device="cpu"``, where the kernel wrappers K10 (``segmented_row_sums``)
and K11 (``shuffle_gather``) run their plain versions:
``prepare_shuffle_spmv`` (every array), ``spmv_shuffle`` on each package's
own layout and on the other's (through ``convert``), ``best_spmv``'s
route, ``segmented_row_sums``/``spmv_csr_segsum`` and their helpers, and
``chip_smoke.unstructured_path`` rehearsed on the CPU.

Tolerances: layout arrays exact, except a duplicate entry's summed value,
which may differ by one ulp (the JAX prepare sums with ``np.add.at``, the
port with ``index_add_``). ``y`` within rtol 2e-5 and atol 2e-5 of the
JAX result and of a float64 dense product, the JAX tests' own bound.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import spsparse_torch as tsp
import spsparse_tpu as jsp
from spsparse_torch import convert as cv
from spsparse_torch.core.structure import SparseCSR as TCSR
from spsparse_torch.ops import best_spmv as t_best
from spsparse_torch.ops import max_entries_per_rowblock as t_max_entries
from spsparse_torch.ops import pad_products as t_pad
from spsparse_torch.ops import prepare_shuffle_spmv as t_prepare
from spsparse_torch.ops import segmented_row_sums as t_segsum
from spsparse_torch.ops import shuffle_gather as t_k11
from spsparse_torch.ops import spmv_csr_segsum as t_csr_spmv
from spsparse_torch.ops import spmv_shuffle as t_spmv
from spsparse_tpu.core.structure import SparseCSR as JCSR
from spsparse_tpu.ops.pallas_segsum import max_entries_per_rowblock
from spsparse_tpu.ops.pallas_segsum import pad_products as j_pad
from spsparse_tpu.ops.pallas_segsum import segmented_row_sums as j_segsum
from spsparse_tpu.ops.pallas_segsum import spmv_csr_pallas
from spsparse_tpu.ops.spmv_kernels import best_spmv as j_best
from spsparse_tpu.ops.spmv_shuffle import PreparedShuffleSpMV as JPrep
from spsparse_tpu.ops.spmv_shuffle import prepare_shuffle_spmv as j_prepare
from spsparse_tpu.ops.spmv_shuffle import spmv_shuffle as j_spmv

tn = cv.tensor_to_numpy
FIELDS = ("octet", "idx", "vals", "dest", "filler_dest", "extra_rows",
          "extra_vrows")
TOL = dict(rtol=2e-5, atol=2e-5)


def _random(rng, shape, k):
    """``tests/test_spmv_shuffle.py``'s matrix: nrows*k entries at random
    rows and columns (duplicates possible)."""
    n = shape[0] * k
    return (rng.integers(0, shape[0], n), rng.integers(0, shape[1], n),
            rng.uniform(-1, 1, n).astype(np.float32))


def _heavy(rng):
    """``test_heavy_rows_split``: one row of 90 among 100 random entries."""
    cols = rng.permutation(300)[:90]
    r = np.concatenate([np.full(90, 7), rng.integers(0, 50, 100)])
    c = np.concatenate([cols, rng.integers(0, 300, 100)])
    return r, c, rng.uniform(-1, 1, 190).astype(np.float32)


def _dups(rng):
    """Many duplicates (rows 0-19, columns 0-9) and empty rows 20-38, the
    JAX test's (3, 7) pair and corner (39, 129)."""
    r = np.concatenate([[3, 3, 39], rng.integers(0, 20, 300)])
    c = np.concatenate([[7, 7, 129], rng.integers(0, 10, 300)])
    v = np.concatenate([[2.0, 5.0, -1.0], rng.uniform(-1, 1, 300)])
    return r, c, v.astype(np.float32)


# name -> (shape, ell_k, entries(rng), has duplicates)
CASES = {
    "300x400_k6": ((300, 400), 16, lambda g: _random(g, (300, 400), 6),
                   True),
    "700x260_k3": ((700, 260), 16, lambda g: _random(g, (700, 260), 3),
                   True),
    "64x2000_k10": ((64, 2000), 16, lambda g: _random(g, (64, 2000), 10),
                    True),
    "heavy_rows": ((50, 300), 8, _heavy, True),
    "dups_empty_rows": ((40, 130), 16, _dups, True),
    "empty": ((40, 130), 16, lambda g: (np.zeros(0, np.int64),
                                        np.zeros(0, np.int64),
                                        np.zeros(0, np.float32)), False),
}


def build_both(shape, r, c, v):
    """The same entries through both packages' ``CooBuilder``."""
    out = []
    for pkg, kw in ((jsp, {}), (tsp, {"device": "cpu"})):
        b = pkg.CooBuilder(shape, dtype=np.float32)
        if len(r):
            b.add_many(np.stack([r, c], 1), v)
        out.append(b.build(**kw))
    return out


@functools.lru_cache(maxsize=None)
def case(name):
    """``(JAX layout, port layout, x, JAX y, float64 dense y)``."""
    shape, ell_k, entries, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    r, c, v = entries(rng)
    ja, ta = build_both(shape, r, c, v)
    x = rng.uniform(-1, 1, shape[1]).astype(np.float32)
    pj = j_prepare(ja, ell_k=ell_k)
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), v.astype(np.float64))
    return (pj, t_prepare(ta, ell_k=ell_k), x,
            np.asarray(j_spmv(pj, jnp.asarray(x), interpret=True)),
            dense @ x.astype(np.float64))


def jax_layout(tp):
    """A JAX ``PreparedShuffleSpMV`` holding the port's arrays."""
    return JPrep(**{f: jnp.asarray(tn(getattr(tp, f))) for f in FIELDS},
                 n_vrows=tp.n_vrows, ell_k=tp.ell_k, shape=tp.shape)


# ----------------------------------------------------------------------
# K11: the shuffle layout and spmv_shuffle
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_prepare_matches_jax(name):
    pj, tp, *_ = case(name)
    assert (tp.n_vrows, tp.ell_k, tp.shape) == (pj.n_vrows, pj.ell_k,
                                                pj.shape)
    assert (tp.n_batches, tp.n_slots) == (pj.n_batches, pj.n_slots)
    for f in FIELDS:
        want, got = np.asarray(getattr(pj, f)), tn(getattr(tp, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        if f == "vals" and CASES[name][3]:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    if name == "heavy_rows":
        assert tp.extra_rows.shape[0] >= 90 // 8 - 1
    if name == "empty":
        assert tp.n_batches == 1 and tp.octet.shape == (1,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_shuffle_matches_jax(name):
    pj, tp, x, yj, y64 = case(name)
    xt = torch.from_numpy(x)
    y = t_spmv(tp, xt)
    assert y.dtype == torch.float32 and tuple(y.shape) == (tp.shape[0],)
    np.testing.assert_allclose(tn(y), yj, **TOL)
    np.testing.assert_allclose(tn(y), y64, **TOL)
    assert torch.equal(t_best(tp, xt), y)
    # each package on the other's layout
    np.testing.assert_allclose(
        tn(t_spmv(cv.prepared_shuffle_from_jax(pj, device="cpu"), xt)), yj,
        **TOL)
    np.testing.assert_allclose(
        np.asarray(j_spmv(jax_layout(tp), jnp.asarray(x), interpret=True)),
        yj, **TOL)


def test_slot_grid_is_the_sort_of_the_gather_products():
    """K11's plain version equals the JAX pipeline's sorted stream: every
    entry's product in its ELL slot, fillers exactly 0."""
    _, tp, x, *_ = case("heavy_rows")
    slots = tn(t_k11(tp, torch.from_numpy(x))).reshape(-1)
    dest = tn(tp.dest)
    live = dest < tp.n_slots
    xpad = np.zeros(-(-tp.shape[1] // 1024) * 1024, np.float32)
    xpad[: tp.shape[1]] = x
    col = ((tn(tp.octet)[:, None] * 8 + np.arange(8))[:, :, None] * 128
           + tn(tp.idx)).reshape(-1)
    want = np.zeros(tp.n_slots, np.float32)
    want[dest[live]] = (tn(tp.vals).reshape(-1) * xpad[col])[live]
    np.testing.assert_array_equal(slots, want)
    assert not slots[tn(tp.filler_dest)].any()


def test_best_spmv_routes_the_shuffle_layout():
    import spsparse_torch.ops.spmv_kernels as km

    pj, tp, x, yj, _ = case("300x400_k6")
    assert not hasattr(km, "_NOT_PORTED")
    before = t_k11.launches
    y = t_best(tp, torch.from_numpy(x))
    assert t_k11.launches == before       # the CPU runs the plain version
    np.testing.assert_allclose(tn(y), np.asarray(j_best(pj, jnp.asarray(x))),
                               **TOL)


def test_prepare_rejects_rank3():
    a = tsp.SparseCOO.empty((2, 3, 4), 4, device="cpu")
    with pytest.raises(tsp.SpSparseError):
        t_prepare(a)


# ----------------------------------------------------------------------
# K10: segmented row sums and spmv_csr_segsum
# ----------------------------------------------------------------------
def csr_both(shape, r, c, v, pad=5):
    """The consolidated CSR of the entries, built in numpy and handed to
    both packages (JAX's ``to_csr`` is held against the port's elsewhere);
    ``pad`` padding entries with the sentinel column."""
    key = np.asarray(r, np.int64) * shape[1] + c
    uk, inv = np.unique(key, return_inverse=True)
    vals = np.zeros(uk.size, np.float32)
    np.add.at(vals, inv, v)
    rows, cols = uk // shape[1], uk % shape[1]
    rp = np.searchsorted(rows, np.arange(shape[0] + 1)).astype(np.int32)
    cols = np.concatenate([cols, np.full(pad, shape[1])]).astype(np.int32)
    vals = np.concatenate([vals, np.zeros(pad, np.float32)])
    j = JCSR(row_ptr=jnp.asarray(rp), cols=jnp.asarray(cols),
             vals=jnp.asarray(vals), nnz=jnp.asarray(uk.size, jnp.int32),
             shape=shape)
    t = TCSR(row_ptr=torch.from_numpy(rp), cols=torch.from_numpy(cols),
             vals=torch.from_numpy(vals), nnz=int(uk.size), shape=shape)
    return j, t


SEG_CASES = {
    # tests/test_pallas.py:24-57: random; rows not a multiple of the block
    # with many empty rows; one dense row forcing a large window
    "random": ((500, 300), 256, lambda g: (
        g.integers(0, 500, 4000), g.integers(0, 300, 4000),
        g.uniform(-1, 1, 4000).astype(np.float32))),
    "empty_rows_tail": ((1000, 50), 256, lambda g: (
        np.array([999, 0]), np.array([3, 1]),
        np.array([2.0, 1.0], np.float32))),
    "skewed": ((64, 512), 8, lambda g: (
        np.append(np.zeros(400, np.int64), 63),
        np.append(g.permutation(512)[:400], 0),
        np.append(g.uniform(-1, 1, 400), 5.0).astype(np.float32))),
}


@pytest.mark.parametrize("name", sorted(SEG_CASES))
def test_spmv_csr_segsum_matches_jax(name):
    shape, R, entries = SEG_CASES[name]
    rng = np.random.default_rng(3)
    r, c, v = entries(rng)
    jc, tc = csr_both(shape, r, c, v)
    x = rng.uniform(-1, 1, shape[1]).astype(np.float32)
    yj = np.asarray(spmv_csr_pallas(jc, x, rows_per_block=R,
                                    interpret=True))
    before = t_segsum.launches
    y = t_csr_spmv(tc, torch.from_numpy(x), rows_per_block=R)
    assert t_segsum.launches == before
    np.testing.assert_allclose(tn(y), yj, **TOL)
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), v.astype(np.float64))
    np.testing.assert_allclose(tn(y), dense @ x, **TOL)


@pytest.mark.parametrize("R,short", [(8, False), (256, False), (8, True)])
def test_segmented_row_sums_matches_jax(R, short):
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 12, 77) * (np.arange(77) % 4 != 1)
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nrows = 77
    if short:                 # a pointer array shorter than nrows + 1
        rp, nrows = rp[:40], 77
    prod = rng.uniform(-1, 1, int(rp[-1])).astype(np.float32)
    E = -(-max(max_entries_per_rowblock(rp, R), 8) // 128) * 128
    pj = j_pad(jnp.asarray(prod), E)
    pt = t_pad(torch.from_numpy(prod), E)
    np.testing.assert_array_equal(tn(pt), np.asarray(pj))
    yj = np.asarray(j_segsum(pj, jnp.asarray(rp), nrows=nrows,
                             rows_per_block=R, entries_per_block=E,
                             interpret=True))
    y = t_segsum(pt, torch.from_numpy(rp), nrows=nrows, rows_per_block=R,
                 entries_per_block=E)
    assert tuple(y.shape) == (nrows,)
    np.testing.assert_allclose(tn(y), yj, **TOL)


@pytest.mark.parametrize("rp,R", [([0, 2, 2, 7, 9, 9], 2),
                                  ([0, 2, 2, 7, 9, 9], 5),
                                  ([0, 2, 2, 7, 9, 9], 3), ([0], 4),
                                  ([0, 0, 0, 130, 130], 1)])
def test_max_entries_per_rowblock_matches_jax(rp, R):
    rp = np.asarray(rp, np.int32)
    want = max_entries_per_rowblock(rp, R)
    assert t_max_entries(rp, R) == want
    assert t_max_entries(torch.from_numpy(rp), R) == want


# ----------------------------------------------------------------------
# chip_smoke.unstructured_path, rehearsed on the CPU
# ----------------------------------------------------------------------
def test_unstructured_path_rehearsal_matches_jax():
    n = 2048
    st = chip_smoke.unstructured_path(torch, tsp, "cpu", n=n, heavy_n=4096,
                                      sort_nblk=4)
    tp = st["c2"]["prep"]
    rows, cols, vals, x = chip_smoke.cfg2c_entries(n)
    ja, _ = build_both((n, n), rows, cols, vals)
    pj = j_prepare(ja)
    for f in FIELDS:
        want, got = np.asarray(getattr(pj, f)), tn(getattr(tp, f))
        if f == "vals":
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert st["c2"]["fill"] == n * 10 / (pj.n_batches * 1024)
    np.testing.assert_allclose(
        tn(st["shuffle"]["2c"]["y"]),
        np.asarray(j_spmv(pj, jnp.asarray(x), interpret=True)), **TOL)
