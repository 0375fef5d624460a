"""Parity of the port's constructors (``core/construct.py``) and elementwise
algebra (``core/algebra.py``) with the JAX package.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` and
``spsparse_torch``; containers are compared field for field, padding and
capacity included. Indices, counts and ``coo_random``'s entries must match
exactly; float64 values within rtol 1e-12, float32 within rtol 1e-6. The
goldens of ``tests/test_construct.py`` and ``tests/test_algebra.py`` are
cases here.

The JAX package compiles its consolidate once per capacity, rank and
dtype, and that compile, not the port, is what these tests would otherwise
spend their time on. So every operand that reaches the JAX consolidate has
shape (9, 11) and float64, and capacity 32, or 16 where two of them are
concatenated first (``coo_add``, ``coo_kronsum``) into capacity 32.
"""

import math

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_torch.convert import coo_to_numpy, tensor_to_numpy
from port_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (9, 11)
RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-6}


def build_both(shape, idx, vals, dtype=np.float64):
    jb = jsp.CooBuilder(shape, dtype=dtype)
    tb = tsp.CooBuilder(shape, dtype=dtype)
    if len(vals):
        jb.add_many(idx, vals)
        tb.add_many(idx, vals)
    return jb.build(), tb.build(device="cpu")


def rand_both(rng, shape=SHAPE, nnz=24, dtype=np.float64):
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], 1)
    return build_both(shape, idx, rng.uniform(-1, 1, nnz), dtype)


def assert_same(j, t, *, exact=False):
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert (tn, tshape, torder) == (int(j.nnz), tuple(j.shape), j.sort_order)
    assert t.cap == j.cap
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    jv = np.asarray(j.vals)
    assert tv.dtype == jv.dtype
    if exact:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=RTOL[jv.dtype], atol=0,
                                   equal_nan=True)


def dense(t):
    return tensor_to_numpy(t.to_dense())


# ----------------------------------------------------------------------
# Constructors
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,m,k", [(5, None, 0), (5, 8, 2), (6, 4, -3),
                                   (3, 3, 5)])
def test_eye_matches_jax(n, m, k):
    j, t = jsp.coo_eye(n, m, k), tsp.coo_eye(n, m, k, device="cpu")
    assert_same(j, t, exact=True)
    if k < 5:
        np.testing.assert_array_equal(dense(t), sps.eye(n, m, k=k).toarray())


@pytest.mark.parametrize("case", ["arrays", "scalars"])
def test_diags_matches_jax(case):
    rng = np.random.default_rng(1)
    if case == "arrays":
        shape, offs = (7, 9), [-2, 0, 3]
        diags = [rng.uniform(-1, 1, min(7, 9 - o) - max(0, -o)) for o in offs]
    else:
        shape, offs, diags = (4, 4), [0, 1], [2.0, -1.0]
    j = jsp.coo_diags(diags, offs, shape, dtype=np.float64)
    t = tsp.coo_diags(diags, offs, shape, dtype=np.float64, device="cpu")
    assert_same(j, t, exact=True)
    if case == "scalars":
        np.testing.assert_array_equal(
            dense(t), 2 * np.eye(4) + np.diag([-1.0] * 3, 1))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_random_matches_jax(dtype):
    # 30 draws in (9, 11): cap 32, the capacity the other tests compile.
    j = jsp.coo_random(SHAPE, 0.3, seed=3, dtype=dtype)
    t = tsp.coo_random(SHAPE, 0.3, seed=3, dtype=dtype, device="cpu")
    assert_same(j, t, exact=True)
    assert t.sort_order == (0, 1)


@pytest.mark.parametrize("which", ["matrix", "rank3", "clamped"])
def test_slice_matches_jax(which):
    rng = np.random.default_rng(2)
    if which == "rank3":
        j, t = rand_both(rng, (6, 7, 8), 24)
        lo, hi = (1, 0, 2), (5, 7, 8)
    else:
        j, t = rand_both(rng)
        lo, hi = ((3, 5), (8, 10)) if which == "matrix" else ((0, 0), (99, 99))
    js, ts = jsp.coo_slice(j, lo, hi), tsp.coo_slice(t, lo, hi)
    assert_same(js, ts, exact=True)
    sl = tuple(slice(a, b) for a, b in zip(lo, hi))
    np.testing.assert_array_equal(dense(ts), dense(t)[sl])


def test_slice_bad_bounds_raise():
    _, t = rand_both(np.random.default_rng(2))
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_slice(t, (3,), (4,))
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_slice(t, (4, 0), (2, 5))


@pytest.mark.parametrize("which", ["kron", "kron_empty", "kron_f32",
                                   "kronsum"])
def test_kron_matches_jax(which):
    rng = np.random.default_rng(4)
    dt = np.float32 if which == "kron_f32" else np.float64
    ja, ta = rand_both(rng, (4, 5), 8, dt)
    jb, tb = rand_both(rng, (3, 2), 4, dt)
    if which == "kron_empty":
        jb, tb = build_both((2, 2), np.zeros((0, 2), int), [])
    if which == "kronsum":
        # kron(I3, A) 12 entries and kron(B, I4) 16: capacity 16 each.
        ja, ta = rand_both(rng, (4, 4), 4)
        jb, tb = rand_both(rng, (3, 3), 4)
        j, t = jsp.coo_kronsum(ja, jb), tsp.coo_kronsum(ta, tb)
        ref = sps.kronsum(sps.csr_matrix(dense(ta)), sps.csr_matrix(dense(tb)))
    else:
        j, t = jsp.coo_kron(ja, jb), tsp.coo_kron(ta, tb)
        ref = sps.kron(sps.coo_matrix(dense(ta)), sps.coo_matrix(dense(tb)))
    assert_same(j, t, exact=which != "kronsum")
    np.testing.assert_allclose(dense(t), ref.toarray(), rtol=RTOL[
        np.dtype(dt)], atol=1e-15)


def test_kronsum_laplacian_and_rejects_rectangular():
    n = 5
    T = tsp.coo_diags([2.0, -1.0, -1.0], [0, 1, -1], (n, n),
                      dtype=np.float64, device="cpu")
    d = dense(tsp.coo_kronsum(T, T))
    np.testing.assert_allclose(np.diag(d), 4.0)
    np.testing.assert_allclose(d.sum(axis=1)[12], 0.0, atol=1e-12)
    A = tsp.SparseCOO.from_arrays(np.array([[0, 1]]), np.array([1.0]),
                                  (2, 3), device="cpu")
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_kronsum(A, A)


def test_row_col_sums_and_scaling_match_jax():
    rng = np.random.default_rng(5)
    j, t = rand_both(rng)
    for jf, tf in ((jsp.row_sums, tsp.row_sums), (jsp.col_sums, tsp.col_sums)):
        np.testing.assert_allclose(tensor_to_numpy(tf(t)), np.asarray(jf(j)),
                                   rtol=1e-12, atol=1e-15)
    sr, sc = rng.uniform(-2, 2, SHAPE[0]), rng.uniform(-2, 2, SHAPE[1])
    js = jsp.scale_cols(jsp.scale_rows(j.consolidate((0, 1)),
                                       jnp.asarray(sr)), jnp.asarray(sc))
    ts = tsp.scale_cols(tsp.scale_rows(t.consolidate((0, 1)),
                                       torch.from_numpy(sr)),
                        torch.from_numpy(sc))
    assert_same(js, ts)
    np.testing.assert_allclose(dense(ts), np.diag(sr) @ dense(t) @ np.diag(sc),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("ord", ["fro", 1, math.inf, "max"])
def test_norm_matches_jax(ord):
    rng = np.random.default_rng(6)
    j, t = rand_both(rng)
    j, t = j.consolidate((0, 1)), t.consolidate((0, 1))
    got = float(tsp.coo_norm(t, ord))
    np.testing.assert_allclose(got, float(jsp.coo_norm(j, ord)), rtol=1e-12)
    d = np.abs(dense(t))
    want = {"fro": np.sqrt((d * d).sum()), 1: d.sum(0).max(),
            math.inf: d.sum(1).max(), "max": d.max()}[ord]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_norm_golden_and_errors():
    t = tsp.SparseCOO.from_arrays([[1, 2]], [-3.0], (3, 3), device="cpu")
    assert float(tsp.coo_norm(t)) == 3.0
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_norm(t, 2)


@pytest.mark.parametrize("k", [-3, -1, 0, 1, 4])
def test_tril_triu_match_jax(k):
    rng = np.random.default_rng(7)
    j, t = rand_both(rng)
    for jf, tf in ((jsp.coo_tril, tsp.coo_tril), (jsp.coo_triu, tsp.coo_triu)):
        assert_same(jf(j, k), tf(t, k), exact=True)
    lo, hi = dense(tsp.coo_tril(t, k)), dense(tsp.coo_triu(t, k + 1))
    np.testing.assert_array_equal(lo, sps.tril(dense(t), k).toarray())
    np.testing.assert_array_equal(lo + hi, dense(t))


def test_filter_matches_jax_and_keeps_order():
    rng = np.random.default_rng(8)
    j, t = rand_both(rng)
    j, t = j.consolidate((0, 1)), t.consolidate((0, 1))
    jk = jsp.coo_filter(j, lambda idx, vals: jnp.abs(vals) > 0.5)
    tk = tsp.coo_filter(t, lambda idx, vals: vals.abs() > 0.5)
    assert_same(jk, tk, exact=True)
    assert tk.sort_order == t.sort_order
    none = tsp.coo_filter(t, lambda idx, vals: torch.zeros(idx.shape[0],
                                                           dtype=torch.bool))
    assert none.nnz == 0
    assert (tensor_to_numpy(none.indices) == np.asarray(SHAPE)).all()
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_tril(tsp.SparseCOO.from_arrays([[1]], [1.0], (9,),
                                               device="cpu"))


# ----------------------------------------------------------------------
# Algebra
# ----------------------------------------------------------------------
def test_concat_matches_jax():
    rng = np.random.default_rng(10)
    (ja, ta), (jb, tb) = rand_both(rng, nnz=16), rand_both(rng, nnz=12)
    assert_same(jsp.coo_concat(ja, jb), tsp.coo_concat(ta, tb), exact=True)
    assert_same(jsp.coo_concat(ja, jb, ja, cap=48),
                tsp.coo_concat(ta, tb, ta, cap=48), exact=True)
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_concat(ta, tb, cap=27)
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_concat(ta, tsp.coo_eye(3, device="cpu"))


@pytest.mark.parametrize("policy", ["ADD", "LEAVE_ALONE", "REPLACE"])
def test_add_matches_jax(policy):
    rng = np.random.default_rng(11)
    (ja, ta), (jb, tb) = rand_both(rng, nnz=16), rand_both(rng, nnz=14)
    j = jsp.coo_add(ja, jb, alpha=2.5, beta=-0.5,
                    duplicate_policy=getattr(jsp.DuplicatePolicy, policy))
    t = tsp.coo_add(ta, tb, alpha=2.5, beta=-0.5,
                    duplicate_policy=tsp.DuplicatePolicy[policy])
    assert_same(j, t)
    if policy == "ADD":
        np.testing.assert_allclose(dense(t), 2.5 * dense(ta) - 0.5 * dense(tb),
                                   rtol=1e-12, atol=1e-15)


def test_add_goldens():
    a = tsp.CooBuilder((3, 3), dtype=np.float64)
    a.add((1, 1), 2.0)
    a.add((0, 2), 1.0)
    b = tsp.CooBuilder((3, 3), dtype=np.float64)
    b.add((1, 1), -2.0)
    C = tsp.coo_add(a.build(device="cpu"), b.build(device="cpu"))
    assert C.to_lists() == ([(0, 2), (1, 1)], [1.0, 0.0])
    assert tsp.consolidate(C, (0, 1)).to_lists() == ([(0, 2)], [1.0])
    a = tsp.SparseCOO.from_arrays([[0, 0], [1, 1]], [1.0, 3.0], (2, 2),
                                  device="cpu")
    b = tsp.SparseCOO.from_arrays([[0, 0]], [9.0], (2, 2), device="cpu")
    first = dense(tsp.coo_add(a, b, duplicate_policy=tsp.DuplicatePolicy
                              .LEAVE_ALONE))
    last = dense(tsp.coo_add(a, b, duplicate_policy=tsp.DuplicatePolicy
                             .REPLACE))
    assert (first[0, 0], last[0, 0], first[1, 1]) == (1.0, 9.0, 3.0)


def test_scale_and_power_match_jax():
    rng = np.random.default_rng(12)
    idx = np.stack([rng.integers(0, s, 24) for s in SHAPE], 1)
    # Positive values: fractional powers stay real.
    j, t = build_both(SHAPE, idx, rng.uniform(0.5, 1.5, 24))
    j, t = j.consolidate((0, 1)), t.consolidate((0, 1))
    assert_same(jsp.coo_scale(j, 0.1), tsp.coo_scale(t, 0.1))
    assert tsp.coo_scale(t, 0.1).sort_order == (0, 1)
    for p in (2, 3, 0.5, -1):
        tp = tsp.coo_power(t, p)
        assert_same(jsp.coo_power(j, p), tp)
        ref = sps.coo_matrix(dense(t)).power(p).toarray()
        np.testing.assert_allclose(dense(tp), ref, rtol=1e-12)
    with pytest.raises(tsp.SpSparseError, match="power"):
        tsp.coo_power(t, 0)


@pytest.mark.parametrize("op", ["multiply", "maximum", "minimum"])
@pytest.mark.parametrize("seed", range(2))
def test_binop_matches_jax(op, seed):
    rng = np.random.default_rng(20 + seed)
    ja, ta = rand_both(rng)
    # Half of B's entries sit on A's keys: the intersection is non-empty.
    ia = tensor_to_numpy(ta.indices)[:12]
    ib = np.concatenate([ia, np.stack([rng.integers(0, s, 12)
                                       for s in SHAPE], 1)])
    jb, tb = build_both(SHAPE, ib, rng.uniform(-1, 1, 24))
    j = getattr(jsp, f"coo_{op}")(ja, jb)
    t = getattr(tsp, f"coo_{op}")(ta, tb)
    assert_same(j, t)
    sa, sb = sps.csr_matrix(dense(ta)), sps.csr_matrix(dense(tb))
    np.testing.assert_allclose(dense(t), getattr(sa, op)(sb).toarray(),
                               rtol=1e-12)


@pytest.mark.parametrize("require_both", [False, True])
def test_binop_custom_function_matches_jax(require_both):
    # coo_binop itself, with a function of its caller's and exact zeros
    # kept: A - B over the union (or the intersection).
    rng = np.random.default_rng(22)
    ja, ta = rand_both(rng)
    ib = np.concatenate([tensor_to_numpy(ta.indices)[:12],
                         np.stack([rng.integers(0, s, 12) for s in SHAPE], 1)])
    jb, tb = build_both(SHAPE, ib, rng.uniform(-1, 1, 24))
    j = jsp.coo_binop(ja, jb, jnp.subtract, require_both=require_both,
                      drop_zeros=False)
    t = tsp.coo_binop(ta, tb, torch.sub, require_both=require_both,
                      drop_zeros=False)
    assert_same(j, t)


def test_binop_goldens():
    def mk(entries):
        idx = np.array([e[0] for e in entries])
        return tsp.SparseCOO.from_arrays(idx, [e[1] for e in entries],
                                         (3, 3), device="cpu")
    C = tsp.coo_multiply(mk([((1, 1), 2.0), ((1, 1), 3.0)]),
                         mk([((1, 1), 4.0), ((1, 1), -1.0)]))
    assert C.to_lists() == ([(1, 1)], [15.0])
    C = tsp.coo_multiply(mk([((0, 0), np.nan), ((1, 1), 2.0)]),
                         mk([((1, 1), 3.0)]))
    assert C.to_lists() == ([(1, 1)], [6.0])
    C = tsp.coo_maximum(mk([((0, 1), -1.0), ((1, 0), 4.0)]),
                        mk([((1, 0), 2.0)]))
    assert C.to_lists() == ([(1, 0)], [4.0])
    with pytest.raises(tsp.SpSparseError, match="shape"):
        tsp.coo_multiply(C, tsp.coo_eye(4, dtype=np.float64, device="cpu"))


def test_binop_rank3_union_golden():
    # Against the dense oracle of tests/test_algebra.py (a rank-3 JAX
    # consolidate would be one more compile for what the rank-2 cases
    # already hold against the JAX package).
    rng = np.random.default_rng(13)
    _, ta = rand_both(rng, (4, 5, 6), 18)
    _, tb = rand_both(rng, (4, 5, 6), 14)
    C = tsp.coo_maximum(ta, tb)
    np.testing.assert_allclose(dense(C), np.maximum(dense(ta), dense(tb)),
                               rtol=1e-12)
    assert C.sort_order == (0, 1, 2)


@pytest.mark.parametrize("which", ["hstack", "vstack", "block_diag"])
def test_stacking_matches_jax(which):
    rng = np.random.default_rng(14)
    ja, ta = rand_both(rng, (5, 7), 12)
    other = {"hstack": (5, 3), "vstack": (4, 7), "block_diag": (2, 2)}[which]
    jb, tb = rand_both(rng, other, 6)
    j = getattr(jsp, f"coo_{which}")(ja, jb, ja)
    t = getattr(tsp, f"coo_{which}")(ta, tb, ta)
    assert_same(j, t, exact=True)
    ref = getattr(sps, which)([sps.coo_matrix(dense(x)) for x in (ta, tb, ta)])
    np.testing.assert_array_equal(dense(t), ref.toarray())


def test_stacking_goldens_and_validation():
    b1 = tsp.SparseCOO.from_arrays([[0, 0], [0, 0]], [1.0, 2.0], (2, 2),
                                   device="cpu")
    b2 = tsp.SparseCOO.from_arrays([[0, 0]], [5.0], (1, 2), device="cpu")
    V = tsp.coo_vstack(b1, b2)
    assert V.nnz == 3
    d = dense(V.consolidate((0, 1), tsp.DuplicatePolicy.LEAVE_ALONE))
    assert d[0, 0] == 1.0 and d[2, 0] == 5.0
    rng = np.random.default_rng(15)
    _, A = rand_both(rng, (3, 4), 5)
    _, B = rand_both(rng, (2, 4), 5)
    _, C = rand_both(rng, (3, 5), 5)
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_hstack(A, B)
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_vstack()
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_vstack(A, C)
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_hstack(A, C, cap=3)
