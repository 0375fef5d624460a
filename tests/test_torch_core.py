"""Parity of the PyTorch port's core layer with the JAX package.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` and
``spsparse_torch``; containers are compared field for field (padding and
capacity included). Indices, counts and the reference goldens must match
exactly; float64 values within rtol 1e-12 (the JAX "compact" merge sums a
run as a tree, the port sequentially).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_torch.convert import coo_to_numpy, tensor_to_numpy

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ["ADD", "LEAVE_ALONE", "REPLACE"]


def build_both(shape, idx, vals, dtype=np.float64):
    jb = jsp.CooBuilder(shape, dtype=dtype)
    tb = tsp.CooBuilder(shape, dtype=dtype)
    if len(vals):
        jb.add_many(idx, vals)
        tb.add_many(idx, vals)
    return jb.build(), tb.build(device="cpu")


def random_entries(rng, shape, n, *, dup=True, zeros=True, nans=False):
    idx = np.stack([rng.integers(0, s, n) for s in shape], axis=1)
    if dup and n > 4:
        idx[n // 2:n // 2 + n // 4] = idx[:n // 4]
    vals = rng.uniform(-1, 1, n)
    if zeros:
        vals[rng.random(n) < 0.15] = 0.0
    if nans:
        vals[rng.random(n) < 0.1] = np.nan
    return idx, vals


def assert_same_coo(j, t, *, exact_vals=False, rtol=1e-12):
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert tn == int(j.nnz)
    assert tshape == tuple(j.shape)
    assert torder == j.sort_order
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    jv = np.asarray(j.vals)
    assert tv.dtype == jv.dtype
    if exact_vals:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=0,
                                   equal_nan=True)


# ----------------------------------------------------------------------
# The port imports neither JAX nor the JAX package
# ----------------------------------------------------------------------
PORT_FILES = sorted((ROOT / "spsparse_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "spsparse_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


# ----------------------------------------------------------------------
# Builder, bounds checks, caps and padding
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bad", [(17,), (-1,), (4,)])
def test_builder_add_bounds_raises(bad):
    b = tsp.CooBuilder((4,))
    with pytest.raises(tsp.SpSparseError):
        b.add(bad, 4.0)


@pytest.mark.parametrize("bad", [[[0, 5]], [[2, 0]], [[-1, 1]]])
def test_bounds_raise_in_both(bad):
    with pytest.raises(jsp.SpSparseError):
        jsp.SparseCOO.from_arrays(bad, [1.0], (2, 4))
    with pytest.raises(tsp.SpSparseError):
        tsp.SparseCOO.from_arrays(bad, [1.0], (2, 4), device="cpu")
    b = tsp.CooBuilder((2, 4))
    with pytest.raises(tsp.SpSparseError):
        b.add_many(np.asarray(bad), [1.0])


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 100])
def test_builder_caps_and_padding(n):
    rng = np.random.default_rng(n)
    idx, vals = random_entries(rng, (7, 9), n, zeros=False)
    j, t = build_both((7, 9), idx, vals)
    assert t.cap == j.cap
    assert_same_coo(j, t, exact_vals=True)
    grown_j, grown_t = j.with_capacity(2 * j.cap), t.with_capacity(2 * t.cap)
    assert_same_coo(grown_j, grown_t, exact_vals=True)
    np.testing.assert_array_equal(tensor_to_numpy(t.to_dense()),
                                  np.asarray(j.to_dense()))


def test_with_capacity_shrink_below_nnz_raises():
    t = tsp.SparseCOO.from_arrays([[0, 0], [1, 1]], [1.0, 2.0], (2, 2),
                                  device="cpu")
    with pytest.raises(tsp.SpSparseError):
        t.with_capacity(1)


def test_from_dense_matches():
    rng = np.random.default_rng(3)
    dense = np.where(rng.random((6, 5)) < 0.3, rng.uniform(-1, 1, (6, 5)), 0)
    assert_same_coo(jsp.SparseCOO.from_dense(dense),
                    tsp.SparseCOO.from_dense(dense, device="cpu"),
                    exact_vals=True)


def test_int64_indices_for_huge_extent():
    t = tsp.SparseCOO.from_arrays([[0, 2**31]], [1.0], (2, 2**31 + 1),
                                  cap=2, device="cpu")
    assert t.index_dtype == torch.int64
    assert t.indices[1].tolist() == [2, 2**31 + 1]


# ----------------------------------------------------------------------
# Reference goldens (test_array.cpp, as pinned in tests/test_core.py)
# ----------------------------------------------------------------------
ENTRIES = [((1, 3), 5.0), ((1, 2), 3.0), ((0, 3), 17.0), ((0, 1), 14.0),
           ((1, 2), 15.0)]


def golden_array(entries=ENTRIES, shape=(2, 4)):
    b = tsp.CooBuilder(shape, dtype=np.float64)
    for idx, v in entries:
        b.add(idx, v)
    return b.build(device="cpu")


@pytest.mark.parametrize("order,rows,cols,vals,begins", [
    ((0, 1), [0, 0, 1, 1], [1, 3, 2, 3], [14., 17., 18., 5.], [0, 2, 4]),
    ((1, 0), [0, 1, 0, 1], [1, 2, 3, 3], [14., 18., 17., 5.], [0, 1, 2, 4]),
])
def test_consolidate_goldens(order, rows, cols, vals, begins):
    c = tsp.consolidate(golden_array(), order)
    assert c.nnz == 4
    assert c.index(0)[:4].tolist() == rows
    assert c.index(1)[:4].tolist() == cols
    assert c.vals[:4].tolist() == vals
    assert tsp.dim_beginnings(c).to_list() == begins


@pytest.mark.parametrize("policy,vals", [
    ("LEAVE_ALONE", [14., 17., 3., 5.]), ("REPLACE", [14., 17., 15., 5.])])
def test_policy_goldens(policy, vals):
    c = tsp.consolidate(golden_array(), (0, 1),
                        tsp.DuplicatePolicy[policy])
    assert c.vals[:4].tolist() == vals


def test_zero_dropping_golden():
    arr = golden_array([((1,), 5.0), ((1,), 0.0), ((2,), 3.0), ((2,), -3.0),
                        ((3,), 0.0)], (4,))
    rep = tsp.consolidate(arr, (0,), tsp.DuplicatePolicy.REPLACE)
    assert rep.to_lists() == ([(1,), (2,)], [5.0, -3.0])
    add = tsp.consolidate(arr, (0,))
    assert add.to_lists() == ([(1,), (2,)], [5.0, 0.0])   # zero SUM kept


def test_zero_nan_golden():
    arr = golden_array([((0,), np.nan), ((1,), 5.0), ((1,), np.nan),
                        ((2,), np.nan)], (4,))
    idx, vals = tsp.consolidate(arr, (0,)).to_lists()
    assert idx == [(0,), (1,), (2,)] and np.isnan(vals).all()
    assert tsp.consolidate(arr, (0,), zero_nan=True).to_lists() == (
        [(1,)], [5.0])


def test_noop_when_sorted_and_empty():
    c = golden_array().consolidate((0, 1))
    assert c.consolidate((0, 1)) is c
    e = tsp.consolidate(tsp.SparseCOO.empty((3, 3), cap=8, device="cpu"),
                        (0, 1))
    assert e.nnz == 0 and e.sort_order == (0, 1) and e.cap == 8


@pytest.mark.parametrize("order,perm", [((0, 1), [2, 1, 0]),
                                        ((1, 0), [1, 2, 0])])
def test_sorted_permutation_goldens(order, perm):
    arr = golden_array(ENTRIES[:3])
    assert tsp.sorted_permutation(arr, order)[:3].tolist() == perm


def test_sorted_permutation_stability_golden():
    arr = golden_array(ENTRIES[:3] + [((1, 2), 15.0)])
    assert tsp.sorted_permutation(arr, (1, 0))[:4].tolist() == [1, 3, 2, 0]


def test_transposes():
    arr = golden_array()
    t = arr.transposed((1, 0))
    assert t.shape == (4, 2)
    torch.testing.assert_close(t.to_dense(), arr.to_dense().T)
    a1 = arr.transpose_indices_only((1, 0))
    assert a1.shape == (2, 4) and a1.sort_order is None
    assert a1.index(0)[:5].tolist() == [3, 2, 3, 1, 2]


# ----------------------------------------------------------------------
# consolidate parity with the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("zero_nan", [False, True])
@pytest.mark.parametrize("order", [(0, 1), (1, 0), (1,), None])
def test_consolidate_matches_jax(policy, zero_nan, order):
    rng = np.random.default_rng(
        [POLICIES.index(policy), int(zero_nan), *(order or (9,))])
    idx, vals = random_entries(rng, (9, 7), 48, nans=True)
    j, t = build_both((9, 7), idx, vals)
    pol = getattr(jsp.DuplicatePolicy, policy)
    jc = jsp.consolidate(j, order, pol, zero_nan)
    tc = tsp.consolidate(t, order, tsp.DuplicatePolicy[policy], zero_nan)
    assert_same_coo(jc, tc)


@pytest.mark.parametrize("order", [(2,), (1, 2), (2, 0, 1)])
def test_consolidate_rank3_partial_order_matches_jax(order):
    rng = np.random.default_rng(len(order))
    idx, vals = random_entries(rng, (4, 5, 3), 40)
    j, t = build_both((4, 5, 3), idx, vals)
    assert_same_coo(jsp.consolidate(j, order), tsp.consolidate(t, order))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consolidate_scatter_is_bitwise(seed):
    rng = np.random.default_rng(seed)
    idx, vals = random_entries(rng, (5, 5), 64, zeros=False)
    j, t = build_both((5, 5), idx, vals)
    assert_same_coo(jsp.consolidate(j, (0, 1), method="scatter"),
                    tsp.consolidate(t, (0, 1), method="scatter"),
                    exact_vals=True)


def test_consolidate_cap_and_float32():
    rng = np.random.default_rng(5)
    idx, vals = random_entries(rng, (6, 6), 30)
    j, t = build_both((6, 6), idx, vals, dtype=np.float32)
    assert_same_coo(jsp.consolidate(j, (0, 1), cap=64),
                    tsp.consolidate(t, (0, 1), cap=64), rtol=1e-6)


def test_filter_compact_matches_jax():
    rng = np.random.default_rng(6)
    idx, vals = random_entries(rng, (6, 6), 20, zeros=False)
    j, t = build_both((6, 6), idx, vals)
    keep = rng.random(j.cap) < 0.5
    assert_same_coo(jsp.filter_compact(j, keep, cap=16),
                    tsp.filter_compact(t, keep, cap=16), exact_vals=True)


# ----------------------------------------------------------------------
# Structure views
# ----------------------------------------------------------------------
def test_dim_beginnings_present_rows_golden():
    arr = golden_array([((1, 0), 15.0), ((1, 3), 17.0), ((2, 4), 17.0),
                        ((6, 4), 10.0)], (20, 10))
    db = tsp.dim_beginnings(tsp.consolidate(arr, (0, 1)))
    assert db.rows_to_list() == [1, 2, 6]
    assert db.to_list() == [0, 2, 3, 4]


def test_dim_beginnings_unsorted_raises():
    with pytest.raises(tsp.SpSparseError):
        tsp.dim_beginnings(golden_array())


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_dim_beginnings_matches_jax(order):
    rng = np.random.default_rng(7)
    idx, vals = random_entries(rng, (12, 8), 30, zeros=False)
    j, t = build_both((12, 8), idx, vals)
    jd = jsp.dim_beginnings(jsp.consolidate(j, order))
    td = tsp.dim_beginnings(tsp.consolidate(t, order))
    assert td.to_list() == jd.to_list()
    assert td.rows_to_list() == jd.rows_to_list()
    assert td.n_rows == int(jd.n_rows) and td.dim == jd.dim


@pytest.mark.parametrize("transpose", [False, True])
def test_to_csr_matches_jax(transpose):
    rng = np.random.default_rng(8)
    idx, vals = random_entries(rng, (10, 6), 25)
    j, t = build_both((10, 6), idx, vals)
    jc = jsp.to_csr(j, transpose=transpose)
    tc = tsp.to_csr(t, transpose=transpose)
    for field in ("row_ptr", "cols", "vals"):
        np.testing.assert_array_equal(tensor_to_numpy(getattr(tc, field)),
                                      np.asarray(getattr(jc, field)))
    assert tc.nnz == int(jc.nnz) and tc.shape == jc.shape
    np.testing.assert_array_equal(tensor_to_numpy(tc.row_ids()),
                                  np.asarray(jc.row_ids()))
    assert_same_coo(jc.to_coo(), tc.to_coo(), exact_vals=True)
    csc = tsp.to_csc(t)
    np.testing.assert_array_equal(tensor_to_numpy(csc.to_dense()),
                                  np.asarray(j.to_dense()).T)


@pytest.mark.parametrize("max_row_nnz", [None, 2])
def test_to_ell_matches_jax(max_row_nnz):
    rng = np.random.default_rng(9)
    idx, vals = random_entries(rng, (8, 6), 20, zeros=False)
    j, t = build_both((8, 6), idx, vals)
    je, te = jsp.to_ell(j, max_row_nnz), tsp.to_ell(t, max_row_nnz)
    np.testing.assert_array_equal(tensor_to_numpy(te.cols),
                                  np.asarray(je.cols))
    np.testing.assert_array_equal(tensor_to_numpy(te.vals),
                                  np.asarray(je.vals))
    np.testing.assert_array_equal(tensor_to_numpy(te.to_dense()),
                                  np.asarray(je.to_dense()))
    assert te.to_coo().to_lists() == je.to_coo().to_lists()


@pytest.mark.parametrize("offsets", [None, (-4, -1, 0, 1, 2, 3, 5)])
def test_to_dia_and_back_match_jax(offsets):
    rng = np.random.default_rng(10)
    n = 9
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip(rows + rng.choice([-1, 0, 2], rows.size), 0, n - 1)
    vals = rng.uniform(-1, 1, rows.size)
    j, t = build_both((n, n), np.stack([rows, cols], 1), vals)
    jd, td = jsp.to_dia(j, offsets), tsp.to_dia(t, offsets)
    assert td.offsets == jd.offsets and td.shape == jd.shape
    np.testing.assert_allclose(tensor_to_numpy(td.data), np.asarray(jd.data),
                               rtol=1e-12)
    np.testing.assert_allclose(tensor_to_numpy(td.to_dense()),
                               np.asarray(jd.to_dense()), rtol=1e-12)
    assert_same_coo(jsp.core.dia.dia_to_coo(jd), tsp.core.dia_to_coo(td))


def test_to_dia_off_band_raises():
    t = tsp.SparseCOO.from_arrays([[0, 3]], [1.0], (4, 4), device="cpu")
    with pytest.raises(ValueError):
        tsp.to_dia(t, (0, 1))


# ----------------------------------------------------------------------
# Generic sparse x dense products (ops/spmm.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["coo", "csr", "csc", "ell"])
@pytest.mark.parametrize("rhs", ["vector", "block"])
def test_spmv_spmm_match_jax(fmt, rhs):
    from spsparse_tpu.ops import spmm as j_spmm
    from spsparse_torch.ops import spmm as t_spmm

    rng = np.random.default_rng([len(fmt), len(rhs)])
    idx, vals = random_entries(rng, (9, 7), 30)
    j, t = build_both((9, 7), idx, vals)
    ncols = 9 if fmt == "csc" else 7
    X = rng.uniform(-1, 1, (ncols,) if rhs == "vector" else (ncols, 3))
    X[0] = np.nan                      # filter_nan treats it as zero
    conv = {"coo": lambda pkg, a: a, "csr": lambda pkg, a: pkg.to_csr(a),
            "csc": lambda pkg, a: pkg.to_csc(a),
            "ell": lambda pkg, a: pkg.to_ell(a)}[fmt]
    y_j = np.asarray(j_spmm(conv(jsp, j), X, filter_nan=True))
    y_t = tensor_to_numpy(t_spmm(conv(tsp, t), torch.from_numpy(X),
                                 filter_nan=True))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-15)
    assert np.isfinite(y_t).all()


@pytest.mark.parametrize("rhs_shape", [(7,), (7, 2)])
def test_matmul_with_dense_operand(rhs_shape):
    rng = np.random.default_rng(len(rhs_shape))
    idx, vals = random_entries(rng, (9, 7), 30)
    _, t = build_both((9, 7), idx, vals)
    X = rng.uniform(-1, 1, rhs_shape)
    np.testing.assert_allclose(tensor_to_numpy(t @ torch.from_numpy(X)),
                               tensor_to_numpy(t.to_dense()) @ X, rtol=1e-12)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t @ t


# ----------------------------------------------------------------------
# Constructors from host data default to the card
# ----------------------------------------------------------------------
def test_default_device_is_cuda():
    assert tsp.default_device() == torch.device("cuda")


def _host_constructors(tmp_path):
    from spsparse_torch.convert import dia_from_numpy, tensor_from_numpy
    from spsparse_torch.core.coo import as_tensor
    from spsparse_torch.io import load_netcdf, save_netcdf

    b = tsp.CooBuilder((3, 3))
    b.add((0, 1), 2.0)
    path = str(tmp_path / "a.nc")
    save_netcdf(path, {"A": b.build(device="cpu")})
    return {
        "build": lambda **kw: b.build(**kw),
        "from_arrays": lambda **kw: tsp.SparseCOO.from_arrays(
            [[0, 1]], [2.0], (3, 3), **kw),
        "from_dense": lambda **kw: tsp.SparseCOO.from_dense(np.eye(3), **kw),
        "empty": lambda **kw: tsp.SparseCOO.empty((3, 3), 4, **kw),
        "sentinel_index": lambda **kw: tsp.SparseCOO.sentinel_index(
            (3, 3), **kw),
        "as_tensor": lambda **kw: as_tensor([1.0, 2.0], **kw),
        "tensor_from_numpy": lambda **kw: tensor_from_numpy(np.ones(3), **kw),
        "dia_from_numpy": lambda **kw: dia_from_numpy(
            np.ones((1, 3), np.float32), (0,), (3, 3), **kw),
        "load_netcdf": lambda **kw: load_netcdf(path, "A", **kw),
    }


HOST_CONSTRUCTORS = ["build", "from_arrays", "from_dense", "empty",
                     "sentinel_index", "as_tensor", "tensor_from_numpy",
                     "dia_from_numpy", "load_netcdf"]


@pytest.mark.parametrize("ctor", HOST_CONSTRUCTORS)
def test_host_constructor_without_device_raises_without_cuda(ctor, tmp_path):
    fn = _host_constructors(tmp_path)[ctor]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


@pytest.mark.parametrize("ctor", HOST_CONSTRUCTORS)
def test_host_constructor_with_device_cpu(ctor, tmp_path):
    out = _host_constructors(tmp_path)[ctor](device="cpu")
    tensors = [out] if isinstance(out, torch.Tensor) else [
        getattr(out, f) for f in ("indices", "vals", "data")
        if hasattr(out, f)]
    assert all(t.device.type == "cpu" for t in tensors)


def test_tensors_stay_and_ops_follow_their_operand():
    a = tsp.SparseCOO.from_arrays(torch.tensor([[0, 1], [2, 2]]),
                                  torch.tensor([2.0, 3.0]), (3, 3))
    assert a.device.type == "cpu"
    y = a @ [1.0, 1.0, 1.0]              # host x follows the operand
    assert y.device.type == "cpu" and y.tolist() == [2.0, 0.0, 3.0]
    from spsparse_torch.ops import spmv_dia
    d = tsp.to_dia(a)
    assert spmv_dia(d, [1.0, 1.0, 1.0]).device.type == "cpu"
