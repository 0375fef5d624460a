"""Parity of the port's RCM reordering (``core/reorder.py``), scipy interop
(``core/interop.py``) and NetCDF-4 container (``io/nc4.py``) with the JAX
package.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` and
``spsparse_torch``. RCM permutations, bandwidths, indices and counts must
match exactly; float64 values too (a permutation, a conversion and a file
round trip move values without arithmetic). NetCDF-4 files round-trip
through both packages in both directions; they need ``h5py``. The goldens
of ``tests/test_reorder.py``, ``tests/test_interop.py`` and the NetCDF-4
cases of ``tests/test_netcdf.py`` are cases here.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_tpu.core.interop import from_scipy as j_from_scipy
from spsparse_tpu.core.interop import to_scipy as j_to_scipy
from spsparse_tpu.io import load_netcdf as j_load, save_netcdf as j_save
from spsparse_torch.convert import coo_to_numpy, tensor_to_numpy
from spsparse_torch.io import load_netcdf as t_load, save_netcdf as t_save
from port_threads import one_torch_thread  # noqa: F401 (autouse)


def build_both(shape, idx, vals, cap=None):
    jb = jsp.CooBuilder(shape, dtype=np.float64)
    tb = tsp.CooBuilder(shape, dtype=np.float64)
    jb.add_many(idx, vals)
    tb.add_many(idx, vals)
    return jb.build(cap=cap), tb.build(cap=cap, device="cpu")


def scrambled_band(rng, n, band):
    """A symmetric band relabelled by a random permutation, as in
    tests/test_reorder.py. Returns (jax COO, torch COO, dense)."""
    A = np.zeros((n, n))
    for off in range(band + 1):
        v = rng.uniform(0.5, 1.5, n - off)
        A[np.arange(n - off), np.arange(off, n)] = v
        A[np.arange(off, n), np.arange(n - off)] = v
    p = rng.permutation(n)
    S = A[np.ix_(p, p)]
    ii, jj = np.nonzero(S)
    j, t = build_both((n, n), np.stack([ii, jj], 1), S[ii, jj])
    return j, t, S


def assert_same_coo(j, t):
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert (tn, tshape, torder) == (int(j.nnz), tuple(j.shape), j.sort_order)
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    np.testing.assert_array_equal(tv, np.asarray(j.vals))


def disconnected_both():
    """Two components {0,3,6} and {1,4}; node 2 with a self-loop; 5, 7, 8
    isolated (tests/test_reorder.py)."""
    pairs = [(0, 3), (3, 6), (1, 4), (2, 2)]
    idx = []
    for i, k in pairs:
        idx.append((i, k))
        if i != k:
            idx.append((k, i))
    return build_both((9, 9), np.array(idx), np.ones(len(idx)))


@pytest.mark.parametrize("case", ["band128", "band96", "disconnected",
                                  "empty", "duplicates"])
def test_rcm_matches_jax_exactly(case):
    rng = np.random.default_rng(11)
    if case == "band128":
        j, t, _ = scrambled_band(rng, 128, 3)
    elif case == "band96":
        j, t, _ = scrambled_band(rng, 96, 2)
    elif case == "disconnected":
        j, t = disconnected_both()
    elif case == "empty":
        j = jsp.CooBuilder((6, 6), dtype=np.float64).build(cap=4)
        t = tsp.CooBuilder((6, 6), dtype=np.float64).build(cap=4,
                                                           device="cpu")
    else:
        idx = np.stack([rng.integers(0, 40, 120), rng.integers(0, 40, 120)],
                       1)
        idx[60:90] = idx[:30]
        j, t = build_both((40, 40), idx, rng.uniform(-1, 1, 120))
    jp, tp = jsp.rcm_permutation(j), tsp.rcm_permutation(t)
    assert tp.dtype == jp.dtype == np.int64
    np.testing.assert_array_equal(tp, jp)
    assert sorted(tp.tolist()) == list(range(t.shape[0]))
    assert tsp.bandwidth(t) == jsp.bandwidth(j)


@pytest.mark.parametrize("case", ["band", "disconnected", "two_sided"])
def test_permute_and_bandwidth_match_jax(case):
    rng = np.random.default_rng(12)
    cperm = None
    if case == "band":
        j, t, S = scrambled_band(rng, 128, 3)
        perm = jsp.rcm_permutation(j)
    elif case == "disconnected":
        j, t = disconnected_both()
        S = tensor_to_numpy(t.to_dense())
        perm = jsp.rcm_permutation(j)
    else:
        j, t = build_both((4, 6), np.array([[1, 5], [3, 0]]),
                          np.array([2.0, 1.0]), cap=8)
        S = tensor_to_numpy(t.to_dense())
        perm, cperm = np.array([2, 0, 3, 1]), np.array([5, 4, 3, 2, 1, 0])
    jb = jsp.coo_permute(j, jnp.asarray(perm),
                         None if cperm is None else jnp.asarray(cperm))
    tb = tsp.coo_permute(t, torch.from_numpy(perm),
                         None if cperm is None else torch.from_numpy(cperm))
    assert_same_coo(jb, tb)
    cp = perm if cperm is None else cperm
    np.testing.assert_array_equal(tensor_to_numpy(tb.to_dense()),
                                  S[np.ix_(perm, cp)])
    assert tsp.bandwidth(tb) == jsp.bandwidth(jb)
    if case == "band":
        assert tsp.bandwidth(t) > 12 and tsp.bandwidth(tb) <= 9


def test_rcm_spmv_commutes_and_validation():
    rng = np.random.default_rng(13)
    _, t, S = scrambled_band(rng, 64, 2)
    perm = tsp.rcm_permutation(t)
    B = tsp.coo_permute(t, perm).consolidate((0, 1))
    x = rng.uniform(-1, 1, 64)
    y = tensor_to_numpy(tsp.ops.spmv(tsp.to_csr(B), torch.from_numpy(x[perm])))
    np.testing.assert_allclose(y, (S @ x)[perm], rtol=1e-12)
    v = tsp.SparseCOO.from_arrays([[0]], [1.0], (4,), device="cpu")
    with pytest.raises(tsp.SpSparseError):
        tsp.rcm_permutation(v)
    with pytest.raises(tsp.SpSparseError):
        tsp.bandwidth(v)
    with pytest.raises(tsp.SpSparseError):
        tsp.coo_permute(t, torch.arange(5))


# ----------------------------------------------------------------------
# scipy interop
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["csr", "coo", "csc"])
def test_scipy_interop_matches_jax(fmt):
    M = sps.random(12, 9, density=0.2, random_state=0, format=fmt)
    j, t = j_from_scipy(M), tsp.core.from_scipy(M, device="cpu")
    assert_same_coo(j, t)
    assert t.cap == j.cap
    np.testing.assert_array_equal(tensor_to_numpy(t.to_dense()), M.toarray())
    jm, tm = j_to_scipy(j), tsp.core.to_scipy(t)
    assert tm.dtype == jm.dtype and tm.shape == jm.shape
    np.testing.assert_array_equal(tm.row, jm.row)
    np.testing.assert_array_equal(tm.col, jm.col)
    np.testing.assert_array_equal(tm.data, jm.data)
    back = tsp.core.from_scipy(tm, cap=t.cap, device="cpu")
    assert_same_coo(j, back)


def test_scipy_interop_f32_and_rank_guard():
    M = sps.random(7, 5, density=0.4, random_state=1, format="coo",
                   dtype=np.float32)
    t = tsp.core.from_scipy(M, device="cpu")
    assert t.dtype == torch.float32
    assert tsp.core.to_scipy(t).dtype == j_to_scipy(j_from_scipy(M)).dtype
    t64 = tsp.core.from_scipy(M, dtype=np.float64, device="cpu")
    assert t64.dtype == torch.float64
    v = tsp.SparseCOO.from_arrays([[0]], [1.0], (4,), device="cpu")
    with pytest.raises(tsp.SpSparseError, match="rank-2"):
        tsp.core.to_scipy(v)


# ----------------------------------------------------------------------
# NetCDF-4 (HDF5) through h5py
# ----------------------------------------------------------------------
def example_both():
    """The 5 x 6 array of tests/test_netcdf.py's examples, with a
    duplicate, in both packages."""
    idx = np.array([[0, 1], [2, 3], [4, 5], [2, 3], [1, 0]])
    return build_both((5, 6), idx, np.array([1.5, -2.0, 3.25, 4.0, 0.5]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_nc4_round_trip_both_directions(writer, tmp_path):
    j, t = example_both()
    path = str(tmp_path / "sp4.nc")
    if writer == "jax":
        j_save(path, {"A": j, "E": jsp.CooBuilder((3, 3)).build()}, version=4)
    else:
        t_save(path, {"A": t, "E": tsp.CooBuilder((3, 3)).build(
            device="cpu")}, version=4)
    assert tsp.io.is_hdf5(path) and jsp.io.is_hdf5(path)
    want = t.to_lists()
    jl = j_load(path, "A", rank=2)
    tl = t_load(path, "A", rank=2, device="cpu")
    assert jl.to_lists() == want and tl.to_lists() == want
    assert tl.shape == jl.shape == (5, 6) and tl.cap == jl.cap
    assert tl.dtype == torch.float64
    assert t_load(path, "E", device="cpu").nnz == 0
    # The stub dimensions are not read back as variables.
    names = {v.name for v in tsp.io.read_nc4(path).vars}
    assert "A.size" not in names and "A.rank" not in names
    assert {"A.info", "A.indices", "A.vals"} <= names


def test_nc4_foreign_file_and_ncio(tmp_path):
    import h5py
    path = str(tmp_path / "foreign.nc")
    with h5py.File(path, "w") as f:
        for dname, size in (("A.size", 2), ("A.rank", 2)):
            ds = f.create_dataset(dname, shape=(size,), dtype=np.float32)
            ds.attrs["CLASS"] = np.bytes_(b"DIMENSION_SCALE")
            ds.attrs["NAME"] = np.bytes_(
                b"This is a netCDF dimension but not a netCDF variable.")
            ds.make_scale(dname)
        iv = f.create_dataset("A.indices",
                              data=np.array([[0, 1], [3, 4]], np.int64))
        iv.dims[0].attach_scale(f["A.size"])
        iv.dims[1].attach_scale(f["A.rank"])
        vv = f.create_dataset("A.vals", data=np.array([7.5, 8.5]))
        vv.dims[0].attach_scale(f["A.size"])
        info = f.create_dataset("A.info", data=np.int64(0))
        info.attrs["shape"] = np.array([5, 6], np.uint64)
    B = t_load(path, "A", rank=2, device="cpu")
    assert B.shape == (5, 6)
    assert B.to_lists() == ([(0, 1), (3, 4)], [7.5, 8.5])
    assert B.to_lists() == j_load(path, "A", rank=2).to_lists()
    _, t = example_both()
    p4, p5 = str(tmp_path / "v4.nc"), str(tmp_path / "v5.nc")
    t_save(p4, {"A": t}, version=4)
    t_save(p5, {"A": t}, version=5)
    for p in (p4, p5):
        ncio = tsp.io.NcIO(p, "r", device="cpu")
        tsp.io.ncio_spsparse(ncio, None, True, "A", rank=2)
        assert ncio.flush()["A"].to_lists() == t.to_lists()


def test_chip_smoke_core_path_rehearsal():
    """``chip_smoke.core_path`` at 1024 rows on the CPU (plain kernel
    versions): every phase's checks against scipy and numpy run, and RCM
    takes the scrambled band back to its 11 diagonals."""
    import chip_smoke

    st = chip_smoke.core_path(torch, tsp, "cpu", n=1024, kron_n=16,
                              slice_m=256, r3_nnz=5000, n_query=2000)
    ro = st["reorder"]
    assert ro["bw_scrambled"] > 1000 and ro["bw"] == 5 and ro["diags"] == 11
    assert set(st["wall_s"]) == {"C1", "C2", "C3", "C4", "C5"}
