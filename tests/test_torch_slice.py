"""The port's main path end to end against the JAX package, at small size.

build (twice-added entries) → consolidate → scaled multiply / multiply_mv →
to_dia → best_spmv → DIA chain → NetCDF, with the same seeded numpy inputs
through both packages; files written by either package load in the other.
Tolerances: indices and counts exact; float32 products rtol 1e-6 (sums of
a few products in another order); SpMV rtol/atol 2e-5; the 3-step chain
rtol 1e-4 / atol 1e-6.

The JAX package's consolidate and multiply chain run under ``jax.jit``
(``port_refs``): eagerly they compiled every primitive anew at these
shapes (36 s of set-up on one CPU worker; jitted, 6 s). Their capacities
are the eager calls' (``tests/test_torch_multiply.py`` holds the jitted
chain to the eager call).
"""

import numpy as np
import pytest
import torch

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_tpu.io import load_netcdf as j_load, save_netcdf as j_save
from spsparse_tpu.ops import best_spmv as j_best_spmv
from spsparse_tpu.ops.pallas_dia_chain import spmv_dia_chain_pallas
from spsparse_torch.convert import coo_to_numpy, tensor_to_numpy
from spsparse_torch.io import load_netcdf as t_load, save_netcdf as t_save
from spsparse_torch.ops import (best_spmv as t_best_spmv, multiply as
                                t_multiply, multiply_mv as t_mv,
                                spmv_dia_chain)
from port_threads import one_torch_thread  # noqa: F401 (autouse)
import port_refs as refs

N, BAND = 512, 3


def banded_entries(n=N, band=BAND, seed=0):
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    vals = np.where(valid, rng.uniform(-1, 1, (n, 2 * band + 1)),
                    0).astype(np.float32)
    rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)
    return np.stack([rows[valid], cols[valid]], 1), vals[valid]


def build(pkg, shape, idx, vals, times=1):
    b = pkg.CooBuilder(shape, dtype=np.float32)
    for _ in range(times):
        b.add_many(idx, vals)
    return b.build(device="cpu") if pkg is tsp else b.build()


def assert_same(j, t, rtol=1e-6):
    """Exact indices; values within ``rtol`` plus ``rtol * max|value|``
    (float32 sums that cancel lose relative accuracy near zero)."""
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert tn == int(j.nnz) and tshape == tuple(j.shape)
    assert torder == j.sort_order
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    jv = np.asarray(j.vals)
    np.testing.assert_allclose(tv, jv, rtol=rtol,
                               atol=rtol * float(np.abs(jv).max(initial=0)))


@pytest.fixture(scope="module")
def slice_run():
    """Run the whole slice once in each package."""
    idx, vals = banded_entries()
    rng = np.random.default_rng(2)
    si, sj, sk, v = (rng.uniform(0.5, 1.5, N).astype(np.float32)
                     for _ in range(4))
    x = np.random.default_rng(1).uniform(-1, 1, N).astype(np.float32)
    out = {"vals": vals, "x": x}
    for name, pkg, mult, mv, con in (
            ("jax", jsp, refs.multiply, refs.multiply_mv,
             refs.jit(jsp.consolidate)),
            ("torch", tsp, t_multiply, t_mv, tsp.consolidate)):
        A = con(build(pkg, (N, N), idx, vals, times=2))
        S = [build(pkg, (N,), np.arange(N)[:, None], s)
             for s in (si, sj, sk, v)]
        out[name] = {
            "A": A,
            "P": mult(0.5, A, A, scalei=S[0], scalej=S[1], scalek=S[2]),
            "y": mv(0.5, A, S[3], scalei=S[0], scalej=S[1]),
            "dia": pkg.to_dia(A),
        }
    return out


def test_consolidated_doubles_every_entry(slice_run):
    j, t = slice_run["jax"]["A"], slice_run["torch"]["A"]
    assert t.nnz == int(j.nnz) == len(slice_run["vals"])
    np.testing.assert_array_equal(tensor_to_numpy(t.vals)[: t.nnz],
                                  2 * slice_run["vals"])
    assert_same(j, t, rtol=0)


@pytest.mark.parametrize("product", ["P", "y"])
def test_multiply_chain_matches(slice_run, product):
    assert_same(slice_run["jax"][product], slice_run["torch"][product])


def test_dia_spmv_and_chain_match(slice_run):
    jd, td = slice_run["jax"]["dia"], slice_run["torch"]["dia"]
    assert td.offsets == jd.offsets
    np.testing.assert_array_equal(tensor_to_numpy(td.data),
                                  np.asarray(jd.data))
    x = slice_run["x"]
    np.testing.assert_allclose(
        tensor_to_numpy(t_best_spmv(td, torch.from_numpy(x))),
        np.asarray(j_best_spmv(jd, x)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tensor_to_numpy(spmv_dia_chain(td, torch.from_numpy(x), 3, 0.3)),
        np.asarray(spmv_dia_chain_pallas(jd, x, iters=3, scale=0.3,
                                         block=128, interpret=True)),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_netcdf_files_cross_load(slice_run, writer, tmp_path):
    path = str(tmp_path / "product.nc")
    P = slice_run[writer]["P"]
    (j_save if writer == "jax" else t_save)(path, {"P": P, "A": slice_run[
        writer]["A"]})
    for name in ("P", "A"):
        want = slice_run[writer][name].to_lists()
        jl = j_load(path, name, rank=2, dtype=np.float32)
        tl = t_load(path, name, rank=2, dtype=np.float32, device="cpu")
        assert jl.to_lists() == want
        assert tl.to_lists() == want
        assert tl.shape == jl.shape and tl.cap == jl.cap


def test_netcdf_hdf5_raises_not_ported(tmp_path):
    """A truncated HDF5 file raises ``OSError`` in both packages alike.

    The name dates from before NetCDF-4 was ported, when the port raised
    ``NotImplementedError`` here; now the file reaches h5py in both
    (``tests/test_torch_reorder_io.py`` holds the NetCDF-4 round trips)."""
    path = tmp_path / "x.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(OSError):
        j_load(str(path), "A")
    with pytest.raises(OSError):
        t_load(str(path), "A", device="cpu")
