"""Parity of the port's distributed layer (``spsparse_torch.dist``,
``spsparse_torch.io.sharded``) with the JAX package's, on a ``StackedMesh``
of the CPU.

* The partitioners (host numpy in both packages) take the same CSR arrays
  and must give the same arrays exactly, for P in {2, 4, 8}, on a band, a
  random rectangular matrix and one whose rows end early (empty trailing
  partitions).
* Every op on a ``StackedMesh`` against a float64 dense oracle at rtol
  1e-12 (the JAX tests' bound, ``tests/test_dist.py``), structure exactly;
  the error cases of the JAX tests.
* The JAX package's distributed functions are dear to call here (1.7-3 s
  each on the CPU mesh, a compile each), so only three run, each once at
  P = 4 in a module fixture: ``dist_spmv(method="all_gather")``,
  ``dist_spmv_a2a`` and ``dist_bellman_ford``; the port must give their
  numbers at rtol 1e-12. (``dist_spgemm_tiled`` took 10.4 s for one call
  and is held to the port's single-device ``spgemm_tiled`` instead.) The
  rest is held to the JAX single-device function where there is one
  (``spgemm``, ``graph.bellman_ford``, ``connected_components``; SpMV
  through the JAX distributed calls above) and to the oracle.
* Layouts built by the JAX package and carried over by the
  ``*_from_jax`` functions give the same op output as the port's own.
* Sharded checkpoints round-trip and cross between the packages; the
  scaling model gives the JAX package's numbers at the same bandwidths;
  solvers over a distributed matvec give the single-device results.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csgraph
import torch
from jax.sharding import Mesh

import spsparse_tpu.dist as jd
import spsparse_torch.dist as td
import spsparse_torch.convert as cv
from spsparse_tpu import SparseCOO as JCOO
from spsparse_tpu.core.structure import SparseCSR as JCSR
from spsparse_torch import SparseCOO as TCOO, SpSparseError
from port_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_dist_worker import band_csr, battery_inputs, torch_csr

P4 = 4
RTOL = 1e-12


def jax_csr(m):
    """The JAX package's ``SparseCSR`` of a scipy CSR matrix (no compile)."""
    return JCSR(row_ptr=jnp.asarray(m.indptr.astype(np.int32)),
                cols=jnp.asarray(m.indices.astype(np.int32)),
                vals=jnp.asarray(m.data), nnz=jnp.asarray(m.nnz, jnp.int32),
                shape=m.shape)


def random_csr(nrows, ncols, per_row, seed):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(nrows), per_row)
    c = rng.integers(0, ncols, r.size)
    m = sps.csr_matrix((rng.uniform(-1, 1, r.size), (r, c)),
                       shape=(nrows, ncols))
    m.sum_duplicates()
    return m


def early_rows_csr(n, seed):
    """Entries only in the first 12 rows and row 20: the trailing
    partitions are empty for P = 4 and 8."""
    rng = np.random.default_rng(seed)
    r = np.r_[np.repeat(np.arange(12), 3), [20, 20]]
    c = rng.integers(0, n, r.size)
    m = sps.csr_matrix((rng.uniform(-1, 1, r.size), (r, c)), shape=(n, n))
    m.sum_duplicates()
    return m


MATS = {"band": band_csr(61, 3, 0), "random": random_csr(50, 45, 3, 1),
        "early_rows": early_rows_csr(40, 2)}
SQUARE = ("band", "early_rows")


def mesh(P=P4):
    return td.StackedMesh(P, "cpu")


def dense(m):
    return m.toarray()


def x_for(m, seed=3, cols=None):
    rng = np.random.default_rng(seed)
    shape = (m.shape[1],) if cols is None else (m.shape[1], cols)
    return rng.uniform(-1, 1, shape)


def glob(y, n):
    """The global rows of owned blocks (all of them on a stacked mesh)."""
    return y.reshape((-1,) + tuple(y.shape[2:]))[:n].numpy()


def close(got, want, rtol=RTOL):
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# ----------------------------------------------------------------------
# Partitioners: exactly the JAX package's arrays
# ----------------------------------------------------------------------
def same_fields(t, j, names):
    for k in names:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
        assert getattr(t, k).numpy().dtype == np.asarray(getattr(j, k)).dtype
    assert tuple(t.shape) == tuple(j.shape)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("kind", list(MATS))
@pytest.mark.parametrize("which", ["rows", "bucketed", "footprint",
                                   "vector"])
def test_partitioner_matches_jax(which, kind, P):
    m = MATS[kind]
    if which == "rows":
        same_fields(td.partition_rows(torch_csr(m), P, device="cpu"),
                    jd.partition_rows(jax_csr(m), P),
                    ("row_ptr", "cols", "vals", "nnz"))
    elif which == "bucketed":
        t = td.partition_bucketed(torch_csr(m), P, device="cpu")
        j = jd.partition_bucketed(jax_csr(m), P)
        same_fields(t, j, ("rows", "cols", "vals", "nnz"))
        assert (t.rows_local, t.blk_len) == (j.rows_local, j.blk_len)
    elif which == "footprint":
        t = td.partition_footprint(torch_csr(m), P, device="cpu")
        j = jd.partition_footprint(jax_csr(m), P)
        same_fields(t, j, ("row_ptr", "cols_fp", "vals", "nnz", "req",
                           "req_n"))
        assert t.blk_len == j.blk_len
        np.testing.assert_array_equal(t.footprint_per_device,
                                      j.footprint_per_device)
    else:
        x = x_for(m)
        np.testing.assert_array_equal(
            td.partition_vector(x, P, device="cpu").numpy(),
            np.asarray(jd.partition_vector(x, P)))


def test_partition_round_trip_and_caps():
    m = MATS["band"]
    part = td.partition_rows(torch_csr(m), 8, device="cpu")
    np.testing.assert_array_equal(part.to_dense().numpy(), dense(m))
    with pytest.raises(SpSparseError):
        td.partition_rows(torch_csr(m), 4, cap_local=8, device="cpu")
    with pytest.raises(SpSparseError):
        td.partition_bucketed(torch_csr(m), 4, cap_bucket=2, device="cpu")
    with pytest.raises(SpSparseError):
        td.partition_footprint(torch_csr(m), 4, fp_cap=2, device="cpu")


# ----------------------------------------------------------------------
# SpMV / SpMM on a StackedMesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("kind", list(MATS))
@pytest.mark.parametrize("method", ["ring", "all_gather"])
def test_dist_spmv_matches_dense(method, kind, P):
    m = MATS[kind]
    x = x_for(m)
    part = td.partition_rows(torch_csr(m), P, device="cpu")
    y = td.dist_spmv(part, td.partition_vector(x, P, device="cpu"),
                     mesh(P), method=method)
    assert tuple(y.shape) == (P, part.rows_local)
    close(glob(y, m.shape[0]), dense(m) @ x)


@pytest.mark.parametrize("kind", list(MATS))
@pytest.mark.parametrize("rhs", [None, 5])
def test_dist_bucketed_matches_dense(kind, rhs):
    m = MATS[kind]
    x = x_for(m, cols=rhs)
    xp = td.partition_vector(x, P4, device="cpu")
    bkt = td.partition_bucketed(torch_csr(m), P4, blk_len=xp.shape[1],
                                device="cpu")
    op = td.dist_spmv_bucketed if rhs is None else td.dist_spmm_bucketed
    close(glob(op(bkt, xp, mesh()), m.shape[0]), dense(m) @ x)


def test_bucketed_layout_mismatch_raises():
    m = MATS["band"]
    xp = td.partition_vector(x_for(m), P4, device="cpu")
    bkt = td.partition_bucketed(torch_csr(m), 2, device="cpu")
    with pytest.raises(ValueError):
        td.dist_spmv_bucketed(bkt, xp, mesh())
    bkt4 = td.partition_bucketed(torch_csr(m), P4, blk_len=3, device="cpu")
    with pytest.raises(ValueError):
        td.dist_spmm_bucketed(bkt4, xp[..., None], mesh())


@pytest.mark.parametrize("kind", list(MATS))
def test_dist_spmm_matches_dense(kind):
    m = MATS[kind]
    X = x_for(m, cols=5)
    part = td.partition_rows(torch_csr(m), P4, device="cpu")
    Y = td.dist_spmm(part, td.partition_vector(X, P4, device="cpu"), mesh())
    close(glob(Y, m.shape[0]), dense(m) @ X)


def test_dist_spmv_halo_matches_dense_and_ring():
    m = MATS["band"]
    x = x_for(m)
    part = td.partition_rows(torch_csr(m), P4, device="cpu")
    xp = td.partition_vector(x, P4, device="cpu")
    y = td.dist_spmv_halo(part, xp, mesh(), halo=3)
    close(glob(y, 61), dense(m) @ x)
    close(glob(y, 61), glob(td.dist_spmv(part, xp, mesh()), 61))


@pytest.mark.parametrize("halo", [1, 17])
def test_dist_spmv_halo_bad_halo_raises(halo):
    """halo 1 is below the band's bandwidth 3; 17 exceeds the block."""
    m = MATS["band"]
    part = td.partition_rows(torch_csr(m), P4, device="cpu")
    xp = td.partition_vector(x_for(m), P4, device="cpu")
    with pytest.raises(ValueError):
        td.dist_spmv_halo(part, xp, mesh(), halo=halo)


@pytest.mark.parametrize("kind", list(MATS))
@pytest.mark.parametrize("rhs", [None, 5])
def test_dist_a2a_matches_dense(kind, rhs):
    m = MATS[kind]
    x = x_for(m, cols=rhs)
    fp = td.partition_footprint(torch_csr(m), P4, device="cpu")
    op = td.dist_spmv_a2a if rhs is None else td.dist_spmm_a2a
    y = op(fp, td.partition_vector(x, P4, device="cpu"), mesh())
    close(glob(y, m.shape[0]), dense(m) @ x)


def test_dist_a2a_layout_mismatch_raises():
    m = MATS["band"]
    fp = td.partition_footprint(torch_csr(m), 2, device="cpu")
    xp = td.partition_vector(x_for(m), P4, device="cpu")
    with pytest.raises(SpSparseError):
        td.dist_spmv_a2a(fp, xp, mesh())
    fp4 = td.partition_footprint(torch_csr(m), P4, device="cpu")
    with pytest.raises(SpSparseError):
        td.dist_spmv_a2a(fp4, xp[:, :-1], mesh())


def test_mesh_axis_and_size_checked():
    m = MATS["band"]
    part = td.partition_rows(torch_csr(m), P4, device="cpu")
    xp = td.partition_vector(x_for(m), P4, device="cpu")
    with pytest.raises(ValueError):
        td.dist_spmv(part, xp, mesh(), axis="y")
    with pytest.raises(ValueError):
        td.dist_spmv(part, xp, mesh(8))


def test_shard_layout_once_and_for_its_mesh():
    """``shard_layout`` marks the layout, comes back as it is for its own
    mesh, refuses another's, and the ops give the global layout's result
    from it; the halo check reads its cached column extents."""
    m = MATS["band"]
    part = td.partition_rows(torch_csr(m), P4, device="cpu")
    xp = td.partition_vector(x_for(m), P4, device="cpu")
    ms = mesh()
    held = ms.shard_layout(part)
    assert held.owner.parts == (0, 1, 2, 3) and part.owner is None
    assert ms.shard_layout(held) is held
    assert held.n_parts == P4 and held.parts == part.parts
    np.testing.assert_array_equal(
        td.dist_spmv(held, xp, ms).numpy(), td.dist_spmv(part, xp, ms).numpy())
    np.testing.assert_array_equal(
        td.dist_spmv_halo(held, xp, ms, halo=3).numpy(),
        td.dist_spmv_halo(part, xp, ms, halo=3).numpy())
    span = held.owner.col_span
    assert span.shape == (P4, 2) and int(span[0, 0]) == 0
    with pytest.raises(ValueError):
        td.dist_spmv_halo(held, xp, ms, halo=1)
    with pytest.raises(ValueError):
        mesh(8).shard_layout(held)
    with pytest.raises(ValueError):
        held.to_dense()


def test_stacked_mesh_collectives():
    """Shift, all_to_all and the reductions as the JAX collectives define
    them (``ppermute`` with ``perm = [(i, (i - 1) % P)]`` is shift 1)."""
    ms = mesh()
    t = torch.arange(4 * 3).reshape(4, 3)
    np.testing.assert_array_equal(ms.shift(t, 1)[0].numpy(), t[1].numpy())
    np.testing.assert_array_equal(ms.shift(t, -1)[0].numpy(), t[3].numpy())
    a = torch.arange(4 * 4).reshape(4, 4)          # a[o, q]: o sends q
    r = ms.all_to_all(a)
    assert int(r[2, 1]) == int(a[1, 2])             # 2 received from 1
    np.testing.assert_array_equal(ms.axis_index().numpy(), np.arange(4))
    assert int(ms.pmax(t)[0]) == 9 and int(ms.pmin(t)[2]) == 2
    assert int(ms.psum(t)[1]) == 1 + 4 + 7 + 10


# ----------------------------------------------------------------------
# SpGEMM
# ----------------------------------------------------------------------
SPGEMM_CASES = {"band": ("band", "band"),
                "early_rows": ("early_rows", "early_rows"),
                "rect": ("random", None)}


def spgemm_operands(case):
    a_kind, b_kind = SPGEMM_CASES[case]
    A = MATS[a_kind]
    B = MATS[b_kind] if b_kind else random_csr(45, 30, 2, 9)
    return A, B


def run_spgemm(variant, A, B, caps):
    a_part = td.partition_rows(torch_csr(A), P4, device="cpu")
    b_part = td.partition_rows(torch_csr(B), P4, device="cpu")
    if variant == "all_gather":
        return td.dist_spgemm(a_part, b_part, mesh(), with_overflow=True,
                              expand_cap=caps[0], out_cap=caps[1])
    if variant == "a2a":
        return td.dist_spgemm_a2a(a_part, b_part, mesh(), req_cap=caps[2],
                                  reply_cap=caps[3], expand_cap=caps[0],
                                  out_cap=caps[1])
    a_bkt = td.partition_bucketed(torch_csr(A), P4,
                                  blk_len=b_part.rows_local, device="cpu")
    return td.dist_spgemm_ring(a_bkt, b_part, mesh(),
                               expand_cap_step=caps[0], out_cap=caps[1])


BIG_CAPS = (2048, 512, 64, 512)


@pytest.mark.parametrize("case", list(SPGEMM_CASES))
@pytest.mark.parametrize("variant", ["all_gather", "a2a", "ring"])
def test_dist_spgemm_matches_dense(variant, case):
    """Values against float64 dense, structure exactly against the port's
    single-device ``spgemm`` (the cells whose sum is nonzero)."""
    from spsparse_torch.ops import spgemm

    A, B = spgemm_operands(case)
    C, ov = run_spgemm(variant, A, B, BIG_CAPS)
    assert int(ov.sum()) == 0
    coo = C.to_coo()
    close(coo.to_dense().numpy(), dense(A) @ dense(B))
    single = spgemm(torch_csr(A).to_coo(), torch_csr(B).to_coo())
    np.testing.assert_array_equal(coo.indices[:coo.nnz].numpy(),
                                  single.indices[:single.nnz].numpy())
    close(coo.vals[:coo.nnz].numpy(), single.vals[:single.nnz].numpy())


@pytest.fixture(scope="module")
def jax_spgemm_band():
    """The JAX package's single-device ``spgemm`` of the band, one call
    under ``jax.jit`` with caps that hold the whole product (eager, its
    per-primitive compiles took ~17-24 s here; jitted, one compile). Only
    the live entries are compared, which the caps do not change."""
    from spsparse_tpu.ops import spgemm

    a = MATS["band"].tocoo()
    A = JCOO.from_arrays(np.stack([a.row, a.col], 1), a.data, a.shape,
                         sort_order=(0, 1))
    # the products A·A expands to: column counts times row counts
    expansion = int(np.bincount(a.col, minlength=a.shape[0])
                    @ np.bincount(a.row, minlength=a.shape[0]))
    cap = 1 << expansion.bit_length()
    C = jax.jit(lambda A: spgemm(A, A, cap=cap, expand_cap=cap))(A)
    n = int(C.nnz)
    assert n <= expansion < cap
    return np.asarray(C.indices)[:n], np.asarray(C.vals)[:n]


@pytest.mark.parametrize("variant", ["all_gather", "a2a", "ring"])
def test_dist_spgemm_matches_jax_single_device(variant, jax_spgemm_band):
    A = MATS["band"]
    C, _ = run_spgemm(variant, A, A, BIG_CAPS)
    coo = C.to_coo()
    idx, vals = jax_spgemm_band
    np.testing.assert_array_equal(coo.indices[:coo.nnz].numpy(), idx)
    close(coo.vals[:coo.nnz].numpy(), vals)


@pytest.mark.parametrize("variant", ["all_gather", "a2a", "ring"])
def test_dist_spgemm_overflow_reported(variant):
    """Caps far too small: every variant reports per-partition overflow
    and returns cells of the true product's pattern, fewer of them."""
    A = MATS["band"]
    C, ov = run_spgemm(variant, A, A, (16, 8, 2, 8))
    assert ov.shape == (P4,) and int(ov.sum()) > 0
    got = C.to_coo().to_dense().numpy()
    want = dense(A) @ dense(A)
    assert not (got != 0)[want == 0].any()        # no cell made up
    assert np.count_nonzero(got) < np.count_nonzero(want)


def test_dist_spgemm_inner_dim_mismatch_raises():
    a = td.partition_rows(torch_csr(MATS["random"]), P4, device="cpu")
    with pytest.raises(SpSparseError):
        td.dist_spgemm(a, a, mesh(), expand_cap=64, out_cap=64)
    with pytest.raises(SpSparseError):
        td.dist_spgemm_a2a(a, a, mesh(), req_cap=8, reply_cap=8,
                           expand_cap=64, out_cap=64)


def test_dist_spgemm_ring_layout_mismatch_raises():
    A = MATS["band"]
    b = td.partition_rows(torch_csr(A), P4, device="cpu")
    bkt = td.partition_bucketed(torch_csr(A), P4, blk_len=7, device="cpu")
    with pytest.raises(ValueError):
        td.dist_spgemm_ring(bkt, b, mesh(), expand_cap_step=64, out_cap=64)


def coo32(m):
    c = m.tocoo()
    return TCOO.from_arrays(np.stack([c.row, c.col], 1),
                            c.data.astype(np.float32), c.shape, device="cpu")


@pytest.mark.parametrize("P", [2, 4])
def test_dist_spgemm_tiled_matches_single_device(P):
    """Against the port's single-device tiled product (the plain version
    of K9 on the CPU) and float64 dense; tiles of the padded rows stay
    at sentinel coordinates."""
    from spsparse_torch.ops import spgemm_tiled

    T = battery_inputs()["T"]
    A = coo32(T)
    plan = td.plan_dist_spgemm_tiled(A, A, P)
    out = td.dist_spgemm_tiled(plan, mesh(P))
    got = out.to_dense().numpy()
    single = spgemm_tiled(A, A, transpose_b=True,
                          use_window=False).to_dense().numpy()
    np.testing.assert_allclose(got, single, rtol=1e-6, atol=1e-6)
    a32 = dense(T).astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(got, a32 @ a32.T, rtol=1e-5, atol=1e-5)


def test_dist_spgemm_tiled_errors():
    A = coo32(battery_inputs()["T"])
    plan = td.plan_dist_spgemm_tiled(A, A, 2)
    with pytest.raises(SpSparseError):
        td.dist_spgemm_tiled(plan, mesh(4))        # a plan for another P
    with pytest.raises(SpSparseError):
        td.plan_dist_spgemm_tiled(A, A, 2, transpose_b=False)
    with pytest.raises(SpSparseError):
        td.plan_dist_spgemm_tiled(A, coo32(random_csr(8, 5, 1, 0)), 2)


# ----------------------------------------------------------------------
# Preconditioner and solvers over a distributed matvec
# ----------------------------------------------------------------------
def spd_band(n=64, seed=4):
    b = band_csr(n, 3, seed)
    return ((b + b.T) * 0.5 + 8.0 * sps.identity(n)).tocsr()


def test_dist_block_jacobi_is_the_block_inverse():
    S = spd_band()
    pre = td.dist_block_jacobi(torch_csr(S).to_coo(), P4, bs=4)
    assert tuple(pre.inv.shape) == (P4, 4, 4, 4)
    r = x_for(S)
    z = pre(td.partition_vector(r, P4, device="cpu")).reshape(-1).numpy()
    D = dense(S)
    want = np.concatenate([np.linalg.solve(D[i:i + 4, i:i + 4], r[i:i + 4])
                           for i in range(0, 64, 4)])
    close(z, want, rtol=1e-10)


def test_dist_block_jacobi_bs_must_divide():
    with pytest.raises(SpSparseError):
        td.dist_block_jacobi(torch_csr(spd_band()).to_coo(), P4, bs=5)


def dist_matvec(S, P=P4):
    part = td.partition_rows(torch_csr(S), P, device="cpu")
    ms = mesh(P)

    def mv(v):
        return td.dist_spmv(part, v.reshape(P, -1), ms).reshape(-1)

    return mv


def test_dist_pcg_block_jacobi_solves():
    from spsparse_torch.solvers import pcg_solve

    S = spd_band()
    b = torch.from_numpy(x_for(S))
    pre = td.dist_block_jacobi(torch_csr(S).to_coo(), P4, bs=8)
    x, _ = pcg_solve(dist_matvec(S), b, iters=40,
                     minv=lambda r: pre(r.reshape(P4, -1)).reshape(-1))
    close(x.numpy(), np.linalg.solve(dense(S), b.numpy()), rtol=1e-10)


@pytest.mark.parametrize("solver", ["lanczos_eigsh", "minres_solve",
                                    "cgls_solve"])
def test_solvers_over_dist_matvec_match_single_device(solver):
    from spsparse_torch.ops import spmv
    from spsparse_torch import solvers

    S = spd_band()
    csr = torch_csr(S)
    single = lambda v: spmv(csr, v)                 # noqa: E731
    b = torch.from_numpy(x_for(S, seed=6))
    fn = getattr(solvers, solver)
    if solver == "lanczos_eigsh":
        def run(mv):
            return fn(mv, b, k=3, iters=40)[0]
    elif solver == "minres_solve":
        def run(mv):
            return fn(mv, b, iters=60)[0]
    else:
        def run(mv):
            return fn(mv, mv, b, iters=60)[0]
    np.testing.assert_allclose(run(dist_matvec(S)).numpy(),
                               run(single).numpy(), rtol=1e-10, atol=1e-12)


# ----------------------------------------------------------------------
# Graph relaxations
# ----------------------------------------------------------------------
def graph(kind):
    m = MATS[kind].copy()
    m.data = np.abs(m.data) + 0.1
    return m


def jax_coo(m):
    c = m.tocoo()
    return JCOO.from_arrays(np.stack([c.row, c.col], 1), c.data, c.shape,
                            sort_order=(0, 1))


@pytest.mark.parametrize("kind", SQUARE)
def test_dist_bellman_ford_matches_jax_and_scipy(kind):
    import spsparse_tpu.graph as jg

    g = graph(kind)
    n = g.shape[0]
    srcs = [0, n // 2, n - 1]
    d = td.dist_bellman_ford(td.partition_rows(torch_csr(g), P4,
                                               device="cpu"), srcs, mesh())
    got = glob(d, n)
    np.testing.assert_array_equal(got,
                                  np.asarray(jg.bellman_ford(jax_coo(g),
                                                             srcs)).T)
    close(got, csgraph.dijkstra(g, indices=srcs).T)


def test_dist_bfs_levels_match_scipy():
    g = graph("band")
    d = td.dist_bfs_levels(td.partition_rows(torch_csr(g), P4, device="cpu"),
                           [7], mesh())
    ref = csgraph.shortest_path(g, unweighted=True, indices=[7]).T
    np.testing.assert_array_equal(glob(d, 61), ref)


@pytest.mark.parametrize("kind", SQUARE)
def test_dist_connected_components_match_jax(kind):
    import spsparse_tpu.graph as jg

    g = graph(kind)
    n = g.shape[0]
    lab = td.dist_connected_components(
        td.partition_rows(torch_csr(g), P4, device="cpu"), mesh())
    _, want = jg.connected_components(jax_coo(g), directed=False)
    np.testing.assert_array_equal(lab[:n].numpy(), np.asarray(want))
    ncomp, ref = csgraph.connected_components(g, directed=False)
    assert len(np.unique(lab[:n].numpy())) == ncomp


# ----------------------------------------------------------------------
# The JAX package's distributed functions, called once each
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_dist():
    """Three JAX distributed calls at P = 4 on the battery's operands (the
    two SpMVs under ``jax.jit``: one compile each, where their eager
    primitives compiled ~55 times each)."""
    inp = battery_inputs()
    jm = Mesh(np.asarray(jax.devices()[:P4]), ("x",))
    xp = jd.partition_vector(inp["x"], P4)
    return {
        "spmv_all_gather": np.asarray(jax.jit(
            lambda p, x: jd.dist_spmv(p, x, jm, method="all_gather"))(
            jd.partition_rows(jax_csr(inp["A"]), P4), xp)),
        "spmv_a2a": np.asarray(jax.jit(
            lambda p, x: jd.dist_spmv_a2a(p, x, jm))(
            jd.partition_footprint(jax_csr(inp["A"]), P4), xp)),
        "bellman_ford": np.asarray(jd.dist_bellman_ford(
            jd.partition_rows(jax_csr(inp["G"]), P4), [0, 30, 60], jm)),
    }


def port_battery_op(name):
    inp = battery_inputs()
    xp = td.partition_vector(inp["x"], P4, device="cpu")
    if name == "spmv_all_gather":
        return td.dist_spmv(td.partition_rows(torch_csr(inp["A"]), P4,
                                              device="cpu"), xp, mesh(),
                            method="all_gather")
    if name == "spmv_a2a":
        return td.dist_spmv_a2a(td.partition_footprint(
            torch_csr(inp["A"]), P4, device="cpu"), xp, mesh())
    return td.dist_bellman_ford(td.partition_rows(torch_csr(inp["G"]), P4,
                                                  device="cpu"),
                                [0, 30, 60], mesh())


@pytest.mark.parametrize("name", ["spmv_all_gather", "spmv_a2a",
                                  "bellman_ford"])
def test_port_matches_jax_dist_call(name, jax_dist):
    got = port_battery_op(name).numpy()
    assert got.shape == jax_dist[name].shape
    close(got, jax_dist[name])


# ----------------------------------------------------------------------
# Layouts carried over from the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["csr", "bucketed", "footprint",
                                    "tiled_plan", "block_jacobi"])
def test_from_jax_layout_gives_the_same_output(layout):
    m = MATS["band"]
    x = x_for(m)
    xp = td.partition_vector(x, P4, device="cpu")
    if layout == "csr":
        own = td.partition_rows(torch_csr(m), P4, device="cpu")
        got = cv.row_partitioned_csr_from_jax(
            jd.partition_rows(jax_csr(m), P4), device="cpu")
        a, b = (td.dist_spmv(p, xp, mesh()) for p in (own, got))
    elif layout == "bucketed":
        own = td.partition_bucketed(torch_csr(m), P4, device="cpu")
        got = cv.row_partitioned_bucketed_from_jax(
            jd.partition_bucketed(jax_csr(m), P4), device="cpu")
        a, b = (td.dist_spmv_bucketed(p, xp, mesh()) for p in (own, got))
    elif layout == "footprint":
        own = td.partition_footprint(torch_csr(m), P4, device="cpu")
        got = cv.row_partitioned_footprint_from_jax(
            jd.partition_footprint(jax_csr(m), P4), device="cpu")
        a, b = (td.dist_spmv_a2a(p, xp, mesh()) for p in (own, got))
    elif layout == "tiled_plan":
        T = battery_inputs()["T"]
        c = T.tocoo()
        J = JCOO.from_arrays(np.stack([c.row, c.col], 1),
                             c.data.astype(np.float32), c.shape)
        own = td.plan_dist_spgemm_tiled(coo32(T), coo32(T), P4)
        got = cv.dist_tiled_gemm_plan_from_jax(
            jd.plan_dist_spgemm_tiled(J, J, P4), device="cpu")
        for k in ("pa", "pb", "oid", "out_tile_row", "out_tile_col"):
            np.testing.assert_array_equal(getattr(own, k), getattr(got, k))
        a, b = (td.dist_spgemm_tiled(p, mesh()).blocks for p in (own, got))
    else:
        S = spd_band()
        own = td.dist_block_jacobi(torch_csr(S).to_coo(), P4, bs=4)
        got = cv.dist_block_jacobi_from_jax(
            jd.dist_block_jacobi(jax_coo(S), P4, bs=4), device="cpu")
        xp = td.partition_vector(x_for(S), P4, device="cpu")
        a, b = own(xp), got(xp)
    close(b.numpy(), a.numpy())


# ----------------------------------------------------------------------
# multihost in one process, the scaling model
# ----------------------------------------------------------------------
def test_multihost_single_process():
    from spsparse_torch.dist import multihost as mh

    mh.initialize()                      # nothing to join: a no-op
    assert not mh.is_multiprocess()
    assert mh.pod_mesh(device="cpu").n_parts == 1
    assert list(mh.my_partitions(8)) == list(range(8))
    assert list(mh.my_partitions(3)) == list(range(3))


MODEL_CASES = {
    "ring": ("ring_weak_scaling_efficiency",
             dict(nnz_local=11 << 20, rows_local=1 << 20, n_devices=8)),
    "ring_rhs": ("ring_weak_scaling_efficiency",
                 dict(nnz_local=200 << 18, rows_local=1 << 18, n_devices=8,
                      n_rhs=4)),
    "halo": ("halo_weak_scaling_efficiency",
             dict(nnz_local=11 << 20, rows_local=1 << 20, halo=8,
                  n_devices=64)),
    "a2a": ("a2a_weak_scaling_efficiency",
            dict(nnz_local=10 << 18, rows_local=1 << 18,
                 footprint_local=1 << 17, n_devices=64)),
    "target": ("a2a_footprint_for_target",
               dict(nnz_local=11 << 20, rows_local=1 << 20)),
    "uniform": ("uniform_footprint",
                dict(nnz_local=10 << 18, ncols_global=1 << 24)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_formulas_match_jax(case):
    name, kw = MODEL_CASES[case]
    if name != "uniform_footprint":
        kw = dict(kw, hbm_gbs=819.0, ici_gbs=90.0)
    assert getattr(td, name)(**kw) == pytest.approx(getattr(jd, name)(**kw),
                                                     rel=1e-15)


def test_model_defaults_are_h100_figures():
    m = td.RingModel(nnz_local=1, rows_local=1)
    assert (m.hbm_gbs, m.ici_gbs) == (3350.0, 450.0)
    kw = dict(nnz_local=11 << 20, rows_local=1 << 20, n_devices=8)
    assert td.ring_weak_scaling_efficiency(**kw) == pytest.approx(
        jd.ring_weak_scaling_efficiency(**kw, hbm_gbs=3350.0,
                                        ici_gbs=450.0), rel=1e-15)


# ----------------------------------------------------------------------
# Sharded NetCDF checkpoints
# ----------------------------------------------------------------------
def test_sharded_round_trip_and_subset(tmp_path):
    from spsparse_torch.io import load_netcdf_sharded, save_netcdf_sharded

    m = MATS["band"]
    part = td.partition_rows(torch_csr(m), P4, device="cpu")
    prefix = str(tmp_path / "ck")
    save_netcdf_sharded(prefix, part)
    back = load_netcdf_sharded(prefix, device="cpu")
    for k in ("row_ptr", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      getattr(part, k).numpy())
    sub = load_netcdf_sharded(prefix, parts=[1, 3], device="cpu")
    for p in (0, 2):
        assert int(sub.nnz[p]) == 0 and int(sub.row_ptr[p].max()) == 0
    for p in (1, 3):
        np.testing.assert_array_equal(sub.vals[p].numpy(),
                                      part.vals[p].numpy())


def test_sharded_wrong_manifest_version_raises(tmp_path):
    from spsparse_torch.io import load_netcdf_sharded, save_netcdf_sharded

    part = td.partition_rows(torch_csr(MATS["band"]), P4, device="cpu")
    prefix = str(tmp_path / "ck")
    save_netcdf_sharded(prefix, part)
    path = tmp_path / "ck.manifest.json"
    man = json.loads(path.read_text())
    man["version"] = 2
    path.write_text(json.dumps(man))
    with pytest.raises(SpSparseError):
        load_netcdf_sharded(prefix, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_checkpoint_crosses_packages(writer, tmp_path):
    from spsparse_tpu.io.sharded import (load_netcdf_sharded as jload,
                                         save_netcdf_sharded as jsave)
    from spsparse_torch.io import load_netcdf_sharded, save_netcdf_sharded

    m = MATS["random"]
    prefix = str(tmp_path / "ck")
    if writer == "jax":
        jsave(prefix, jd.partition_rows(jax_csr(m), P4))
        back = load_netcdf_sharded(prefix, device="cpu")
        get = lambda k: getattr(back, k).numpy()    # noqa: E731
    else:
        save_netcdf_sharded(prefix, td.partition_rows(torch_csr(m), P4,
                                                      device="cpu"))
        back = jload(prefix)
        get = lambda k: np.asarray(getattr(back, k))  # noqa: E731
    ref = jd.partition_rows(jax_csr(m), P4)
    for k in ("row_ptr", "cols", "vals", "nnz"):
        np.testing.assert_array_equal(get(k), np.asarray(getattr(ref, k)))


def test_chip_smoke_dist_path_rehearsal():
    """``chip_smoke.dist_path`` at a tiny size on the CPU: D0-D8 (D9 needs
    the card) with every check of the card run."""
    import chip_smoke as cs
    import spsparse_torch as sp

    st = cs.dist_path(torch, sp, "cpu", n=4096, P=4, n2c=4096, n4=1024,
                      side=32)
    assert sorted(st["wall_s"]) == [f"D{i}" for i in range(10)]
    assert st["d6"]["iters"][0] == st["d6"]["iters"][1]
    ev = st["d7"]["events"]
    assert ev["bellman_ford"]["graph.dist_bellman_ford"][0] > 1
    assert st["d9"] == {"skipped": "no card"}
