"""The generators, the plain references and the roofline arithmetic,
against NumPy and SciPy at tiny sizes."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csg
import torch

import spsparse_torch as sp
from portbench.gen import hpcg27, urand
from portbench.metrics import _roofline
from portbench.reference import hpcg27 as ref_hpcg
from portbench.reference import urand as ref_urand

CFG8 = {"kind": "hpcg27", "nx": 8, "ny": 8, "nz": 8, "diag": 26, "off": -1}


def _dense(idx, vals, n):
    a = np.zeros((n, n))
    np.add.at(a, (idx[:, 0].numpy(), idx[:, 1].numpy()), vals.numpy())
    return a


def _stencil_dense(cfg):
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    n = nx * ny * nz
    a = np.zeros((n, n))
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                r = ix + nx * (iy + ny * iz)
                for dz in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            jx, jy, jz = ix + dx, iy + dy, iz + dz
                            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                                a[r, jx + nx * (jy + ny * jz)] = (
                                    26 if dx == dy == dz == 0 else -1)
    return a


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 4, 3)])
def test_hpcg_entries_are_the_27_point_stencil(shape):
    cfg = dict(CFG8, nx=shape[0], ny=shape[1], nz=shape[2])
    n = hpcg27.n_rows(cfg)
    idx, vals = hpcg27.entries(cfg, "cpu")
    assert idx.shape[0] == hpcg27.n_entries(cfg)
    assert len({(int(i), int(j)) for i, j in idx}) == idx.shape[0]
    a = _stencil_dense(cfg)
    np.testing.assert_array_equal(_dense(idx, vals, n), a)
    x = torch.rand(n, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(n))
    # Sums near 0 in another order: an absolute floor beside the relative.
    np.testing.assert_allclose(hpcg27.stencil_apply(cfg, x).numpy(),
                               a @ x.numpy(), rtol=1e-12, atol=1e-12)


def test_hpcg_256_counts():
    cfg = dict(CFG8, nx=256, ny=256, nz=256)
    assert hpcg27.n_entries(cfg) == 449_455_096
    assert _roofline.hpcg27_spmv_bytes(cfg) == 449_455_096 * 4 + 8 * 2 ** 24


def test_rhs_pool_is_seeded():
    a = hpcg27.rhs_pool(CFG8, 2, 2 ** 33 + 5, "cpu")
    b = hpcg27.rhs_pool(CFG8, 2, 2 ** 33 + 5, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], a[1])


@pytest.mark.parametrize("solver", ["cg", "pcg"])
def test_reference_cg_agrees_with_numpy(solver):
    cfg = dict(CFG8, nx=6, ny=5, nz=4)
    op = ref_hpcg.operator(cfg, "cpu")
    a = _stencil_dense(cfg)
    b = hpcg27.rhs_pool(cfg, 1, 7, "cpu")[0]
    x = ref_hpcg.SOLVERS[solver](op, b, 12, torch.float64).numpy()
    # NumPy CG from 0 (with M = 26 I for pcg: the same iterates).
    bn = b.double().numpy()
    xn, r = np.zeros_like(bn), bn.copy()
    p = r.copy()
    for _ in range(12):
        ap = a @ p
        alpha = (r @ r) / (p @ ap)
        xn = xn + alpha * p
        rn = r - alpha * ap
        p = rn + (rn @ rn) / (r @ r) * p
        r = rn
    np.testing.assert_allclose(x, xn, rtol=1e-9, atol=1e-12)


CFGU = {"kind": "urand", "scale": 9, "degree": 16}


def test_urand_arcs_drop_self_loops_and_keep_duplicates_for_the_build():
    idx, vals = urand.arcs(CFGU, 2 ** 40 + 3, "cpu", weighted=True)
    u, v = idx[:, 0], idx[:, 1]
    assert not bool((u == v).any())
    m = idx.shape[0] // 2
    assert torch.equal(idx[:m, 0], idx[m:, 1])
    assert m <= urand.n_edges(CFGU)
    # Both directions and every duplicate of a pair carry one weight.
    w = {}
    for (a, b), x in zip(idx.tolist(), vals.tolist()):
        assert w.setdefault((min(a, b), max(a, b)), x) == x
        assert 0 < x <= 1
    keys = (u.long() * 512 + v.long())
    assert torch.unique(keys).shape[0] < keys.shape[0]   # duplicates exist
    g = ref_urand.Graph(CFGU, 2 ** 40 + 3, "cpu", weighted=True)
    assert g.rows.shape[0] == torch.unique(keys).shape[0]


def test_the_port_builds_the_reference_graph():
    seed = 99
    idx, vals = urand.arcs(CFGU, seed, "cpu", weighted=True)
    a = sp.SparseCOO.from_arrays(idx, vals, (512, 512), device="cpu")
    c = sp.consolidate(a, duplicate_policy=sp.DuplicatePolicy.LEAVE_ALONE)
    g = ref_urand.Graph(CFGU, seed, "cpu", weighted=True)
    nnz = c.nnz
    assert nnz == g.rows.shape[0]
    assert torch.equal(c.indices[:nnz, 0].int(), g.rows)
    assert torch.equal(c.indices[:nnz, 1].int(), g.cols)
    assert torch.equal(c.vals[:nnz], g.vals)


def _scipy_graph(g):
    return sps.csr_matrix((g.vals.double().numpy(),
                           (g.rows.numpy(), g.cols.numpy())),
                          shape=(g.n, g.n))


def test_reference_pagerank_agrees_with_numpy():
    mix = {"damping": 0.85, "tolerance": 1e-4, "max_iters": 20}
    g = ref_urand.Graph(CFGU, 5, "cpu", weighted=False)
    s = ref_urand.pagerank(g, mix, torch.float64).numpy()
    a = _scipy_graph(g)
    deg = np.asarray(a.sum(axis=1)).ravel()
    x = np.full(g.n, 1.0 / g.n)
    for _ in range(20):
        new = 0.15 / g.n + 0.85 * (a.T @ np.where(deg > 0, x / deg, 0))
        err = np.abs(new - x).sum()
        x = new
        if err < 1e-4:
            break
    np.testing.assert_allclose(s, x, rtol=1e-12)


def test_reference_bellman_ford_agrees_with_scipy():
    g = ref_urand.Graph(CFGU, 6, "cpu", weighted=True)
    d = ref_urand.bellman_ford(g, 17, torch.float64).numpy()
    want = csg.dijkstra(_scipy_graph(g), indices=17)
    np.testing.assert_allclose(d, want, rtol=1e-12)


def test_roots_are_non_isolated_and_seeded():
    idx, _ = urand.arcs(CFGU, 4, "cpu", weighted=False)
    r = urand.roots(CFGU, idx, 50, 4)
    assert r == urand.roots(CFGU, idx, 50, 4)
    has = set(idx[:, 0].tolist())
    assert all(x in has for x in r)


def test_urand_roofline_counts_every_arc_once():
    cfg = {"kind": "urand", "scale": 24, "degree": 16}
    n = 2 ** 24
    assert _roofline.urand_spmv_bytes(cfg) == (2 ** 29 * 8 + (n + 1) * 4
                                               + 8 * n)
    assert _roofline.spmv_seconds(cfg, "cpu") is None
    t = _roofline.spmv_seconds(cfg, "NVIDIA H100 80GB HBM3")
    assert abs(t - _roofline.urand_spmv_bytes(cfg) / 3.35e12) < 1e-15
