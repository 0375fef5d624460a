"""The port's CUDA kernels against their plain PyTorch versions, on a card.

    python -m pytest tests_gpu -m gpu -q

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false; the decision is made inside each test. This lane imports neither
JAX nor the JAX package (the CPU parity tests under ``tests/`` hold the
plain versions against JAX). Tolerances: K1 and K3 rtol/atol 1e-5 (the
kernels fuse multiply-adds, the plain versions round each product); K2
rtol 1e-4 / atol 1e-6 over up to 7 iterations; K4 1e-4 of max|x| after 40
CG iterations against its plain version and the composed solve over K1
(the rounding differences compound through the recurrences). K5-K7
(tiled general SpMM): float32 rtol 1e-5 with atol 1e-5 of max|ref|;
bfloat16 blocks atol 1e-4 of max|ref| (exact products, float32 sums in
another order); gradients rtol/atol 1e-4.
"""

import numpy as np
import pytest
import torch

import spsparse_torch.ops.dia_stream as dia_stream_mod
from spsparse_torch.convert import dia_from_numpy
from spsparse_torch.ops import (best_spmv, cg_solve_dia,
                                cg_solve_dia_reference, prepare_dia,
                                spmm_dia_mrhs, spmm_dia_mrhs_reference,
                                spmv_dia_chain, spmv_dia_chain_reference,
                                spmv_dia_stream, spmv_dia_stream_reference)
from spsparse_torch.solvers import cg_solve

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def banded(rng, n, offsets, scale=1.0):
    offs = np.asarray(offsets)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    data = np.where(valid, rng.uniform(-1, 1, (n, offs.size)), 0) * scale
    return data.T.astype(np.float32).copy(), tuple(int(o) for o in offs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,offsets", [
    (100_003, [-300, -5, 0, 1, 7, 129]),
    (1, [0]),
    (777, list(range(-60, 61))),
])
def test_k1_matches_plain(dtype, n, offsets):
    dev = _cuda()
    rng = np.random.default_rng(n)
    data, offs = banded(rng, n, offsets)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev),
                       dtype=getattr(torch, dtype))
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    before = spmv_dia_stream.launches
    y = spmv_dia_stream(prep, x)
    torch.cuda.synchronize()
    assert spmv_dia_stream.launches == before + 1
    torch.testing.assert_close(y, spmv_dia_stream_reference(prep, x),
                               rtol=1e-5, atol=1e-5)


def test_k1_rectangular_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(3)
    n, m = 5000, 3000
    offs = (-2, 0, 1, 2500)
    cols = np.arange(n)[:, None] + np.asarray(offs)[None, :]
    valid = (cols >= 0) & (cols < m)
    data = np.where(valid, rng.uniform(-1, 1, (n, len(offs))), 0)
    prep = prepare_dia(dia_from_numpy(data.T.astype(np.float32).copy(), offs,
                                      (n, m), device=dev))
    x = torch.from_numpy(rng.uniform(-1, 1, m).astype(np.float32)).to(dev)
    torch.testing.assert_close(spmv_dia_stream(prep, x),
                               spmv_dia_stream_reference(prep, x),
                               rtol=1e-5, atol=1e-5)


def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    dev = _cuda()
    rng = np.random.default_rng(4)
    n = 4096
    data, offs = banded(rng, n, [-1, 0, 1])
    dia = dia_from_numpy(data, offs, (n, n), device=dev)
    x = torch.ones(n, device=dev)
    want = spmv_dia_stream_reference(prepare_dia(dia), x)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(dia_stream_mod, "spmv_dia_stream_reference", refuse)
    torch.testing.assert_close(best_spmv(dia, x), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("iters", [1, 2, 7])
def test_k2_matches_plain(iters):
    dev = _cuda()
    rng = np.random.default_rng(14)
    n = 65_537
    data, offs = banded(rng, n, [-2, 0, 3, 200], scale=0.5)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev))
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    before = spmv_dia_chain.launches
    z = spmv_dia_chain(prep, x, iters, 0.9)
    torch.cuda.synchronize()
    assert spmv_dia_chain.launches == before + 1
    torch.testing.assert_close(
        z, spmv_dia_chain_reference(prep, x, iters, 0.9),
        rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 7, 8])
def test_k3_matches_plain(dtype, R):
    dev = _cuda()
    rng = np.random.default_rng(20 + R)
    n = 100_003                       # not a multiple of the block
    data, offs = banded(rng, n, [-300, -5, 0, 1, 7, 129])
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev),
                       dtype=getattr(torch, dtype))
    X = torch.from_numpy(rng.uniform(-1, 1, (R, n)).astype(np.float32)).to(
        dev)
    before = spmm_dia_mrhs.launches
    Y = spmm_dia_mrhs(prep, X)
    torch.cuda.synchronize()
    assert spmm_dia_mrhs.launches == before + 1
    assert Y.shape == (R, n)
    torch.testing.assert_close(Y, spmm_dia_mrhs_reference(prep, X),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(Y[0], spmv_dia_stream(prep, X[0]), rtol=1e-5,
                               atol=1e-5)


def test_k3_vector_rhs_and_grads():
    dev = _cuda()
    rng = np.random.default_rng(30)
    n = 5000
    data, offs = banded(rng, n, [-2, 0, 3])
    dia = dia_from_numpy(data, offs, (n, n), device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    torch.testing.assert_close(spmm_dia_mrhs(dia, x),
                               spmv_dia_stream_reference(prepare_dia(dia), x),
                               rtol=1e-5, atol=1e-5)
    X = torch.from_numpy(rng.uniform(-1, 1, (3, n)).astype(np.float32))
    W = torch.from_numpy(rng.uniform(-1, 1, (3, n)).astype(np.float32))
    grads = []
    for d in (dev, "cpu"):
        data_t = torch.from_numpy(data).to(d).requires_grad_(True)
        Xt = X.to(d).requires_grad_(True)
        dd = type(dia)(data=data_t, offsets=offs, shape=(n, n))
        (W.to(d) * spmm_dia_mrhs(dd, Xt)).sum().backward()
        grads.append((data_t.grad.cpu(), Xt.grad.cpu()))
    for g_dev, g_cpu in zip(*grads):
        torch.testing.assert_close(g_dev, g_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 777, 65_537])
def test_k4_matches_plain_and_composed(dtype, n):
    dev = _cuda()
    rng = np.random.default_rng(n)
    offs = (-2, -1, 0, 1, 2)
    data, offs = banded(rng, n, offs, scale=0.5)
    # Symmetrise: A[i, i+o] = A[i+o, i], so A + 3 I is SPD by Gershgorin.
    for k, o in enumerate(offs):
        if o > 0:
            kk = offs.index(-o)
            data[kk, o:] = data[k, :n - o]
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev),
                       dtype=getattr(torch, dtype))
    b = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    before = cg_solve_dia.launches
    x, rs = cg_solve_dia(prep, b, iters=40, shift=3.0)
    torch.cuda.synchronize()
    assert cg_solve_dia.launches == before + 1
    assert x.shape == (n,) and rs.shape == () and rs.device.type == "cuda"
    x_ref, rs_ref = cg_solve_dia_reference(prep, b, iters=40, shift=3.0)
    x_cmp, _ = cg_solve(lambda v: best_spmv(prep, v) + 3.0 * v, b, iters=40)
    scale = float(x_ref.abs().max())
    for other in (x_ref, x_cmp):
        assert float((x - other).abs().max()) <= 1e-4 * scale
    assert float(rs) <= 1e-8 * float(b.dot(b)) + 1e-10


def test_k4_zero_rhs_and_zero_iters():
    dev = _cuda()
    rng = np.random.default_rng(40)
    n = 4099
    data, offs = banded(rng, n, [-1, 0, 1], scale=0.3)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev))
    x, rs = cg_solve_dia(prep, torch.zeros(n, device=dev), iters=5,
                         shift=2.0)
    torch.cuda.synchronize()
    assert torch.equal(x, torch.zeros_like(x)) and float(rs) == 0.0
    b = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    x, rs = cg_solve_dia(prep, b, iters=0)
    torch.testing.assert_close(rs, b.dot(b), rtol=1e-5, atol=0)
    assert torch.equal(x, torch.zeros_like(x))


# ----------------------------------------------------------------------
# K5-K7: tiled general SpMM
# ----------------------------------------------------------------------
def regrid(dev, m, k, seed, spread=100, empty_every=0):
    """A column-local matrix (row r near column 2r) on ``dev``; with
    ``empty_every`` only every such row holds entries."""
    import spsparse_torch as sp

    rng = np.random.default_rng(seed)
    rows = np.arange(0, m, empty_every or 1)
    rr = np.repeat(rows, k)
    cc = np.clip(rr * 2 + rng.integers(-spread, spread + 1, rr.size), 0,
                 2 * m - 1)
    b = sp.CooBuilder((m, 2 * m), dtype=np.float32)
    b.add_many(np.stack([rr, cc], 1),
               rng.uniform(-1, 1, rr.size).astype(np.float32))
    return sp.to_tiled(b.build(device=dev))


TILED_CASES = [
    # (m, entries a row, N, every-nth row holds entries)
    (1000, 6, 128, 0),
    (777, 9, 100, 0),        # ragged rows, columns and N
    (1500, 4, 300, 3),       # N over two chunks; empty rows
    (900, 5, 1, 2),          # a vector RHS
    (5000, 3, 33, 0),
]


def _tol(dtype):
    # float32: the kernels fuse multiply-adds and sum in another order;
    # bfloat16 blocks: exact products, float32 sums of up to 128 k terms.
    return dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=0, atol=1e-4)


def _scaled(tol, ref):
    return dict(rtol=tol["rtol"], atol=tol["atol"] * max(
        float(ref.abs().max()), 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,N,empty", TILED_CASES)
def test_k6_matches_plain(dtype, m, k, N, empty):
    from spsparse_torch.ops import (prepare_tiled_dense, spmm_tiled_dense,
                                    spmm_tiled_dense_reference)

    dev = _cuda()
    tl = regrid(dev, m, k, m, empty_every=empty)
    prep = prepare_tiled_dense(tl, dtype=getattr(torch, dtype))
    X = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2 * m, N)).astype(np.float32)).to(dev)
    before = spmm_tiled_dense.launches
    Y = spmm_tiled_dense(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_dense.launches == before + 1
    assert Y.shape == (m, N) and Y.dtype == torch.float32
    ref = spmm_tiled_dense_reference(prep, X)
    torch.testing.assert_close(Y, ref, **_scaled(_tol(dtype), ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [3, 16])
@pytest.mark.parametrize("m,k,N,empty", TILED_CASES)
def test_k5_matches_plain_and_k6(dtype, group, m, k, N, empty):
    from spsparse_torch.ops import (prepare_tiled_window, spmm_tiled_dense,
                                    spmm_tiled_window,
                                    spmm_tiled_window_reference,
                                    to_tiled_dense)

    dev = _cuda()
    tl = regrid(dev, m, k, m, empty_every=empty)
    prep = prepare_tiled_window(tl, group=group, dtype=getattr(torch, dtype))
    X = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2 * m, N)).astype(np.float32)).to(dev)
    before = spmm_tiled_window.launches
    Y = spmm_tiled_window(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_window.launches == before + 1
    assert Y.shape == (m, N)
    ref = spmm_tiled_window_reference(prep, X)
    torch.testing.assert_close(Y, ref, **_scaled(_tol(dtype), ref))
    torch.testing.assert_close(Y, spmm_tiled_dense(to_tiled_dense(prep), X),
                               **_scaled(_tol(dtype), ref))


@pytest.mark.parametrize("m,k,N,empty", TILED_CASES)
def test_k7_matches_plain(m, k, N, empty):
    from spsparse_torch.ops import (prepare_tiled_rows, spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    dev = _cuda()
    tl = regrid(dev, m, k, m, empty_every=empty)
    prep = prepare_tiled_rows(tl)
    X = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2 * m, N)).astype(np.float32)).to(dev)
    before = spmm_tiled_onehot.launches
    Y = spmm_tiled_onehot(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_onehot.launches == before + 1
    ref = spmm_tiled_onehot_reference(prep, X)
    torch.testing.assert_close(Y, ref, **_scaled(_tol("float32"), ref))
    assert torch.equal(Y, spmm_tiled_onehot(prep, X))   # fixed order


def test_tiled_cuda_tensors_never_reach_plain_versions(monkeypatch):
    import spsparse_torch.ops.tiled_spmm as ts_mod
    import spsparse_torch.ops.tiled_window as tw_mod
    from spsparse_torch.ops import (prepare_tiled_rows, prepare_tiled_window,
                                    spmm_tiled_onehot, spmm_tiled_window)

    dev = _cuda()
    tl = regrid(dev, 1000, 6, 5)
    X = torch.ones((2000, 16), device=dev)
    want_w = tw_mod.spmm_tiled_window_reference(
        prepare_tiled_window(tl, group=4), X)
    want_r = ts_mod.spmm_tiled_onehot_reference(prepare_tiled_rows(tl), X)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((ts_mod, "spmm_tiled_onehot_reference"),
                      (ts_mod, "spmm_tiled_dense_reference"),
                      (tw_mod, "spmm_tiled_window_reference"),
                      (tw_mod, "spmm_tiled_dense_reference")):
        monkeypatch.setattr(mod, name, refuse)
    torch.testing.assert_close(
        spmm_tiled_window(prepare_tiled_window(tl, group=4), X), want_w,
        rtol=0, atol=1e-4 * float(want_w.abs().max()))
    torch.testing.assert_close(spmm_tiled_onehot(prepare_tiled_rows(tl), X),
                               want_r, rtol=1e-5, atol=1e-5)


def test_tiled_window_grads_match_plain():
    import dataclasses

    from spsparse_torch.ops import prepare_tiled_window, spmm_tiled_window

    dev = _cuda()
    W = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (700, 40)).astype(np.float32))
    X = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (1400, 40)).astype(np.float32))
    grads = []
    for d in (dev, "cpu"):
        prep = prepare_tiled_window(regrid(d, 700, 5, 6), group=3,
                                    dtype=torch.float32)
        blocks = prep.blocks.clone().requires_grad_(True)
        prep = dataclasses.replace(prep, blocks=blocks)
        Xt = X.to(d).requires_grad_(True)
        (W.to(d) * spmm_tiled_window(prep, Xt)).sum().backward()
        grads.append((blocks.grad.cpu(), Xt.grad.cpu()))
    for g_dev, g_cpu in zip(*grads):
        torch.testing.assert_close(g_dev, g_cpu, rtol=1e-4, atol=1e-4)
