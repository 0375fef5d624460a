"""The port's CUDA kernels against their plain PyTorch versions, on a card.

    python -m pytest tests_gpu -m gpu -q

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false; the decision is made inside each test. This lane imports neither
JAX nor the JAX package (the CPU parity tests under ``tests/`` hold the
plain versions against JAX). Tolerances: K1 and K3 rtol/atol 1e-5 (the
kernels fuse multiply-adds, the plain versions round each product); K2
rtol 1e-4 / atol 1e-6 over up to 7 iterations; K4 1e-4 of max|x| after 40
CG iterations against its plain version and the composed solve over K1
(the rounding differences compound through the recurrences), rtol 1e-4 on
rs after 3, and bit for bit from one solve to the next. K5-K7
(tiled general SpMM) and K8, K9, K13 (tiled SpGEMM): float32 rtol 1e-5
with atol 1e-5 of max|ref|; bfloat16 blocks atol 1e-4 of max|ref| (exact
products, float32 sums in another order); gradients rtol/atol 1e-4;
float32 K9 and K13 equal bit for bit to each other (the same sum order; a
skipped chunk adds only exact zeros), every kernel to a second call; NaN
and Inf exactly where the plain version has them. K10
rtol/atol 1e-5 (another sum order); K11's slot grid bit for bit (one
multiply a slot, the same slots as the plain sort pipeline), its SpMV
rtol 1e-5 against the plain version and float64; K12 keys exact, payloads
exact when the sort is stable and otherwise as a multiset within each run
of equal keys (a bitonic network is not stable). A float64 DIA operand's
``best_spmv`` (plain PyTorch) within 1e-12 of float64 numpy.
"""

import numpy as np
import pytest
import torch

import chip_smoke
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


def test_best_spmv_float64_dia_stays_float64():
    dev = _cuda()
    rng = np.random.default_rng(5)
    n = 5000
    data, offs = banded(rng, n, [-2, 0, 1])
    dia = dia_from_numpy(data.astype(np.float64), offs, (n, n), device=dev)
    x = rng.uniform(-1, 1, n)
    before = spmv_dia_stream.launches
    y = best_spmv(dia, torch.from_numpy(x).to(dev))
    assert y.dtype == torch.float64 and spmv_dia_stream.launches == before
    want = dia.to_dense().cpu().numpy() @ x
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-12,
                               atol=1e-12)


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


def _spd(rng, n, offs, scale=0.5):
    """Symmetric DIA data: A[i, i+o] = A[i+o, i]; with scale 0.5 and the
    shift below, A + shift I is SPD by Gershgorin."""
    data, offs = banded(rng, n, offs, scale=scale)
    for k, o in enumerate(offs):
        if 0 < o < n:
            kk = offs.index(-o)
            data[kk, o:] = data[k, :n - o]
    return data, offs


# name: (n, offsets, shift, the mode the geometry must report or None)
K4_CASES = {
    "one_row": (1, (-2, -1, 0, 1, 2), 3.0, True),
    "odd_n": (777, (-2, -1, 0, 1, 2), 3.0, True),
    "two_chunks_a_cta": (65_537, (-2, -1, 0, 1, 2), 3.0, True),
    "below_the_grid": (100, (-7, -3, 0, 3, 7), 6.0, True),
    "far_offsets": (200_000, (-100_000, -1, 0, 1, 100_000), 3.0, None),
    "past_a_cta": (300_001, (-5000, -2000, 0, 2000, 5000), 6.0, None),
    "single_diagonal": (4099, (0,), 1.0, True),
    "device_memory_mode": (1 << 22, (-2, -1, 0, 1, 2), 3.0, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_matches_plain_and_composed(dtype, case):
    """K4 against its plain version and the composed solve over K1 (1e-4 of
    max|x|), bit for bit from one solve to the next, with the geometry the
    kernel reports equal to the mirror's."""
    from spsparse_torch.ops.dia_cg import cg_geometry, cg_kernel_geometry

    dev = _cuda()
    n, offs, shift, resident = K4_CASES[case]
    rng = np.random.default_rng(n)
    data, offs = _spd(rng, n, offs)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev),
                       dtype=getattr(torch, dtype))
    b = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    before = cg_solve_dia.launches
    x, rs = cg_solve_dia(prep, b, iters=40, shift=shift)
    torch.cuda.synchronize()
    assert cg_solve_dia.launches == before + 1
    assert x.shape == (n,) and rs.shape == () and rs.device.type == "cuda"
    x2, rs2 = cg_solve_dia(prep, b, iters=40, shift=shift)
    assert torch.equal(x, x2) and torch.equal(rs, rs2)
    x_ref, rs_ref = cg_solve_dia_reference(prep, b, iters=40, shift=shift)
    x_cmp, _ = cg_solve(lambda v: best_spmv(prep, v) + shift * v, b,
                        iters=40)
    scale = float(x_ref.abs().max())
    for other in (x_ref, x_cmp):
        assert float((x - other).abs().max()) <= 1e-4 * scale
    assert float(rs) <= 1e-8 * float(b.dot(b)) + 1e-10
    props = torch.cuda.get_device_properties(0)
    geo = cg_kernel_geometry(n, getattr(torch, dtype))
    assert geo == cg_geometry(
        n, sms=props.multi_processor_count,
        smem_per_sm=props.shared_memory_per_multiprocessor,
        smem_per_block=props.shared_memory_per_block_optin)
    assert resident is None or geo.resident == resident
    if case == "below_the_grid":
        assert geo.grid > n


def test_k4_few_iterations_match_plain_rs():
    """Before convergence, x and the final rs against the plain version."""
    dev = _cuda()
    rng = np.random.default_rng(41)
    n = 50_003
    data, offs = _spd(rng, n, (-9, -4, -1, 0, 1, 4, 9), scale=0.3)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev))
    b = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    x, rs = cg_solve_dia(prep, b, iters=3, shift=2.0)
    x_ref, rs_ref = cg_solve_dia_reference(prep, b, iters=3, shift=2.0)
    torch.cuda.synchronize()
    assert float((x - x_ref).abs().max()) <= 1e-4 * float(x_ref.abs().max())
    torch.testing.assert_close(rs, rs_ref, rtol=1e-4, atol=0)


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
@pytest.mark.parametrize("N", [1, 32, 33, 128, 200])
def test_k6_ring_edges(dtype, N):
    """Ragged M and K, padding slots, an all-padding block row, a NaN-filled
    Y allocation; padding slots' blocks (NaN) are never read."""
    from spsparse_torch.ops import (PreparedTiledDense, spmm_tiled_dense,
                                    spmm_tiled_dense_reference)

    dev = _cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(N)
    M, K = 3 * 128 + 50, 5 * 128 - 37            # nbr 4, nbc 5
    nbc = 5
    tcols = torch.tensor([[0, 4, nbc], [nbc, nbc, nbc], [2, nbc, 1],
                          [4, 3, 0]], dtype=torch.int32, device=dev)
    blocks = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 128, 128)).astype(
        np.float32)).to(dev)
    pad = (tcols == nbc)[:, :, None, None]
    blocks = torch.where(pad, 0.0, blocks).to(dt)
    prep = PreparedTiledDense(tcols=tcols, blocks=blocks, shape=(M, K))
    X = torch.from_numpy(rng.uniform(-1, 1, (K, N)).astype(np.float32)).to(
        dev)
    dirty_cache(dev, M * N * 4)
    before = spmm_tiled_dense.launches
    Y = spmm_tiled_dense(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_dense.launches == before + 1
    assert Y.shape == (M, N) and not bool(torch.isnan(Y).any())
    assert not bool(Y[128:256].any())            # the all-padding block row
    ref = spmm_tiled_dense_reference(prep, X)
    torch.testing.assert_close(Y, ref, **_scaled(_tol(dtype), ref))
    nan_pad = PreparedTiledDense(
        tcols=tcols, blocks=torch.where(pad, float("nan"), blocks.float())
        .to(dt), shape=(M, K))
    assert torch.equal(spmm_tiled_dense(nan_pad, X), Y)


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


def window_prep(tcols, blocks, nbc, group, shape, fill):
    """A ``PreparedTiledWindow`` of a tile-column table (``nbc`` marks
    padding): block rows padded to whole super-rows of ``group`` (padding
    slots, blocks full of ``fill``), each super-row's window starting at its
    least live tile column."""
    from spsparse_torch.ops import PreparedTiledWindow

    nbr, rt = tcols.shape
    nsuper = -(-nbr // group)
    pad = nsuper * group - nbr
    tc = torch.cat([tcols, tcols.new_full((pad, rt), nbc)])
    live = tc < nbc
    lo = torch.where(live, tc, nbc).reshape(nsuper, -1).amin(dim=1)
    wstart = torch.where(lo < nbc, lo, 0).to(torch.int32)
    offs = torch.where(live, tc - wstart.repeat_interleave(group)[:, None],
                       -1)
    blocks = torch.cat([blocks, blocks.new_full(
        (pad,) + tuple(blocks.shape[1:]), fill)])
    return PreparedTiledWindow(
        wstart=wstart, offs=offs.to(torch.int32).reshape(-1).contiguous(),
        blocks=blocks, shape=shape, group=group, ws=nbc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [3, 16])
@pytest.mark.parametrize("N", [1, 32, 33, 128, 200])
def test_k5_ring_edges(dtype, group, N):
    """K5 on K6's ring (N > 32) and the thin body: ragged M and K, 4 block
    rows (not a multiple of the group: the padding rows of the last
    super-row are never launched), windows that start past column 0,
    padding slots, an all-padding block row, a NaN-filled Y allocation;
    padding slots' blocks (NaN) are never read."""
    from spsparse_torch.ops import (spmm_tiled_window,
                                    spmm_tiled_window_reference)

    dev = _cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(100 + N + group)
    M, K, nbc = 3 * 128 + 50, 8 * 128 - 37, 8
    tcols = torch.tensor([[3, 7, nbc], [nbc, nbc, nbc], [5, nbc, 4],
                          [7, 6, 5]], dtype=torch.int32, device=dev)
    blocks = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 128, 128)).astype(
        np.float32)).to(dev)
    pad = (tcols == nbc)[:, :, None, None]
    prep = window_prep(tcols, torch.where(pad, 0.0, blocks).to(dt), nbc,
                       group, (M, K), 0.0)
    assert prep.nbr > 4 and bool((prep.wstart > 0).any())
    X = torch.from_numpy(rng.uniform(-1, 1, (K, N)).astype(np.float32)).to(
        dev)
    dirty_cache(dev, M * N * 4)
    before = spmm_tiled_window.launches
    Y = spmm_tiled_window(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_window.launches == before + 1
    assert Y.shape == (M, N) and not bool(torch.isnan(Y).any())
    assert not bool(Y[128:256].any())            # the all-padding block row
    ref = spmm_tiled_window_reference(prep, X)
    torch.testing.assert_close(Y, ref, **_scaled(_tol(dtype), ref))
    nan_pad = window_prep(
        tcols, torch.where(pad, float("nan"), blocks).to(dt), nbc, group,
        (M, K), float("nan"))
    assert torch.equal(spmm_tiled_window(nan_pad, X), Y)


def test_k5_rejects_misaligned_blocks():
    """The ring's cp.async needs 16-byte aligned blocks: a view that starts
    one element into its storage raises before any launch."""
    import dataclasses

    from spsparse_torch.ops import prepare_tiled_window, spmm_tiled_window

    dev = _cuda()
    prep = prepare_tiled_window(regrid(dev, 1000, 6, 5), group=4,
                                dtype=torch.float32)
    flat = torch.zeros(prep.blocks.numel() + 1, device=dev)
    bad = flat[1:].view(prep.blocks.shape)
    bad.copy_(prep.blocks)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = spmm_tiled_window.launches
    with pytest.raises(ValueError, match="16-byte"):
        spmm_tiled_window(dataclasses.replace(prep, blocks=bad),
                          torch.ones((2000, 128), device=dev))
    assert spmm_tiled_window.launches == before


K7_CASES = TILED_CASES + [
    (512, 100, 128, 0),      # config 3's fill and more: tiles past 4096
    (700, 8, 3, 4),          # N = 3, empty block rows
    (300, 5, 200, 0),        # N over two 128-column chunks
]


def bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("m,k,N,empty", K7_CASES)
def test_k7_matches_plain(m, k, N, empty):
    from spsparse_torch.ops import (prepare_tiled_rows, spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    dev = _cuda()
    tl = regrid(dev, m, k, m, spread=30 if k > 50 else 100,
                empty_every=empty)
    prep = prepare_tiled_rows(tl)
    X = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (2 * m, N)).astype(np.float32)).to(dev)
    before = spmm_tiled_onehot.launches
    Y = spmm_tiled_onehot(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_onehot.launches == before + 1
    ref = spmm_tiled_onehot_reference(prep, X)
    torch.testing.assert_close(Y, ref, **_scaled(_tol("float32"), ref))
    assert torch.equal(bits(Y), bits(spmm_tiled_onehot(prep, X)))
    if k > 50:
        assert prep.tile_cap > 4096   # more than one staging unit a tile


def k7_layout(dev, rng, M, K, rt, cap, pad_slots, order):
    """A PreparedTiledRows by hand: random tile columns with padding slots
    (sentinel nbc) and an all-padding block row, entries with duplicates
    and rows in random order (``order`` "random"), sorted within each tile
    ("sorted") or within each 256 slots ("windows"), value-0 slots in the
    middle and at the tail of each tile."""
    from spsparse_torch.ops import PreparedTiledRows

    nbr, nbc = -(-M // 128), -(-K // 128)
    tcols = rng.integers(0, nbc, (nbr, rt))
    tcols[rng.random((nbr, rt)) < pad_slots] = nbc
    tcols[nbr // 2] = nbc
    rows = rng.integers(0, 128, (nbr, rt, cap))
    if order == "sorted":
        rows = np.sort(rows, axis=-1)
    elif order == "windows":
        w = rows.reshape(nbr, rt, -1, 256)
        rows = np.sort(w, axis=-1).reshape(nbr, rt, cap)
    cols = rng.integers(0, 128, (nbr, rt, cap))
    # Columns of the last, partial tile column stay below K.
    last = (tcols == nbc - 1)[:, :, None]
    cols = np.where(last, cols % (K - (nbc - 1) * 128), cols)
    vals = rng.uniform(-1, 1, (nbr, rt, cap)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.2] = 0.0
    vals[:, :, cap - cap // 4:] = 0.0
    vals[tcols >= nbc] = 0.0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(
            np.int32 if a.dtype != np.float32 else np.float32)).to(dev)

    return PreparedTiledRows(tcols=t(tcols), rows=t(rows), cols=t(cols),
                             vals=t(vals), shape=(M, K))


# (tile cap, row order, non-finite X, tiles a block row): caps of at most
# 256 take the warp-a-block-row kernel (one piece of 256 slots with three
# tiles of 64, several pieces, split mid-tile, past that), larger ones the
# staged kernel: in row order (its compaction path) or not (its stable
# ranking), past one staging unit (4096 slots) with 5000.
K7_EDGES = {"small": (64, "random", False, 3),
            "unsorted": (128, "random", False, 3),
            "sorted": (128, "sorted", False, 3),
            "many_tiles": (48, "random", False, 13),
            "many_tiles_sorted": (48, "sorted", False, 13),
            "full_pieces": (256, "random", False, 3),
            "staged": (300, "random", False, 3),
            "staged_sorted": (300, "sorted", False, 3),
            "windows": (1024, "windows", False, 3),
            "wide_tiles": (5000, "random", False, 3),
            "wide_sorted": (5000, "sorted", False, 3),
            "odd_cap": (100, "sorted", False, 3),   # no 16-byte slot loads
            "odd_cap_random": (100, "random", False, 3),
            "nonfinite": (128, "random", True, 3),
            "nonfinite_sorted": (128, "sorted", True, 3),
            "nonfinite_small": (64, "random", True, 3),
            "nonfinite_many": (48, "random", True, 13),
            "nonfinite_staged": (300, "random", True, 3)}


@pytest.mark.parametrize("N", [1, 3, 100, 128, 200])
@pytest.mark.parametrize("case", list(K7_EDGES))
def test_k7_layout_edges_bitwise(N, case):
    """K7 against its plain version and a second call, bit for bit, on
    hand-built layouts: padding slots and an empty block row, K not a multiple of 128,
    duplicate entries and unsorted rows, block rows of several 256-slot
    pieces, tiles of more than one staging unit (4096 slots), and Inf/NaN
    in X rows that no entry names (they must not reach Y) and in rows that
    an entry names (only the rows those reach are non-finite; the others
    against the plain version)."""
    from spsparse_torch.ops import (spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    dev = _cuda()
    rng = np.random.default_rng(N * 7 + len(case))
    M, K = 1000, 1650
    cap, order, nonfinite, rt = K7_EDGES[case]
    prep = k7_layout(dev, rng, M, K, rt, cap, 0.3, order)
    Xh = rng.uniform(-1, 1, (K, N)).astype(np.float32)
    if nonfinite:
        named = np.zeros(K, bool)
        tc = prep.tcols.cpu().numpy()
        live = (prep.vals.cpu().numpy() != 0) & (tc < prep.nbc)[:, :, None]
        gcol = tc[:, :, None] * 128 + prep.cols.cpu().numpy()
        named[gcol[live]] = True
        unnamed = np.flatnonzero(~named)
        Xh[unnamed[::3], :] = np.inf
        Xh[unnamed[1::3], :] = np.nan
        Xh[np.flatnonzero(named)[:2], 0] = [np.inf, np.nan]
    X = torch.from_numpy(Xh).to(dev)
    dirty_cache(dev, M * N * 4)
    before = spmm_tiled_onehot.launches
    Y = spmm_tiled_onehot(prep, X)
    torch.cuda.synchronize()
    assert spmm_tiled_onehot.launches == before + 1
    assert torch.equal(bits(Y), bits(spmm_tiled_onehot(prep, X)))
    if not nonfinite:
        ref = spmm_tiled_onehot_reference(prep, X)
        torch.testing.assert_close(Y, ref, **_scaled(_tol("float32"), ref))
    else:
        # Only rows whose entries name a non-finite X row are non-finite.
        tc = prep.tcols.cpu().numpy()
        vals = prep.vals.cpu().numpy()
        live = (vals != 0) & (tc < prep.nbc)[:, :, None]
        gcol = tc[:, :, None] * 128 + prep.cols.cpu().numpy()
        grow = (np.arange(tc.shape[0])[:, None, None] * 128
                + prep.rows.cpu().numpy())
        bad = ~np.isfinite(Xh).all(axis=1)
        hit = np.zeros(tc.shape[0] * 128, bool)   # rows past M included
        hit[grow[live & bad[np.minimum(gcol, K - 1)]]] = True
        finite = torch.isfinite(Y).all(dim=1).cpu().numpy()
        np.testing.assert_array_equal(finite, ~hit[:M])
        # The other rows name finite X rows only: against the plain version
        # on X with its non-finite values set to 0.
        ref = spmm_tiled_onehot_reference(
            prep, torch.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0))
        keep = torch.from_numpy(finite).to(dev)
        if bool(keep.any()):
            torch.testing.assert_close(Y[keep], ref[keep],
                                       **_scaled(_tol("float32"), ref[keep]))


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


# ----------------------------------------------------------------------
# K8, K9, K13: tiled SpGEMM
# ----------------------------------------------------------------------
def regrid_coo(dev, n, per, seed, every=1):
    """Bench config 4's kind: ``per`` entries in each ``every``-th row at
    columns ``2r + U{0,1,2}`` of 2n."""
    import spsparse_torch as sp

    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(0, n, every), per)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), 2 * n - 1)
    b = sp.CooBuilder((n, 2 * n), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), rng.uniform(0, 1, r.size))
    return b.build(device=dev)


def coo_of(dev, shape, rows, cols, seed):
    import spsparse_torch as sp

    b = sp.CooBuilder(shape, dtype=np.float32)
    b.add_many(np.stack([rows, cols], 1),
               np.random.default_rng(seed).uniform(-1, 1, len(rows)))
    return b.build(device=dev)


def dirty_cache(dev, nbytes):
    """Leave NaN in the caching allocator's free blocks, so that an output
    slot the kernel fails to write shows."""
    junk = torch.full((nbytes // 4 + 1,), float("nan"), device=dev)
    del junk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["shared", "two_operand", "uneven"])
def test_k8_matches_plain_dead_slots_zero(dtype, case):
    import spsparse_torch as sp
    from spsparse_torch.ops import (plan_window_spgemm, prepare_tiled_dense,
                                    spgemm_window, spgemm_window_reference)

    dev = _cuda()
    dt = getattr(torch, dtype)
    if case == "uneven":       # half the rows empty, 8 block rows, group 3
        A, B, group = regrid_coo(dev, 900, 2, 11, every=2), None, 3
    else:
        A, group = regrid_coo(dev, 1000, 4, 12), 4
        B = None if case == "shared" else regrid_coo(dev, 1000, 3, 13)
    pa = prepare_tiled_dense(sp.to_tiled(A), dtype=dt)
    pb = pa if B is None else prepare_tiled_dense(sp.to_tiled(B), dtype=dt)
    plan = plan_window_spgemm(pa.tcols, pb.tcols, nbc=pa.nbc,
                              out_shape=(A.shape[0],
                                         (A if B is None else B).shape[0]),
                              group=group, dtype=dt)
    assert plan.shared == (B is None)
    if case == "uneven":
        assert plan.nbr_pad > plan.nbr
    dirty_cache(dev, plan.nbr_pad * plan.nband * 128 * 128 * 4)
    before = spgemm_window.launches
    band = spgemm_window(plan, pa.blocks, None if plan.shared else pb.blocks)
    torch.cuda.synchronize()
    assert spgemm_window.launches == before + 1
    ref = spgemm_window_reference(plan, pa.blocks,
                                  None if plan.shared else pb.blocks)
    torch.testing.assert_close(band, ref, **_scaled(_tol(dtype), ref))
    dead = torch.from_numpy(plan.cnt == 0).to(dev)
    assert bool(dead.any())
    assert not bool(band.reshape(-1, 128 * 128)[dead].any())
    assert torch.equal(band, spgemm_window(
        plan, pa.blocks, None if plan.shared else pb.blocks))


def pair_operands(dev, kind, transpose_b, dt):
    """Flat operand blocks: ``regrid`` (config 4's kind), ``one_pair`` (one
    tile each) or ``many_pairs`` (one output tile summing 40 pairs)."""
    import spsparse_torch as sp
    from spsparse_torch.ops import densify_tiled

    if kind == "regrid":
        A = regrid_coo(dev, 1000, 4, 21)
        B = A if transpose_b else coo_of(
            dev, (2000, 700), np.arange(2000),
            np.random.default_rng(22).integers(0, 700, 2000), 23)
    elif kind == "one_pair":
        A = coo_of(dev, (200, 300), np.arange(100), np.arange(100) % 128, 24)
        shape = (150, 300) if transpose_b else (300, 150)
        r = np.arange(100) % 128
        B = coo_of(dev, shape, *((np.arange(100), r) if transpose_b
                                 else (r, np.arange(100))), 25)
    else:
        k = np.arange(40 * 128)
        A = coo_of(dev, (128, 40 * 128), k % 128, k, 26)
        shape = (128, 40 * 128) if transpose_b else (40 * 128, 128)
        B = coo_of(dev, shape, *((k % 128, k) if transpose_b
                                 else (k, k % 128)), 27)
    return (densify_tiled(sp.to_tiled(A), dtype=dt),
            densify_tiled(sp.to_tiled(B), dtype=dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("kind", ["regrid", "one_pair", "many_pairs"])
def test_k9_k13_match_plain(dtype, transpose_b, kind):
    from spsparse_torch.ops import (plan_tiled_spgemm, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream)

    dev = _cuda()
    ta, tb = pair_operands(dev, kind, transpose_b, getattr(torch, dtype))
    plan = plan_tiled_spgemm(ta, tb, transpose_b=transpose_b)
    if kind == "one_pair":
        assert plan.n_pairs == 1
    if kind == "many_pairs":
        assert plan.n_out_tiles == 1 and plan.n_pairs == 40
    ref = spgemm_tiled_reference(ta, tb, plan).blocks
    outs = []
    for fn in (spgemm_tiled_pairs, spgemm_tiled_stream):
        dirty_cache(dev, plan.n_out_tiles * 128 * 128 * 4)
        before = fn.launches
        out = fn(ta, tb, plan)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(out.blocks, ref,
                                   **_scaled(_tol(dtype), ref))
        outs.append(out.blocks)
    torch.testing.assert_close(outs[1], outs[0], **_scaled(_tol(dtype), ref))
    if dtype == "float32":      # K13 sums in K9's order
        assert torch.equal(outs[1], outs[0])
    assert torch.equal(spgemm_tiled_stream(ta, tb, plan).blocks, outs[1])
    assert torch.equal(spgemm_tiled_pairs(ta, tb, plan).blocks, outs[0])


def diagonal_pair_operands(dev, n, transpose_b, dt, seed):
    """Flat operands whose product has exactly the n output tiles (i, i),
    tile i summing r_i in {1, 2, 3} pairs: A holds tiles (i, 3i + s) for
    s < r_i, B tiles (3i + s, i) (for A B^T, (i, 3i + s)) for s < 3. Values
    uniform(-1, 1) from a seeded generator on the card."""
    import importlib

    tb_cls = importlib.import_module("spsparse_torch.ops.spgemm_tiled") \
        .TiledBlocks
    r = np.random.default_rng(seed).integers(1, 4, n)
    a_row = np.repeat(np.arange(n), r)
    a_col = 3 * a_row + np.arange(a_row.size) - np.repeat(np.cumsum(r) - r,
                                                           r)
    b_i = np.repeat(np.arange(n), 3)
    b_k = 3 * b_i + np.tile(np.arange(3), n)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def tiled(rows, cols, shape):
        blocks = torch.rand((rows.size, 128, 128), generator=gen,
                            device=dev) * 2 - 1
        return tb_cls(
            tile_row=torch.from_numpy(rows.astype(np.int32)).to(dev),
            tile_col=torch.from_numpy(cols.astype(np.int32)).to(dev),
            blocks=blocks.to(dt), shape=shape)

    A = tiled(a_row, a_col, (n * 128, 3 * n * 128))
    B = (tiled(b_i, b_k, (n * 128, 3 * n * 128)) if transpose_b
         else tiled(b_k, b_i, (3 * n * 128, n * 128)))
    return A, B


def with_empty_tiles(plan, at):
    """``plan`` with an output tile of no pairs inserted before each old
    tile index in ``at`` (at sentinel coordinates)."""
    import importlib

    plan_cls = importlib.import_module("spsparse_torch.ops.spgemm_tiled") \
        .TiledGemmPlan
    at = np.sort(np.asarray(at))
    old = np.arange(plan.n_out_tiles)
    new_of_old = old + np.searchsorted(at, old, side="right")
    empty = at + np.arange(at.size)
    rows = np.full(plan.n_out_tiles + at.size, -(-plan.out_shape[0] // 128),
                   np.int32)
    cols = np.full_like(rows, -(-plan.out_shape[1] // 128))
    rows[new_of_old], cols[new_of_old] = plan.out_tile_row, plan.out_tile_col
    return plan_cls(pa=plan.pa, pb=plan.pb,
                    oid=new_of_old[plan.oid].astype(np.int32),
                    out_tile_row=rows, out_tile_col=cols,
                    transpose_b=plan.transpose_b,
                    out_shape=plan.out_shape), empty


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("n", [1, 261, 2000])
def test_k13_ring_tile_counts(dtype, transpose_b, n):
    """K13's persistent CTAs and K9's one CTA a tile over fewer output
    tiles than resident CTAs (4), about as many (264: two CTAs on each of
    132 SMs) and more (2003), with tiles of no pairs first, in the middle
    and last (stored as exact zeros over a NaN-filled allocation); float32
    K9 and K13 equal to each other bit for bit, and two calls
    bit-identical."""
    from spsparse_torch.ops import (plan_tiled_spgemm, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream)

    dev = _cuda()
    A, B = diagonal_pair_operands(dev, n, transpose_b, getattr(torch, dtype),
                                  n)
    plan = plan_tiled_spgemm(A, B, transpose_b=transpose_b)
    assert plan.n_out_tiles == n
    plan, empty = with_empty_tiles(plan, [0, n // 2, n])
    ref = spgemm_tiled_reference(A, B, plan).blocks
    dirty_cache(dev, plan.n_out_tiles * 128 * 128 * 4)
    before = spgemm_tiled_stream.launches
    got = spgemm_tiled_stream(A, B, plan).blocks
    torch.cuda.synchronize()
    assert spgemm_tiled_stream.launches == before + 1
    assert got.shape == (n + 3, 128, 128)
    torch.testing.assert_close(got, ref, **_scaled(_tol(dtype), ref))
    assert not bool(got[torch.from_numpy(empty).to(dev)].any())
    assert torch.equal(spgemm_tiled_stream(A, B, plan).blocks, got)
    dirty_cache(dev, plan.n_out_tiles * 128 * 128 * 4)
    before = spgemm_tiled_pairs.launches
    k9 = spgemm_tiled_pairs(A, B, plan).blocks
    torch.cuda.synchronize()
    assert spgemm_tiled_pairs.launches == before + 1
    torch.testing.assert_close(k9, ref, **_scaled(_tol(dtype), ref))
    assert not bool(k9[torch.from_numpy(empty).to(dev)].any())
    if dtype == "float32":
        assert torch.equal(k9, got)


def nonfinite_tiles(dt):
    """Two pairs of 128 x 128 tiles (A0, A1; B0, B1 as n x k rows) built so
    that each warp's skip test meets every case: A0's rows 0-63 are zero
    and meet an Inf in B0 (row 5, k 3: NaN must come out, not 0); B1's rows
    0-63 are zero and meet an Inf in A1 (row 10, k 20: NaN again); B1 holds
    a NaN (row 100, k 50); everywhere else a zero warp block meets finite
    values, whose output is an exact zero. Values uniform(0.5, 1)."""
    rng = np.random.default_rng(41)
    a0, a1, b0, b1 = (rng.uniform(0.5, 1, (128, 128)).astype(np.float32)
                      for _ in range(4))
    a0[:64] = 0
    b1[:64] = 0
    b0[5, 3] = np.inf
    a1[10, 20] = np.inf
    b1[100, 50] = np.nan
    return [torch.from_numpy(v).to(dt) for v in (a0, a1, b0, b1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["k8", "k9_ab", "k9_abt", "k13_ab",
                                    "k13_abt"])
def test_spgemm_skip_keeps_nonfinite_and_zeros(dtype, kernel):
    """One output tile of two pairs (:func:`nonfinite_tiles`) through K8,
    K9 and K13: NaN and Inf exactly where the plain version (on the CPU)
    has them, exact zeros where its sum is zero, the rest within the
    tolerance of the type."""
    import importlib

    from spsparse_torch.ops import (plan_tiled_spgemm, plan_window_spgemm,
                                    spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream, spgemm_window,
                                    spgemm_window_reference)

    dev = _cuda()
    dt = getattr(torch, dtype)
    a0, a1, b0, b1 = nonfinite_tiles(dt)
    if kernel == "k8":
        tcols = torch.tensor([[0, 1]], dtype=torch.int32)
        plan = plan_window_spgemm(tcols, tcols, nbc=2, out_shape=(128, 128),
                                  dtype=dt)
        assert plan.n_live == 2 and plan.nband == 1
        ab = torch.stack([a0, a1])[None]
        bb = torch.stack([b0, b1])[None]
        ref = spgemm_window_reference(plan, ab, bb)[0, 0]
        got = spgemm_window(plan, ab.to(dev), bb.to(dev))[0, 0].cpu()
    else:
        tb_cls = importlib.import_module(
            "spsparse_torch.ops.spgemm_tiled").TiledBlocks
        transpose_b = kernel.endswith("abt")
        i32 = dict(dtype=torch.int32)
        A = tb_cls(tile_row=torch.tensor([0, 0], **i32),
                   tile_col=torch.tensor([0, 1], **i32),
                   blocks=torch.stack([a0, a1]), shape=(128, 256))
        if transpose_b:
            B = tb_cls(tile_row=torch.tensor([0, 0], **i32),
                       tile_col=torch.tensor([0, 1], **i32),
                       blocks=torch.stack([b0, b1]), shape=(128, 256))
        else:
            B = tb_cls(tile_row=torch.tensor([0, 1], **i32),
                       tile_col=torch.tensor([0, 0], **i32),
                       blocks=torch.stack([b0.T, b1.T]).contiguous(),
                       shape=(256, 128))
        plan = plan_tiled_spgemm(A, B, transpose_b=transpose_b)
        assert plan.n_pairs == 2 and plan.n_out_tiles == 1
        ref = spgemm_tiled_reference(A, B, plan).blocks[0]

        def on(tb):
            return tb_cls(tile_row=tb.tile_row.to(dev),
                          tile_col=tb.tile_col.to(dev),
                          blocks=tb.blocks.to(dev), shape=tb.shape)

        fn = spgemm_tiled_pairs if kernel.startswith("k9") else \
            spgemm_tiled_stream
        got = fn(on(A), on(B), plan).blocks[0].cpu()
    nan = torch.isnan(ref)
    assert bool(nan[:64, 5].all()) and bool(nan[10, :64].all())
    assert bool(nan[:, 100].all()) and bool((ref[:64, :64] == 0).sum() > 0)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(torch.isinf(got) & (got > 0), torch.isinf(ref)
                       & (ref > 0))
    assert torch.equal(torch.isinf(got) & (got < 0), torch.isinf(ref)
                       & (ref < 0))
    assert bool((got[ref == 0] == 0).all())
    fin = torch.isfinite(ref)
    torch.testing.assert_close(got[fin], ref[fin],
                               **_scaled(_tol(dtype), ref[fin]))


def test_spgemm_cuda_tensors_never_reach_plain_versions(monkeypatch):
    import importlib

    import scipy.sparse as ssp

    from spsparse_torch.ops import best_spgemm, spgemm_tiled

    # importlib: the package attribute ops.spgemm_tiled is the function.
    st_mod = importlib.import_module("spsparse_torch.ops.spgemm_tiled")
    sw_mod = importlib.import_module("spsparse_torch.ops.spgemm_window")

    dev = _cuda()
    A = regrid_coo(dev, 1000, 4, 31)
    idx = A.indices[: A.nnz].cpu().numpy()
    As = ssp.csr_matrix((A.vals[: A.nnz].cpu().numpy().astype(np.float64),
                         (idx[:, 0], idx[:, 1])), shape=A.shape)
    want = (As @ As.T).toarray()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(st_mod, "spgemm_tiled_reference", refuse)
    monkeypatch.setattr(sw_mod, "spgemm_window_reference", refuse)
    for C in (best_spgemm(A, A, transpose_b=True),
              spgemm_tiled(A, A, transpose_b=True, use_window=False)):
        got = C.to_dense().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------------------
# K10, K11, K12: unstructured SpMV and the block sort
# ----------------------------------------------------------------------
def shuffle_case(dev, kind):
    """``(prep, x, dense A in float64)`` on ``dev``: ``uniform`` (config
    2c's kind, ncols not a multiple of 128), ``heavy`` (rows split at
    ell_k 8), ``dups`` (duplicates and empty rows) or ``empty``."""
    import spsparse_torch as sp
    from spsparse_torch.ops import prepare_shuffle_spmv

    rng = np.random.default_rng({"uniform": 50, "heavy": 51, "dups": 52,
                                 "empty": 53}[kind])
    shape, ell_k = (3000, 2900), 16
    if kind == "uniform":
        r = np.repeat(np.arange(3000), 10)
        c = rng.integers(0, 2900, r.size)
    elif kind == "heavy":
        shape, ell_k = (500, 3000), 8
        r = np.concatenate([np.full(2000, 7), rng.integers(0, 500, 3000)])
        c = np.concatenate([rng.permutation(3000)[:2000],
                            rng.integers(0, 3000, 3000)])
    elif kind == "dups":
        r = np.repeat(np.arange(0, 3000, 3), 4)
        c = rng.integers(0, 40, r.size)
    else:
        r = c = np.zeros(0, np.int64)
    v = rng.uniform(-1, 1, r.size).astype(np.float32)
    b = sp.CooBuilder(shape, dtype=np.float32)
    if r.size:
        b.add_many(np.stack([r, c], 1), v)
    dense = np.zeros(shape)
    np.add.at(dense, (r, c), v.astype(np.float64))
    x = torch.from_numpy(rng.uniform(-1, 1, shape[1]).astype(np.float32))
    return (prepare_shuffle_spmv(b.build(device=dev), ell_k=ell_k),
            x.to(dev), dense)


@pytest.mark.parametrize("kind", ["uniform", "heavy", "dups", "empty"])
def test_k11_slot_grid_bitwise_and_spmv(kind):
    from spsparse_torch.ops import (best_spmv, shuffle_gather,
                                    shuffle_gather_reference,
                                    spmv_shuffle_reference)

    dev = _cuda()
    prep, x, dense = shuffle_case(dev, kind)
    if kind == "heavy":
        assert prep.extra_rows.shape[0] > 0
    dirty_cache(dev, prep.n_slots * 4)
    before = shuffle_gather.launches
    slots = shuffle_gather(prep, x)
    torch.cuda.synchronize()
    assert shuffle_gather.launches == before + 1
    assert not bool(torch.isnan(slots).any())
    assert torch.equal(slots, shuffle_gather_reference(prep, x))
    y = best_spmv(prep, x)
    torch.testing.assert_close(y, spmv_shuffle_reference(prep, x),
                               rtol=1e-5, atol=1e-5)
    want = dense @ x.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))


def test_k11_int64_dest():
    """int64 slot columns (the layout of ncols >= 2^31) and int64 dest."""
    import dataclasses

    from spsparse_torch.ops import shuffle_gather, shuffle_gather_reference

    dev = _cuda()
    prep, x, _ = shuffle_case(dev, "uniform")
    wide = dataclasses.replace(prep, dest=prep.dest.long(),
                               filler_dest=prep.filler_dest.long(),
                               ell_cols=prep.ell_cols.long())
    dirty_cache(dev, prep.n_slots * 4)
    assert torch.equal(shuffle_gather(wide, x),
                       shuffle_gather_reference(prep, x))


@pytest.mark.parametrize("ell_k", [5, 16])
def test_k11_inf_in_x_and_tail(ell_k):
    """An inf in x reaches the slots of its column and no filler; ell_k 5
    over an odd number of virtual rows leaves a tail of n_slots % 4."""
    import spsparse_torch as sp
    from spsparse_torch.ops import (prepare_shuffle_spmv, shuffle_gather,
                                    shuffle_gather_reference)

    dev = _cuda()
    rng = np.random.default_rng(55)
    r = np.repeat(np.arange(1001), 3)
    c = rng.integers(0, 700, r.size)
    b = sp.CooBuilder((1001, 700), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), rng.uniform(0.5, 1, r.size))
    prep = prepare_shuffle_spmv(b.build(device=dev), ell_k=ell_k)
    if ell_k == 5:
        assert prep.n_slots % 4 != 0
    x = rng.uniform(-1, 1, 700).astype(np.float32)
    x[c[:50]] = np.inf
    x = torch.from_numpy(x).to(dev)
    dirty_cache(dev, prep.n_slots * 4)
    slots = shuffle_gather(prep, x)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(slots).any())
    assert bool(torch.isinf(slots).any())
    assert torch.equal(slots, shuffle_gather_reference(prep, x))
    assert not bool(slots.reshape(-1)[prep.ell_cols < 0].any())


@pytest.mark.parametrize("case", ["random", "tail_empty_rows", "skewed"])
def test_k10_matches_plain(case):
    from spsparse_torch.ops import (segmented_row_sums,
                                    segmented_row_sums_reference)

    dev = _cuda()
    rng = np.random.default_rng(60)
    if case == "random":
        counts = rng.integers(0, 20, 5000)
    elif case == "tail_empty_rows":        # rows not a multiple of 256
        counts = np.zeros(1000, np.int64)
        counts[[0, 999]] = 1
    else:                                  # one row of 400 among rows of one
        counts = np.ones(64, np.int64)
        counts[0] = 400
        counts[5:9] = 0
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    prod = rng.uniform(-1, 1, int(rp[-1]) + 100).astype(np.float32)
    args = (torch.from_numpy(prod).to(dev), torch.from_numpy(rp).to(dev))
    before = segmented_row_sums.launches
    y = segmented_row_sums(*args, nrows=counts.size, rows_per_block=256,
                           entries_per_block=128)
    torch.cuda.synchronize()
    assert segmented_row_sums.launches == before + 1
    ref = segmented_row_sums_reference(*args, counts.size)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    assert bool((y[torch.from_numpy(counts == 0).to(dev)] == 0).all())


def test_k10_spmv_csr_segsum_matches_scipy():
    import spsparse_torch as sp
    from spsparse_torch.ops import spmv_csr_segsum

    dev = _cuda()
    rng = np.random.default_rng(61)
    A = coo_of(dev, (4000, 3000), rng.integers(0, 4000, 30000),
               rng.integers(0, 3000, 30000), 62)
    idx = A.indices[: A.nnz].cpu().numpy()
    dense = np.zeros(A.shape)
    np.add.at(dense, (idx[:, 0], idx[:, 1]),
              A.vals[: A.nnz].cpu().numpy().astype(np.float64))
    x = rng.uniform(-1, 1, 3000).astype(np.float32)
    y = spmv_csr_segsum(sp.to_csr(A), torch.from_numpy(x).to(dev))
    want = dense @ x.astype(np.float64)
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def canon_blocks(arrays):
    """Blocks sorted by keys and payload bits: equal iff the keys are equal
    and the payloads agree as a multiset within each run of equal keys."""
    from spsparse_torch.ops import sort_blocks_reference

    bits = tuple(a.view(torch.int32) for a in arrays)
    return sort_blocks_reference(bits, num_keys=len(bits))


@pytest.mark.parametrize("shape,num_keys,n_payload", [
    ((3, 1, 128), 1, 1), ((5, 8, 128), 1, 1), ((4, 32, 128), 2, 1),
    ((2, 64, 128), 1, 3),
    ((3, 256, 128), 2, 1),       # 384 KB a block: past the smem chunk
    ((1, 1024, 128), 1, 1),      # 1 MB a block: many global passes
    ((2, 64, 128), 2, 2),        # four arrays: a 4096-element chunk
    ((2, 32, 128), 1, 4),        # five arrays: the generic kernel
    ((3, 2, 128), 3, 5),         # eight arrays, three keys
])
def test_k12_matches_plain(shape, num_keys, n_payload):
    from spsparse_torch.ops import sort_blocks, sort_blocks_reference

    dev = _cuda()
    rng = np.random.default_rng(sum(shape) + num_keys)
    keys = [torch.from_numpy(rng.integers(-50, 50 if k else 1 << 20, shape)
                             .astype(np.int32)).to(dev)
            for k in range(num_keys)]
    pays = [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
            .to(dev) for _ in range(n_payload)]
    arrays = tuple(keys + pays)
    dirty_cache(dev, sum(a.numel() for a in arrays) * 4)
    before = sort_blocks.launches
    got = sort_blocks(arrays, num_keys=num_keys)
    torch.cuda.synchronize()
    assert sort_blocks.launches == before + 1
    ref = sort_blocks_reference(arrays, num_keys=num_keys)
    for g, r in zip(got[:num_keys], ref[:num_keys]):
        assert torch.equal(g, r)
    for g, r in zip(canon_blocks(got), canon_blocks(ref)):
        assert torch.equal(g, r)
    # The same network and tie rule from one call to the next: payloads
    # too.
    assert chip_smoke.bitwise_equal(torch, got,
                                    sort_blocks(arrays, num_keys=num_keys))


@pytest.mark.parametrize("n_arrays,num_keys", [
    (1, 1), (2, 1), (3, 1), (2, 2), (3, 2), (4, 2), (4, 1), (5, 1), (8, 3)])
@pytest.mark.parametrize("R", [1, 2, 4, 8, 16, 64, 256, 1024])
def test_k12_geometry_is_the_kernels(R, n_arrays, num_keys):
    """The host replay's copy of the chunk geometry (block_sort_geometry,
    which the CPU tests' schedule replay runs on) equals what the library
    launches, for every specialised and generic shape."""
    from spsparse_torch.ops.block_sort import block_sort_geometry

    _cuda()
    n = R * 128
    assert (chip_smoke.k12_geometry(n, n_arrays, num_keys)
            == block_sort_geometry(n, n_arrays, num_keys))


@pytest.mark.parametrize("key_bound", [8, None])
def test_k12_stable_is_exact(key_bound):
    from spsparse_torch.ops import sort_blocks_reference, sort_blocks_stable

    dev = _cuda()
    rng = np.random.default_rng(70)
    kk = torch.from_numpy(rng.integers(0, 8, (6, 16, 128)).astype(
        np.int32)).to(dev)
    pay = torch.arange(kk.numel(), dtype=torch.int32, device=dev).reshape(
        kk.shape)
    got = sort_blocks_stable(kk, (pay,), key_bound=key_bound)
    for g, r in zip(got, sort_blocks_reference((kk, pay))):
        assert torch.equal(g, r)


def test_k12_rejects_bad_blocks():
    from spsparse_torch.ops import sort_blocks

    dev = _cuda()
    with pytest.raises(ValueError):
        sort_blocks((torch.zeros((1, 7, 128), dtype=torch.int32,
                                 device=dev),))
    with pytest.raises(TypeError):
        sort_blocks((torch.zeros((1, 8, 128), dtype=torch.float64,
                                 device=dev),))
    with pytest.raises(ValueError):
        sort_blocks((torch.full((1, 8, 128), float("nan"), device=dev),))


@pytest.mark.parametrize("num_keys,n_arrays", [(1, 2), (2, 10), (1, 12)])
def test_k12_float_keys_and_many_arrays(num_keys, n_arrays):
    """float32 keys (ties, both zeros, infinities, subnormals) through the
    order-preserving int32 map, and more arrays than the kernel takes
    (keys with a position payload through K12, then a gather)."""
    import chip_smoke
    from spsparse_torch.ops import sort_blocks, sort_blocks_reference

    dev = _cuda()
    rng = np.random.default_rng(90 + n_arrays)
    shape = (6, 16, 128)
    keys = [torch.from_numpy(chip_smoke.float_keys(rng, shape)).to(dev)]
    if num_keys == 2:
        keys.insert(0, torch.from_numpy(rng.integers(0, 5, shape).astype(
            np.int32)).to(dev))
    pays = [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
            .to(dev) for _ in range(n_arrays - num_keys)]
    arrays = tuple(keys + pays)
    before = sort_blocks.launches
    got = sort_blocks(arrays, num_keys=num_keys)
    torch.cuda.synchronize()
    assert sort_blocks.launches == before + 1
    ref = sort_blocks_reference(arrays, num_keys=num_keys)
    for g, r in zip(got[:num_keys], ref[:num_keys]):
        assert torch.equal(g, r)
    for g, r in zip(canon_blocks(got), canon_blocks(ref)):
        assert torch.equal(g, r)
    assert chip_smoke.bitwise_equal(torch, got,
                                    sort_blocks(arrays, num_keys=num_keys))


def test_unstructured_cuda_tensors_never_reach_plain_versions(monkeypatch):
    import importlib

    import spsparse_torch as sp
    from spsparse_torch.ops import (best_spmv, sort_blocks,
                                    sort_blocks_stable, spmv_csr_segsum)

    sh_mod = importlib.import_module("spsparse_torch.ops.spmv_shuffle")
    sg_mod = importlib.import_module("spsparse_torch.ops.segsum")
    bs_mod = importlib.import_module("spsparse_torch.ops.block_sort")
    dev = _cuda()
    prep, x, dense = shuffle_case(dev, "heavy")
    want = dense @ x.cpu().numpy().astype(np.float64)
    csr = sp.to_csr(coo_of(dev, (500, 3000), np.arange(500) % 500,
                           np.arange(500) * 5, 80))
    keys = torch.from_numpy(np.random.default_rng(81).integers(
        0, 9, (2, 8, 128)).astype(np.int32)).to(dev)
    want_keys = torch.sort(keys.reshape(2, -1), dim=1).values

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(sh_mod, "shuffle_gather_reference", refuse)
    monkeypatch.setattr(sg_mod, "segmented_row_sums_reference", refuse)
    monkeypatch.setattr(bs_mod, "sort_blocks_reference", refuse)
    np.testing.assert_allclose(best_spmv(prep, x).cpu().numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert spmv_csr_segsum(csr, torch.ones(3000, device=dev)).shape == (500,)
    assert torch.equal(sort_blocks((keys,))[0].reshape(2, -1), want_keys)
    assert torch.equal(sort_blocks_stable(keys, key_bound=9)[0].reshape(
        2, -1), want_keys)
