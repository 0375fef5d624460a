"""The port's general SpMM path against the JAX package, at small size.

``prepare_general`` → ``spmm_general`` / ``spmv_general`` / ``best_spmm`` /
``best_spmv`` with the same seeded numpy inputs through ``spsparse_tpu``
(Pallas kernels in interpret mode) and ``spsparse_torch`` on
``device="cpu"`` (kernel wrappers K5-K7 run their plain versions), and
``chip_smoke.spmm_path`` rehearsed on the CPU.

Matrices are those of ``tests/test_general.py``: packable, scattered,
column-local, mid-fill and long-tailed. The scattered one is bench config
3b's kind at 1024 rows (4 random columns a row of 8192), in the regime of
the ``(4096, 32768)`` and ``(2048, 16384)`` ones there (columns shared
across block rows, so packing cannot raise the fill): the JAX consolidate
behind their gather layout compiles for about 20 s on the CPU at their
capacities.

Tolerances: routes, orders, indices and layouts exact, except the values
of the gather layouts, which ``consolidate`` sums (rtol 1e-6: the JAX merge
sums a run of duplicates as a tree, the port in order); float32 products
rtol 1e-5 with atol 1e-5 of max|ref| (sums in another order); gradients
rtol 1e-4 with atol 1e-4 of max|grad|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import spsparse_torch as tsp
import spsparse_tpu as jsp
from spsparse_tpu.ops import best_spmm as j_best_spmm
from spsparse_tpu.ops import best_spmv as j_best_spmv
from spsparse_tpu.ops import prepare_general as j_prepare
from spsparse_tpu.ops import spmm_general as j_spmm
from spsparse_tpu.ops import spmv_general as j_spmv
from spsparse_torch import convert as cv
from spsparse_torch.ops import best_spmm as t_best_spmm
from spsparse_torch.ops import best_spmv as t_best_spmv
from spsparse_torch.ops import prepare_general as t_prepare
from spsparse_torch.ops import spmm_general as t_spmm
from spsparse_torch.ops import spmv_general as t_spmv
from port_threads import one_torch_thread  # noqa: F401 (autouse)

tn = cv.tensor_to_numpy


def build_both(shape, rows, cols, vals):
    idx = np.stack([rows, cols], 1)
    jb = jsp.CooBuilder(shape, dtype=np.float32)
    tb = tsp.CooBuilder(shape, dtype=np.float32)
    jb.add_many(idx, vals)
    tb.add_many(idx, vals)
    return jb.build(), tb.build(device="cpu")


def scattered_entries(rng, m=1024, k=4, ncols=8192):
    rows = np.repeat(np.arange(m), k)
    return ((m, ncols), rows, rng.integers(0, ncols, rows.size),
            rng.uniform(-1, 1, rows.size).astype(np.float32))


def random_entries(rng, shape, nnz):
    return (shape, rng.integers(0, shape[0], nnz),
            rng.integers(0, shape[1], nnz),
            rng.uniform(-1, 1, nnz).astype(np.float32))


def local_entries(rng, m, k, spread=64):
    r = np.repeat(np.arange(m), k)
    c = np.clip(r * 2 + rng.integers(-spread, spread + 1, r.size), 0,
                2 * m - 1)
    return (m, 2 * m), r, c, rng.uniform(-1, 1, r.size).astype(np.float32)


def mid_fill_entries(rng):
    r = np.concatenate([blk * 128 + np.arange(40) for blk in range(4)])
    return (512, 512), r, r.copy(), rng.uniform(-1, 1, r.size).astype(
        np.float32)


def long_tail_entries(rng):
    rows = np.concatenate([np.zeros(3000, np.int64),
                           rng.integers(1, 1024, 1000)])
    cols = rng.integers(0, 8192, 4000)
    return (1024, 8192), rows, cols, rng.uniform(-1, 1, 4000).astype(
        np.float32)


def close(got, ref, rtol=1e-5, atol_rel=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), ref, rtol=rtol,
        atol=atol_rel * max(float(np.abs(ref).max(initial=0)), 1e-30))


# name: (entries, JAX route, RHS width)
CASES = {
    "packable": (lambda rng: random_entries(rng, (512, 8192), 2000),
                 "one_hot", 16),
    "scattered": (scattered_entries, "gather_ell", 16),
    "local": (lambda rng: local_entries(rng, 512, 50), "dense_window", 72),
    "mid_fill": (mid_fill_entries, "one_hot", 64),
    "long_tail": (long_tail_entries, "gather", 8),
}


@pytest.fixture(scope="module")
def general():
    """Each matrix prepared in both packages, with the JAX products,
    computed once."""
    out = {}
    for seed, (name, (make, _, n_rhs)) in enumerate(CASES.items()):
        rng = np.random.default_rng(seed)
        ja, ta = build_both(*make(rng))
        X = rng.uniform(-1, 1, (ja.shape[1], n_rhs)).astype(np.float32)
        jpg = j_prepare(ja)
        out[name] = {"ja": ja, "ta": ta, "X": X, "jpg": jpg,
                     "tpg": t_prepare(ta),
                     "jy": np.asarray(j_spmm(jpg, jnp.asarray(X),
                                             interpret=True))}
    return out


def layout_arrays(prep) -> dict:
    return {k: v for k, v in vars(prep).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("name", CASES)
def test_prepare_general_route_matches_jax(general, name):
    case = general[name]
    jpg, tpg = case["jpg"], case["tpg"]
    assert jpg.kernel == CASES[name][1]
    assert tpg.kernel == jpg.kernel
    assert (tpg.order is None) == (jpg.order is None)
    if tpg.order is not None:
        np.testing.assert_array_equal(tn(tpg.order), np.asarray(jpg.order))
    conv = cv.prepared_general_from_jax(jpg, device="cpu")
    assert type(conv.prep) is type(tpg.prep)
    want = layout_arrays(conv.prep)
    got = layout_arrays(tpg.prep)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        if key == "vals" and jpg.kernel.startswith("gather"):
            close(tn(got[key]), tn(want[key]), rtol=1e-6, atol_rel=1e-6)
        else:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", CASES)
def test_spmm_general_matches_jax(general, name):
    case = general[name]
    Y = t_spmm(case["tpg"], torch.from_numpy(case["X"]))
    assert Y.dtype == torch.float32
    close(tn(Y), case["jy"])
    close(tn(t_best_spmm(case["tpg"], torch.from_numpy(case["X"]))),
          case["jy"])


def test_spmv_and_best_spmv_dispatch(general):
    case = general["local"]
    x = case["X"][:, 0].copy()
    want = np.asarray(j_spmv(case["jpg"], jnp.asarray(x), interpret=True))
    close(tn(t_spmv(case["tpg"], torch.from_numpy(x))), want)
    close(tn(t_best_spmv(case["tpg"], torch.from_numpy(x))),
          np.asarray(j_best_spmv(case["jpg"], jnp.asarray(x))))


def test_dense_block_route_when_the_window_is_too_wide():
    # Two dense tiles a block row, 80 column blocks apart: fill >= 64 and a
    # window span of 81 column blocks, over the float32 budget. Handed over
    # as tiles (no packing), both packages take the per-tile dense layout.
    rng = np.random.default_rng(21)
    rows = np.repeat(np.arange(512), 2)
    cols = (rows // 128) * 128 + rng.integers(0, 128, rows.size) \
        + np.tile([0, 80 * 128], 512)
    ja, ta = build_both((512, 128 * 84), rows, cols,
                        rng.uniform(-1, 1, rows.size).astype(np.float32))
    jpg, tpg = j_prepare(jsp.to_tiled(ja)), t_prepare(tsp.to_tiled(ta))
    assert jpg.kernel == tpg.kernel == "dense_block"
    X = rng.uniform(-1, 1, (128 * 84, 24)).astype(np.float32)
    close(tn(t_spmm(tpg, torch.from_numpy(X))),
          np.asarray(j_spmm(jpg, jnp.asarray(X), interpret=True)))


def test_bf16_low_fill_routes_ell(general):
    case = general["scattered"]
    jpg = j_prepare(case["ja"], dtype=jnp.bfloat16)
    tpg = t_prepare(case["ta"], dtype=torch.bfloat16)
    assert jpg.kernel == tpg.kernel == "gather_ell"
    assert tpg.prep.vals.dtype == torch.bfloat16
    conv = cv.prepared_general_from_jax(jpg, device="cpu")
    assert torch.equal(conv.prep.cols, tpg.prep.cols)
    close(tn(conv.prep.vals), tn(tpg.prep.vals), rtol=1e-2, atol_rel=1e-2)
    X = case["X"]
    close(tn(t_spmm(tpg, torch.from_numpy(X))),
          np.asarray(j_spmm(jpg, jnp.asarray(X))))


def test_warnings_for_dtypes_that_do_not_apply(general):
    with pytest.warns(UserWarning, match="row-gather"):
        assert t_prepare(general["long_tail"]["ta"],
                         dtype=torch.bfloat16).kernel == "gather"
    with pytest.warns(UserWarning, match="one-hot"):
        assert t_prepare(general["mid_fill"]["ta"],
                         dtype=torch.bfloat16).kernel == "one_hot"


def test_gather_layout_grads_match_jax(general):
    case = general["scattered"]
    X = case["X"]
    gj = np.asarray(jax.grad(lambda Xc: jnp.sum(
        j_spmm(case["jpg"], Xc) ** 2))(jnp.asarray(X)))
    Xt = torch.from_numpy(X).requires_grad_(True)
    (t_spmm(case["tpg"], Xt) ** 2).sum().backward()
    close(tn(Xt.grad), gj, rtol=1e-4, atol_rel=1e-4)


def test_no_pack_and_inner_mismatch(general):
    case = general["packable"]
    tpg = t_prepare(case["ta"], pack=False)
    assert tpg.order is None
    close(tn(t_spmm(tpg, torch.from_numpy(case["X"]))), case["jy"])
    with pytest.raises(tsp.SpSparseError):
        t_spmm(tpg, torch.zeros((7, 4)))


def test_best_spmm_routes_every_format():
    rng = np.random.default_rng(22)
    n = 96
    rows, cols = [], []
    for off in (-1, 0, 2):
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    _, ta = build_both((n, n), rows, cols,
                       rng.uniform(-1, 1, rows.size).astype(np.float32))
    X = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    ref = tn(ta.to_dense()).astype(np.float64) @ X
    for conv in (tsp.to_csr, tsp.to_dia, tsp.to_tiled,
                 lambda a: tsp.to_bsr(a, (8, 8)), t_prepare,
                 lambda a: tsp.ops.prepare_tiled_rows(tsp.to_tiled(a)),
                 lambda a: tsp.ops.prepare_tiled_dense(tsp.to_tiled(a)),
                 lambda a: tsp.ops.prepare_tiled_window(
                     tsp.to_tiled(a), dtype=torch.float32)):
        close(tn(t_best_spmm(conv(ta), torch.from_numpy(X))), ref)


def test_spmm_path_rehearsal_matches_jax_tiles():
    """``chip_smoke.spmm_path`` at m = 4096 on the CPU: every phase's
    checks pass, and config 3's tiles equal the JAX package's."""
    state = chip_smoke.spmm_path(torch, tsp, "cpu", m=4096, m_onehot=4096,
                                 m_3b=2048, m_grad=2048)
    rr, cc, vals = state["reg"]["entries"]
    jt = jsp.to_tiled(build_both((4096, 8192), rr, cc, vals)[0])
    tt = state["reg"]["tl"]
    assert tt.n_tiles == int(jt.n_tiles) and tt.tile_cap == jt.tile_cap
    np.testing.assert_array_equal(tn(tt.tile_col), np.asarray(jt.tile_col))
    assert state["win"]["pg"].kernel == "dense_window"
