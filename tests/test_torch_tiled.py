"""Parity of the port's tiled layouts and tiled kernels with the JAX package.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` (the
Pallas kernels in interpret mode, as the JAX package's own tests run them
on the CPU) and ``spsparse_torch`` on ``device="cpu"``, where the kernel
wrappers of K5 (``spmm_tiled_window``), K6 (``spmm_tiled_dense``) and K7
(``spmm_tiled_onehot``) run their plain versions.

Tolerances: indices, layouts and counts exact; float32 products rtol 1e-5
with atol 1e-5 of max|ref| (sums in another order); bfloat16 blocks atol
1e-4 of max|ref| (exact products, float32 sums in another order);
gradients rtol 1e-4 with atol 1e-4 of max|grad|. Each JAX result is
computed once, in a module-scoped fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spsparse_torch as tsp
import spsparse_tpu as jsp
from spsparse_tpu.core.tiled import pack_columns as j_pack
from spsparse_tpu.ops import pallas_tiled as jpt
from spsparse_tpu.ops import pallas_tiled_window as jpw
from spsparse_tpu.ops import tiled_ops as jto
from spsparse_tpu.ops.spmm import spmm as j_spmm, spmm_bsr as j_spmm_bsr
from spsparse_tpu.solvers import extract_diagonal as j_diag
from spsparse_torch import convert as cv
from spsparse_torch.core.tiled import pack_columns as t_pack
from spsparse_torch.ops import spmm as t_spmm, spmm_bsr as t_spmm_bsr
from spsparse_torch.ops import tiled_ops as tto
from spsparse_torch.ops import tiled_spmm as tts
from spsparse_torch.ops import tiled_window as ttw
from spsparse_torch.solvers import extract_diagonal as t_diag
from port_threads import one_torch_thread  # noqa: F401 (autouse)

tn = cv.tensor_to_numpy


def build_both(shape, rows, cols, vals):
    jb = jsp.CooBuilder(shape, dtype=np.float32)
    tb = tsp.CooBuilder(shape, dtype=np.float32)
    if len(vals):
        idx = np.stack([rows, cols], 1)
        jb.add_many(idx, vals)
        tb.add_many(idx, vals)
    return jb.build(), tb.build(device="cpu")


def regrid(m, k, seed, spread=64, every=1):
    """Column-local entries: k a row near column 2r on every ``every``-th
    row, duplicates possible."""
    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(0, m, every), k)
    cc = np.clip(rr * 2 + rng.integers(-spread, spread + 1, rr.size), 0,
                 2 * m - 1)
    return (m, 2 * m), rr, cc, rng.uniform(-1, 1, rr.size).astype(np.float32)


def scattered(shape, nnz, seed):
    rng = np.random.default_rng(seed)
    return (shape, rng.integers(0, shape[0], nnz),
            rng.integers(0, shape[1], nnz),
            rng.uniform(-1, 1, nnz).astype(np.float32))


MATRICES = {
    "regrid": lambda: regrid(300, 7, 0),
    "scattered": lambda: scattered((512, 8192), 2000, 1),
    "half_rows_empty": lambda: regrid(900, 3, 2, spread=30, every=2),
    "empty": lambda: ((200, 300), np.zeros(0, int), np.zeros(0, int),
                      np.zeros(0, np.float32)),
}

TILED_FIELDS = ("tile_row", "tile_col", "rows", "cols", "vals")


def assert_fields_equal(j, t, names):
    for name in names:
        np.testing.assert_array_equal(
            tn(getattr(t, name)),
            np.asarray(getattr(j, name)).astype(
                tn(getattr(t, name)).dtype), err_msg=name)


def close(got, ref, rtol=1e-5, atol_rel=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), ref, rtol=rtol,
        atol=atol_rel * max(float(np.abs(ref).max(initial=0)), 1e-30))


# ----------------------------------------------------------------------
# core/tiled.py: to_tiled, pack_columns, to_dense
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", MATRICES)
def test_to_tiled_and_pack_columns_exact(name):
    ja, ta = build_both(*MATRICES[name]())
    jt, tt = jsp.to_tiled(ja), tsp.to_tiled(ta)
    assert_fields_equal(jt, tt, TILED_FIELDS)
    assert tt.n_tiles == int(jt.n_tiles) and tt.shape == tuple(jt.shape)
    assert (tt.tile_cap, tt.nt_cap) == (jt.tile_cap, jt.nt_cap)
    np.testing.assert_array_equal(tn(tt.to_dense()), np.asarray(jt.to_dense()))
    jp, jo = j_pack(ja)
    tp, to = t_pack(ta)
    np.testing.assert_array_equal(tn(to), np.asarray(jo))
    assert tp.nnz == int(jp.nnz) and tp.cap == jp.cap
    np.testing.assert_array_equal(tn(tp.indices), np.asarray(jp.indices))
    np.testing.assert_array_equal(tn(tp.vals), np.asarray(jp.vals))


def test_pack_columns_ties_go_to_the_lowest_block():
    # Column c is used once by block rows 0 and 2 (a tie) and twice by
    # block row 1 in column 5: the modal owner of c is block 0, of 5 block 1.
    rows = np.array([0, 256, 130, 131, 300])
    cols = np.array([7, 7, 5, 5, 5])
    ja, ta = build_both((384, 16), rows, cols, np.ones(5, np.float32))
    np.testing.assert_array_equal(tn(t_pack(ta)[1]), np.asarray(j_pack(ja)[1]))


def test_to_tiled_caps_and_errors():
    ja, ta = build_both(*regrid(300, 7, 0))
    jt = jsp.to_tiled(ja, tile_cap=1024, nt_cap=64)
    tt = tsp.to_tiled(ta, tile_cap=1024, nt_cap=64)
    assert_fields_equal(jt, tt, TILED_FIELDS)
    for kw in (dict(tile_cap=4), dict(nt_cap=2)):
        with pytest.raises(jsp.SpSparseError):
            jsp.to_tiled(ja, **kw)
        with pytest.raises(tsp.SpSparseError):
            tsp.to_tiled(ta, **kw)


def test_spmm_tiled_and_spmv_tiled_match_jax():
    ja, ta = build_both(*regrid(300, 7, 0))
    jt, tt = jsp.to_tiled(ja), tsp.to_tiled(ta)
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (600, 5)).astype(np.float32)
    close(tn(tto.spmm_tiled(tt, torch.from_numpy(X))),
          jto.spmm_tiled(jt, jnp.asarray(X)))
    close(tn(tsp.ops.best_spmm(tt, torch.from_numpy(X))),
          jto.spmm_tiled(jt, jnp.asarray(X)))
    close(tn(tto.spmv_tiled(tt, torch.from_numpy(X[:, 0]))),
          jto.spmv_tiled(jt, jnp.asarray(X[:, 0])))


# ----------------------------------------------------------------------
# Prepared layouts and kernels K5 (window), K6 (dense), K7 (one-hot)
# ----------------------------------------------------------------------
N_RHS = 200          # a wide RHS: two 128-column chunks, the last ragged
GROUP = 3            # 8 block rows -> super-rows of 3, 3 and 2


@pytest.fixture(scope="module")
def tiled_case():
    """One column-local matrix with every other row empty (the JAX
    package's uneven-last-super-row case, ``tests/test_tiled_window.py``),
    its layouts in both packages and every JAX product, computed once."""
    shape, rr, cc, vals = regrid(900, 3, 5, spread=30, every=2)
    ja, ta = build_both(shape, rr, cc, vals)
    jt, tt = jsp.to_tiled(ja), tsp.to_tiled(ta)
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, (shape[1], N_RHS)).astype(np.float32)
    W = rng.uniform(-1, 1, (shape[0], N_RHS)).astype(np.float32)
    f32, bf16 = jnp.float32, jnp.bfloat16
    jp = {
        "rows": jpt.prepare_tiled_rows(jt),
        "dense_f32": jpt.prepare_tiled_dense(jt, dtype=f32),
        "dense_bf16": jpt.prepare_tiled_dense(jt, dtype=bf16),
        "window_f32": jpw.prepare_tiled_window(jt, group=GROUP, dtype=f32),
        "window_bf16": jpw.prepare_tiled_window(jt, group=GROUP, dtype=bf16),
    }
    tp = {
        "rows": tts.prepare_tiled_rows(tt),
        "dense_f32": tts.prepare_tiled_dense(tt, dtype=torch.float32),
        "dense_bf16": tts.prepare_tiled_dense(tt, dtype=torch.bfloat16),
        "window_f32": ttw.prepare_tiled_window(tt, group=GROUP,
                                               dtype=torch.float32),
        "window_bf16": ttw.prepare_tiled_window(tt, group=GROUP,
                                                dtype=torch.bfloat16),
    }
    Xj, Wj = jnp.asarray(X), jnp.asarray(W)
    jfun = {"rows": jpt.spmm_tiled_pallas,
            "dense": jpt.spmm_tiled_dense_pallas,
            "window": jpw.spmm_tiled_window_pallas}
    # The JAX products and gradients run under jax.jit: one compile each,
    # where their eager primitives compiled ~100 times for the fixture.
    jy = {key: np.asarray(jax.jit(
        lambda p, x, fn=jfun[key.split("_")[0]]: fn(p, x, interpret=True))(
        p, Xj)) for key, p in jp.items()}

    def jgrad(key, field):
        p, fn = jp[key], jfun[key.split("_")[0]]

        def loss(a, x):
            q = dataclasses.replace(p, **{field: a})
            return jnp.sum(Wj * fn(q, x, interpret=True))

        return [np.asarray(g) for g in jax.jit(
            jax.grad(loss, argnums=(0, 1)))(getattr(p, field), Xj)]

    jg = {"rows": jgrad("rows", "vals"),
          "dense_f32": jgrad("dense_f32", "blocks"),
          "window_f32": jgrad("window_f32", "blocks")}
    return {"ja": ja, "ta": ta, "jt": jt, "tt": tt, "X": X, "W": W,
            "jp": jp, "tp": tp, "jy": jy, "jg": jg}


LAYOUT_FIELDS = {"rows": ("tcols", "rows", "cols", "vals"),
                 "dense": ("tcols", "blocks"),
                 "window": ("wstart", "offs", "blocks")}
FROM_JAX = {"rows": cv.prepared_tiled_rows_from_jax,
            "dense": cv.prepared_tiled_dense_from_jax,
            "window": cv.prepared_tiled_window_from_jax}
T_FUN = {"rows": tts.spmm_tiled_onehot, "dense": tts.spmm_tiled_dense,
         "window": ttw.spmm_tiled_window}
KEYS = ["rows", "dense_f32", "dense_bf16", "window_f32", "window_bf16"]


@pytest.mark.parametrize("key", KEYS)
def test_prepared_layouts_exact(tiled_case, key):
    kind = key.split("_")[0]
    j, t = tiled_case["jp"][key], tiled_case["tp"][key]
    conv = FROM_JAX[kind](j, device="cpu")
    for name in LAYOUT_FIELDS[kind]:
        a, b = getattr(t, name), getattr(conv, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert t.shape == conv.shape == tuple(j.shape)
    if kind == "window":
        assert (t.ws, t.group) == (j.ws, j.group)
        assert t.nbr == 9 and t.offs.shape == (9 * t.tiles_per_row,)


@pytest.mark.parametrize("key", KEYS)
def test_kernel_plain_versions_match_jax(tiled_case, key):
    kind = key.split("_")[0]
    t = tiled_case["tp"][key]
    before = T_FUN[kind].launches
    Y = T_FUN[kind](t, torch.from_numpy(tiled_case["X"]))
    assert T_FUN[kind].launches == before       # CPU: the plain version
    assert Y.dtype == torch.float32 and Y.shape == (900, N_RHS)
    bf16 = key.endswith("bf16")
    close(tn(Y), tiled_case["jy"][key], rtol=0 if bf16 else 1e-5,
          atol_rel=1e-4 if bf16 else 1e-5)
    # the plain version on the layout carried over from JAX agrees too
    conv = FROM_JAX[kind](tiled_case["jp"][key], device="cpu")
    assert torch.equal(T_FUN[kind](conv, torch.from_numpy(
        tiled_case["X"])), Y)


@pytest.mark.parametrize("key,field", [("rows", "vals"),
                                       ("dense_f32", "blocks"),
                                       ("window_f32", "blocks")])
def test_gradients_match_jax(tiled_case, key, field):
    kind = key.split("_")[0]
    p = tiled_case["tp"][key]
    a = getattr(p, field).clone().requires_grad_(True)
    X = torch.from_numpy(tiled_case["X"]).requires_grad_(True)
    q = dataclasses.replace(p, **{field: a})
    (torch.from_numpy(tiled_case["W"]) * T_FUN[kind](q, X)).sum().backward()
    for got, ref in zip((a.grad, X.grad), tiled_case["jg"][key]):
        close(tn(got), ref, rtol=1e-4, atol_rel=1e-4)


def test_to_tiled_dense_reconstruction(tiled_case):
    rec = ttw.to_tiled_dense(tiled_case["tp"]["window_f32"])
    jrec = jpw.to_tiled_dense(tiled_case["jp"]["window_f32"])
    np.testing.assert_array_equal(tn(rec.tcols), np.asarray(jrec.tcols))
    base = tiled_case["tp"]["dense_f32"]
    assert torch.equal(rec.tcols[: base.nbr], base.tcols)
    close(tn(tts.spmm_tiled_dense(rec, torch.from_numpy(tiled_case["X"]))),
          tiled_case["jy"]["dense_f32"])


def test_window_span_checks_match_jax():
    # scattered columns: the window spans everything and the budget check
    # rejects it in both packages (``tests/test_tiled_window.py``)
    m = 4096
    shape, rr, cc, vals = scattered((m, 64 * m), 4 * m, 0)
    ja, ta = build_both(shape, np.repeat(np.arange(m), 4), cc, vals)
    with pytest.raises(jsp.SpSparseError, match="window"):
        jpw.prepare_tiled_window(jsp.to_tiled(ja), group=64)
    with pytest.raises(tsp.SpSparseError, match="window"):
        ttw.prepare_tiled_window(tsp.to_tiled(ta), group=64)
    # a declared RHS width that blows the budget is rejected at prepare
    ja, ta = build_both(*regrid(1024, 5, 7))
    ws = ttw.prepare_tiled_window(tsp.to_tiled(ta), group=4,
                                  dtype=torch.float32).ws
    wide = (ttw._WINDOW_VMEM_BUDGET // (2 * ws * 128 * 4) + 1) * 128
    with pytest.raises(jsp.SpSparseError, match="RHS width"):
        jpw.prepare_tiled_window(jsp.to_tiled(ja), group=4,
                                 dtype=jnp.float32, n_cols_rhs=wide)
    with pytest.raises(tsp.SpSparseError, match="RHS width"):
        ttw.prepare_tiled_window(tsp.to_tiled(ta), group=4,
                                 dtype=torch.float32, n_cols_rhs=wide)


def test_dense_staging_limit_and_rhs_checks(tiled_case):
    tt = tiled_case["tt"]
    with pytest.raises(tsp.SpSparseError, match="GiB"):
        tts.prepare_tiled_dense(tt, host_limit_bytes=1 << 10)
    prep = tiled_case["tp"]["dense_f32"]
    with pytest.raises(ValueError, match="rows"):
        tts.spmm_tiled_dense(prep, torch.zeros((7, 3)))
    with pytest.raises(ValueError, match="2-D"):
        tts.spmm_tiled_onehot(tiled_case["tp"]["rows"], torch.zeros(1800))


# ----------------------------------------------------------------------
# core/bsr.py, spmm_bsr and extract_diagonal on BSR and tiled operands
# ----------------------------------------------------------------------
@pytest.mark.parametrize("block", [(8, 128), (4, 16)])
def test_bsr_layout_and_spmm_match_jax(block):
    ja, ta = build_both(*scattered((300, 500), 900, 11))
    jb, tb = jsp.to_bsr(ja, block), tsp.to_bsr(ta, block)
    conv = cv.bsr_from_jax(jb, device="cpu")
    for name in ("row_ptr", "bcols", "blocks"):
        assert torch.equal(getattr(tb, name), getattr(conv, name)), name
    assert tb.nnz_blocks == conv.nnz_blocks
    np.testing.assert_array_equal(tn(tb.block_rows()),
                                  np.asarray(jb.block_rows()))
    np.testing.assert_array_equal(tn(tb.to_dense()), np.asarray(jb.to_dense()))
    X = np.random.default_rng(12).uniform(-1, 1, (500, 6)).astype(np.float32)
    want = np.asarray(j_spmm_bsr(jb, jnp.asarray(X)))
    close(tn(t_spmm_bsr(tb, torch.from_numpy(X))), want)
    close(tn(t_spmm(tb, torch.from_numpy(X))), np.asarray(j_spmm(jb, X)))
    close(tn(tsp.ops.best_spmm(tb, torch.from_numpy(X))), want)


@pytest.mark.parametrize("fmt", ["bsr", "tiled"])
def test_extract_diagonal_matches_jax(fmt):
    rng = np.random.default_rng(13)
    n = 300
    rows = np.concatenate([rng.integers(0, n, 800), np.arange(n),
                           np.arange(0, n, 7)])     # diagonal duplicates
    cols = np.concatenate([rng.integers(0, n, 800), np.arange(n),
                           np.arange(0, n, 7)])
    vals = rng.uniform(-1, 1, rows.size).astype(np.float32)
    ja, ta = build_both((n, n + 50), rows, cols, vals)
    if fmt == "bsr":
        j, t = jsp.to_bsr(ja, (16, 16)), tsp.to_bsr(ta, (16, 16))
    else:
        j, t = jsp.to_tiled(ja), tsp.to_tiled(ta)
    np.testing.assert_allclose(tn(t_diag(t)), np.asarray(j_diag(j)),
                               rtol=1e-6, atol=1e-7)
    if fmt == "bsr":
        with pytest.raises(tsp.SpSparseError, match="square"):
            t_diag(tsp.to_bsr(ta, (8, 16)))
