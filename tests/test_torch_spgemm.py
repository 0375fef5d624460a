"""The port's SpGEMM slice against the JAX package, at small size.

The same seeded numpy inputs go through ``spsparse_tpu`` (Pallas kernels
in interpret mode, as ``tests/test_spgemm_tiled.py`` and
``tests/test_spgemm_window.py`` run them) and through ``spsparse_torch`` on
``device="cpu"``, where the kernel wrappers K8, K9 and K13 run their plain
versions: ``densify_tiled``, ``plan_tiled_spgemm``/``plan_pstart``, the
pair products, ``plan_window_spgemm``, the band product and
``band_to_tiled_blocks``, K8's slot table and pair stream
(``slot_pstart``, ``band_pair_stream``), NaN and Inf through the plain K8
and K9, ``tiled_blocks_to_coo``, ``spgemm_tiled`` and its routes,
``plan_esc``/``spgemm_planned``, ``best_spgemm``, ``SparseCOO @
SparseCOO``, ``coo_matrix_power``, and ``chip_smoke.spgemm_path``
rehearsed on the CPU.

Tolerances: plans, routes, tile coordinates and indices exact. Float32
blocks within 1e-5 of max|ref| of the JAX output (the sums run in another
order); bfloat16 blocks the same (both packages round the blocks alike,
and the products are exact in float32). Against a float64 dense oracle:
float32 rtol 1e-5 (atol 1e-5 of max|ref|), bfloat16 2e-2 of max|ref|, the
JAX tests' own bound. ``plan_esc(host=True)`` values rtol 1e-6: the JAX
host path sums duplicates in float64.
"""

import dataclasses
import importlib
import unittest.mock as mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import spsparse_torch as tsp
import spsparse_tpu as jsp
from spsparse_torch import convert as cv
from spsparse_torch.ops.spgemm import best_spgemm as t_best
from spsparse_torch.ops.spgemm import coo_matrix_power as t_power
from spsparse_torch.ops.spgemm import plan_spgemm_caps as t_caps
from spsparse_torch.ops.spgemm import spgemm_aat as t_aat
from spsparse_torch.ops.spgemm_planned import plan_esc as t_plan_esc
from spsparse_torch.ops.spgemm_planned import spgemm_planned as t_planned
from spsparse_torch.ops.spgemm_tiled import densify_tiled as t_densify
from spsparse_torch.ops.spgemm_tiled import plan_pstart as t_pstart
from spsparse_torch.ops.spgemm_tiled import plan_tiled_spgemm as t_plan
from spsparse_torch.ops.spgemm_tiled import spgemm_tiled as t_tiled
from spsparse_torch.ops.spgemm_tiled import spgemm_tiled_pairs as t_k9
from spsparse_torch.ops.spgemm_tiled import spgemm_tiled_stream as t_k13
from spsparse_torch.ops.spgemm_tiled import tiled_blocks_to_coo as t_to_coo
from spsparse_torch.ops.spgemm_window import band_pair_stream as t_stream
from spsparse_torch.ops.spgemm_window import band_to_tiled_blocks as t_b2t
from spsparse_torch.ops.spgemm_window import plan_window_spgemm as t_wplan
from spsparse_torch.ops.spgemm_window import spgemm_window as t_k8
from spsparse_torch.ops.tiled_spmm import prepare_tiled_dense as t_prep
from spsparse_torch.ops.tiled_spmm import spmm_tiled_dense as t_spmm_dense
from spsparse_tpu.ops.pallas_tiled import prepare_tiled_dense as j_prep
from spsparse_tpu.ops.pallas_tiled import spmm_tiled_dense_pallas
from spsparse_tpu.ops.spgemm import best_spgemm as j_best
from spsparse_tpu.ops.spgemm import coo_matrix_power as j_power
from spsparse_tpu.ops.spgemm import plan_spgemm_caps as j_caps
from spsparse_tpu.ops.spgemm_planned import plan_esc as j_plan_esc
from spsparse_tpu.ops.spgemm_planned import spgemm_planned as j_planned
from spsparse_tpu.ops.spgemm_tiled import densify_tiled as j_densify
from spsparse_tpu.ops.spgemm_tiled import plan_pstart as j_pstart
from spsparse_tpu.ops.spgemm_tiled import plan_tiled_spgemm as j_plan
from spsparse_tpu.ops.spgemm_tiled import spgemm_tiled as j_tiled
from spsparse_tpu.ops.spgemm_tiled import spgemm_tiled_pallas as j_k9
from spsparse_tpu.ops.spgemm_tiled import tiled_blocks_to_coo as j_to_coo
from spsparse_tpu.ops.spgemm_window import band_to_tiled_blocks as j_b2t
from spsparse_tpu.ops.spgemm_window import plan_window_spgemm as j_wplan
from spsparse_tpu.ops.spgemm_window import spgemm_window_pallas as j_k8
from port_threads import one_torch_thread  # noqa: F401 (autouse)

tn = cv.tensor_to_numpy
routes = chip_smoke.traced_routes
J_TILED = importlib.import_module("spsparse_tpu.ops.spgemm_tiled")
J_WINDOW = importlib.import_module("spsparse_tpu.ops.spgemm_window")
J_SPGEMM = importlib.import_module("spsparse_tpu.ops.spgemm")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def build_both(shape, rows, cols, vals, dtype=np.float32):
    idx = np.stack([rows, cols], 1)
    jb = jsp.CooBuilder(shape, dtype=dtype)
    tb = tsp.CooBuilder(shape, dtype=dtype)
    jb.add_many(idx, vals)
    tb.add_many(idx, vals)
    return jb.build(), tb.build(device="cpu")


def regrid(n_dst, per, rng, jitter=3):
    """``tests/test_spgemm_window.py``'s generator: c = 2r + U(0, jitter),
    a block-banded A A^T."""
    r = np.repeat(np.arange(n_dst), per)
    c = np.minimum(r * 2 + rng.integers(0, jitter, r.size), n_dst * 2 - 1)
    return build_both((n_dst, n_dst * 2), r, c, rng.uniform(0, 1, r.size))


def random_both(shape, nnz, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return build_both(shape, rng.integers(0, shape[0], nnz),
                      rng.integers(0, shape[1], nnz),
                      rng.uniform(-1, 1, nnz), dtype)


def dense(a) -> np.ndarray:
    return np.asarray(tn(a.to_dense()) if isinstance(a, tsp.SparseCOO)
                      else a.to_dense(), np.float64)


def close(got, ref, rtol=1e-5, atol_rel=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), ref, rtol=rtol,
        atol=atol_rel * max(float(np.abs(ref).max(initial=0)), 1e-30))


def same_coo(t, j):
    """Equal nnz, live indices and padding; values within 1e-5."""
    assert t.nnz == int(j.nnz) and t.cap == j.cap
    np.testing.assert_array_equal(tn(t.indices), np.asarray(j.indices))
    close(tn(t.vals), np.asarray(j.vals))


@pytest.fixture(scope="module")
def aat():
    """A block-banded A (512 x 1024) in both packages, densified, with
    its pair plans and the JAX pair products of A A^T (f32, bf16) and of
    C C for C = A A^T (f32)."""
    ja, ta = regrid(512, 4, np.random.default_rng(0))
    out = {"ja": ja, "ta": ta, "jt": {}, "tt": {}, "jout": {}}
    for name, (tdt, jdt) in DTYPES.items():
        out["jt"][name] = j_densify(jsp.to_tiled(ja), dtype=jdt)
        out["tt"][name] = t_densify(tsp.to_tiled(ta), dtype=tdt)
    jplan = j_plan(out["jt"]["f32"], out["jt"]["f32"], transpose_b=True)
    out["jplan"] = {True: jplan}
    for name in DTYPES:
        jb = out["jt"][name]
        out["jout"][(True, name)] = j_k9(jb, jb, jplan, interpret=True)
    jc = j_tiled(ja, ja, transpose_b=True, use_pallas=False).consolidate(
        (0, 1))
    out["jc"] = jc
    out["tc"] = cv.coo_from_numpy(np.asarray(jc.indices), np.asarray(jc.vals),
                                  int(jc.nnz), jc.shape, (0, 1), device="cpu")
    jct = j_densify(jsp.to_tiled(jc))
    out["jct"], out["tct"] = jct, t_densify(tsp.to_tiled(out["tc"]))
    out["jplan"][False] = j_plan(jct, jct)
    out["jout"][(False, "f32")] = j_k9(jct, jct, out["jplan"][False],
                                       interpret=True)
    return out


def operands(aat, transpose_b, name):
    if transpose_b:
        return aat["jt"][name], aat["tt"][name]
    return aat["jct"], aat["tct"]


@pytest.mark.parametrize("name", ["f32", "bf16", "empty"])
def test_densify_tiled_matches_jax(aat, name):
    if name == "empty":
        ja, ta = build_both((300, 200), np.zeros(0, int), np.zeros(0, int),
                            np.zeros(0))
        jt = j_densify(jsp.to_tiled(ja))
        tt = t_densify(tsp.to_tiled(ta))
        assert tuple(tn(tt.tile_row)) == (3,) and tuple(tn(tt.tile_col)) == (2,)
    else:
        jt, tt = aat["jt"][name], aat["tt"][name]
    assert tt.blocks.dtype == DTYPES.get(name, DTYPES["f32"])[0]
    assert tt.tile_row.dtype == tt.tile_col.dtype == torch.int32
    np.testing.assert_array_equal(tn(tt.tile_row), np.asarray(jt.tile_row))
    np.testing.assert_array_equal(tn(tt.tile_col), np.asarray(jt.tile_col))
    close(tn(tt.blocks), np.asarray(jt.blocks, np.float32), rtol=1e-6,
          atol_rel=1e-6)
    conv = cv.tiled_blocks_from_jax(jt, device="cpu")
    assert conv.shape == tt.shape
    np.testing.assert_array_equal(dense(conv), dense(tt))


@pytest.mark.parametrize("transpose_b", [False, True])
def test_plan_tiled_spgemm_matches_jax(aat, transpose_b):
    jb, tb = operands(aat, transpose_b, "f32")
    tplan = t_plan(tb, tb, transpose_b=transpose_b)
    jplan = aat["jplan"][transpose_b]
    assert tplan.n_pairs > 0
    for key in ("pa", "pb", "oid", "out_tile_row", "out_tile_col"):
        got, want = getattr(tplan, key), getattr(jplan, key)
        assert got.dtype == want.dtype == np.int32, key
        np.testing.assert_array_equal(got, want, key)
    assert tplan.out_shape == jplan.out_shape
    assert tplan.transpose_b == jplan.transpose_b
    np.testing.assert_array_equal(t_pstart(tplan), j_pstart(jplan))
    conv = cv.tiled_gemm_plan_from_jax(jplan)
    np.testing.assert_array_equal(conv.tensors("cpu")["pstart"].numpy(),
                                  j_pstart(jplan))


@pytest.mark.parametrize("transpose_b,name",
                         [(False, "f32"), (True, "f32"), (True, "bf16")])
def test_pair_kernel_modules_match_jax(aat, transpose_b, name):
    """K9 (``spgemm_tiled_pairs``) and K13 (``spgemm_tiled_stream``) on the
    CPU against the JAX pair kernel in interpret mode and a float64
    oracle."""
    jb, tb = operands(aat, transpose_b, name)
    plan = t_plan(tb, tb, transpose_b=transpose_b)
    want = aat["jout"][(transpose_b, name)]
    d = dense(jb)
    oracle = d @ (d.T if transpose_b else d)
    for fn in (t_k9, t_k13):
        out = fn(tb, tb, plan)
        assert out.blocks.dtype == torch.float32
        np.testing.assert_array_equal(tn(out.tile_row),
                                      np.asarray(want.tile_row))
        np.testing.assert_array_equal(tn(out.tile_col),
                                      np.asarray(want.tile_col))
        close(tn(out.blocks), np.asarray(want.blocks))
        close(dense(out), oracle)


@pytest.fixture(scope="module")
def window():
    """Window plans of both packages: A A^T (shared), A B^T (two operand)
    and half-empty rows in uneven groups."""
    rng = np.random.default_rng(5)
    ja, ta = regrid(512, 4, rng)
    jb, tb = regrid(512, 3, rng)
    rng = np.random.default_rng(11)
    r = np.repeat(np.arange(0, 900, 2), 2)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), 1799)
    je, te = build_both((900, 1800), r, c, rng.uniform(0, 1, r.size))
    cases = {"shared": (ja, ta, None, None, 4),
             "two_operand": (ja, ta, jb, tb, 2),
             "uneven": (je, te, None, None, 3)}
    out = {}
    for key, (ja_, ta_, jb_, tb_, group) in cases.items():
        for name, (tdt, jdt) in DTYPES.items():
            if name == "bf16" and key != "shared":
                continue
            jpa = j_prep(jsp.to_tiled(ja_), dtype=jdt)
            tpa = t_prep(tsp.to_tiled(ta_), dtype=tdt)
            jpb = jpa if jb_ is None else j_prep(jsp.to_tiled(jb_), dtype=jdt)
            tpb = tpa if tb_ is None else t_prep(tsp.to_tiled(tb_), dtype=tdt)
            rows_b = (jb_ if jb_ is not None else ja_).shape[0]
            kw = dict(nbc=tpa.nbc, out_shape=(ja_.shape[0], rows_b),
                      group=group)
            jplan = j_wplan(jpa.tcols, jpb.tcols, dtype=jdt, **kw)
            tplan = t_wplan(tpa.tcols, tpb.tcols, dtype=tdt, **kw)
            jband = j_k8(jplan, jpa.blocks,
                         None if jplan.shared else jpb.blocks, interpret=True)
            d_a = dense(ta_)
            d_b = d_a if tb_ is None else dense(tb_)
            out[(key, name)] = dict(
                jplan=jplan, tplan=tplan, tpa=tpa, tpb=tpb, jband=jband,
                oracle=d_a @ d_b.T)
    return out


WINDOW_FIELDS = ("cnt", "pt", "pu", "row_lo")
WINDOW_SCALARS = ("W", "G", "wrows", "nbr", "nbr_pad", "rt_a", "rt_b",
                  "out_shape", "shared", "pmax_band", "n_dots")


@pytest.mark.parametrize("key", ["shared", "two_operand", "uneven"])
def test_window_plan_matches_jax(window, key):
    case = window[(key, "f32")]
    jplan, tplan = case["jplan"], case["tplan"]
    assert tplan.shared == (key != "two_operand")
    for f in WINDOW_FIELDS:
        got, want = getattr(tplan, f), np.asarray(getattr(jplan, f))
        assert got.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, f)
    for f in WINDOW_SCALARS:
        assert getattr(tplan, f) == getattr(jplan, f), f
    conv = cv.window_gemm_plan_from_jax(jplan)
    np.testing.assert_array_equal(conv.pt, tplan.pt)
    assert conv.pmax_band == tplan.pmax_band


@pytest.mark.parametrize("key,name", [("shared", "f32"), ("shared", "bf16"),
                                      ("two_operand", "f32"),
                                      ("uneven", "f32")])
def test_window_band_matches_jax(window, key, name):
    """K8 (``spgemm_window``) on the CPU against the JAX band kernel in
    interpret mode; ``band_to_tiled_blocks`` coordinates exact; the dense
    product against float64."""
    case = window[(key, name)]
    tplan = case["tplan"]
    band = t_k8(tplan, case["tpa"].blocks,
                None if tplan.shared else case["tpb"].blocks)
    assert band.dtype == torch.float32
    assert tuple(band.shape) == tuple(case["jband"].shape)
    close(tn(band), np.asarray(case["jband"]))
    dead = tplan.cnt == 0
    assert not tn(band).reshape(-1, 128 * 128)[dead].any()
    tb = t_b2t(band, tplan)
    jb = j_b2t(case["jband"], case["jplan"])
    np.testing.assert_array_equal(tn(tb.tile_row), np.asarray(jb.tile_row))
    np.testing.assert_array_equal(tn(tb.tile_col), np.asarray(jb.tile_col))
    if name == "f32":
        close(dense(tb), case["oracle"])
    else:
        close(dense(tb), case["oracle"], rtol=0, atol_rel=2e-2)


def test_window_needs_b_for_a_two_operand_plan(window):
    case = window[("two_operand", "f32")]
    with pytest.raises(tsp.SpSparseError, match="two-operand"):
        t_k8(case["tplan"], case["tpa"].blocks)


@pytest.mark.parametrize("cap", [None, 64, 100_000])
def test_tiled_blocks_to_coo_matches_jax(aat, cap):
    jout = aat["jout"][(True, "f32")]
    tout = t_k9(aat["tt"]["f32"], aat["tt"]["f32"],
                t_plan(aat["tt"]["f32"], aat["tt"]["f32"], transpose_b=True))
    same_coo(t_to_coo(tout, cap=cap), j_to_coo(jout, cap=cap))


def test_unbanded_plan_falls_back_to_pairs():
    rng = np.random.default_rng(9)
    r = np.repeat(np.arange(1024), 2)
    ja, ta = build_both((1024, 64 * 1024), r,
                        rng.integers(0, 64 * 1024, r.size),
                        rng.uniform(0, 1, r.size))
    jp = j_prep(jsp.to_tiled(ja), dtype=jnp.float32)
    tp = t_prep(tsp.to_tiled(ta))
    for plan, pp in ((j_wplan, jp), (t_wplan, tp)):
        with pytest.raises(Exception, match="window|pairs") as info:
            plan(pp.tcols, pp.tcols, nbc=pp.nbc, out_shape=(1024, 1024))
        assert type(info.value).__name__ == "SpSparseError"
    C, got = routes(lambda: t_tiled(ta, ta, transpose_b=True))
    assert got == [("spgemm_tiled", "pairs")]
    d = dense(ta)
    close(dense(C), d @ d.T)


def test_spgemm_tiled_routes_and_values_match_jax(aat):
    ja, ta = aat["ja"], aat["ta"]
    calls = []
    orig = J_WINDOW.spgemm_window_pallas

    def spy(*a, **k):
        calls.append("window")
        return orig(*a, **k)

    with mock.patch.object(J_WINDOW, "spgemm_window_pallas", spy):
        jc = j_tiled(ja, ja, transpose_b=True, interpret=True)
    assert calls == ["window"]
    tc, got = routes(lambda: t_tiled(ta, ta, transpose_b=True))
    assert got == [("spgemm_tiled", "window")]
    close(dense(tc), dense(jc))
    assert tc.sort_order is None and bool((tc.vals[: tc.nnz] != 0).all())
    _, got = routes(lambda: t_tiled(ta, ta, transpose_b=True,
                                    use_window=False))
    assert got == [("spgemm_tiled", "pairs")]
    cc, got = routes(lambda: t_tiled(aat["tc"], aat["tc"]))
    assert got == [("spgemm_tiled", "pairs")]
    close(dense(cc), np.asarray(aat["jout"][(False, "f32")].to_dense()))


def test_empty_intersection_and_sentinel_filler():
    ja, ta = build_both((128, 256), np.array([0]), np.array([0]),
                        np.array([1.0]))
    jb, tb = build_both((256, 128), np.array([200]), np.array([0]),
                        np.array([1.0]))
    jplan = j_plan(j_densify(jsp.to_tiled(ja)), j_densify(jsp.to_tiled(jb)))
    ta_, tb_ = t_densify(tsp.to_tiled(ta)), t_densify(tsp.to_tiled(tb))
    tplan = t_plan(ta_, tb_)
    assert tplan.n_pairs == jplan.n_pairs == 0
    np.testing.assert_array_equal(t_pstart(tplan), j_pstart(jplan))
    for fn in (t_k9, t_k13):
        out = fn(ta_, tb_, tplan)
        assert tuple(tn(out.tile_row)) == (1,) == tuple(tn(out.tile_col))
        assert not out.blocks.any()
    C = t_tiled(ta, tb)
    assert C.nnz == 0 and C.cap == 1
    assert tuple(tn(C.indices[0])) == (128, 128)


def test_inner_dimension_mismatch_raises():
    _, a = random_both((64, 64), 10, 1)
    _, b = random_both((100, 64), 10, 2)
    ta, tb = t_densify(tsp.to_tiled(a)), t_densify(tsp.to_tiled(b))
    with pytest.raises(tsp.SpSparseError, match="inner dimension"):
        t_plan(ta, tb)
    with pytest.raises(tsp.SpSparseError):
        a @ b


def test_to_prepared_dense_feeds_spmm_tiled_dense(aat):
    jb, tb = aat["jt"]["f32"], aat["tt"]["f32"]
    jout = aat["jout"][(True, "f32")]
    tout = t_k9(tb, tb, t_plan(tb, tb, transpose_b=True))
    jp, tp = jout.to_prepared_dense(), tout.to_prepared_dense()
    np.testing.assert_array_equal(tn(tp.tcols), np.asarray(jp.tcols))
    close(tn(tp.blocks), np.asarray(jp.blocks))
    assert tout.to_prepared_dense(torch.bfloat16).blocks.dtype == \
        torch.bfloat16
    X = np.random.default_rng(5).uniform(-1, 1, (512, 32)).astype(np.float32)
    Y = t_spmm_dense(tp, torch.from_numpy(X))
    close(tn(Y), np.asarray(spmm_tiled_dense_pallas(jp, jnp.asarray(X),
                                                    interpret=True)))
    d = dense(jb)
    close(tn(Y), (d @ d.T) @ X, rtol=1e-4, atol_rel=1e-4)


@pytest.mark.parametrize("host", [False, True])
def test_plan_esc_matches_jax(host):
    ja, ta = random_both((40, 60), 150, 3)
    jplan, jacon, jbcon = j_plan_esc(ja, ja, transpose_b=True, host=host)
    tplan, tacon, tbcon = t_plan_esc(ta, ta, transpose_b=True, host=host)
    for f in ("ea", "eb", "seg", "out_indices"):
        np.testing.assert_array_equal(tn(getattr(tplan, f)),
                                      np.asarray(getattr(jplan, f)), f)
    assert tplan.n_out == jplan.n_out and tplan.out_shape == jplan.out_shape
    assert tacon.cap == jacon.cap and tacon.nnz == int(jacon.nnz)
    np.testing.assert_array_equal(tn(tacon.indices), np.asarray(jacon.indices))
    close(tn(tacon.vals), np.asarray(jacon.vals), rtol=1e-6, atol_rel=0)
    got = t_planned(tplan, tacon.vals, tbcon.vals)
    want = j_planned(jplan, jacon.vals, jbcon.vals)
    assert got.sort_order == (0, 1)
    same_coo(got, want)
    conv = cv.esc_plan_from_jax(jplan, device="cpu")
    assert torch.equal(conv.seg, tplan.seg) and conv.n_out == tplan.n_out


def test_planned_keeps_zero_sums_and_empty_operand():
    _, ta = build_both((2, 2), np.array([0, 0]), np.array([0, 1]),
                       np.array([1.0, 1.0]), np.float64)
    _, tb = build_both((2, 2), np.array([0, 1]), np.array([0, 0]),
                       np.array([1.0, -1.0]), np.float64)
    plan, acon, bcon = t_plan_esc(ta, tb)
    C = t_planned(plan, acon.vals, bcon.vals)
    assert C.nnz == 1 and float(C.vals[0]) == 0.0   # the static pattern
    assert (ta @ tb).nnz == 0                       # the ESC path drops it
    _, te = build_both((4, 2), np.zeros(0, int), np.zeros(0, int),
                       np.zeros(0))
    plan, acon, bcon = t_plan_esc(te, ta)
    assert plan.n_products == 0
    assert t_planned(plan, acon.vals, bcon.vals).nnz == 0


def jax_route(ja) -> list:
    """The engine the JAX ``best_spgemm(ja, ja, transpose_b=True)`` picks,
    recorded without running it."""
    seen = []

    class Picked(Exception):
        pass

    def record(name):
        def fn(*a, **k):
            seen.append(name)
            raise Picked
        return fn

    with mock.patch.object(J_TILED, "spgemm_tiled", record("tiled")), \
            mock.patch.object(J_SPGEMM, "spgemm", record("esc")):
        with pytest.raises(Picked):
            j_best(ja, ja, transpose_b=True)
    return seen


@pytest.mark.parametrize("kind", ["blocky", "scattered", "f64"])
def test_best_spgemm_routes_match_jax(aat, kind):
    if kind == "blocky":
        ja, ta = aat["ja"], aat["ta"]
    else:
        ja, ta = random_both((300, 400), 150, 4,
                             np.float64 if kind == "f64" else np.float32)
    want = jax_route(ja)
    assert want == ["tiled" if kind == "blocky" else "esc"]
    tc, got = routes(lambda: t_best(ta, ta, transpose_b=True))
    assert got[-1] == ("best_spgemm", want[0])
    assert tc.sort_order == (0, 1) and tc.dtype == ta.dtype
    d = dense(ta)
    close(dense(tc), d @ d.T)
    if kind == "blocky":
        same_coo(tc, aat["jc"])


def test_sparse_matmul_matches_jax():
    ja, ta = random_both((50, 70), 120, 6)
    jb, tb = random_both((70, 40), 110, 7)
    same_coo(ta @ tb, ja @ jb)
    close(dense(ta @ tb), dense(ta) @ dense(tb))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_coo_matrix_power_matches_jax(aat, k):
    jc, tc = aat["jc"], aat["tc"]
    got, want = t_power(tc, k), j_power(jc, k)
    assert got.shape == want.shape and got.nnz == int(want.nnz)
    close(dense(got), dense(want))
    if k == 0:
        assert torch.equal(got.to_dense(), torch.eye(512))
    with pytest.raises(tsp.SpSparseError):
        t_power(tc, -1)


def test_plan_spgemm_caps_and_aat_match_jax(aat):
    ja, ta = aat["ja"], aat["ta"]
    assert t_caps(ta, ta, transpose_b=True) == j_caps(ja, ja,
                                                      transpose_b=True)
    close(dense(t_aat(ta)), dense(aat["jc"]))


def test_spgemm_path_rehearsal_matches_jax():
    """``chip_smoke.spgemm_path`` at 1024 rows on the CPU: every phase's
    checks pass, and its tiles, pair plan and A A^T equal the JAX
    package's on the same entries."""
    state = chip_smoke.spgemm_path(torch, tsp, "cpu", n=1024)
    r, c, v = chip_smoke.cfg4_entries(1024)
    ja, ta = build_both((1024, 2048), r, c, v)
    cfg = state["cfg"]
    jt = jsp.to_tiled(ja)
    assert cfg["tl"].n_tiles == int(jt.n_tiles)
    jd = j_densify(jt)
    jplan = j_plan(jd, jd, transpose_b=True)
    tplan = state["pairs"]["plans"]["A A^T"]
    for f in ("pa", "pb", "oid"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    assert state["k8"]["plan"]["f32"].W == 1
    jc = j_tiled(ja, ja, transpose_b=True, use_pallas=False)
    C = state["k8"]["C"]
    assert C.nnz == int(jc.nnz)
    close(dense(C), dense(jc))


# ----------------------------------------------------------------------
# K8 and K9 on one cp.async ring: the host tables that K8 walks, and the
# non-finite semantics that the kernels' skipping of zero warp blocks keeps
# ----------------------------------------------------------------------
@pytest.mark.parametrize("key", ["shared", "two_operand", "uneven"])
def test_window_slot_pstart_matches_jax_cnt(window, key):
    """``slot_pstart`` is the running sum of the JAX plan's ``cnt`` with
    dead slots (no pair, a row past A's, a column outside B's) at 0."""
    case = window[(key, "f32")]
    jplan, tplan = case["jplan"], case["tplan"]
    nb = jplan.W * 2 + 1
    i = np.repeat(np.arange(jplan.nbr_pad), nb)
    j = i + np.tile(np.arange(nb), jplan.nbr_pad) - jplan.W
    nbr_a, nbr_b = case["tpa"].tcols.shape[0], case["tpb"].tcols.shape[0]
    cnt = np.asarray(jplan.cnt).reshape(-1)
    live = (i < nbr_a) & (j >= 0) & (j < nbr_b)
    want = np.concatenate([[0], np.cumsum(np.where(live, cnt, 0))])
    got = tplan.tensors("cpu")["slot_pstart"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(tn(got), want)
    assert int(want[-1]) == tplan.n_live > 0
    if key == "uneven":
        assert tplan.nbr_pad > tplan.nbr and not cnt[i >= nbr_a].any()


@pytest.mark.parametrize("key,name", [("shared", "f32"), ("shared", "bf16"),
                                      ("two_operand", "f32"),
                                      ("uneven", "f32")])
def test_window_pair_stream_matches_jax_band(window, key, name):
    """The pair stream K8 walks (``band_pair_stream``), fed through the
    plain pair product over the flattened ``(nbr*Rt, 128, 128)`` blocks,
    gives the JAX band in every slot; dead slots exactly zero."""
    case = window[(key, name)]
    tplan = case["tplan"]
    slot, a_tile, b_tile = t_stream(tplan)
    sp = tplan.slot_pstart
    np.testing.assert_array_equal(np.bincount(slot, minlength=sp.size - 1),
                                  np.diff(sp))
    fa = case["tpa"].blocks.reshape(-1, 128, 128).to(torch.float32)
    fb = case["tpb"].blocks.reshape(-1, 128, 128).to(torch.float32)
    band = torch.zeros((sp.size - 1, 128, 128))
    band.index_add_(0, torch.from_numpy(slot),
                    fa[a_tile] @ fb[b_tile].transpose(1, 2))
    band = tn(band).reshape(np.asarray(case["jband"]).shape)
    close(band, np.asarray(case["jband"]))
    assert not band.reshape(-1, 128 * 128)[tplan.cnt == 0].any()


def plant_nonfinite(blocks, at_inf, at_nan):
    """A float32 copy of ``blocks`` (flattened to tiles) with an Inf and a
    NaN planted at ``(tile, row, col)``."""
    out = blocks.to(torch.float32).numpy().copy()
    flat = out.reshape(-1, 128, 128)
    flat[at_inf] = np.inf
    flat[at_nan] = np.nan
    return out


def same_nonfinite(got, want):
    """NaN and signed Inf at the same places; finite values within 1e-5."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin])


@pytest.mark.parametrize("kernel", ["k8", "k9"])
def test_plain_versions_keep_nonfinite_like_jax(window, aat, kernel):
    """An Inf in a B row whose partner A rows are mostly zero, and a NaN:
    the plain K8 and K9 give NaN (0 * Inf) and Inf where the JAX kernels in
    interpret mode do. The CUDA kernels' zero-block skipping is held to
    these plain versions on the card."""
    if kernel == "k8":
        case = window[("two_operand", "f32")]
        tplan = case["tplan"]
        _, _, b_tile = t_stream(tplan)
        a_np = case["tpa"].blocks.numpy()
        b_np = plant_nonfinite(case["tpb"].blocks, (b_tile[0], 7, 11),
                               (b_tile[-1], 3, 5))
        got = t_k8(tplan, torch.from_numpy(a_np), torch.from_numpy(b_np))
        want = j_k8(case["jplan"], jnp.asarray(a_np), jnp.asarray(b_np),
                    interpret=True)
        same_nonfinite(tn(got), want)
        return
    ta, ja = aat["tt"]["f32"], aat["jt"]["f32"]
    plan = t_plan(ta, ta, transpose_b=True)
    b_np = plant_nonfinite(ta.blocks, (int(plan.pb[0]), 7, 11),
                           (int(plan.pb[-1]), 3, 5))
    tb = dataclasses.replace(ta, blocks=torch.from_numpy(b_np))
    jb = dataclasses.replace(ja, blocks=jnp.asarray(b_np))
    got = t_k9(ta, tb, plan)
    want = j_k9(ja, jb, aat["jplan"][True], interpret=True)
    same_nonfinite(tn(got.blocks), want.blocks)
