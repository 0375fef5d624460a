"""Parity of the port's diag-scaled multiply chain with the JAX package.

Random operands and sparse scale vectors (with missing entries and exact
zeros) are made with numpy from a seed and built in both packages.
Indices and nnz must match exactly, float64 values within rtol 1e-12 (the
default "compact" merge sums each run in another order than the JAX
package's tree); with ``merge_method="scatter"`` on the CPU both packages
sum each cell left to right, so values must be bitwise equal.

The seeded cases run the JAX references under ``jax.jit`` (``port_refs``):
one compile for all seeds, where eagerly each seed's capacities compiled
much of the ESC chain anew. The chain shim's case runs first: its eager
call (the shim infers its capacities on the host, so it cannot be jitted)
compiles the chain's primitives, which the single cases after it reuse
eagerly, and it holds the jitted reference to the eager call, capacities
included; the first ``scatter`` seed of ``mv`` does the same for ``mv``.
"""

import importlib
import unittest.mock as mock

import numpy as np
import pytest

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_tpu.ops import multiply as j_multiply, multiply_mv as j_mv
from spsparse_torch.convert import coo_to_numpy
from spsparse_torch.ops import multiply as t_multiply, multiply_mv as t_mv
from port_threads import one_torch_thread  # noqa: F401 (autouse)
import port_refs as refs

JM = importlib.import_module("spsparse_tpu.ops.multiply")
# Every operand of the seeded cases has capacity 16 (14 entries), so
# 16 x 16 products bound every seed's expansion: one shape, one compile.
EXPAND = 256


def build_both(shape, idx, vals, cap=None):
    jb = jsp.CooBuilder(shape, dtype=np.float64)
    tb = tsp.CooBuilder(shape, dtype=np.float64)
    if len(vals):
        jb.add_many(idx, vals)
        tb.add_many(idx, vals)
    return jb.build(cap=cap), tb.build(cap=cap, device="cpu")


def random_both(rng, shape, nnz):
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], axis=1)
    return build_both(shape, idx, rng.uniform(-1, 1, nnz))


def scale_both(rng, n):
    """A sparse scale vector: ~3/4 of the indices present, some exactly 0.
    Capacity 8 whatever the count (n <= 8 here), so that every seed's
    operands have one shape and share the JAX package's compiles."""
    present = np.nonzero(rng.random(n) < 0.75)[0]
    vals = rng.uniform(0.5, 2.0, present.size)
    vals[rng.random(present.size) < 0.2] = 0.0
    return build_both((n,), present[:, None], vals, cap=8)


def assert_same(j, t, *, bitwise=False):
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert tn == int(j.nnz) and tshape == tuple(j.shape)
    assert torder == j.sort_order
    assert t.cap == j.cap
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    if bitwise:
        np.testing.assert_array_equal(tv, np.asarray(j.vals))
    else:
        np.testing.assert_allclose(tv, np.asarray(j.vals), rtol=1e-12,
                                   atol=0, equal_nan=True)


def same_as_eager(j, eager):
    """The jitted reference equals the eager call: capacity, count,
    indices and values, padding included."""
    assert j.cap == eager.cap and int(j.nnz) == int(eager.nnz)
    assert j.sort_order == eager.sort_order
    np.testing.assert_array_equal(np.asarray(j.indices),
                                  np.asarray(eager.indices))
    np.testing.assert_array_equal(np.asarray(j.vals), np.asarray(eager.vals))


def eager_multiply(fn, **kw):
    """An eager call of ``fn`` (a JAX MM chain) and the expansion capacity
    its ``multiply`` inferred."""
    seen = []
    real = JM._expand_products

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    with mock.patch.object(JM, "_expand_products", spy):
        out = fn(**kw)
    return out, seen[0]


def operands(seed, ta=False, tb=False):
    rng = np.random.default_rng(seed)
    I, K, J = 6, 5, 7
    A = random_both(rng, (K, I) if ta else (I, K), 14)
    B = random_both(rng, (J, K) if tb else (K, J), 14)
    scales = [scale_both(rng, n) for n in (I, K, J)]
    return A, B, scales


def test_multiply_chain_shim_matches():
    """The module's one eager ``multiply`` (the shim infers its capacities
    on the host, so it cannot be jitted): it also holds the jitted
    reference of the other cases to the eager call, capacities included."""
    (jA, tA), (jB, tB), ((jsi, tsi), _, _) = operands(50, ta=True)
    from spsparse_tpu.ops import multiply_chain as j_chain
    from spsparse_torch.ops import multiply_chain as t_chain
    eager, expand_cap = eager_multiply(
        j_chain, C=1.5, scalei=jsi, A=jA, tA="T", B=jB)
    bound = refs.expansion_bound(jA, jB, transpose_a=True)
    assert expand_cap <= refs.round_up_pow2(bound) <= EXPAND
    for cap in (None, EXPAND):
        same_as_eager(refs.multiply(1.5, jA, jB, scalei=jsi,
                                    transpose_a=True, expand_cap=cap),
                      eager)
    assert_same(eager, t_chain(C=1.5, scalei=tsi, A=tA, tA="T", B=tB))


@pytest.mark.parametrize("merge_method", ["compact", "scatter"])
@pytest.mark.parametrize("seed", list(range(1, 9)))
def test_mm_scaled_matches_jax(seed, merge_method):
    (jA, tA), (jB, tB), ((jsi, tsi), (jsj, tsj), (jsk, tsk)) = operands(seed)
    kw = dict(scalei=jsi, scalej=jsj, scalek=jsk, merge_method=merge_method)
    j = refs.multiply(0.5, jA, jB, expand_cap=EXPAND, **kw)
    t = t_multiply(0.5, tA, tB, scalei=tsi, scalej=tsj, scalek=tsk,
                   merge_method=merge_method)
    assert_same(j, t, bitwise=merge_method == "scatter")


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_mm_transposes_match_jax(ta, tb):
    (jA, tA), (jB, tB), _ = operands(20 + 2 * ta + tb, ta, tb)
    assert_same(j_multiply(1.0, jA, jB, transpose_a=ta, transpose_b=tb),
                t_multiply(1.0, tA, tB, transpose_a=ta, transpose_b=tb))


def test_mm_c_zero_is_empty():
    (jA, tA), (jB, tB), _ = operands(30)
    j, t = j_multiply(0.0, jA, jB), t_multiply(0.0, tA, tB)
    assert t.nnz == int(j.nnz) == 0
    assert_same(j, t)


@pytest.mark.parametrize("which", ["mm", "mv"])
def test_inner_dimension_mismatch_raises(which):
    rng = np.random.default_rng(31)
    _, tA = random_both(rng, (4, 5), 6)
    _, tB = random_both(rng, (6, 3) if which == "mm" else (6,), 4)
    fn = t_multiply if which == "mm" else t_mv
    with pytest.raises(tsp.SpSparseError):
        fn(1.0, tA, tB)


def test_mm_zero_sum_dropped_nan_sum_emitted():
    # Row 0 of A·B sums to exactly 0 (dropped); row 1 holds a NaN (kept).
    idx = np.array([[0, 0], [0, 1], [1, 0]])
    jA, tA = build_both((2, 2), idx, np.array([1.0, -1.0, np.nan]))
    jB, tB = build_both((2, 1), np.array([[0, 0], [1, 0]]),
                        np.array([2.0, 2.0]))
    j, t = refs.multiply(1.0, jA, jB), t_multiply(1.0, tA, tB)
    assert t.to_lists()[0] == [(1, 0)]
    assert_same(j, t)


def test_mm_duplicate_policy_and_zero_nan_reach_operands():
    idx = np.array([[0, 0], [0, 0], [1, 1], [1, 1]])
    vals = np.array([1.0, 3.0, np.nan, 2.0])
    jA, tA = build_both((2, 2), idx, vals)
    jB, tB = build_both((2, 2), np.array([[0, 0], [1, 1]]),
                        np.array([1.0, 1.0]))
    for pol in ("LEAVE_ALONE", "REPLACE"):
        assert_same(
            refs.multiply(1.0, jA, jB, zero_nan=True,
                          duplicate_policy=getattr(jsp.DuplicatePolicy, pol)),
            t_multiply(1.0, tA, tB, zero_nan=True,
                       duplicate_policy=tsp.DuplicatePolicy[pol]))


@pytest.mark.parametrize("merge_method", ["compact", "scatter"])
@pytest.mark.parametrize("seed", list(range(1, 9)))
def test_mv_scaled_matches_jax(seed, merge_method):
    rng = np.random.default_rng(100 + seed)
    jA, tA = random_both(rng, (7, 6), 16)
    jV, tV = scale_both(rng, 6)
    (jsi, tsi), (jsj, tsj) = scale_both(rng, 7), scale_both(rng, 6)
    kw = dict(scalei=jsi, scalej=jsj, merge_method=merge_method)
    j = refs.multiply_mv(2.0, jA, jV, **kw)
    if seed == 1 and merge_method == "scatter":
        same_as_eager(j, j_mv(2.0, jA, jV, **kw))
    t = t_mv(2.0, tA, tV, scalei=tsi, scalej=tsj, merge_method=merge_method)
    assert_same(j, t, bitwise=merge_method == "scatter")


def test_mv_transpose_matches_jax():
    rng = np.random.default_rng(40)
    jA, tA = random_both(rng, (6, 7), 16)
    jV, tV = random_both(rng, (6,), 5)
    assert_same(j_mv(1.0, jA, jV, transpose_a=True),
                t_mv(1.0, tA, tV, transpose_a=True))
