"""The helpers that make the port tests' JAX references (``port_refs``).

A memoized reference must never be handed out for another input: inputs
that differ in one byte, in dtype, in shape or in one keyword get entries
of their own, equal inputs get the cached one, and a caller cannot change
a cached array in place. The ESC capacity helpers are held to a count by
brute force and to ``with_capacity``.
"""

import functools

import numpy as np
import pytest

import spsparse_tpu as jsp
from port_threads import one_torch_thread  # noqa: F401 (autouse)
import port_refs as refs

CALLS = []


def counted(x, *, scale=1.0):
    """A reference that records each time it really runs."""
    CALLS.append(1)
    return np.asarray(x, np.float64) * scale


@pytest.fixture(autouse=True)
def fresh():
    """An empty memo and call count for each case; the cases' entries are
    taken out again afterwards."""
    before = dict(refs._MEMO)
    refs._MEMO.clear()
    CALLS.clear()
    yield
    refs._MEMO.clear()
    refs._MEMO.update(before)


def test_equal_inputs_get_the_cached_entry():
    x = np.arange(6, dtype=np.float32)
    first = refs.memo(counted, x, scale=2.0)
    again = refs.memo(counted, x.copy(), scale=2.0)
    assert again is first and len(CALLS) == 1
    np.testing.assert_array_equal(first, 2.0 * x)


@pytest.mark.parametrize("change", ["byte", "dtype", "shape", "keyword",
                                    "keyword_type"])
def test_a_changed_input_gets_its_own_entry(change):
    x = np.arange(8, dtype=np.int32)
    kw = {"scale": 2.0}
    y, kw2 = x.copy(), dict(kw)
    if change == "byte":
        y.view(np.uint8)[5] ^= 1
    elif change == "dtype":
        y = x.view(np.float32)              # the same bytes
    elif change == "shape":
        y = x.reshape(2, 4)                 # the same bytes and dtype
    elif change == "keyword":
        kw2["scale"] = 3.0
    elif change == "keyword_type":
        kw2["scale"] = 2                    # equal, but an int
    want = refs.memo(counted, x, **kw)
    got = refs.memo(counted, y, **kw2)
    assert len(CALLS) == 2 and got is not want
    assert len(refs._MEMO) == 2


def test_sparse_inputs_are_keyed_by_their_arrays():
    def coo(vals):
        return jsp.SparseCOO.from_arrays(np.array([[0, 1], [2, 0]]),
                                         np.asarray(vals, np.float64), (3, 3))
    a, b = coo([1.0, 2.0]), coo([1.0, 2.0])
    c = coo([1.0, 2.5])
    assert refs.digest(a) == refs.digest(b) != refs.digest(c)
    d = jsp.SparseCOO.from_arrays(np.array([[0, 1], [2, 0]]),
                                  np.array([1.0, 2.0]), (3, 4))
    assert refs.digest(d) != refs.digest(a)       # the shape is a field


def test_cached_arrays_are_read_only():
    x = np.arange(4.0)
    got = refs.memo(counted, x)
    with pytest.raises(ValueError):
        got[0] = 99.0
    with pytest.raises(ValueError):
        got += 1.0
    np.testing.assert_array_equal(refs.memo(counted, x), x)
    assert len(CALLS) == 1
    frozen = refs.freeze(([np.zeros(2)], (np.ones(1), 3)))
    assert not frozen[0][0].flags.writeable
    assert not frozen[1][0].flags.writeable


def test_functions_are_keyed_by_name_and_closures_refused():
    assert refs.digest(counted) != refs.digest(np.add)
    assert refs.digest(functools.partial(counted, scale=2.0)) != \
        refs.digest(functools.partial(counted, scale=3.0))
    scale = 2.0
    with pytest.raises(TypeError):
        refs.memo(lambda: counted(np.ones(1)))
    with pytest.raises(TypeError):
        refs.digest(lambda v: v * scale)
    assert not CALLS


def test_jit_is_one_function_per_static_arguments():
    f = refs.jit(np.multiply, 2.0)
    assert refs.jit(np.multiply, 2.0) is f
    assert refs.jit(np.multiply, 3.0) is not f
    g = refs.jit(jsp.consolidate, sort_order=(0, 1))
    assert refs.jit(jsp.consolidate, sort_order=(0, 1)) is g
    assert refs.jit(jsp.consolidate, sort_order=(1, 0)) is not g


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_expansion_bound_counts_every_product(ta, tb):
    """The bound against a brute-force count over the live entries,
    duplicates, explicit zeros and padding included."""
    rng = np.random.default_rng(7 + 2 * ta + tb)
    ia = rng.integers(0, 5, (12, 2))
    ib = rng.integers(0, 5, (9, 2))
    va, vb = rng.uniform(-1, 1, 12), rng.uniform(-1, 1, 9)
    va[0] = 0.0
    A = jsp.SparseCOO.from_arrays(ia, va, (5, 5), cap=16)
    B = jsp.SparseCOO.from_arrays(ib, vb, (5, 5), cap=16)
    a_k = ia[:, 0] if ta else ia[:, 1]
    b_k = ib[:, 1] if tb else ib[:, 0]
    brute = sum(int(k == kb) for k in a_k for kb in b_k)
    assert refs.expansion_bound(A, B, ta, tb) == brute


def test_trim_is_the_eager_capacity_rule():
    idx = np.array([[0, 0], [1, 1], [2, 2]])
    a = jsp.SparseCOO.from_arrays(idx, np.ones(3), (4, 4), cap=32)
    t = refs.trim(a)
    assert t.cap == refs.round_up_pow2(3) == 4 and int(t.nnz) == 3
    np.testing.assert_array_equal(np.asarray(t.indices),
                                  np.asarray(a.indices)[:4])
