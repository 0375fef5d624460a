"""The port's bitonic block sort (K12) against the JAX package, at small
size.

The same seeded numpy blocks go through ``spsparse_tpu.ops.pallas_sort``
(the Pallas kernel in interpret mode, as ``tests/test_pallas.py`` runs it)
and through ``spsparse_torch.ops.block_sort`` on the CPU, where
``sort_blocks`` runs its plain version (stable ``torch.sort`` passes).

A bitonic network is not stable, so the rules are: keys exactly equal;
payloads exactly equal where the sort is stable (``sort_blocks_stable``),
and otherwise equal as a multiset within each run of equal keys.

The card's float32 keys and more than 8 arrays: the order-preserving
int32 map ``float_order_key`` is held to float order (ties, both zeros,
infinities, subnormals), and ``sort_by_permutation`` runs here with the
plain sort in K12's place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spsparse_torch.ops import plan_stages as t_plan
from spsparse_torch.ops import sort_blocks_reference as t_reference
from spsparse_torch.ops.block_sort import float_order_key, sort_by_permutation
from spsparse_torch.ops import sort_blocks as t_sort
from spsparse_torch.ops import sort_blocks_stable as t_stable
from spsparse_tpu.ops.pallas_sort import plan_stages as j_plan
from spsparse_tpu.ops.pallas_sort import sort_blocks as j_sort
from spsparse_tpu.ops.pallas_sort import sort_blocks_stable as j_stable


def canon(arrays):
    """Per block, the elements as rows ordered by (keys..., payload bits):
    equal for two sorts iff their keys agree and their payloads agree as a
    multiset within each run of equal keys."""
    cols = [np.asarray(a).reshape(a.shape[0], -1).view(np.int32)
            for a in arrays]
    out = []
    for b in range(cols[0].shape[0]):
        order = np.lexsort([c[b] for c in reversed(cols)])
        out.append(np.stack([c[b][order] for c in cols]))
    return np.stack(out)


def assert_same_sort(got, want, num_keys):
    for g, w in zip(got[:num_keys], want[:num_keys]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(canon([g.numpy() for g in got]),
                                  canon(want))


@pytest.mark.parametrize("R", [1, 8, 32])
def test_one_key_with_payload_matches_jax(R):
    rng = np.random.default_rng(R)
    k = rng.integers(0, 1 << 12, (3, R, 128)).astype(np.int32)   # ties
    v = rng.uniform(-1, 1, (3, R, 128)).astype(np.float32)
    want = j_sort((jnp.asarray(k), jnp.asarray(v)), num_keys=1,
                  interpret=True)
    got = t_sort((torch.from_numpy(k), torch.from_numpy(v)))
    assert_same_sort(got, want, 1)
    assert got[1].dtype == torch.float32
    flat = got[0].reshape(3, -1)
    assert bool((flat[:, 1:] >= flat[:, :-1]).all())


def test_two_key_lexicographic_matches_jax():
    rng = np.random.default_rng(9)
    k1 = rng.integers(0, 8, (2, 8, 128)).astype(np.int32)
    k2 = rng.integers(-(1 << 20), 1 << 20, (2, 8, 128)).astype(np.int32)
    v = rng.integers(0, 1 << 30, (2, 8, 128)).astype(np.int32)
    arrays = (k1, k2, v)
    want = j_sort(tuple(jnp.asarray(a) for a in arrays), num_keys=2,
                  interpret=True)
    got = t_sort(tuple(torch.from_numpy(a) for a in arrays), num_keys=2)
    assert_same_sort(got, want, 2)


@pytest.mark.parametrize("packed", [True, False])
def test_stable_matches_jax_and_numpy(packed):
    rng = np.random.default_rng(10)
    kk = rng.integers(0, 8, (2, 8, 128)).astype(np.int32)
    pay = rng.uniform(-1, 1, (2, 8, 128)).astype(np.float32)
    bound = 8 if packed else None
    want = j_stable(jnp.asarray(kk), (jnp.asarray(pay),), key_bound=bound,
                    interpret=True)
    got = t_stable(torch.from_numpy(kk), (torch.from_numpy(pay),),
                   key_bound=bound)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for b in range(2):
        ref = np.argsort(kk[b].ravel(), kind="stable")
        np.testing.assert_array_equal(got[1][b].numpy().ravel(),
                                      pay[b].ravel()[ref])


@pytest.mark.parametrize("n", [128, 1024, 8192])
def test_plan_stages_matches_jax(n):
    for g, w in zip(t_plan(n), j_plan(n)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("shape", [(1, 7, 128), (1, 8, 64)])
def test_bad_block_shape_raises(shape):
    with pytest.raises(ValueError):
        t_sort((torch.zeros(shape, dtype=torch.int32),))


FLOAT_EDGES = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40, 1.17549435e-38,
     -1.17549435e-38, 1.0, -1.0, 1.0, np.nextafter(np.float32(1), 2),
     3.4028235e38, -3.4028235e38, 0.5, -0.5, 2.0, -2.0, 1e-45],
    np.float32)


def test_float_order_key_is_monotone():
    v = np.concatenate([FLOAT_EDGES, np.random.default_rng(3).uniform(
        -1e3, 1e3, 40).astype(np.float32)])
    k = float_order_key(torch.from_numpy(v)).numpy()
    assert k.dtype == np.int32
    np.testing.assert_array_equal(k[:, None] < k[None, :],
                                  v[:, None] < v[None, :])
    np.testing.assert_array_equal(k[:, None] == k[None, :],
                                  v[:, None] == v[None, :])


def test_float_order_key_refuses_nan_and_other_types():
    with pytest.raises(ValueError):
        float_order_key(torch.tensor([1.0, float("nan")]))
    with pytest.raises(TypeError):
        float_order_key(torch.zeros(3, dtype=torch.float64))


def _float_keys(rng, shape):
    k = rng.uniform(-4, 4, shape).astype(np.float32).round(1)
    pick = rng.random(shape) < 0.2
    k[pick] = FLOAT_EDGES[rng.integers(0, FLOAT_EDGES.size, int(pick.sum()))]
    return k


@pytest.mark.parametrize("num_keys,n_pay", [(1, 1), (1, 9), (2, 10)])
def test_sort_by_permutation_with_plain_sort(num_keys, n_pay):
    """The reorder of the card's wide path, with the plain (stable) sort in
    K12's place: exactly the plain sort of all the arrays, payloads of
    any type."""
    rng = np.random.default_rng(num_keys * 16 + n_pay)
    shape = (3, 8, 128)
    keys = [torch.from_numpy(_float_keys(rng, shape))]
    if num_keys == 2:
        keys.insert(0, torch.from_numpy(rng.integers(0, 4, shape).astype(
            np.int32)))
    kinds = (np.float32, np.int32, np.int64, np.float64)
    pays = [torch.from_numpy(rng.uniform(-9, 9, shape).astype(
        kinds[i % len(kinds)])) for i in range(n_pay)]
    arrays = tuple(keys + pays)
    got = sort_by_permutation(arrays, num_keys, t_reference)
    want = t_reference(arrays, num_keys)
    for g, w, a in zip(got, want, arrays):
        assert g.dtype == a.dtype
        assert torch.equal(g, w)


def test_float_keys_and_ten_arrays_match_jax():
    # XLA on the CPU flushes subnormals to zero in comparisons (they tie
    # with 0 there, and on the TPU), so this key set has none.
    rng = np.random.default_rng(21)
    shape = (2, 1, 128)
    keys = _float_keys(rng, shape)
    keys[np.abs(keys) < 1.17549435e-38] = 0.0
    arrays = (keys,) + tuple(
        rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(9))
    want = j_sort(tuple(jnp.asarray(a) for a in arrays), num_keys=1,
                  interpret=True)
    got = sort_by_permutation(tuple(torch.from_numpy(a) for a in arrays), 1,
                              t_reference)
    assert_same_sort(got, want, 1)
