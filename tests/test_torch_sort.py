"""The port's bitonic block sort (K12) against the JAX package, at small
size.

The same seeded numpy blocks go through ``spsparse_tpu.ops.pallas_sort``
(the Pallas kernel in interpret mode, as ``tests/test_pallas.py`` runs it)
and through ``spsparse_torch.ops.block_sort`` on the CPU, where
``sort_blocks`` runs its plain version (stable ``torch.sort`` passes).

A bitonic network is not stable, so the rules are: keys exactly equal;
payloads exactly equal where the sort is stable (``sort_blocks_stable``),
and otherwise equal as a multiset within each run of equal keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spsparse_torch.ops import plan_stages as t_plan
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
