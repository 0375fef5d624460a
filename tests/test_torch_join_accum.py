"""Parity of the port's joins (``core/join.py``), accumulators
(``core/accum.py``) and ``consolidate(method=...)`` names with the JAX
package.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` and
``spsparse_torch``. Positions, counts, ``n_match``, masks and indices must
match exactly; float64 values within rtol 1e-12, float32 within rtol 1e-6.
The goldens are the reference's xiter goldens and the accumulator cases of
``tests/test_join.py`` and ``tests/test_accum.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spsparse_tpu as jsp
import spsparse_torch as tsp
from spsparse_torch.convert import coo_to_numpy, tensor_to_numpy
from port_threads import one_torch_thread  # noqa: F401 (autouse)

POLICIES = ["ADD", "LEAVE_ALONE", "REPLACE"]
CAP = 16
SENT = 100


def pad(xs, cap=CAP, sentinel=SENT):
    out = np.full((cap,), sentinel, dtype=np.int32)
    out[: len(xs)] = xs
    return out


def assert_same_join(j, t):
    assert t.n_match == int(j.n_match)
    assert len(t.pos) == len(j.pos)
    for tp, jp in zip(t.pos, j.pos):
        np.testing.assert_array_equal(tensor_to_numpy(tp), np.asarray(jp))
    np.testing.assert_array_equal(tensor_to_numpy(t.valid_mask()),
                                  np.asarray(j.valid_mask()))


def both_join(keys, *, cap=None):
    """Run join2 (two key lists) or join3 (three) in both packages on
    padded int32 buffers of one length, so one JAX compile serves all."""
    bufs = [pad(k) for k in keys]
    ns = [len(k) for k in keys]
    jargs, targs = [], []
    for b, n in zip(bufs, ns):
        jargs += [b, np.int32(n)]
        targs += [torch.from_numpy(b), n]
    jf, tf = ((jsp.join2, tsp.join2) if len(keys) == 2
              else (jsp.join3, tsp.join3))
    return (jf(*jargs, sentinel=SENT, cap=cap),
            tf(*targs, sentinel=SENT, cap=cap), bufs)


# The reference's xiter goldens (tests/test_join.py).
JOIN_GOLDENS = {
    "subset": ([[0, 2, 4, 6], [0, 1, 2, 3, 4, 5, 6, 7]], [0, 2, 4, 6]),
    "subset_reversed": ([[0, 1, 2, 3, 4, 5, 6, 7], [0, 2, 4, 6]],
                        [0, 2, 4, 6]),
    "asymmetric": ([[0, 2, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 6]], [2, 4, 6]),
    "empty_first": ([[], [1, 2, 3]], []),
    "empty_second": ([[1, 2, 3], []], []),
    "docstring": ([[0, 3, 4, 8], [1, 4, 5, 6, 7, 8, 10]], [4, 8]),
    "join3": ([[0, 2, 4, 6], [0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 6]],
              [2, 6]),
}


@pytest.mark.parametrize("case", list(JOIN_GOLDENS))
def test_join_goldens_match_jax(case):
    keys, want = JOIN_GOLDENS[case]
    j, t, bufs = both_join(keys)
    assert_same_join(j, t)
    m = t.n_match
    got = [bufs[s][tensor_to_numpy(t.pos[s])[:m]].tolist()
           for s in range(len(keys))]
    assert all(g == want for g in got)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ways", [2, 3])
def test_join_random_keys_match_jax(seed, ways):
    rng = np.random.default_rng(seed)
    keys = [np.sort(rng.choice(40, int(rng.integers(0, CAP + 1)),
                               replace=False)) for _ in range(ways)]
    j, t, _ = both_join(keys)
    assert_same_join(j, t)
    # A cap below the match count clamps n_match and keeps the padding.
    j, t, _ = both_join(keys, cap=3)
    assert_same_join(j, t)


def test_intersect_mask_matches_jax():
    rng = np.random.default_rng(5)
    k1 = pad(np.sort(rng.choice(40, 12, replace=False)))
    k2 = pad(np.sort(rng.choice(40, 9, replace=False)))
    jm, jp = jsp.core.intersect_mask(k1, np.int32(12), k2, np.int32(9), SENT)
    tm, tp = tsp.core.intersect_mask(torch.from_numpy(k1), 12,
                                     torch.from_numpy(k2), 9, SENT)
    np.testing.assert_array_equal(tensor_to_numpy(tm), np.asarray(jm))
    np.testing.assert_array_equal(tensor_to_numpy(tp), np.asarray(jp))
    assert tp.dtype == torch.int32


# ----------------------------------------------------------------------
# Accumulators
# ----------------------------------------------------------------------
def stream_both(rank3=False):
    """The duplicate-bearing stream of tests/test_accum.py ((1,2) three
    times), or a random rank-3 stream with duplicates."""
    if rank3:
        rng = np.random.default_rng(9)
        shape = (4, 5, 6)
        idx = np.stack([rng.integers(0, s, 40) for s in shape], 1)
        idx[20:30] = idx[:10]
        vals = rng.uniform(-1, 1, 40)
    else:
        shape = (2, 4)
        idx = np.array([[1, 2], [0, 1], [1, 2], [1, 3], [1, 2]])
        vals = np.array([3.0, 14.0, 15.0, 5.0, -1.0])
    jb = jsp.CooBuilder(shape, dtype=np.float64)
    tb = tsp.CooBuilder(shape, dtype=np.float64)
    jb.add_many(idx, vals)
    tb.add_many(idx, vals)
    return jb.build(), tb.build(device="cpu")


@pytest.mark.parametrize("rank3", [False, True], ids=["golden", "rank3"])
@pytest.mark.parametrize("policy", POLICIES)
def test_scatter_to_dense_matches_jax(policy, rank3):
    j, t = stream_both(rank3)
    jpol, tpol = getattr(jsp.DuplicatePolicy, policy), tsp.DuplicatePolicy[
        policy]
    jd = np.asarray(jsp.scatter_to_dense(j, duplicate_policy=jpol))
    td = tensor_to_numpy(tsp.scatter_to_dense(t, duplicate_policy=tpol))
    np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)
    if not rank3:
        want = {"ADD": 17.0, "LEAVE_ALONE": 3.0, "REPLACE": -1.0}[policy]
        assert td[1, 2] == want and td[0, 1] == 14.0 and td[1, 3] == 5.0


@pytest.mark.parametrize("policy", POLICIES)
def test_scatter_into_existing_leaves_out_alone(policy):
    j, t = stream_both()
    base = np.full((2, 4), 100.0)
    tbase = torch.from_numpy(base.copy())
    jd = np.asarray(jsp.scatter_to_dense(
        j, out=jnp.asarray(base),
        duplicate_policy=getattr(jsp.DuplicatePolicy, policy)))
    td = tensor_to_numpy(tsp.scatter_to_dense(
        t, out=tbase, duplicate_policy=tsp.DuplicatePolicy[policy]))
    np.testing.assert_allclose(td, jd, rtol=1e-12, atol=0)
    assert td[0, 0] == 100.0
    np.testing.assert_array_equal(tensor_to_numpy(tbase), base)


def test_scalar_sum_and_permute_match_jax():
    for rank3 in (False, True):
        j, t = stream_both(rank3)
        np.testing.assert_allclose(float(tsp.scalar_sum(t)),
                                   float(jsp.scalar_sum(j)), rtol=1e-12)
        perm = (1, 0) if not rank3 else (2, 0, 1)
        ti, tv, tn, tshape, torder = coo_to_numpy(tsp.permute_output(t, perm))
        jp = jsp.permute_output(j, perm)
        np.testing.assert_array_equal(ti, np.asarray(jp.indices))
        np.testing.assert_array_equal(tv, np.asarray(jp.vals))
        assert (tn, tshape, torder) == (int(jp.nnz), jp.shape, jp.sort_order)
    assert float(tsp.scalar_sum(stream_both()[1])) == 36.0


@pytest.mark.parametrize("keep,shape", [((1,), None), ((2, 0), None),
                                        ((0,), (7,))])
def test_project_output_matches_jax(keep, shape):
    j, t = stream_both(rank3=len(keep) > 1 or shape is not None)
    jp, tp = jsp.project_output(j, keep, shape), tsp.project_output(t, keep,
                                                                    shape)
    ti, tv, tn, tshape, torder = coo_to_numpy(tp)
    np.testing.assert_array_equal(ti, np.asarray(jp.indices))
    np.testing.assert_array_equal(tv, np.asarray(jp.vals))
    assert (tn, tshape, torder) == (int(jp.nnz), jp.shape, jp.sort_order)
    # The projection's duplicates merge under a later consolidate
    # (against a numpy oracle: the JAX consolidate is held elsewhere).
    want = np.zeros(tshape)
    np.add.at(want, tuple(ti[:tn].T), tv[:tn])
    got = tsp.consolidate(tp, tuple(range(len(keep))))
    np.testing.assert_allclose(tensor_to_numpy(got.to_dense()), want,
                               rtol=1e-12, atol=1e-15)


def test_project_output_golden():
    _, t = stream_both()
    c = tsp.consolidate(tsp.project_output(t, (1,)), (0,))
    idx, vals = c.to_lists()
    assert idx == [(1,), (2,), (3,)]
    np.testing.assert_allclose(vals, [14.0, 17.0, 5.0])


# ----------------------------------------------------------------------
# consolidate(method=...): any name other than "compact" is the scatter
# merge, in both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["ADD", "REPLACE"])
@pytest.mark.parametrize("method", ["sort", "segment"])
def test_consolidate_other_method_names_match_jax(method, policy):
    rng = np.random.default_rng(17)
    shape = (9, 11)
    idx = np.stack([rng.integers(0, s, 60) for s in shape], 1)
    idx[30:45] = idx[:15]
    vals = rng.uniform(-1, 1, 60)
    vals[::7] = 0.0
    jb = jsp.CooBuilder(shape, dtype=np.float64)
    tb = tsp.CooBuilder(shape, dtype=np.float64)
    jb.add_many(idx, vals)
    tb.add_many(idx, vals)
    jpol, tpol = getattr(jsp.DuplicatePolicy, policy), tsp.DuplicatePolicy[
        policy]
    j = jsp.consolidate(jb.build(), (0, 1), jpol, method=method)
    t = tsp.consolidate(tb.build(device="cpu"), (0, 1), tpol, method=method)
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert (tn, tshape, torder) == (int(j.nnz), j.shape, j.sort_order)
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    # Both packages sum each run left to right here: bitwise equal.
    np.testing.assert_array_equal(tv, np.asarray(j.vals))
