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

K12's schedule (``block_sort_schedule``: stages in registers, by warp
shuffles and as global passes, and the exchanges of placement between
them) is replayed in torch on the kernel's placements and held to the JAX
kernel bit for bit, keys and payloads (the same network and tie rule).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spsparse_torch.ops import plan_stages as t_plan
from spsparse_torch.ops import sort_blocks_reference as t_reference
from spsparse_torch.ops.block_sort import (block_sort_geometry,
                                           block_sort_schedule,
                                           float_order_key, smem_index,
                                           sort_by_permutation)
from spsparse_torch.ops import sort_blocks as t_sort
from spsparse_torch.ops import sort_blocks_stable as t_stable
from spsparse_tpu.ops.pallas_sort import plan_stages as j_plan
from spsparse_tpu.ops.pallas_sort import sort_blocks as j_sort
from spsparse_tpu.ops.pallas_sort import sort_blocks_stable as j_stable
from port_threads import one_torch_thread  # noqa: F401 (autouse)


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


# --- K12's schedule: registers, shuffles, exchanges, global passes ---------
STAGE_KINDS = ("register", "shuffle", "global")


def plan_pairs(n):
    branch, masks, _ = j_plan(n)
    return [(1 << int(b) if b < 7 else 128 << (int(b) - 7), int(m))
            for b, m in zip(np.asarray(branch), np.asarray(masks))]


def _swap(lo, hi, num_keys, up):
    """K12's compare-exchange rule: an ascending pair swaps when lo > hi, a
    descending one when lo <= hi, over the keys lexicographically."""
    le = torch.ones_like(lo[0], dtype=torch.bool)
    for a, b in reversed(list(zip(lo[:num_keys], hi[:num_keys]))):
        le = (a < b) | ((a == b) & le)
    return torch.where(up, ~le, le)


def replay(arrays, num_keys, elems, threads):
    """Run :func:`block_sort_schedule` on int32 ``(nblk, R, 128)`` arrays
    with each chunk held as K12 holds it: ``(threads, elems)`` registers in
    the blocked (L0) or striped (L1) placement, exchanges through
    :func:`smem_index`, register pairs, lane shuffles ``t ^ (d / elems)``
    and global passes."""
    nblk, R, Lx = arrays[0].shape
    n, C = R * Lx, elems * threads
    flat = [a.reshape(nblk, n).clone() for a in arrays]
    t = torch.arange(threads)[:, None]
    i = torch.arange(elems)[None, :]
    elem = {"L0": t * elems + i, "L1": i * threads + t}
    base = (torch.arange(n // C) * C)[None, :, None, None]
    regs, where = None, None
    for step in block_sort_schedule(n, elems, threads):
        kind = step[0]
        if kind == "load":
            regs = [f.reshape(nblk, n // C, C)[..., elem["L1"]] for f in flat]
            where = "L1"
        elif kind == "exchange":
            sm = [torch.empty((nblk, n // C, C), dtype=torch.int32)
                  for _ in regs]
            for s, r in zip(sm, regs):
                s[..., smem_index(elem[where])] = r
            where = step[1]
            regs = [s[..., smem_index(elem[where])] for s in sm]
        elif kind == "register":
            _, d, mask, place = step
            assert place == where
            D = d if place == "L0" else d // threads
            lo_i = [j for j in range(elems) if not j & D]
            hi_i = [j + D for j in lo_i]
            up = ((base + elem[place][:, lo_i]) & mask) == 0
            lo = [r[..., lo_i] for r in regs]
            hi = [r[..., hi_i] for r in regs]
            sw = _swap(lo, hi, num_keys, up)
            for r, a, b in zip(regs, lo, hi):
                r[..., lo_i] = torch.where(sw, b, a)
                r[..., hi_i] = torch.where(sw, a, b)
        elif kind == "shuffle":
            _, d, mask, place = step
            assert place == where == "L0" and elems <= d < 32 * elems
            ld = d // elems
            other = [r[..., t[:, 0] ^ ld, :] for r in regs]
            lower = (t & ld) == 0
            up = ((base + (elem["L0"] & ~d)) & mask) == 0
            lo = [torch.where(lower, r, o) for r, o in zip(regs, other)]
            hi = [torch.where(lower, o, r) for r, o in zip(regs, other)]
            sw = _swap(lo, hi, num_keys, up)
            regs = [torch.where(sw, o, r) for r, o in zip(regs, other)]
        elif kind == "store":
            assert where == "L1"
            for f, r in zip(flat, regs):
                f.reshape(nblk, n // C, C)[..., elem["L1"]] = r
        else:
            _, d, mask = step
            assert d >= C
            idx = torch.arange(n)
            lo_i = idx[(idx & d) == 0]
            hi_i = lo_i + d
            up = (lo_i & mask) == 0
            lo = [f[:, lo_i] for f in flat]
            hi = [f[:, hi_i] for f in flat]
            sw = _swap(lo, hi, num_keys, up)
            for f, a, b in zip(flat, lo, hi):
                f[:, lo_i] = torch.where(sw, b, a)
                f[:, hi_i] = torch.where(sw, a, b)
    return tuple(f.reshape(nblk, R, Lx) for f in flat)


@pytest.mark.parametrize("n,elems,threads,exchanges", [
    (128, 4, 32, 2), (1024, 16, 64, 4), (8192, 16, 512, 10),
    (2048, 8, 256, 8), (32768, 16, 512, 18), (1024, 4, 32, 8)])
def test_k12_schedule_runs_plan_stages_once(n, elems, threads, exchanges):
    """Every (distance, span) of plan_stages exactly once, in its order;
    shuffles only between lanes of a warp, registers only within a
    thread's placement, global passes only past the chunk; the exchanges
    the kernel makes (the load's and the store's included)."""
    steps = block_sort_schedule(n, elems, threads)
    stages = [(s[1], s[2]) for s in steps if s[0] in STAGE_KINDS]
    assert stages == plan_pairs(n)
    C = elems * threads
    for s in steps:
        if s[0] == "shuffle":
            assert elems <= s[1] < 32 * elems
        elif s[0] == "register":
            assert s[1] < elems if s[3] == "L0" else threads <= s[1] < C
        elif s[0] == "global":
            assert s[1] >= C
    assert sum(s[0] == "exchange" for s in steps) == exchanges


def test_k12_geometry_of_the_callers_shapes():
    # (1024, 64, 128) key + payload: one chunk a block, 512 threads.
    assert block_sort_geometry(8192, 2, 1) == (8192, 16, 512)
    assert block_sort_geometry(128, 2, 1) == (128, 4, 32)
    assert block_sort_geometry(32768, 3, 2) == (8192, 16, 512)
    assert block_sort_geometry(8192, 4, 2) == (4096, 16, 256)
    assert block_sort_geometry(2048, 8, 1) == (2048, 8, 256)
    for n in (128, 256, 1024, 8192, 1 << 17):
        for na, nk in ((1, 1), (2, 1), (3, 2), (4, 2), (5, 1), (8, 3)):
            C, elems, threads = block_sort_geometry(n, na, nk)
            assert C == elems * threads and C <= n and threads <= 512
            assert 32 * elems <= C <= 32 * elems * elems
            assert C * na * 4 <= 96 * 1024
            block_sort_schedule(n, elems, threads)


@pytest.mark.parametrize("elems,threads", [(4, 32), (8, 256), (16, 512)])
def test_k12_exchange_is_a_conflict_free_permutation(elems, threads):
    """smem_index permutes the chunk; a warp's 16-byte writes of the
    blocked placement (8 lanes a phase) and its 4-byte accesses of the
    striped one fall on distinct banks."""
    C = elems * threads
    phys = smem_index(torch.arange(C))
    assert torch.equal(torch.sort(phys).values, torch.arange(C))
    t = torch.arange(threads)
    for c in range(elems // 4):
        group = (smem_index(t * elems + 4 * c) // 4) % 8
        for p in range(0, threads, 8):
            assert group[p:p + 8].unique().numel() == 8
    for i in range(elems):
        banks = smem_index(i * threads + t) % 32
        for w in range(0, threads, 32):
            assert banks[w:w + 32].unique().numel() == 32


@pytest.mark.parametrize("R,num_keys,geometry", [
    (1, 1, None), (8, 1, None), (64, 1, None), (8, 2, None),
    (64, 2, None), (8, 1, (4, 32)), (32, 2, (16, 64))])
def test_k12_replay_matches_jax_bitwise(R, num_keys, geometry):
    """The kernel's schedule, replayed in torch on its placements, equals
    the JAX kernel (interpret mode, the same network and tie rule) bit for
    bit, keys and payloads, and the plain version's keys; with many tied
    keys. (4, 32) and (16, 64) chunks run global passes."""
    rng = np.random.default_rng(100 + R * 4 + num_keys)
    shape = (2, R, 128)
    keys = [rng.integers(0, 6, shape).astype(np.int32)
            for _ in range(num_keys)]
    pay = rng.uniform(-1, 1, shape).astype(np.float32)
    n = R * 128
    elems, threads = (geometry or block_sort_geometry(
        n, num_keys + 1, num_keys)[1:])
    got = replay([torch.from_numpy(k) for k in keys]
                 + [torch.from_numpy(pay.view(np.int32))], num_keys, elems,
                 threads)
    want = j_sort(tuple(jnp.asarray(a) for a in keys + [pay]),
                  num_keys=num_keys, interpret=True)
    for g, w in zip(got[:num_keys], want[:num_keys]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[-1].numpy().view(np.float32),
                                  np.asarray(want[-1]))
    ref = t_reference(tuple(torch.from_numpy(a) for a in keys + [pay]),
                      num_keys)
    for g, r in zip(got[:num_keys], ref[:num_keys]):
        assert torch.equal(g, r)
    assert_same_sort((*got[:num_keys], got[-1].view(torch.float32)), want,
                     num_keys)
