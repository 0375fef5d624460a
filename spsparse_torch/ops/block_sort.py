"""Block-local sort of ``(R, 128)`` blocks: kernel K12.

Counterpart of :mod:`spsparse_tpu.ops.pallas_sort` (the Pallas kernel
``_sort_kernel``; the module-name rule drops ``pallas_``). Each
``(R, 128)`` block of ``(nblk, R, 128)`` arrays, read row-major, is sorted
ascending by the lexicographic order of the first ``num_keys`` arrays; the
other arrays ride along. As in the JAX package nothing routes to it: it is
a building block for block-local sorts.

On CUDA tensors :func:`sort_blocks` launches ``sps_block_sort``
(``spsparse_torch/csrc/block_sort.cu``): the bitonic network of
:func:`plan_stages` over a chunk of each block held in registers, E
elements of every array a thread, with the stages of short distance run in
registers, those of middle distance by warp shuffles, and shared memory
used only to change the chunk's placement between threads
(:func:`block_sort_schedule` gives the sequence, :func:`block_sort_geometry`
the chunk); a block larger than the chunk runs its stages of long distance
as global-memory passes. The kernel takes int32 keys and 4-byte
payloads (any type, moved as bits), at most ``MAX_ARRAYS`` = 8 arrays.
:func:`sort_blocks` widens that on the card: float32 keys are sorted
through the order-preserving int32 map :func:`float_order_key`, and more
than 8 arrays (or payloads of another width) by sorting the keys with an
int32 position payload through K12 and gathering every array by that
permutation (:func:`sort_by_permutation`), which is exact. Keys of any
other type raise. On CPU tensors it runs the plain version
:func:`sort_blocks_reference`: stable ``torch.sort`` passes, from the last
key to the first.

A bitonic network is not stable, so with tied keys the payload order of
the kernel, of its plain version and of the JAX kernel may differ; the
keys never do. :func:`sort_blocks_stable` makes the keys unique with the
element position, as the JAX package does, and is then exact.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from .. import backend

__all__ = ["plan_stages", "sort_blocks", "sort_blocks_reference",
           "sort_blocks_stable", "float_order_key", "sort_by_permutation",
           "block_sort_geometry", "block_sort_schedule", "smem_index"]

Tensor = torch.Tensor

L = 128
MAX_ARRAYS = 8       # must equal kMaxArrays in csrc/block_sort.cu
# csrc/block_sort.cu's chunk limits: kMaxThreads, kSmemBudget, and the
# (num_keys, n_arrays) shapes with kernels of their own.
SORT_MAX_THREADS = 512
SORT_SMEM_BUDGET = 96 * 1024
SORT_SPECIALISED = {(1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (2, 4)}


def plan_stages(n: int):
    """The bitonic network for n=R*128 elements: per stage (distance d,
    span) with d the partner distance and span the direction period.
    Returns (branch_ids, span_masks, n_stages)."""
    stages = []
    span = 2
    while span <= n:
        d = span // 2
        while d >= 1:
            stages.append((d, span if span < n else 2 * n))
            d //= 2
        span *= 2
    branch = []
    span_masks = []
    for d, sm in stages:
        if d < L:
            branch.append(int(np.log2(d)))
        else:
            branch.append(7 + int(np.log2(d // L)))
        span_masks.append(sm)
    return (np.asarray(branch, np.int32), np.asarray(span_masks, np.int32),
            len(stages))


def block_sort_geometry(n: int, n_arrays: int, num_keys: int
                        ) -> tuple[int, int, int]:
    """``(C, E, threads)`` of K12 for blocks of ``n`` elements: the chunk a
    CTA sorts, the elements of each array a thread holds in registers, and
    the CTA's threads (``reg::geometry`` in ``csrc/block_sort.cu``).

    E is 16 for the specialised shapes of up to four arrays and 8 otherwise
    (4 for chunks under 32 E); C is the largest power of two up to n with
    at most ``SORT_MAX_THREADS`` threads, ``C <= 32 E^2`` (so that every
    distance across warps is a register distance once the chunk is
    striped) and its arrays within ``SORT_SMEM_BUDGET``."""
    big = 16 if (num_keys, n_arrays) in SORT_SPECIALISED else 8
    eb = big.bit_length() - 1
    c = n
    while (c > SORT_MAX_THREADS * big or c > 1 << (2 * eb + 5)
           or c * n_arrays * 4 > SORT_SMEM_BUDGET):
        c //= 2
    elems = big if c >= 32 * big else 4
    return c, elems, c // elems


def smem_index(e):
    """Shared-memory word of chunk element ``e`` (int or integer tensor) in
    K12's exchanges: 16-byte chunks XOR-swizzled within 128-byte rows."""
    q = e >> 2
    return ((q ^ ((q >> 3) & 7)) << 2) | (e & 3)


def block_sort_schedule(n: int, elems: int, threads: int) -> list[tuple]:
    """The steps K12 runs on a block of ``n`` elements with chunks of
    ``C = elems * threads`` (``elems`` a power of two >= 4, ``threads`` a
    power of two >= 32, ``C <= 32 elems^2``), in order:

    * ``("load", base_span)``: a chunk pass starts, reading its elements
      striped (placement ``"L1"``: element ``i * threads + t`` in register
      ``i`` of thread ``t``);
    * ``("exchange", placement)``: the chunk changes placement through
      shared memory, to ``"L0"`` (blocked: element ``t * elems + i``) or
      ``"L1"``;
    * ``("register", d, span, placement)``, ``("shuffle", d, span, "L0")``:
      a stage of distance ``d`` within a thread's registers, or between
      lanes ``lane ^ (d / elems)`` of a warp;
    * ``("global", d, span)``: a stage of distance ``d >= C`` as a pass
      over device memory;
    * ``("store",)``: the chunk pass writes its elements, striped.

    ``span`` is the direction mask of :func:`plan_stages` (the span, or
    ``2 n`` for the last). The stages, in order, are exactly those of
    :func:`plan_stages`."""
    C = elems * threads
    eb, sh = elems.bit_length() - 1, threads.bit_length() - 1
    if (elems < 4 or threads < 32 or elems & (elems - 1)
            or threads & (threads - 1) or sh > eb + 5 or n & (n - 1)
            or C > n):
        raise ValueError(f"no K12 chunk of {elems} x {threads} for n={n}")
    steps = []

    def chunk_pass(first, last):
        steps.append(("load", first))
        steps.append(("exchange", "L0"))
        where = "L0"
        span = first
        while span <= last:
            mask = span if span < n else 2 * n
            k = min(span, C).bit_length() - 2
            while k >= 0:
                d = 1 << k
                if k >= sh and (where == "L1" or k >= eb + 5):
                    if where != "L1":
                        steps.append(("exchange", "L1"))
                        where = "L1"
                    steps.append(("register", d, mask, "L1"))
                else:
                    if where != "L0":
                        steps.append(("exchange", "L0"))
                        where = "L0"
                    kind = "register" if k < eb else "shuffle"
                    steps.append((kind, d, mask, "L0"))
                k -= 1
            span *= 2
        if where != "L1":
            steps.append(("exchange", "L1"))
        steps.append(("store",))

    chunk_pass(2, C)
    span = 2 * C
    while span <= n:
        mask = span if span < n else 2 * n
        d = span // 2
        while d >= C:
            steps.append(("global", d, mask))
            d //= 2
        chunk_pass(span, span)
        span *= 2
    return steps


def sort_blocks_reference(arrays: Sequence[Tensor], num_keys: int = 1
                          ) -> tuple:
    """Plain PyTorch K12: the block permutation from stable ``torch.sort``
    passes over the keys, the last key first, applied to every array."""
    nblk, R, Lx = arrays[0].shape
    flat = [a.reshape(nblk, R * Lx) for a in arrays]
    perm = torch.arange(R * Lx, device=flat[0].device).expand(nblk, -1)
    for key in reversed(flat[:num_keys]):
        order = torch.sort(key.gather(1, perm), dim=1, stable=True).indices
        perm = perm.gather(1, order)
    return tuple(a.gather(1, perm).reshape(nblk, R, Lx) for a in flat)


def float_order_key(keys: Tensor) -> Tensor:
    """int32 keys in the order of float32 ``keys``: ``a < b`` exactly when
    ``key(a) < key(b)``, and equal floats give equal keys. -0.0 becomes
    +0.0 first (the two compare equal under the JAX ``<``); then the bits
    of a negative float are flipped all but the sign, and a non-negative
    float keeps its bits (flipping every bit of a negative float and the
    sign bit of a non-negative one orders them as unsigned integers;
    re-biasing to signed gives this). Subnormals keep their IEEE order
    (XLA on the CPU and the TPU flushes them to zero in comparisons, so
    there they tie with 0). NaN has no place in that order and raises."""
    if keys.dtype != torch.float32:
        raise TypeError(f"float_order_key takes float32, got {keys.dtype}")
    if bool(torch.isnan(keys).any()):
        raise ValueError("sort_blocks: NaN keys have no order (the JAX "
                         "kernel's order for them is undefined)")
    bits = torch.where(keys == 0, torch.zeros_like(keys), keys).view(
        torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def sort_by_permutation(arrays: Sequence[Tensor], num_keys: int,
                        sort) -> tuple:
    """Sort blocks by the keys through ``sort`` (K12's launcher, or a plain
    version in its place) carrying only an int32 position, then gather
    every array by the permutation: float32 keys go through
    :func:`float_order_key`, and any number of payloads of any type ride
    along. Exact: a permutation applied to every array."""
    nblk, R, Lx = arrays[0].shape
    if num_keys + 1 > MAX_ARRAYS:
        raise ValueError(f"sort_blocks: at most {MAX_ARRAYS - 1} keys, got "
                         f"{num_keys}")
    keys = tuple(float_order_key(k) if k.dtype == torch.float32 else k
                 for k in arrays[:num_keys])
    pos = torch.arange(R * Lx, dtype=torch.int32, device=keys[0].device)
    pos = pos.reshape(1, R, Lx).expand(nblk, R, Lx).contiguous()
    perm = sort(keys + (pos,), num_keys)[-1].reshape(nblk, -1).long()
    return tuple(a.reshape(nblk, -1).gather(1, perm).reshape(nblk, R, Lx)
                 for a in arrays)


def _launch(arrays: Sequence[Tensor], num_keys: int) -> tuple:
    """K12 on int32 keys and 4-byte payloads, at most ``MAX_ARRAYS``."""
    nblk, R, Lx = arrays[0].shape
    ins = [a.contiguous() for a in arrays]
    outs = [torch.empty_like(a) for a in ins]
    in_ptrs = (ctypes.c_void_p * len(ins))(*[a.data_ptr() for a in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[a.data_ptr() for a in outs])
    lib = backend.load_kernels()
    err = lib.sps_block_sort(
        ctypes.cast(in_ptrs, ctypes.c_void_p),
        ctypes.cast(out_ptrs, ctypes.c_void_p), len(ins), num_keys, nblk,
        R * Lx, backend.current_stream(ins[0].device))
    backend.check(err, "sps_block_sort")
    sort_blocks.launches += 1
    return tuple(outs)


def sort_blocks(arrays: Sequence[Tensor], *, num_keys: int = 1) -> tuple:
    """Sort each ``(R, 128)`` block of ``(nblk, R, 128)`` arrays ascending
    by the first ``num_keys`` arrays (lexicographic), carrying the rest.

    All arrays must share the block shape; R must be a power of two.
    Elements are ordered row-major within a block. NOT stable — see
    :func:`sort_blocks_stable`. On the card the keys must be int32 or
    float32 (no NaN) and at most 7 when the arrays are more than 8 or a
    key is float32; any other key type raises ``TypeError``.

    CUDA tensors launch kernel K12 (``sort_blocks.launches`` counts the
    launches); CPU tensors take :func:`sort_blocks_reference`."""
    arrays = tuple(arrays)
    nblk, R, Lx = arrays[0].shape
    if Lx != L or R & (R - 1):
        raise ValueError(f"block must be (R=2^k, {L}); got ({R}, {Lx})")
    if not 1 <= num_keys <= len(arrays):
        raise ValueError(f"num_keys {num_keys} with {len(arrays)} arrays")
    for a in arrays:
        if tuple(a.shape) != (nblk, R, Lx) or a.device != arrays[0].device:
            raise ValueError("sort_blocks: arrays must share one shape and "
                             "device")
    if arrays[0].device.type == "cpu":
        return sort_blocks_reference(arrays, num_keys)
    key_types = {a.dtype for a in arrays[:num_keys]}
    if not key_types <= {torch.int32, torch.float32}:
        raise TypeError("sort_blocks: keys must be int32 or float32 on the "
                        f"card, got {sorted(map(str, key_types))}")
    if (key_types == {torch.int32} and len(arrays) <= MAX_ARRAYS
            and all(a.element_size() == 4 for a in arrays)):
        return _launch(arrays, num_keys)
    return sort_by_permutation(arrays, num_keys, _launch)


sort_blocks.launches = 0


def sort_blocks_stable(key: Tensor, payloads: Sequence[Tensor] = (), *,
                       key_bound: int | None = None) -> tuple:
    """Stable ascending block sort of int32 ``key`` (+ payload arrays).

    Stability is bought by tie-breaking on the in-block element position:
    when ``key_bound * R * 128 <= 2^31`` the position packs into the key
    itself (single-key network, cheapest); otherwise the position rides as
    a second lex key. Returns ``(sorted_key, *sorted_payloads)``.
    """
    nblk, R, Lx = key.shape
    n = R * Lx
    pos = torch.arange(n, dtype=torch.int32, device=key.device).reshape(
        1, R, Lx).expand(nblk, R, Lx)
    if key_bound is not None and key_bound * n <= 2 ** 31:
        packed = key * n + pos
        out = sort_blocks((packed,) + tuple(payloads), num_keys=1)
        return (torch.div(out[0], n, rounding_mode="floor"),) + out[1:]
    out = sort_blocks((key, pos) + tuple(payloads), num_keys=2)
    return (out[0],) + out[2:]
