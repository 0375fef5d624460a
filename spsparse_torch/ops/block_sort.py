"""Block-local sort of ``(R, 128)`` blocks: kernel K12.

Counterpart of :mod:`spsparse_tpu.ops.pallas_sort` (the Pallas kernel
``_sort_kernel``; the module-name rule drops ``pallas_``). Each
``(R, 128)`` block of ``(nblk, R, 128)`` arrays, read row-major, is sorted
ascending by the lexicographic order of the first ``num_keys`` arrays; the
other arrays ride along. As in the JAX package nothing routes to it: it is
a building block for block-local sorts.

On CUDA tensors :func:`sort_blocks` launches ``sps_block_sort``
(``spsparse_torch/csrc/block_sort.cu``): the bitonic network of
:func:`plan_stages` in shared memory, one CTA per block, with the stages of
long distance run as global-memory passes when a block's arrays exceed the
kernel's shared-memory chunk. The kernel takes int32 keys and 4-byte
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
           "sort_blocks_stable", "float_order_key", "sort_by_permutation"]

Tensor = torch.Tensor

L = 128
MAX_ARRAYS = 8       # must equal kMaxArrays in csrc/block_sort.cu


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
