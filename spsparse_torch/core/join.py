"""Vectorised sorted-merge joins — the reference's xiter protocol.

Counterpart of :mod:`spsparse_tpu.core.join`. The reference's
``Join2Xiter``/``Join3Xiter`` advance 2/3 sorted, non-repeating key
streams element by element to successive common keys. Here the same
relation is one ``torch.searchsorted`` probe of stream 1's keys into each
other stream, a match mask, and an order-preserving compaction
(:func:`.consolidate.compact_select`), all on the keys' device.

All functions take padded key arrays plus live counts and return a
:class:`JoinResult` with the matched positions compacted to the front.
Divergence from the JAX package: ``n_match`` is a Python ``int``, like
``SparseCOO.nnz`` in this package.
"""

from __future__ import annotations

import dataclasses

import torch

from .consolidate import compact_select
from .coo import as_tensor, operand_tensor

__all__ = ["JoinResult", "join2", "join3", "intersect_mask"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Matched positions of a k-way sorted join, compacted to the front.

    ``pos[s][m]`` is the position in input stream ``s`` of the ``m``-th
    common key (for ``m < n_match``); padding positions equal the
    RESPECTIVE stream's buffer length (one past its end), so a gather that
    drops out-of-range positions drops them cleanly. ``n_match`` is
    clamped to ``cap``.
    """

    pos: tuple
    n_match: int

    @property
    def cap(self) -> int:
        return self.pos[0].shape[0]

    def valid_mask(self) -> Tensor:
        return torch.arange(self.cap, device=self.pos[0].device) < self.n_match


def _as_padded(keys: Tensor, n: int, sentinel) -> tuple[Tensor, Tensor]:
    live = torch.arange(keys.shape[0], device=keys.device) < n
    return torch.where(live, keys, torch.tensor(sentinel, dtype=keys.dtype,
                                                device=keys.device)), live


def _key_pair(keys1, keys2):
    k1 = as_tensor(keys1)
    k2 = operand_tensor(keys2, k1.device)
    dt = torch.promote_types(k1.dtype, k2.dtype)
    return k1.to(dt), k2.to(dt)


def intersect_mask(keys1, n1, keys2, n2, sentinel):
    """For each live position in sorted ``keys1``, whether its key is
    present in sorted ``keys2``, and at which position. Returns
    ``(match, pos2)``; ``pos2`` is int32."""
    k1, k2 = _key_pair(keys1, keys2)
    n1, n2 = int(n1), int(n2)
    k1, live1 = _as_padded(k1, n1, sentinel)
    k2, _ = _as_padded(k2, n2, sentinel)
    p2 = torch.searchsorted(k2, k1, side="left")
    # Position len(k2) reads the sentinel, like JAX's take(mode="fill").
    ext = torch.cat([k2, k2.new_full((1,), sentinel)])
    found = ext[p2] == k1
    match = live1 & (p2 < n2) & found
    return match, p2.to(torch.int32)


def _compact(match: Tensor, positions, pads, cap: int):
    """Compact matched positions to the front; ``pads[s]`` (stream ``s``'s
    buffer length) fills the slots past the matches."""
    carried, n = compact_select(
        match, tuple(p.to(torch.int32) for p in positions), cap_out=cap)
    n = min(n, cap)
    live = torch.arange(cap, device=match.device) < n
    outs = tuple(torch.where(live, c, torch.tensor(pad, dtype=torch.int32,
                                                   device=c.device))
                 for c, pad in zip(carried, pads))
    return outs, n


def join2(keys1, n1, keys2, n2, *, sentinel,
          cap: int | None = None) -> JoinResult:
    """2-way sorted-unique-key join (reference ``Join2Xiter``).
    ``sentinel`` must compare greater than any live key (use the dimension
    extent)."""
    k1, k2 = _key_pair(keys1, keys2)
    l1, l2 = k1.shape[0], k2.shape[0]
    cap = cap if cap is not None else min(l1, l2)
    match, p2 = intersect_mask(k1, n1, k2, n2, sentinel)
    p1 = torch.arange(l1, dtype=torch.int32, device=k1.device)
    pos, n_match = _compact(match, (p1, p2), (l1, l2), cap)
    return JoinResult(pos=pos, n_match=n_match)


def join3(keys1, n1, keys2, n2, keys3, n3, *, sentinel,
          cap: int | None = None) -> JoinResult:
    """3-way sorted-unique-key join (reference ``Join3Xiter``): keys
    present in all three streams."""
    k1, k2 = _key_pair(keys1, keys2)
    _, k3 = _key_pair(k1, keys3)
    l1, l2, l3 = k1.shape[0], k2.shape[0], k3.shape[0]
    cap = cap if cap is not None else min(l1, l2, l3)
    m12, p2 = intersect_mask(k1, n1, k2, n2, sentinel)
    m13, p3 = intersect_mask(k1, n1, k3, n3, sentinel)
    p1 = torch.arange(l1, dtype=torch.int32, device=k1.device)
    pos, n_match = _compact(m12 & m13, (p1, p2, p3), (l1, l2, l3), cap)
    return JoinResult(pos=pos, n_match=n_match)
