"""GAP's uniform-random graph ("Urand", Beamer, Asanovic, Patterson,
arXiv:1508.03619): ``2^scale`` vertices, ``degree * 2^scale`` edges with
both endpoints uniform, made undirected (every edge stored both ways),
self-loops dropped. Duplicates are left in: building the graph removes
them.

Weights (SSSP) are a function of the unordered vertex pair and the seed,
uniform on the 2^24 values ``k / 2^24``, ``k = 1 .. 2^24`` (so in (0, 1]
and exact in float32): both directions of an edge, and every duplicate of
it, carry the same weight, so any rule for merging duplicates gives the
same graph.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_K = 0x45D9F3B     # < 2^27, so a 32-bit value times it stays inside int64


def n_vertices(cfg: dict) -> int:
    return 1 << cfg["scale"]


def n_edges(cfg: dict) -> int:
    return cfg["degree"] << cfg["scale"]


def _mix(h: Tensor) -> Tensor:
    h = (((h >> 16) ^ h) * _K) & _M32
    h = (((h >> 16) ^ h) * _K) & _M32
    return (h >> 16) ^ h


def pair_weight(a: Tensor, b: Tensor, seed: int) -> Tensor:
    """Float32 weight of the unordered pairs ``{a, b}`` (int tensors)."""
    lo = torch.minimum(a, b).long()
    hi = torch.maximum(a, b).long()
    h = _mix(lo ^ (seed & _M32))
    h = _mix(h ^ hi ^ ((seed >> 32) & _M32))
    return ((h >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))


def arcs(cfg: dict, seed: int, device, *, weighted: bool
         ) -> tuple[Tensor, Tensor]:
    """``(indices (E, 2) int32, vals (E,) float32)``: every generated edge
    that is not a self-loop, as ``(u, v)`` and then as ``(v, u)``; values
    1, or the pair's weight when ``weighted``."""
    n, m = n_vertices(cfg), n_edges(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32,
                      device=device)
    v = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32,
                      device=device)
    keep = u != v
    u, v = u[keep], v[keep]
    del keep
    k = u.shape[0]
    idx = torch.empty((2 * k, 2), dtype=torch.int32, device=device)
    idx[:k, 0] = u
    idx[:k, 1] = v
    idx[k:, 0] = v
    idx[k:, 1] = u
    if weighted:
        w = pair_weight(u, v, seed)
        vals = torch.cat([w, w])
    else:
        vals = torch.ones(2 * k, dtype=torch.float32, device=device)
    return idx, vals


def roots(cfg: dict, idx: Tensor, count: int, seed: int) -> list[int]:
    """``count`` SSSP sources drawn uniformly from ``seed`` among the
    vertices with at least one edge (GAP picks non-isolated sources)."""
    n = n_vertices(cfg)
    deg = torch.bincount(idx[:, 0].long(), minlength=n)
    live = torch.nonzero(deg > 0).squeeze(1)
    gen = torch.Generator(device=idx.device)
    gen.manual_seed(seed ^ 0x5EED)
    pick = torch.randint(0, live.shape[0], (count,), generator=gen,
                         device=idx.device)
    return [int(r) for r in live[pick].tolist()]
