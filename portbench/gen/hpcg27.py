"""HPCG's problem: the 27-point stencil on an ``nx x ny x nz`` grid.

Rows are grid points in natural order, ``row = ix + nx * (iy + ny * iz)``
(HPCG 3.1, ``GenerateProblem``). Row ``r`` holds ``diag`` at ``(r, r)``
and ``off`` at each of its up to 26 neighbours inside the grid, so the
operator has ``(3 nx - 2)(3 ny - 2)(3 nz - 2)`` live entries on 27
diagonals with offsets ``dx + nx dy + nx ny dz``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def offsets() -> list[tuple[int, int, int]]:
    """The 27 ``(dx, dy, dz)`` of the stencil, ``dz`` slowest."""
    return [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


def n_rows(cfg: dict) -> int:
    return cfg["nx"] * cfg["ny"] * cfg["nz"]


def n_entries(cfg: dict) -> int:
    return ((3 * cfg["nx"] - 2) * (3 * cfg["ny"] - 2)
            * (3 * cfg["nz"] - 2))


def _span(d: int, size: int) -> slice:
    return slice(max(0, -d), min(size, size - d))


def entries(cfg: dict, device) -> tuple[Tensor, Tensor]:
    """``(indices (E, 2) int32, vals (E,) float32)``: every live entry,
    diagonal by diagonal, each diagonal in row order."""
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    grid = torch.arange(n_rows(cfg), dtype=torch.int32,
                        device=device).view(nz, ny, nx)
    E = n_entries(cfg)
    idx = torch.empty((E, 2), dtype=torch.int32, device=device)
    vals = torch.empty(E, dtype=torch.float32, device=device)
    at = 0
    for dx, dy, dz in offsets():
        rows = grid[_span(dz, nz), _span(dy, ny), _span(dx, nx)].reshape(-1)
        k = rows.shape[0]
        idx[at:at + k, 0] = rows
        idx[at:at + k, 1] = rows + (dx + nx * dy + nx * ny * dz)
        vals[at:at + k] = float(cfg["diag"] if (dx, dy, dz) == (0, 0, 0)
                                else cfg["off"])
        at += k
    if at != E:
        raise RuntimeError(f"hpcg27: made {at} entries, expected {E}")
    return idx, vals


def stencil_apply(cfg: dict, x: Tensor) -> Tensor:
    """``A x`` by shifted slices of the grid, in ``x``'s dtype: the
    stencil itself, used to make right-hand sides and by the tests."""
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    g = x.view(nz, ny, nx)
    y = torch.zeros_like(g)
    for dx, dy, dz in offsets():
        c = cfg["diag"] if (dx, dy, dz) == (0, 0, 0) else cfg["off"]
        sz, sy, sx = _span(dz, nz), _span(dy, ny), _span(dx, nx)
        y[sz, sy, sx] += c * g[sz.start + dz:sz.stop + dz,
                               sy.start + dy:sy.stop + dy,
                               sx.start + dx:sx.stop + dx]
    return y.reshape(-1)


def rhs_pool(cfg: dict, count: int, seed: int, device) -> list[Tensor]:
    """``count`` right-hand sides ``b = A x*`` in float32, ``x*`` uniform
    in [0, 1) from ``seed``; ``A x*`` is formed in float64 by the
    stencil."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(count):
        xs = torch.rand(n_rows(cfg), generator=gen, dtype=torch.float64,
                        device=device)
        out.append(stencil_apply(cfg, xs).to(torch.float32))
        del xs
    return out
