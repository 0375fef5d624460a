"""K4's partitioned schedule, replayed on the CPU, against the JAX package.

The Hopper K4 (``spsparse_torch/csrc/dia_cg.cu``) runs a whole CG solve in
one persistent grid: CTA c owns the rows ``[c R, (c + 1) R)``, keeps them
on chip, writes one partial a reduction and sums all the partials in a
fixed order after each grid barrier, and forms the next ``p`` of a row it
does not own as ``fmaf(beta, p, r)`` from the rows their owners published.
:func:`replay` repeats that arithmetic in torch on the CPU, CTA ranges,
published rows and reduction trees included (an fma as a float64 product
and sum rounded once to float32), and the geometry mirror
(:func:`spsparse_torch.ops.dia_cg.cg_geometry`) is checked for its
invariants. Rows that no CTA published hold NaN in the replay's published
arrays, so a tap that read one would poison the solve.

The replay is held against ``cg_solve_dia_pallas(..., interpret=True)``
for offsets within the JAX kernel's ``|offset| <= 128``, and against the
plain ``cg_solve_dia_reference`` for offsets past it. Tolerance: 1e-4 of
max|x| and rtol 1e-4 on the final ``rs``, as the K4 tests of
``tests/test_torch_solve.py`` (fused against separate multiply-adds and
other sum orders, compounded through the recurrences).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spsparse_tpu.core.dia import SparseDIA as JDIA
from spsparse_tpu.ops.pallas_cg import cg_solve_dia_pallas
from spsparse_torch.convert import dia_from_numpy, tensor_to_numpy
from spsparse_torch.ops import cg_solve_dia_reference, prepare_dia
from spsparse_torch.ops.dia_cg import (CG_LANE_ROWS, CG_RESERVED_SMEM,
                                       CG_THREADS, cg_geometry)
from port_threads import one_torch_thread  # noqa: F401 (autouse)

# Cards for the geometry: an H100 SXM (132 SMs, 228 KB of shared memory an
# SM, 227 KB a CTA: at PALLAS_N rows, n below the grid), one SM of it (one
# CTA owns every row), and a card too small for the resident mode at these
# sizes.
CARDS = {
    "h100": dict(sms=132, smem_per_sm=233472, smem_per_block=232448),
    "one_sm": dict(sms=1, smem_per_sm=233472, smem_per_block=232448),
    "small_smem": dict(sms=3, smem_per_sm=4096, smem_per_block=1024),
}


def fma(a, b, c):
    """float32 fmaf: the exact product and sum, rounded once (float64)."""
    return (a.double() * b.double() + c.double()).float()


def tree(v):
    """``__shfl_down_sync`` sum over the last axis (32 lanes); lane 0."""
    for o in (16, 8, 4, 2, 1):
        w = v.clone()
        w[..., :32 - o] = v[..., :32 - o] + v[..., o:]
        v = w
    return v[..., 0]


def cta_partials(a, c, geo, n):
    """Each CTA's partial of ``a . c`` in the kernel's order: a lane
    accumulates ``fmaf(a, c, part)`` over its rows (chunks warp, warp + 16,
    ...; 4 rows 32 apart in each), then the warp's and the CTA's shuffle
    trees."""
    R, G = geo.rows_per_cta, geo.grid
    warps = CG_THREADS // 32
    chunk = 32 * CG_LANE_ROWS
    sweeps = -(-R // (chunk * warps))
    idx = torch.arange(n)
    at = (idx // R) * sweeps * chunk * warps + idx % R
    lay = []
    for t in (a, c):
        pad = torch.zeros(G * sweeps * chunk * warps)
        pad[at] = t
        # (G, sweeps, warps, rows a lane a chunk, lanes):
        # local row c*128 + 32e + lane, c = sweep*16 + warp
        lay.append(pad.view(G, sweeps, warps, CG_LANE_ROWS, 32))
    part = torch.zeros(G, warps, 32)
    for s in range(sweeps):
        for e in range(CG_LANE_ROWS):
            part = fma(lay[0][:, s, :, e, :], lay[1][:, s, :, e, :], part)
    lanes = torch.zeros(G, 32)
    lanes[:, :warps] = tree(part)                         # warp sums
    return tree(lanes)                                    # (G,)


def grid_sum(partials):
    """All CTAs' partials in the fixed order: lane q adds slots q, q + 32,
    ... in turn, then the shuffle tree."""
    G = partials.shape[0]
    lanes = torch.zeros(32)
    for q in range(0, G, 32):
        chunk = partials[q:q + 32]
        lanes[:chunk.shape[0]] = lanes[:chunk.shape[0]] + chunk
    return tree(lanes)


def replay(prep, b, *, iters, shift, geo):
    """K4's arithmetic on the CPU in the kernel's partition (float32)."""
    n = prep.shape[0]
    data = prep.data.float()
    offs = prep.offsets
    R = geo.rows_per_cta
    idx = torch.arange(n)
    cta = idx // R
    li = idx % R
    nloc = torch.clamp(n - cta * R, max=R)
    head = max(max(offs, default=0), 0)
    tail = max(-min(offs, default=0), 0)
    published = (li < head) | (nloc - li <= tail)
    b = b.float()
    pub_p = torch.full((n,), float("nan"))
    pub_r = torch.full((n,), float("nan"))
    x = torch.zeros(n)
    r = b.clone()
    p = torch.zeros(n)
    pub_p[published] = 0.0
    pub_r[published] = r[published]

    def reduce(a, c):
        return grid_sum(cta_partials(a, c, geo, n))

    rs = reduce(b, b)
    alpha = beta = torch.zeros(())
    for _ in range(iters):
        p = fma(beta, p, r)
        acc = torch.zeros(n)
        for k, off in enumerate(offs):
            j = idx + off
            valid = (j >= 0) & (j < n)
            jc = j.clamp(0, n - 1)
            local = valid & (jc // R == cta)
            foreign = fma(beta, pub_p[jc], pub_r[jc])
            pj = torch.where(local, p[jc], foreign)
            acc = torch.where(valid, fma(data[k], pj, acc), acc)
        ap = fma(torch.tensor(shift, dtype=torch.float32), p, acc)
        pap = reduce(p, ap)
        alpha = rs / (pap if pap != 0 else torch.ones(()))
        x = fma(alpha, p, x)
        r = fma(-alpha, ap, r)
        pub_p[published] = p[published]
        pub_r[published] = r[published]
        rsnew = reduce(r, r)
        beta = rsnew / (rs if rs != 0 else torch.ones(()))
        rs = rsnew
    return x, rs


def spd_dia(n, offsets, seed, off_scale=0.3):
    """A symmetric, diagonally dominant DIA (float32 data)."""
    rng = np.random.default_rng(seed)
    offsets = tuple(offsets)
    data = np.zeros((len(offsets), n), np.float32)
    for k, o in enumerate(offsets):
        if o > 0 and o < n:
            v = rng.uniform(-off_scale, off_scale, n - o).astype(np.float32)
            data[k, :n - o] = v
            data[offsets.index(-o), o:] = v
    if 0 in offsets:
        data[offsets.index(0)] = rng.uniform(
            len(offsets), len(offsets) + 1, n).astype(np.float32)
    return data, offsets


# ----------------------------------------------------------------------
# The geometry mirror
# ----------------------------------------------------------------------
@pytest.mark.parametrize("card", list(CARDS))
@pytest.mark.parametrize("n", [1, 31, 200, 264, 4097, 1 << 20, 1 << 22])
def test_geometry_covers_rows_once_within_budget(card, n):
    spec = CARDS[card]
    g = cg_geometry(n, **spec)
    assert g.grid == spec["sms"] and g.ctas_per_sm == 1
    assert g.rows_per_cta % 32 == 0
    owned = np.zeros(n, np.int64)
    for c in range(g.grid):
        lo, hi = min(n, c * g.rows_per_cta), min(n, (c + 1) * g.rows_per_cta)
        owned[lo:hi] += 1
    assert (owned == 1).all()
    # Fewer rows a CTA would leave rows without an owner.
    assert (g.rows_per_cta - 32) * g.grid < n
    fits = (256 + 16 * g.rows_per_cta <= spec["smem_per_block"]
            and 256 + 16 * g.rows_per_cta + CG_RESERVED_SMEM
            <= spec["smem_per_sm"])
    assert g.resident == fits
    if g.resident:
        assert g.smem_bytes == 256 + 16 * g.rows_per_cta
        assert g.scratch_floats == 2 * n + 4 * g.grid
    else:
        assert g.smem_bytes == 256
        assert g.scratch_floats == 5 * n + 4 * g.grid


def test_geometry_at_the_chip_smoke_sizes():
    h100 = CARDS["h100"]
    assert cg_geometry(1 << 20, **h100) == (132, 1, 7968, True, 127744,
                                            2 * (1 << 20) + 528)
    big = cg_geometry(1 << 22, **h100)
    assert not big.resident and big.grid == 132
    assert cg_geometry(100, **h100).grid > 100   # n below the grid


# ----------------------------------------------------------------------
# The replay against the Pallas kernel (|offset| <= 128)
# ----------------------------------------------------------------------
PALLAS_N = 120
PALLAS_OFFSETS = (-100, -3, -1, 0, 1, 3, 100)
PALLAS_ITERS = 12
PALLAS_SHIFT = 0.5


@pytest.fixture(scope="module")
def pallas_system():
    data, offs = spd_dia(PALLAS_N, PALLAS_OFFSETS, seed=1)
    jd = JDIA(data=jnp.asarray(data), offsets=offs,
              shape=(PALLAS_N, PALLAS_N))
    rhs = np.random.default_rng(2).uniform(-1, 1, PALLAS_N).astype(
        np.float32)
    out = {}
    for name, b in (("random", rhs), ("zero", np.zeros_like(rhs))):
        x, rs = cg_solve_dia_pallas(jd, b, iters=PALLAS_ITERS,
                                    shift=PALLAS_SHIFT, block=512,
                                    interpret=True)
        out[name] = (b, np.asarray(x), float(rs))
    prep = prepare_dia(dia_from_numpy(data, offs, (PALLAS_N, PALLAS_N),
                                      device="cpu"))
    return prep, out


@pytest.mark.parametrize("rhs", ["random", "zero"])
@pytest.mark.parametrize("card", list(CARDS))
def test_replay_matches_pallas_interpret(pallas_system, card, rhs):
    prep, out = pallas_system
    b, x_j, rs_j = out[rhs]
    geo = cg_geometry(PALLAS_N, **CARDS[card])
    if card == "h100":
        assert geo.grid > PALLAS_N              # CTAs that own no rows
    x, rs = replay(prep, torch.from_numpy(b), iters=PALLAS_ITERS,
                   shift=PALLAS_SHIFT, geo=geo)
    if rhs == "zero":
        assert not x.any() and float(rs) == 0.0 and rs_j == 0.0
        return
    assert bool(torch.isfinite(x).all())
    np.testing.assert_allclose(tensor_to_numpy(x), x_j, rtol=0,
                               atol=1e-4 * np.abs(x_j).max())
    np.testing.assert_allclose(float(rs), rs_j, rtol=1e-4)


# ----------------------------------------------------------------------
# Offsets past the Pallas kernel's limit: against the plain version
# ----------------------------------------------------------------------
# name: (n, offsets, card, iters)
FAR_CASES = {
    "half_n": (2000, (-1000, -1, 0, 1, 1000), "h100", 20),
    "half_n_one_sm": (2000, (-1000, -1, 0, 1, 1000), "one_sm", 20),
    "past_a_cta": (1500, (-700, -2, 0, 2, 700), "one_sm", 15),
    "single_diagonal": (777, (0,), "h100", 6),
    "one_row": (1, (0,), "h100", 3),
}


@pytest.mark.parametrize("case", list(FAR_CASES))
def test_replay_matches_plain_far_offsets(case):
    n, offsets, card, iters = FAR_CASES[case]
    data, offs = spd_dia(n, offsets, seed=n)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device="cpu"))
    b = torch.from_numpy(np.random.default_rng(n + 1).uniform(
        -1, 1, n).astype(np.float32))
    geo = cg_geometry(n, **CARDS[card])
    x, rs = replay(prep, b, iters=iters, shift=0.25, geo=geo)
    x_ref, rs_ref = cg_solve_dia_reference(prep, b, iters=iters, shift=0.25)
    assert bool(torch.isfinite(x).all())
    scale = float(x_ref.abs().max())
    assert float((x - x_ref).abs().max()) <= 1e-4 * scale
    assert float(rs) == pytest.approx(float(rs_ref), rel=1e-4, abs=1e-30)
