"""The port's solvers on a card, against the same calls on the CPU.

    python -m pytest tests_gpu -m gpu -q

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false. This lane imports neither JAX nor the JAX package. Tolerances:
float64 LOBPCG values rtol 1e-10 (the same arithmetic on two devices);
float32 device sweeps through kernel K1 rtol/atol 1e-5 of max|x| against
the plain version on the CPU (the kernel fuses multiply-adds). K4 with its
exchange counters on (the event log on) equal bit for bit to K4 with them
off.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import spsparse_torch as sp
from spsparse_torch import native
from spsparse_torch.ops import cg_solve_dia, spmv_dia_stream
from spsparse_torch.ops.dia_cg import cg_kernel_geometry
from spsparse_torch.solvers import lobpcg_solve, spsolve_triangular
from spsparse_torch.utils.trace import enable_event_log, get_event_log

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("largest", [True, False])
def test_lobpcg_dropped_directions_match_cpu(largest):
    """LOBPCG's first Rayleigh-Ritz drops its zero P block; the values on
    the card equal the CPU's (CUDA's eigh beside a 1/eps^2 penalty did
    not)."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    n = 400
    A = np.diag(np.r_[0.1, 0.2, 0.3, 0.4, np.linspace(1.0, 2.0, n - 8),
                      5.0, 6.0, 7.0, 8.0])
    A[np.arange(n - 1), np.arange(1, n)] = A[np.arange(1, n),
                                             np.arange(n - 1)] = 0.01
    X0 = rng.standard_normal((n, 4))
    out = []
    for d in ("cpu", dev):
        At = torch.from_numpy(A).to(d)
        vals, _ = lobpcg_solve(lambda X: At @ X, torch.from_numpy(X0).to(d),
                               iters=30, largest=largest)
        out.append(vals.cpu().numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-10)
    want = np.linalg.eigvalsh(A)
    want = want[::-1][:4] if largest else want[:4]
    np.testing.assert_allclose(out[1], want, rtol=1e-8)


def test_triangular_device_sweeps_launch_k1():
    """The float32 lower triangle of a 16 x 16 Poisson grid (31 levels) by
    device sweeps: one K1 launch a sweep (30), the result equal to the
    CPU's plain sweeps."""
    dev = _cuda()
    assert native.available()
    side = 16
    n = side * side
    i = np.arange(n)
    left = i[i % side > 0]              # tril of the 2-D Poisson operator
    rows = np.concatenate([i, left, i[i >= side]])
    cols = np.concatenate([i, left - 1, i[i >= side] - side])
    vals = np.concatenate([np.full(n, 4.0), np.full(left.size, -1.0),
                           np.full(n - side, -1.0)]).astype(np.float32)
    b = np.random.default_rng(1).uniform(-1, 1, n).astype(np.float32)
    out = []
    for d in ("cpu", dev):
        bld = sp.CooBuilder((n, n), dtype=np.float32)
        bld.add_many(np.stack([rows, cols], 1), vals)
        L = bld.build(device=d)
        before = spmv_dia_stream.launches
        x = spsolve_triangular(L, torch.from_numpy(b).to(d), lower=True,
                               method="device")
        out.append((x.cpu().numpy(), spmv_dia_stream.launches - before))
    assert out[1][1] == 2 * side - 2 and out[0][1] == 0
    scale = float(np.abs(out[0][0]).max())
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("n,mode", [(1 << 14, "resident"),
                                    (1 << 22, "device_memory")])
def test_k4_exchange_counters_change_no_bit(n, mode):
    """K4 with its cycle counters written (the event log on) and without:
    the same x and rs bit for bit; each CTA's two waits under its cycles
    from entry to exit. Prints the CUDA-event time of an iteration both
    ways (reported, not held to anything)."""
    dev = _cuda()
    prep = cs.spd_dia(torch, dev, n, tuple(range(-cs.BAND, cs.BAND + 1)), 5)
    b = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, n).astype(np.float32)).to(dev)

    def solve(iters, stats):
        enable_event_log(stats)
        try:
            out = cg_solve_dia(prep, b, iters=iters, shift=cs.SHIFT)
            log = get_event_log()
        finally:
            enable_event_log(False)
        return out, log

    (x0, rs0), log0 = solve(40, False)
    (x1, rs1), log1 = solve(40, True)
    torch.cuda.synchronize()
    assert log0 == []
    assert torch.equal(x0, x1) and torch.equal(rs0, rs1)
    (rec,) = [e for e in log1 if e["op"] == "spsparse.cg_solve_dia"]
    geo = cg_kernel_geometry(n)
    assert rec["mode"] == mode and rec["grid"] == geo.grid
    assert rec["iters"] == 40
    cyc = rec["cycles"].cpu()
    assert cyc.shape == (geo.grid, 3) and cyc.dtype == torch.int64
    assert bool((cyc[:, 2] > 0).all())
    assert bool((cyc[:, 0] + cyc[:, 1] < cyc[:, 2]).all())
    ms = cs.per_iteration_ms(torch, {
        "counters off": lambda it: solve(it, False),
        "counters on": lambda it: solve(it, True)})
    print(json.dumps({"case": f"K4 f32, n = {n} ({mode})",
                      "ms_per_iteration": ms,
                      "exchange_wait_pct": float(
                          100 * cyc[:, :2].sum() / cyc[:, 2].sum()),
                      "device": torch.cuda.get_device_name(0)}))
