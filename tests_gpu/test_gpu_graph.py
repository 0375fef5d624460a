"""The port's graph tier on a card, against the same calls on the CPU.

    python -m pytest tests_gpu -m gpu -q

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false. This lane imports neither JAX nor the JAX package. The graph
tier's device rounds are PyTorch gathers and ``scatter_reduce_``
(``amin``/``amax``/``sum``, whose CUDA versions use atomics); minima,
maxima, labels, int32 predecessors and Boruvka's choices must equal the
CPU's exactly, ties and empty segments included; sums to rtol 1e-12 in
float64 and 1e-5 in float32 (atomics add in another order).
"""

import numpy as np
import pytest
import torch

import spsparse_torch as sp
from spsparse_torch import graph as gr
from spsparse_torch.graph.semiring import segment_reduce

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the test compares it with the CPU)")
    return torch.device("cuda")


def both(idx, vals, shape, dev):
    idx = np.asarray(idx, np.int64).reshape(-1, 2)
    return [sp.SparseCOO.from_arrays(idx, vals, shape, device=d)
            for d in ("cpu", dev)]


def tie_graph(seed, n=200, m=1200, dtype=np.float64, symmetric=False):
    """Integer weights 1..3 (many ties), a stored zero, self-loops, and
    nodes no edge reaches."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n - 10, m)
    c = rng.integers(0, n - 10, m)
    w = rng.integers(1, 4, m).astype(dtype)
    w[0] = 0
    r[1:4] = c[1:4]
    if symmetric:
        r, c, w = np.r_[r, c], np.r_[c, r], np.r_[w, w]
    return np.stack([r, c], 1), w


@pytest.mark.parametrize("combine", ["min", "max", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
def test_segment_reduce_ties_and_empty_segments(combine, dtype):
    dev = _cuda()
    rng = np.random.default_rng(0)
    e, n = 100_000, 4096
    ids = rng.integers(0, n - 100, e)            # the last 100 stay empty
    data = rng.integers(-3, 4, (5, e))           # many ties
    out = []
    for d in ("cpu", dev):
        out.append(segment_reduce(
            torch.from_numpy(data).to(d, dtype), torch.from_numpy(ids).to(d),
            n, combine).cpu())
    if combine == "sum" and dtype.is_floating_point:
        torch.testing.assert_close(out[1], out[0], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out[1], out[0])
    if combine != "sum":
        empty = out[1][:, -100:]
        want = (float("inf") if combine == "min" else float("-inf")) \
            if dtype.is_floating_point else (
                torch.iinfo(dtype).max if combine == "min"
                else torch.iinfo(dtype).min)
        assert bool((empty == want).all())


@pytest.mark.parametrize("name", ["MIN_PLUS", "MAX_PLUS", "MIN_MIN",
                                  "MAX_MIN", "OR_AND", "PLUS_TIMES"])
def test_semirings_and_relax(name):
    dev = _cuda()
    idx, w = tie_graph(1)
    a = both(idx, w, (200, 200), dev)
    x = np.random.default_rng(2).integers(-2, 3, (200, 4)).astype(
        np.float64)
    if name == "OR_AND":
        x = (x > 0).astype(np.float64)
    s = getattr(gr, name)
    got = []
    for A, d in zip(a, ("cpu", dev)):
        xt = torch.from_numpy(x).to(d)
        got.append((gr.spmv_semiring(A, xt, s).cpu(),
                    gr.relax(gr.prepare_relax(A, directed=False), xt,
                             s).cpu()))
    for c, g in zip(got[0], got[1]):
        torch.testing.assert_close(g, c, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("directed", [True, False])
def test_int32_predecessors(plan, directed):
    """Ties everywhere (weights 1..3): the smallest tail wins on both."""
    dev = _cuda()
    idx, w = tie_graph(3)
    a = both(idx, w, (200, 200), dev)
    out = []
    for A in a:
        if plan:
            A = gr.prepare_relax(A, directed=directed)
            d, p = gr.bellman_ford(A, [0, 7, 150], return_predecessors=True)
        else:
            d, p = gr.bellman_ford(A, [0, 7, 150], directed=directed,
                                   return_predecessors=True)
        assert p.dtype == torch.int32
        out.append((d.cpu(), p.cpu()))
    assert torch.equal(out[1][0], out[0][0])
    assert torch.equal(out[1][1], out[0][1])
    assert bool((out[1][1][:, -5:] == gr.NEG_SENTINEL).all())   # unreached


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_boruvka_ties(dtype):
    dev = _cuda()
    idx, w = tie_graph(4, dtype=dtype, symmetric=True)
    T = [gr.minimum_spanning_tree(A) for A in both(idx, w, (200, 200), dev)]
    assert T[1].nnz == T[0].nnz
    assert torch.equal(T[1].indices.cpu(), T[0].indices)
    assert torch.equal(T[1].vals.cpu(), T[0].vals)


def test_components_dijkstra_floyd_laplacian():
    dev = _cuda()
    idx, w = tie_graph(5, symmetric=True)
    cpu, gpu = both(idx, w, (200, 200), dev)
    for kw in ({}, {"connection": "strong"}):
        nc, lab = gr.connected_components(cpu, **kw)
        ng, lg = gr.connected_components(gpu, **kw)
        assert ng == nc and lg.device == gpu.device
        assert torch.equal(lg.cpu(), lab)
    for kw in ({"limit": 3.0}, {"min_only": True}):
        c = gr.dijkstra(cpu, indices=[3, 9], return_predecessors=True, **kw)
        g = gr.dijkstra(gpu, indices=[3, 9], return_predecessors=True, **kw)
        for x, y in zip(c, g):
            assert torch.equal(y.cpu(), x)
    for x, y in zip(gr.floyd_warshall(cpu, return_predecessors=True),
                    gr.floyd_warshall(gpu, return_predecessors=True)):
        assert torch.equal(y.cpu(), x)
    assert torch.equal(gr.bfs_levels(gpu, 0).cpu(), gr.bfs_levels(cpu, 0))
    for normed in (False, True):
        Lc, Lg = (gr.laplacian(A, normed=normed) for A in (cpu, gpu))
        assert Lg.nnz == Lc.nnz
        assert torch.equal(Lg.indices.cpu(), Lc.indices)
        torch.testing.assert_close(Lg.vals.cpu(), Lc.vals, rtol=1e-12,
                                   atol=0.0)
