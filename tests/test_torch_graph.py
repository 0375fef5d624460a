"""Parity of the port's graph tier (``spsparse_torch.graph``) with the JAX
package's (``spsparse_tpu.graph``).

The same numpy inputs (made from a seed, n <= 64) go through both packages
in the same entry order, so edge ids agree. Distances, levels, labels,
predecessors, MST edge sets, matchings and flows must be equal exactly,
in float32 and float64: they are minima of the same sequential sums, or
integer results, whatever order the reductions run in. Only sums may
differ, and only by rounding: PLUS_TIMES relaxations and ``laplacian``'s
degrees and normalisation, to rtol 1e-12 in float64 (1e-6 in float32).

The cases cover directed and undirected graphs, weighted and unweighted
runs, stored zeros, self-loops and duplicate entries, ties (integer
weights), a negative cycle raising ``NegativeCycleError``, and
``bellman_ford`` on a ``RelaxPlan`` carried across by
``relax_plan_from_jax``. The golden cases of ``tests/test_graph.py``
(random digraphs against scipy: Bellman-Ford, Floyd-Warshall,
shortest_path's methods, BFS, weak and strong components, MST, the
Laplacian, semirings, matchings, flows, RelaxPlan, Dijkstra/Johnson,
traversal trees, path tools and conversions) are cases here, held against
the JAX package instead of scipy.
"""

import numpy as np
import pytest
import torch

import spsparse_tpu.graph as jg
import spsparse_torch.graph as tg
from spsparse_tpu import SparseCOO as JCOO
from spsparse_torch import SparseCOO as TCOO, SpSparseError
from spsparse_torch.convert import coo_to_numpy, relax_plan_from_jax
from port_threads import one_torch_thread  # noqa: F401 (autouse)

SEMIRINGS = ("MIN_PLUS", "MAX_PLUS", "MIN_MIN", "MAX_MIN", "OR_AND",
             "PLUS_TIMES")


N, CAP = 32, 128     # one node count and capacity: the JAX package
#                      compiles each of its ops once for the module


def pair(idx, vals, shape=(N, N), dtype=np.float64, cap=CAP):
    """The same entries as a JAX and a port (CPU) SparseCOO."""
    idx = np.asarray(idx, np.int64).reshape(-1, 2)
    vals = np.asarray(vals, dtype)
    return (JCOO.from_arrays(idx, vals, shape, cap=cap),
            TCOO.from_arrays(idx, vals, shape, cap=cap, device="cpu"))


def digraph(seed, n=N, m=70, lo=0.1, integer=False, symmetric=False):
    """A random digraph with stored zeros, self-loops and duplicate
    entries (indices, values)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    w = (rng.integers(1, 4, m).astype(float) if integer
         else rng.uniform(lo, 5.0, m))
    w[:3] = 0.0                                # stored zeros
    r[3:5] = c[3:5]                            # self-loops
    r = np.r_[r, r[5:8]]                       # duplicates, other weights
    c = np.r_[c, c[5:8]]
    w = np.r_[w, w[5:8] + 1.0]
    if symmetric:
        r, c, w = np.r_[r, c], np.r_[c, r], np.r_[w, w]
    return np.stack([r, c], 1), w


@pytest.fixture(scope="module")
def g():
    """The module's graphs, each as a (JAX, port) pair."""
    out = {}
    idx, w = digraph(0)
    out["w"] = pair(idx, w)
    out["w32"] = pair(idx, w, dtype=np.float32)
    idx, w = digraph(1, n=N - 1, m=55, integer=True, symmetric=True)
    out["ties"] = pair(idx, w)                 # node 31 isolated
    out["ties32"] = pair(idx, w, dtype=np.float32)
    idx, w = digraph(2, n=N - 2, m=36)         # sparse: several components
    out["sparse"] = pair(idx, w)
    # no zero weights: undirected zero-weight edges tie both ways, and
    # their predecessors can form cycles construct_dist_matrix refuses
    out["positive"] = pair(idx, w + 0.5)
    rng = np.random.default_rng(3)
    dense = np.triu(rng.uniform(-1, 2, (N, N)), 1)
    dense[rng.uniform(size=(N, N)) < 0.85] = 0
    rr, cc = dense.nonzero()
    out["dag_neg"] = pair(np.stack([rr, cc], 1), dense[rr, cc])
    out["neg_cycle"] = pair([[0, 1], [1, 0], [1, 2]], [1.0, -2.0, 1.0])
    return out


def t2n(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(jx, tx):
    """Exact equality, dtype included (int32 predecessors stay int32)."""
    j, t = np.asarray(jx), t2n(tx)
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(t, j)


def same_coo(j, t, rtol=0.0):
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert (tn, tshape, torder) == (int(j.nnz), tuple(j.shape), j.sort_order)
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    if rtol:
        np.testing.assert_allclose(tv, np.asarray(j.vals), rtol=rtol)
    else:
        np.testing.assert_array_equal(tv, np.asarray(j.vals))


def test_exports_match():
    assert list(tg.__all__) == list(jg.__all__)
    for name in tg.__all__:
        assert hasattr(tg, name), name
    assert tg.NEG_SENTINEL == jg.NEG_SENTINEL
    assert issubclass(tg.NegativeCycleError, SpSparseError)


# ----------------------------------------------------------------------
# Semirings and the relaxation plan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_spmv_semiring(g, name, directed):
    j, t = g["w"]
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 3, (N, 3))
    if name == "OR_AND":
        x = (x > 0.5).astype(np.float64)
    js, ts = getattr(jg, name), getattr(tg, name)
    assert (ts.name, ts.combine, ts.identity) == (js.name, js.combine,
                                                  js.identity)
    want = np.asarray(jg.spmv_semiring(j, x, js, directed=directed))
    got = t2n(tg.spmv_semiring(t, torch.from_numpy(x), ts,
                               directed=directed))
    if name == "PLUS_TIMES":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)
    # one column, transposed, unweighted
    want = np.asarray(jg.spmv_semiring(j, x[:, 0], js, transpose=True,
                                       unweighted=True))
    got = t2n(tg.spmv_semiring(t, x[:, 0], ts, transpose=True,
                               unweighted=True))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("directed,unweighted",
                         [(True, False), (False, False), (True, True)])
def test_prepare_relax_matches(g, directed, unweighted):
    j, t = g["w"]
    jp = jg.prepare_relax(j, directed=directed, unweighted=unweighted)
    tp = tg.prepare_relax(t, directed=directed, unweighted=unweighted)
    assert (tp.n, tp.k) == (jp.n, jp.k)
    for f in ("tails", "weights", "pad"):
        same(getattr(jp, f), getattr(tp, f))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_relax(g, name):
    j, _ = g["w"]
    jp = jg.prepare_relax(j)
    tp = relax_plan_from_jax(jp, device="cpu")
    x = np.random.default_rng(5).uniform(0.0, 9.0, (N, 2))
    if name == "OR_AND":
        x = (x > 4.0).astype(np.float64)
    want = np.asarray(jg.relax(jp, x, getattr(jg, name)))
    got = t2n(tg.relax(tp, torch.from_numpy(x), getattr(tg, name)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if name != "PLUS_TIMES":
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# Shortest paths
# ----------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["w", "w32"])
@pytest.mark.parametrize("directed,unweighted",
                         [(True, False), (False, False), (True, True)])
def test_bellman_ford(g, graph, directed, unweighted):
    j, t = g[graph]
    src = [0, 5, 11]
    jd, jp = jg.bellman_ford(j, src, directed=directed,
                             unweighted=unweighted, return_predecessors=True)
    td, tp = tg.bellman_ford(t, src, directed=directed,
                             unweighted=unweighted, return_predecessors=True)
    same(jd, td)
    same(jp, tp)


@pytest.mark.parametrize("directed", [True, False])
def test_bellman_ford_plan_from_jax(g, directed):
    j, t = g["w"]
    jplan = jg.prepare_relax(j, directed=directed)
    tplan = relax_plan_from_jax(jplan, device="cpu")
    src = np.array([1, 7])
    jd, jp = jg.bellman_ford(jplan, src, return_predecessors=True)
    td, tp = tg.bellman_ford(tplan, src, return_predecessors=True)
    same(jd, td)
    same(jp, tp)
    # the plan answers as the edge list does
    same(td, tg.bellman_ford(t, src, directed=directed))
    # a fixed round count, unchecked
    same(jg.bellman_ford(jplan, src, maxiter=2),
         tg.bellman_ford(tplan, src, maxiter=2))
    with pytest.raises(SpSparseError, match="baked"):
        tg.bellman_ford(tplan, src, unweighted=True)


def test_negative_cycle_raises(g):
    j, t = g["neg_cycle"]
    with pytest.raises(jg.NegativeCycleError):
        jg.bellman_ford(j, [0])
    with pytest.raises(tg.NegativeCycleError, match="negative"):
        tg.bellman_ford(t, [0])
    with pytest.raises(tg.NegativeCycleError):
        tg.bellman_ford(tg.prepare_relax(t), [0])
    with pytest.raises(tg.NegativeCycleError):
        tg.floyd_warshall(t)
    with pytest.raises(tg.NegativeCycleError):
        tg.johnson(t, indices=[2, 0])
    # node 2 reaches no cycle: no raise, as in the JAX package
    same(jg.bellman_ford(j, [2]), tg.bellman_ford(t, [2]))


def test_dijkstra_limit_min_only(g):
    j, t = g["w"]
    same(jg.dijkstra(j, indices=[0, 3], limit=2.5),
         tg.dijkstra(t, indices=[0, 3], limit=2.5))
    jout = jg.dijkstra(j, indices=[4, 0, 9], min_only=True,
                       return_predecessors=True, limit=4.0)
    tout = tg.dijkstra(t, indices=[4, 0, 9], min_only=True,
                       return_predecessors=True, limit=4.0)
    for a, b in zip(jout, tout):
        same(a, b)
    same(jg.dijkstra(j, indices=[2], min_only=True),
         tg.dijkstra(t, indices=[2], min_only=True))
    with pytest.raises(SpSparseError, match="min_only"):
        tg.dijkstra(t, min_only=True)


def test_dijkstra_negative_warns_johnson(g):
    j, t = g["dag_neg"]
    with pytest.warns(UserWarning, match="negative"):
        td = tg.dijkstra(t, indices=[0])
    with pytest.warns(UserWarning):
        jd = jg.dijkstra(j, indices=[0])
    same(jd, td)
    jd, jp = jg.johnson(j, return_predecessors=True)
    td, tp = tg.johnson(t, return_predecessors=True)
    same(jd, td)
    same(jp, tp)


@pytest.mark.parametrize("method", ["auto", "D", "FW"])
def test_shortest_path(g, method):
    j, t = g["sparse"]
    same(jg.shortest_path(j, method=method),
         tg.shortest_path(t, method=method))
    if method != "FW":
        same(jg.shortest_path(j, method=method, indices=[2],
                              unweighted=True),
             tg.shortest_path(t, method=method, indices=[2],
                              unweighted=True))


@pytest.mark.parametrize("graph", ["w", "ties32"])
@pytest.mark.parametrize("directed", [True, False])
def test_floyd_warshall(g, graph, directed):
    j, t = g[graph]
    jd, jp = jg.floyd_warshall(j, directed=directed, return_predecessors=True)
    td, tp = tg.floyd_warshall(t, directed=directed, return_predecessors=True)
    same(jd, td)
    same(jp, tp)


@pytest.mark.parametrize("directed", [True, False])
def test_bfs_levels(g, directed):
    j, t = g["sparse"]
    same(jg.bfs_levels(j, 0, directed=directed),
         tg.bfs_levels(t, 0, directed=directed))


# ----------------------------------------------------------------------
# Traversal, components, MST
# ----------------------------------------------------------------------

@pytest.mark.parametrize("directed", [True, False])
def test_traversal_orders_and_trees(g, directed):
    j, t = g["sparse"]
    for fn in ("breadth_first_order", "depth_first_order"):
        jo, jp = getattr(jg, fn)(j, 3, directed=directed)
        to, tp = getattr(tg, fn)(t, 3, directed=directed)
        same(jo, to)
        same(jp, tp)
        same(getattr(jg, fn)(j, 3, directed=directed,
                             return_predecessors=False),
             getattr(tg, fn)(t, 3, directed=directed,
                             return_predecessors=False))
    for fn in ("breadth_first_tree", "depth_first_tree"):
        same_coo(getattr(jg, fn)(j, 3, directed=directed),
                 getattr(tg, fn)(t, 3, directed=directed))


@pytest.mark.parametrize("graph", ["w", "ties", "sparse"])
def test_connected_components(g, graph):
    j, t = g[graph]
    jn, jl = jg.connected_components(j)
    tn, tl = tg.connected_components(t)
    assert tn == jn
    same(jl, tl)
    assert tg.connected_components(t, return_labels=False) == jn
    jn, jl = jg.connected_components(j, connection="strong")
    tn, tl = tg.connected_components(t, connection="strong")
    assert tn == jn
    same(jl, tl)


def test_components_no_edges():
    j = JCOO.empty((N, N), cap=CAP, dtype=np.float64)
    t = TCOO.empty((N, N), cap=CAP, dtype=torch.float64, device="cpu")
    jn, jl = jg.connected_components(j)
    tn, tl = tg.connected_components(t)
    assert tn == jn == N
    same(jl, tl)


@pytest.mark.parametrize("graph", ["w", "ties", "ties32", "sparse"])
def test_minimum_spanning_tree(g, graph):
    j, t = g[graph]
    same_coo(jg.minimum_spanning_tree(j), tg.minimum_spanning_tree(t))


# ----------------------------------------------------------------------
# Matching and flow (host tier)
# ----------------------------------------------------------------------

def bipartite(seed, nr=15, nc=12, p=0.2):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.uniform(size=(nr, nc)) < p,
                     rng.uniform(0.5, 3.0, (nr, nc)), 0.0)
    k = min(nr, nc)
    dense[np.arange(k), rng.permutation(k)] = rng.uniform(0.5, 3.0, k)
    dense[0, 1] = 0.0
    rr, cc = dense.nonzero()
    idx = np.r_[np.stack([rr, cc], 1), [[0, 1]]]     # one stored zero
    return pair(idx, np.r_[dense[rr, cc], 0.0], (nr, nc))


@pytest.mark.parametrize("shape", [(15, 12), (12, 15), (14, 14)])
def test_matchings(shape):
    j, t = bipartite(7, *shape)
    for perm_type in ("row", "column"):
        same(jg.maximum_bipartite_matching(j, perm_type=perm_type),
             tg.maximum_bipartite_matching(t, perm_type=perm_type))
    assert tg.structural_rank(t) == jg.structural_rank(j)
    for maximize in (False, True):
        jr, jc = jg.min_weight_full_bipartite_matching(j, maximize=maximize)
        tr, tc = tg.min_weight_full_bipartite_matching(t, maximize=maximize)
        same(jr, tr)
        same(jc, tc)


def test_matching_errors():
    _, t = pair([[0, 0], [1, 0]], [1.0, 2.0], (2, 2))
    with pytest.raises(SpSparseError, match="full matching"):
        tg.min_weight_full_bipartite_matching(t)
    with pytest.raises(SpSparseError, match="perm_type"):
        tg.maximum_bipartite_matching(t, perm_type="x")


@pytest.mark.parametrize("seed", [0, 5])
def test_maximum_flow(seed):
    rng = np.random.default_rng(seed)
    n = 16
    dense = np.where(rng.uniform(size=(n, n)) < 0.3,
                     rng.integers(1, 10, (n, n)), 0).astype(np.float64)
    dense[3, 3] = 4.0                          # a stored self-loop
    rr, cc = dense.nonzero()
    j, t = pair(np.stack([rr, cc], 1), dense[rr, cc], (n, n))
    jr = jg.maximum_flow(j, 0, n - 1)
    tr = tg.maximum_flow(t, 0, n - 1)
    assert tr.flow_value == jr.flow_value > 0
    same_coo(jr.flow, tr.flow)
    with pytest.raises(SpSparseError, match="integer"):
        tg.maximum_flow(pair([[0, 1]], [1.5], (2, 2))[1], 0, 1)
    with pytest.raises(SpSparseError, match="source/sink"):
        tg.maximum_flow(t, 0, 0)


# ----------------------------------------------------------------------
# Laplacian, path tools, conversions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["ties", "ties32"])
@pytest.mark.parametrize("normed", [False, True])
def test_laplacian(g, graph, normed):
    j, t = g[graph]
    rtol = 1e-6 if graph == "ties32" else 1e-12
    jL, jd = jg.laplacian(j, normed=normed, return_diag=True)
    tL, td = tg.laplacian(t, normed=normed, return_diag=True)
    same_coo(jL, tL, rtol=rtol)
    np.testing.assert_allclose(t2n(td), np.asarray(jd), rtol=rtol)
    same_coo(jg.laplacian(j, normed=normed), tg.laplacian(t, normed=normed),
             rtol=rtol)


@pytest.mark.parametrize("directed", [True, False])
def test_path_tools(g, directed):
    j, t = g["positive"]
    jd, jp = jg.yen(j, 0, 5, 4, directed=directed, return_predecessors=True)
    td, tp = tg.yen(t, 0, 5, 4, directed=directed, return_predecessors=True)
    same(jd, td)
    same(jp, tp)
    same(jg.yen(j, 0, 5, 3, directed=directed, unweighted=True),
         tg.yen(t, 0, 5, 3, directed=directed, unweighted=True))
    _, pred = tg.shortest_path(t, directed=directed,
                               return_predecessors=True)
    pred_np = t2n(pred)
    same_coo(jg.reconstruct_path(j, pred_np[0], directed=directed),
             tg.reconstruct_path(t, pred[0], directed=directed))
    same(jg.construct_dist_matrix(j, pred_np, directed=directed),
         tg.construct_dist_matrix(t, pred, directed=directed))
    with pytest.raises(SpSparseError, match="predecessors"):
        tg.reconstruct_path(t, pred_np[:, :3])
    bad = np.full((N, N), tg.NEG_SENTINEL, np.int32)
    bad[0, 1], bad[0, 2] = 2, 1
    with pytest.raises(SpSparseError, match="cycle"):
        tg.construct_dist_matrix(t, bad)


def test_conversions():
    rng = np.random.default_rng(9)
    dense = np.where(rng.uniform(size=(9, 9)) < 0.3,
                     rng.uniform(0, 2, (9, 9)), 0.0)
    dense[1, 2] = np.inf
    dense[2, 1] = np.nan
    for null in (0.0, np.inf, np.nan):
        same_coo(jg.csgraph_from_dense(dense, null_value=null),
                 tg.csgraph_from_dense(dense, null_value=null, device="cpu"))
    j, t = pair([[0, 1], [0, 1], [2, 2], [3, 0]], [2.0, 1.0, 0.0, 4.0],
                (4, 4))
    for null in (0.0, -1.0):
        same(jg.csgraph_to_dense(j, null_value=null),
             tg.csgraph_to_dense(t, null_value=null))
    jm, tm = jg.csgraph_to_masked(j), tg.csgraph_to_masked(t)
    same(np.ma.getmaskarray(jm), np.ma.getmaskarray(tm))
    same(jm.filled(-7.0), tm.filled(-7.0))
    same_coo(jg.csgraph_from_masked(jm), tg.csgraph_from_masked(tm,
                                                                device="cpu"))
    assert tg.reverse_cuthill_mckee is not None
    np.testing.assert_array_equal(tg.reverse_cuthill_mckee(t),
                                  jg.reverse_cuthill_mckee(j))
