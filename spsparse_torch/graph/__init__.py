"""Graph algorithms on sparse adjacency matrices (the
``scipy.sparse.csgraph`` tier), built on semiring SpMV relaxations —
counterpart of :mod:`spsparse_tpu.graph`; see
:mod:`spsparse_torch.graph.semiring` and :mod:`spsparse_torch.graph.csgraph`
for the design notes."""

from .semiring import (
    Semiring,
    MIN_PLUS,
    MAX_PLUS,
    MIN_MIN,
    MAX_MIN,
    OR_AND,
    PLUS_TIMES,
    spmv_semiring,
    edge_arrays,
    RelaxPlan,
    prepare_relax,
    relax,
)
from .csgraph import (
    bellman_ford,
    dijkstra,
    johnson,
    shortest_path,
    floyd_warshall,
    bfs_levels,
    breadth_first_order,
    depth_first_order,
    breadth_first_tree,
    depth_first_tree,
    connected_components,
    minimum_spanning_tree,
    laplacian,
    maximum_bipartite_matching,
    min_weight_full_bipartite_matching,
    structural_rank,
    maximum_flow,
    MaximumFlowResult,
    NEG_SENTINEL,
    NegativeCycleError,
    yen,
    reconstruct_path,
    construct_dist_matrix,
    csgraph_from_dense,
    csgraph_to_dense,
    csgraph_from_masked,
    csgraph_to_masked,
)
# scipy's spelling of the port's RCM ordering
from ..core.reorder import rcm_permutation as reverse_cuthill_mckee

__all__ = [
    "Semiring", "MIN_PLUS", "MAX_PLUS", "MIN_MIN", "MAX_MIN", "OR_AND",
    "PLUS_TIMES", "spmv_semiring", "edge_arrays",
    "RelaxPlan", "prepare_relax", "relax",
    "bellman_ford", "dijkstra", "johnson", "shortest_path",
    "floyd_warshall", "bfs_levels",
    "breadth_first_order", "depth_first_order",
    "breadth_first_tree", "depth_first_tree",
    "connected_components", "minimum_spanning_tree",
    "laplacian", "maximum_bipartite_matching",
    "min_weight_full_bipartite_matching", "structural_rank",
    "maximum_flow", "MaximumFlowResult",
    "NEG_SENTINEL", "NegativeCycleError", "reverse_cuthill_mckee",
    "yen", "reconstruct_path", "construct_dist_matrix",
    "csgraph_from_dense", "csgraph_to_dense",
    "csgraph_from_masked", "csgraph_to_masked",
]
