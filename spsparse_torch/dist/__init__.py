"""Distributed layer: row-partitioned matrices and collective sparse ops
over two meshes — :class:`StackedMesh` (every partition on one device)
and :class:`GroupMesh` (one partition a ``torch.distributed`` rank).
Counterpart of :mod:`spsparse_tpu.dist`; each op returns the blocks its
mesh owns (see :mod:`spsparse_torch.dist.ops`)."""

from .mesh import StackedMesh, GroupMesh
from .partition import (RowPartitionedCSR, RowPartitionedBucketed,
                        partition_rows, partition_bucketed, partition_vector)
from .ops import (dist_spmv, dist_spmv_bucketed, dist_spmv_halo, dist_spmm,
                  dist_spmm_bucketed, dist_spgemm, RowPartitionedCOO)
from .spgemm_a2a import dist_spgemm_a2a
from .spgemm_ring import dist_spgemm_ring
from .spgemm_tiled import (dist_spgemm_tiled, plan_dist_spgemm_tiled,
                           DistTiledGemmPlan)
from .spmv_a2a import (RowPartitionedFootprint, partition_footprint,
                       dist_spmv_a2a, dist_spmm_a2a)
from .model import (RingModel, ring_weak_scaling_efficiency,
                    halo_weak_scaling_efficiency,
                    a2a_weak_scaling_efficiency, a2a_footprint_for_target,
                    uniform_footprint)
from .precond import DistBlockJacobi, dist_block_jacobi
from .graph import (dist_bellman_ford, dist_bfs_levels,
                    dist_connected_components)

__all__ = [
    "RowPartitionedCSR", "RowPartitionedBucketed", "partition_rows",
    "partition_bucketed", "partition_vector",
    "dist_spmv", "dist_spmv_bucketed", "dist_spmm", "dist_spmm_bucketed",
    "dist_spgemm", "dist_spgemm_a2a", "dist_spgemm_ring",
    "dist_spgemm_tiled", "plan_dist_spgemm_tiled", "DistTiledGemmPlan",
    "RowPartitionedCOO", "RingModel", "ring_weak_scaling_efficiency",
    "halo_weak_scaling_efficiency", "dist_spmv_halo",
    "RowPartitionedFootprint", "partition_footprint", "dist_spmv_a2a",
    "dist_spmm_a2a", "a2a_weak_scaling_efficiency",
    "a2a_footprint_for_target", "uniform_footprint",
    "DistBlockJacobi", "dist_block_jacobi",
    "dist_bellman_ford", "dist_bfs_levels", "dist_connected_components",
    "StackedMesh", "GroupMesh",
]
