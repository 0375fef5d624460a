#!/usr/bin/env python3
"""Drive the spsparse_torch main path, solve path, SpMM path, SpGEMM path,
unstructured SpMV path, core path, solver path, graph path, distributed
path and utils path once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failed check raises,
so the script exits non-zero and prints no result line):

1. Build the CUDA kernels from ``spsparse_torch/csrc`` (nvcc, sm_90a) and
   report the card.
2. Ingest the banded benchmark matrix (n = 2**20 rows, offsets -5..5,
   float32, values from ``default_rng(0)``) through ``CooBuilder.add_many``
   with every entry added twice, and consolidate it on the card: the result
   must hold each entry once with its value doubled.
3. Run ``multiply`` and ``multiply_mv`` with dense scale vectors on the
   2**18-row matrix of the same family and hold them against a scipy.sparse
   float64 oracle on the host.
4. ``to_dia`` + ``prepare_dia`` (float32 and bfloat16) + ``best_spmv``:
   kernel K1 against its plain PyTorch version on the card; a float64
   ``SparseDIA`` through ``best_spmv`` (plain PyTorch in float64, the JAX
   package's route) against scipy float64. Then K1 on n + 3 rows (its
   single-element path) and on data at an odd storage offset, in float32
   and bfloat16, with m = n/2 and n = m/2, offsets beyond +-m, the
   Poisson offsets (0, +-1, +-1024), 128 diagonals and n = 100: each
   against its plain version, bit for bit on a second call, and the launch
   the library reports (``sps_dia_spmv_geometry``) equal to the host
   replay's (``dia_spmv_geometry``).
5. ``spmv_dia_chain`` (64 iterations, scale 0.3): kernel K2 against its
   plain version on the card.
6. NetCDF round trip of the phase-3 product: exact ``to_lists()`` equality.

The solve path (``solve_path``), on the SPD operator ``S = (B + B^T)/2`` of
the same banded matrix ``B`` with ``shift = 11`` (``S + 11 I`` is SPD by
Gershgorin: off-diagonal row sums below 10, diagonal above -1):

7. Build ``S`` through ``CooBuilder`` (every entry of ``B`` at 0.5 plus its
   transpose at 0.5), ``consolidate``, ``to_dia``, ``prepare_dia``.
8. ``spmm_dia_mrhs`` (K3) on ``B`` and ``X (8, n)``, float32 and bfloat16
   data, against its plain version and 8 K1 calls; ``R = 7`` and a 1-D ``x``.
9. ``cg_solve_dia`` (K4, one cooperative launch a solve), 50 iterations,
   against its plain version, the composed ``cg_solve`` over K1 and a
   float64 scipy residual; ``b = 0`` gives ``x = 0`` and ``rs = 0``. Then
   S with bfloat16 diagonals, a symmetric 11-diagonal matrix of 4n rows
   built on the card (too large for the kernel's resident mode: the
   device-memory mode), offsets (-n/2, -1, 0, 1, n/2), n = 100 (below the
   grid of one CTA an SM) and n = 2**14, each against its plain version
   and a float64 residual (1e-4 of max|x|, 1e-4 of max|b|). On the card
   each also gives the same x and rs bit for bit on a second solve, and
   the launch geometry the kernel reports (``sps_dia_cg_geometry``) must
   equal the Python mirror's (``cg_geometry``) from the card's
   properties.
10. ``cg_solve_mrhs`` over K3 with a Jacobi preconditioner, 8 right-hand
    sides, 50 iterations: per-column float64 residuals, and one column
    against ``pcg_solve`` over K1.

The SpMM path (``spmm_path``), general sparse x dense products at bench
config 3's widths (``bench.py:_regrid_matrix``: m = 2**18 rows, 50 entries
a row within 128 columns of column 2r, 2m columns, X of 128 columns, all
from ``default_rng(0)``):

11. Build A through ``CooBuilder`` and ``to_tiled``: 8190 tiles of cap
    4096, as the JAX package records for config 3.
12. K5: ``prepare_tiled_window(tl, group=32)`` in bfloat16 (config 3's
    layout) and ``prepare_general(A)`` in float32, which must route to
    ``dense_window``; ``spmm_tiled_window`` and ``spmm_general`` against
    the plain version and a float64 scipy product on 4096 sampled rows.
13. K6: ``spmm_tiled_dense`` on ``to_tiled_dense`` of the window layout and
    on ``prepare_tiled_dense`` (float32, bfloat16), against its plain
    version, against K5 and against the float64 scipy rows.
14. K7: ``spmm_tiled_onehot`` on ``prepare_tiled_rows`` of the same tiles,
    against its plain version and K6, and on the same layout with each
    tile's slots shuffled (no tile in row order); two one-hot-tier
    matrices through ``prepare_general`` (route ``one_hot``; 40-48 entries
    in the diagonal tile of each block row, and 8 tiles of 40-48 entries a
    block row, past one 256-slot piece) against scipy; bench config 3b's
    scattered matrix (route ``gather_ell``) against scipy. On all four K7
    layouts the kernel must equal a second call bit for bit.
15. One backward through ``spmm_general`` on the dense-window layout at
    2**13 rows, against the plain backward on the CPU.

The SpGEMM path (``spgemm_path``), sparse x sparse products at bench config
4's widths (``bench.py:685-696``: 2**17 rows, zipf(2.0) row lengths capped
at 24, columns ``2r + U{0,1,2}`` of 2**18, values uniform(0, 1), all from
``default_rng(0)``), against float64 scipy products of the consolidated
operand:

16. Build A through ``CooBuilder``, ``consolidate`` (193,565 entries) and
    ``to_tiled`` (2,540 tiles); ``plan_spgemm_caps``.
17. K8: ``best_spgemm(A, A, transpose_b=True)`` (routes ``tiled`` and
    ``window``) in float32 and ``spgemm_tiled`` with bfloat16 blocks
    against scipy; the band of ``plan_window_spgemm`` through K8 against
    its plain version in both types, its dead slots exactly zero, and a
    second call bit for bit.
18. K9 and K13: ``spgemm_tiled(A, A, transpose_b=True, use_window=False)``
    (config 4's pair plan), ``C = A A^T``, ``best_spgemm(C, C)`` and
    ``coo_matrix_power(C, 3)`` (the routes of each product logged) against
    scipy; K9 and K13 on both pair plans, in float32 and bfloat16, against
    the plain version and each other; float32 K9 must equal K13 bit for
    bit, and two K9 and two K13 calls must agree bit for bit.
19. ESC: ``spgemm_aat`` and ``plan_esc`` (device and host) +
    ``spgemm_planned`` against scipy.
20. Hand-off: the band's ``TiledBlocks.to_prepared_dense()`` through K6
    with X of 128 columns, against scipy.
The unstructured path (``unstructured_path``), bench config 2c's widths
(``bench.py:config2c_unstructured``: 2**20 x 2**20, 10 uniform-random
columns a row, values uniform(-1, 1), x uniform(-1, 1), all from
``default_rng(0)``), against float64 scipy products:

21. Build the matrix through ``CooBuilder`` and ``prepare_shuffle_spmv``;
    log B, n_vrows, gather_fill and the prepare's host wall.
22. K11: ``best_spmv(prep, x)``; K11's ELL slot grid against its plain
    version (the JAX sort pipeline) bit for bit on an allocation left full
    of NaN, ``y`` against the plain ``spmv_shuffle`` and scipy; the same on
    a heavy-row matrix (2**16 rows, one row of 4096 and 100 of 90 entries,
    ``ell_k`` 16: split rows).
23. K10: ``segmented_row_sums`` on the CSR products against its plain
    version, ``spmv_csr_segsum`` against scipy, and K10 on a skewed row
    pointer (empty rows, one row of 4096); then on 70% empty rows, a row
    of 20,000 entries across several CTAs, rp[0] = 4099, nnz = 0 and
    nrows = 0, entries outside the range NaN, against float64 sums, bit
    for bit on a second call, the launch the library reports
    (``sps_segsum_geometry``) equal to the host replay's
    (``segsum_geometry``).
24. K12: ``sort_blocks`` on (1024, 64, 128) int32 keys with a float32
    payload, two keys, R = 1, (8, 256, 128) with three arrays (past the
    shared-memory chunk), float32 keys (with ties, -0.0 and infinities) and
    ten arrays (keys through K12 with a position payload, then a gather);
    ``sort_blocks_stable`` packed and not. Keys exact, payloads exact when
    stable and otherwise as a multiset within each run of equal keys; on
    all six shapes, keys and payloads equal to a second call bit for bit;
    the chunk geometry the kernel reports equal to the host replay's.
The core path (``core_path``), the rest of ``core/`` at the main path's
width (the band ``B`` of phase 2: 2**20 rows, offsets -5..5, float32,
``default_rng(0)``, 11,534,306 entries, consolidated):

C1. Joins: the row-major keys of ``B`` and of the consolidated ``B^T``
    through ``join2`` (``n_match`` = nnz: the pattern is symmetric; the
    matched positions gather ``B[i, j]`` and ``B[j, i]``, 10**5 of them
    held against scipy), ``join3`` with the main diagonal of
    ``coo_diags`` (``n_match`` = n), and ``intersect_mask`` of 10**6
    random keys near the band against ``np.isin``.
C2. Algebra: ``coo_add(B, B^T, 0.5, 0.5)`` against phase 7's ``S``
    (indices exact, values rtol 1e-6); ``coo_add(tril(S), triu(S, 1))``
    equal to ``S``; ``row_sums(B)`` and ``col_sums(B)`` against K1's
    ``B 1`` and ``B^T 1`` (rtol 1e-5, atol 1e-5 of the max);
    ``scale_rows``/``scale_cols`` with phase 3's scale vectors, the
    stacking of ``B``'s two halves (``coo_slice``) and ``coo_kron`` of two
    512-row bands against scipy.
C3. Accumulators: ``scatter_to_dense`` of a 4096 x 4096 ``coo_slice`` of
    phase 2's doubled stream under ADD, and of the slice with each entry
    twice more at -3x under LEAVE_ALONE (first wins), REPLACE (last wins)
    and ADD, against numpy; ``scalar_sum(B)`` against a float64 host sum
    (rtol 1e-5); ``permute_output`` and ``project_output`` on a rank-3
    array of 10**6 entries.
C4. Reorder to K1: ``B`` scrambled by ``coo_permute`` with a permutation
    from ``default_rng(1)`` (bandwidth near n), ``rcm_permutation`` on the
    host (its time logged), ``coo_permute`` back (bandwidth b with
    ``2b + 1 <= MAX_DIAGS``), ``to_dia``, ``prepare_dia`` in float32 and
    bfloat16 and ``best_spmv`` (K1), against the plain K1 and the scipy
    float64 product of the scrambled matrix with x and y permuted.
C5. Interop: config 2c's matrix through ``to_scipy`` and ``from_scipy``;
    indices and values exact.
The solver path (``solver_path``), the rest of ``solvers/`` and the native
host library (built by ``g++`` from ``csrc/*.cpp``; ``native.available()``
must be true), on three operators built through ``CooBuilder``, ``to_dia``
and ``prepare_dia``, each float32 product with them kernel K1 (the
transpose's DIA for ``B^T``): P, the 2-D 5-point Poisson operator of a
1024 x 1024 grid (2**20 rows, 5,238,784 entries); B, config 2's band and
B^T; S = (B + B^T)/2 + 11 I:

V1. ``amg_setup(P)`` (the host aggregation timed a level), then
    ``pcg_solve`` over K1 with the hierarchy and with Jacobi, 50
    iterations each: float64 residuals on the host, AMG's at least 100x
    below Jacobi's.
V2. ``lanczos_eigsh`` (k = 6, largest, 256 steps) on S over K1: residuals
    at most 1e-3 |lambda|; ``lobpcg_solve`` (a block of 8, K3 as
    ``matmat``, 100 iterations): its top value within 1e-4 of Lanczos's; ``expm_multiply(-0.1 S) v`` against scipy (1e-4 of max).
V3. ``lsqr_solve``, ``lsmr_solve``, ``cgls_solve`` on B over K1 both ways,
    50 iterations: normal-equation residuals at most twice scipy lsqr's
    at the same count (plus 1e-4 of ||B^T b||); ``svds_lanczos`` (k = 6):
    both singular-vector residuals at most 1e-3 sigma.
V4. ``splu(S)`` and ``spsolve(S, b)`` (host LU and substitution: the
    factors have n levels) against scipy's spsolve; ``spsolve_triangular
    (tril(P), b)`` in float32 by ``auto``: 2,047 levels, 2,046 device
    sweeps, one K1 launch each, against scipy's spsolve_triangular.
V5. ``eigsh(S, k = 6, sigma = 7.6)`` by shift-invert through ``splu`` (RCM
    order) against scipy's eigsh (rtol 1e-6) and float64 residuals;
    ``onenormest`` of B through a ``LinearOperator`` of K1 both ways: an
    attained column sum of B, at most ||B||_1.
V6. ``inv`` and ``expm`` of B's leading 2048 x 2048 block against scipy's
    dense float64 ``inv`` and ``expm``.

25. Time every kernel against its plain version (CUDA events, in turns:
    plain, kernel, kernel, plain), and one PyTorch library call computing
    the same function where there is one (``torch.sparse_csr_tensor``
    products; none for K4, whose solve is no single library call). K4 per
    iteration (solves of 72 and 8 iterations) on S in float32 and bfloat16,
    in the device-memory mode at 4n rows and at n = 2**14, where the two
    grid-wide exchanges of an iteration set its time. K7 is
    timed on the four layouts of phase 14: config 3's tiles, sorted and
    shuffled, and the two one_hot route layouts, the traffic
    ``prepare_general`` sends it. K8, K9 and K13 at config
    4, with cuSPARSE's CSR x CSR SpGEMM as the yardstick; ``spgemm_tiled``
    end to end, the ESC ``spgemm_aat`` and the planned apply. K10 and K11
    at config 2c against cuSPARSE's CSR SpMV, with ``spmv_shuffle`` and
    ``spmv_csr_segsum`` end to end in nnz/s; K12 against ``torch.sort``
    carrying the payload through ``gather``. K11 is also timed against its
    earlier scatter design, kept in the kernel library as a yardstick and
    called only here and in ``tests_gpu/``, and K13 against K9 in turns. K10's library call is ``torch.segment_reduce`` of the
    same products by the row pointer (cuSPARSE's whole CSR SpMV beside
    it). The K7 and K12 rows carry ptxas's registers and spill bytes for
    their kernels. K8, K9 and K13 carry two bounds: the dense one
    (every tile product whole) and the occupied one (``bound_ms``: only
    the (warp block, k-chunk) units whose two sides hold a nonzero, which
    is the work the kernels cannot skip). K1 (config 2 in float32 and
    bfloat16, and float32 on phase 4's operand with the Poisson offsets),
    K2 and K10 also carry their device time (``torch.profiler``) and the
    host's issue time a call (bursts of calls not waited for).

The graph path (``graph_path``), the graph tier (``graph/``), ``io/npz.py``
and the CLI, on W (the 1024 x 1024 grid graph of P's off-diagonal pattern,
2**20 nodes, 4,190,208 entries, float64 weights uniform [0.5, 1.5) equal in
both orientations), U (the same pattern unweighted, float32) and R (config
2c's digraph, 2**20 nodes, 10 random heads a node, duplicates dropped,
float32 weights uniform [0.5, 1.5)), all from ``default_rng``; the host
tier, Python loops over nodes, on smaller graphs: R16 (the family of R at
2**16 nodes), a 2048 x 2048 bipartite graph, a ladder of 10**5 rows, a flow
network of 2**14 nodes and a 16 x 16 grid:

G1. ``spmv_semiring`` with each of the six semirings on R, x of 8 columns,
    against ``relax`` on ``prepare_relax(R)`` (min/max exactly, sums to
    rtol 1e-5); MIN_PLUS and PLUS_TIMES against float64 oracles (rtol
    1e-6 and 1e-5).
G2. ``bellman_ford`` on W from 8 sources, through the edge list and the
    ``RelaxPlan``, with predecessors: equal to scipy's ``dijkstra``, every
    tree edge with ``d[pred[j]] + w == d[j]``; ``dijkstra`` with ``limit``
    and ``min_only``; ``bfs_levels`` on R against scipy's BFS;
    ``floyd_warshall`` on W's first 2048 nodes against scipy (rtol 1e-12).
G3. Weak components of R and of W less a random tenth of its edges (on the
    card), strong components of R16 (host Tarjan), against scipy.
G4. ``minimum_spanning_tree(W)`` (Boruvka on the card) against scipy's:
    the same edges and weights.
G5. ``laplacian(U)`` equal to scipy's; ``to_dia`` + ``prepare_dia`` and K1
    on the ones vector: exactly 0; ``lanczos_eigsh`` (k = 6, largest, 256
    steps) through ``aslinearoperator`` (K1): every Ritz value within
    its float64 residual norm (plus a float32 rounding margin, 256
    2**-24 8 = 1.2e-4) of the analytic spectrum ``4 sin^2(pi i/2048) +
    4 sin^2(pi j/2048)`` and none above its top ``8 sin^2(1023 pi /
    2048)`` by more than that margin; each within 1e-4 of the same
    Lanczos run in float64 numpy on the host from the same start (which
    stops 1.8e-4 short of the top: a cluster with gaps ~3e-5); the
    residuals printed;
    ``laplacian(W, normed=True)`` against scipy (rtol 1e-12).
G6. The host tier: BFS/DFS orders and trees of R16; matchings,
    ``structural_rank`` and the min-weight full matching (cardinality and
    cost); the ladder's one long augmenting path; ``maximum_flow`` (value,
    capacities, conservation); ``shortest_path``, ``reconstruct_path``,
    ``construct_dist_matrix`` and ``yen`` — against scipy.
G7. ``save_npz(W)`` read by scipy unchanged; scipy CSR and CSC files read
    back by ``load_npz`` onto the card unchanged.
G8. ``spsparse_torch.tools`` in process with no ``--device`` (so on the
    card): info, convert, stats; solve on P (its residual against
    float64 scipy); eigs on P against the same run replayed in float64
    numpy on the host (its start, its 48 steps; rtol 1e-12); reorder on a
    scrambled 2**16-row band; graph cc/sssp/mst on W against G2-G4's
    oracles, ``--op laplacian --out`` read back against scipy's
    (rtol 1e-12); one subprocess of ``python3 -m spsparse_torch.tools
    info``.

The distributed path (``dist_path``), ``dist/`` and ``io/sharded.py`` on
a ``StackedMesh`` of 4 partitions on the card, at bench config 5's width a
partition (``bench.py:830-837``: 2**20 rows of config 2's family each).
Tolerances: integers exactly; float32 results within 1e-5 of max|ref| of
float64 on the host, and within rtol 1e-5 (with a floor of 1e-6 of
max|ref|) of the single-device port; float64 distances rtol 1e-12:

D0. Config 2's band at 2**22 rows (offsets -5..5, float32,
    ``default_rng(0)``; 46,137,314 entries) through ``CooBuilder`` and
    ``consolidate``, ``partition_rows``, ``partition_bucketed``,
    ``partition_vector`` of x; the host wall of each.
D1. ``dist_spmv`` ring and all_gather, ``dist_spmv_halo`` (halo 5) and
    ``dist_spmv_bucketed`` against K1 (``best_spmv`` on ``to_dia`` of the
    whole band) and scipy float64; halo 1 must raise.
D2. ``dist_spmm`` and ``dist_spmm_bucketed`` with 8 columns against K3
    and scipy float64.
D3. ``partition_footprint``, ``dist_spmv_a2a`` and ``dist_spmm_a2a`` on
    config 2c (2**20 x 2**20, 10 random columns a row) against K11
    (``best_spmv`` on ``prepare_shuffle_spmv``) and scipy float64.
D4. ``dist_spgemm``, ``dist_spgemm_a2a`` and ``dist_spgemm_ring`` on
    config 4's ``A·Aᵀ`` (A is 2**17 x 2**18, so ``A·A`` is undefined: the
    SpGEMM path's product) with caps from exact host counts (overflow 0
    in every partition), against ``best_spgemm`` (its routes logged) and
    scipy float64, structure exactly; each again with half the caps,
    which must report overflow.
D5. ``plan_dist_spgemm_tiled`` and ``dist_spgemm_tiled`` of the same
    product against K9 (``spgemm_tiled(..., use_window=False)``) and
    scipy float64, structure exactly.
D6. ``dist_block_jacobi`` (bs 128) and the port's ``pcg_solve`` with the
    matvec through the ring ``dist_spmv`` on ``S = (B + Bᵀ)/2 + 11 I`` at
    2**22 rows (layout and preconditioner sharded once by
    ``mesh.shard_layout``), against ``pcg_solve`` over K1 with
    ``block_jacobi_preconditioner``: the iteration counts to
    ``||r|| <= 1e-4 ||b||`` within one; at K1's count and at 16
    iterations the two x's equal at rtol 1e-5 and both float64 host
    residuals within 1e-4; then ``__graft_entry__.dryrun_multichip``'s
    checks (the three SpGEMMs, a CG step on the row-partitioned operator,
    ring, bucketed, halo, footprint and tiled products, the scaling model)
    on the card.
D7. ``dist_bellman_ford`` (sources 0, n/2, n-1 and one from
    ``default_rng(15)``), ``dist_bfs_levels`` and
    ``dist_connected_components`` (of W and of W less a random tenth of
    its edges) on the graph path's W (2**20 nodes, float64), against the
    single-device graph tier on the card and scipy; rounds and host syncs
    of each loop from the event log.
D8. ``save_netcdf_sharded`` and ``load_netcdf_sharded`` of D0's row
    partition in a temporary directory: every array back bit for bit
    (values as float64); ``parts=[1, 3]`` leaves partitions 0 and 2 empty.
D9. A world of one NCCL rank (``init_process_group("nccl",
    store=FileStore(...), rank=0, world_size=1, device_id=cuda:0)``, no
    network; a failed start fails the run): D1's four SpMVs,
    ``dist_spmv_a2a`` (config 2c) and ``dist_bellman_ford`` (W) with P = 1
    on its ``GroupMesh``, against ``StackedMesh(1, cuda)`` and the host
    oracles; then ``destroy_process_group()``. Then two processes each try
    to join a two-rank NCCL group on card 0, bounded at 120 s, and their
    outcome is logged (NCCL refuses a second rank on one card); that
    attempt's wall is logged apart from the world of one's.

The utils path (``utils_path``), on config 2's band ``B`` (2**20 rows,
11 diagonals) through ``band_coo``, ``to_dia`` and ``prepare_dia``:

U1. ``utils.roofline.device_hbm_bandwidth()`` names the card (beside the
    nvidia-smi line); ``spmv_dia_stats(11, 2**20)`` gives exactly the bytes
    of the prepared diagonals plus x and y, which are the bytes behind
    K1's float32 bound in the kernel table (whose memory rate is the
    module's too).
U2. ``utils.benchtime.bench_chained`` of ``y = spmv_dia_stream(prep, y)``
    (K1, CUDA events) and ``time_ms`` of the same call, in turns: the two
    must agree within 15%, and ``roofline(...)["pct_of_roofline"]`` must
    not pass 105.
U3. NVTX: with ``enable_ranges(True)``, ``trace_scope`` pushes a range on
    the card (``_NVTX``); a probe ``range_push`` inside a traced op's scope
    opens one level deeper than outside it, and the depth is back after the op and after a raising
    body (counted by wrappers around the real NVTX calls, and by NVTX's
    own return where a tool tracks it); the event log records the op and
    the nested ``spsparse.spmv``.
U4. ``core.validate.validate_coo`` passes on ``B`` and raises
    ``SpSparseError`` on a copy with one live index out of range (and on
    one negative index); ``check_capacity`` raises on overflow and passes
    at equality.

The core path, the solver path, the graph path, the distributed path and
the utils path run after phase 25, so that their host work cannot reach
the kernels' times. The launch counters of the kernel wrappers are reset
before each path and read after it; a kernel of the path launched no time
there fails the run.
The last lines are a JSON line per timing and per path, the
``{"kernels": [...]}`` line (each kernel's launches on the distributed
path in ``launches_dist_path``, on the utils path in
``launches_utils_path``),
the card's name and power limit from nvidia-smi, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N = 1 << 20          # rows of the banded benchmark matrix (config 2)
MM_N = 1 << 18       # rows of the matrix of the multiply phase
BAND = 5             # offsets -BAND..BAND: 11 diagonals
CHAIN_ITERS = 64
CHAIN_SCALE = 0.3
SHIFT = 11.0         # S + 11 I is SPD by Gershgorin
CG_ITERS = 50
CG_TINY_N = 100      # K4 below the grid (264 CTAs on an H100)
CG_SMALL_N = 1 << 14  # K4 where the grid barriers dominate
RHS = 8              # right-hand sides of K3 and the block solve
SPMM_M = 1 << 18     # rows of bench config 3's regridding matrix
SPMM_K = 50          # entries a row
SPMM_N = 128         # columns of the dense block X
SPREAD = 128
WINDOW_GROUP = 32    # config 3's super-row group
CFG3B_M = 1 << 14    # rows of bench config 3b's scattered matrix
TILE_SIDE = 128
TILE_ELEMS = TILE_SIDE * TILE_SIDE
SAMPLED_ROWS = 4096
GRAD_M = 1 << 13
CFG4_N = 1 << 17     # rows of bench config 4's regridding matrix
SPGEMM_X = 128       # columns of X in the SpGEMM hand-off to K6
CFG2C_K = 10         # entries a row of bench config 2c (n = N)
HEAVY_N = 1 << 16    # rows of the heavy-row shuffle matrix
SORT_NBLK = 1024     # (1024, 64, 128) blocks: the TPU sort probe's size
CORE_KRON_N = 512    # rows of each band in C2's coo_kron
CORE_SLICE_M = 4096  # C3's square slice of phase 2's stream
CORE_R3_NNZ = 10 ** 6  # entries of C3's rank-3 array
CORE_QUERIES = 10 ** 6  # random keys C1 probes with intersect_mask
POISSON_SIDE = 1024  # grid side of the solver path's Poisson operator P
SOLVER_ITERS = 50    # PCG, LSQR, LSMR and CGLS iterations of V1 and V3
EIG_K = 6            # eigenpairs and singular triplets of V2, V3 and V5
LANCZOS_ITERS = 256  # Krylov size of V2's Lanczos and V3's svds
CLI_EIGS_STEPS = 48  # the CLI's default eigs --iters
# G8: the CLI's float64 Ritz values against the host's float64 replay
# (different summation orders only)
CLI_EIGS_RTOL = 1e-12
LOBPCG_ITERS = 100
EXPM_T = 0.1         # V2's expm_multiply(-t S) v
SIGMA = 7.6          # V5's shift, near the bottom of S's spectrum
MATFUNC_M = 2048     # rows of V6's slice of B
GRAPH_SOURCES = 8    # G2's Bellman-Ford sources
GRAPH_X = 8          # columns of G1's frontier
SEMIRINGS = ("MIN_PLUS", "MAX_PLUS", "MIN_MIN", "MAX_MIN", "OR_AND",
             "PLUS_TIMES")
FW_N = 2048          # nodes of G2's induced subgraph of W (two grid rows)
HOST_N = 1 << 16     # nodes of R16, the host tier's digraph (G3, G6)
MATCH_N = 2048       # rows and columns of G6's bipartite graph
LADDER_N = 10 ** 5   # rows of G6's ladder: one augmenting path this long
FLOW_N = 1 << 14     # nodes of G6's flow network
PATH_SIDE = 16       # grid side of G6's path-tools graph
YEN_K = 8            # paths of G6's yen
REORDER_N = 1 << 16  # rows of G8's scrambled band
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bfloat16 on the tensor cores

KERNELS = {
    "spmv_dia_stream": dict(
        route="cuda", source="spsparse_torch/csrc/dia.cu",
        replaces="spsparse_tpu/ops/pallas_dia.py:51"),
    "spmv_dia_chain": dict(
        route="cuda", source="spsparse_torch/csrc/dia.cu",
        replaces="spsparse_tpu/ops/pallas_dia_chain.py:35"),
    "spmm_dia_mrhs": dict(
        route="cuda", source="spsparse_torch/csrc/dia_mrhs.cu",
        replaces="spsparse_tpu/ops/pallas_dia_mrhs.py:42"),
    "cg_solve_dia": dict(
        route="cuda", source="spsparse_torch/csrc/dia_cg.cu",
        replaces="spsparse_tpu/ops/pallas_cg.py:71"),
    "spmm_tiled_window": dict(
        route="cuda", source="spsparse_torch/csrc/tiled_window.cu",
        replaces="spsparse_tpu/ops/pallas_tiled_window.py:145"),
    "spmm_tiled_dense": dict(
        route="cuda", source="spsparse_torch/csrc/tiled.cu",
        replaces="spsparse_tpu/ops/pallas_tiled.py:367"),
    "spmm_tiled_onehot": dict(
        route="cuda", source="spsparse_torch/csrc/tiled.cu",
        replaces="spsparse_tpu/ops/pallas_tiled.py:112"),
    "spgemm_window": dict(
        route="cuda", source="spsparse_torch/csrc/spgemm.cu",
        replaces="spsparse_tpu/ops/spgemm_window.py:227"),
    "spgemm_tiled_pairs": dict(
        route="cuda", source="spsparse_torch/csrc/spgemm.cu",
        replaces="spsparse_tpu/ops/spgemm_tiled.py:303"),
    "spgemm_tiled_stream": dict(
        route="cuda", source="spsparse_torch/csrc/spgemm.cu",
        replaces="spsparse_tpu/ops/spgemm_tiled.py:350"),
    "segmented_row_sums": dict(
        route="cuda", source="spsparse_torch/csrc/segsum.cu",
        replaces="spsparse_tpu/ops/pallas_segsum.py:48"),
    "shuffle_gather": dict(
        route="cuda", source="spsparse_torch/csrc/spmv_shuffle.cu",
        replaces="spsparse_tpu/ops/spmv_shuffle.py:199"),
    "sort_blocks": dict(
        route="cuda", source="spsparse_torch/csrc/block_sort.cu",
        replaces="spsparse_tpu/ops/pallas_sort.py:85"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def banded_entries(n: int, band: int = BAND, seed: int = 0):
    """Row-major (rows, cols, vals) of the benchmark's banded matrix: the
    in-range slots of offsets -band..band, values uniform(-1, 1) float32
    from ``default_rng(seed)`` (the generator of ``bench.py``)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    vals = np.where(valid, rng.uniform(-1, 1, (n, 2 * band + 1)),
                    0).astype(np.float32)
    rows = np.broadcast_to(np.arange(n)[:, None], cols.shape)
    return (rows[valid].astype(np.int32), cols[valid].astype(np.int32),
            vals[valid])


def close(got, ref, rtol: float, atol_rel: float) -> tuple[bool, float]:
    """``|got - ref| <= rtol*|ref| + atol_rel*max|ref|`` elementwise, plus
    the max abs error."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    atol = atol_rel * float(np.max(np.abs(ref), initial=0.0))
    return bool(np.all(err <= rtol * np.abs(ref) + atol)), float(
        np.max(err, initial=0.0))


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_ingest(torch, sp, dev, n):
    """Phase 2: double ingest + consolidate."""
    r, c, v = banded_entries(n)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    idx = np.stack([r, c], axis=1)
    b.add_many(idx, v)
    b.add_many(idx, v)
    raw = b.build(device=dev)
    A = sp.consolidate(raw)
    sync(torch, dev)
    nz = v != 0
    require(A.nnz == int(nz.sum()), f"consolidated nnz {A.nnz}")
    require(np.array_equal(A.indices[: A.nnz].cpu().numpy(), idx[nz]),
            "consolidated indices")
    require(np.array_equal(A.vals[: A.nnz].cpu().numpy(), 2 * v[nz]),
            "consolidated values are not the doubled inputs")
    return {"A": A, "vals": v, "raw_entries": raw.nnz}


def scipy_banded(n):
    return csr_host(*banded_entries(n), (n, n))


def _csr_of(coo):
    import scipy.sparse as ssp

    idx = coo.indices[: coo.nnz].cpu().numpy().astype(np.int64)
    vals = coo.vals[: coo.nnz].cpu().numpy().astype(np.float64)
    return ssp.csr_matrix((vals, (idx[:, 0], idx[:, 1])), shape=coo.shape)


def phase_multiply(torch, sp, dev, n):
    """Phase 3: scaled MM and MV chains against a scipy float64 oracle."""
    import scipy.sparse as ssp
    from spsparse_torch.ops import multiply, multiply_mv

    r, c, v = banded_entries(n)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([r, c], axis=1), v)
    A = b.build(device=dev)
    rng = np.random.default_rng(2)
    si, sj, sk = (rng.uniform(0.5, 1.5, n).astype(np.float32)
                  for _ in range(3))
    vec = rng.uniform(-1, 1, n).astype(np.float32)

    def dense_vector(vals):
        vb = sp.coo_vector(n, dtype=np.float32)
        vb.add_many(np.arange(n, dtype=np.int32), vals)
        return vb.build(device=dev)

    S_i, S_j, S_k, V = (dense_vector(s) for s in (si, sj, sk, vec))
    P = multiply(0.5, A, A, scalei=S_i, scalej=S_j, scalek=S_k)
    y = multiply_mv(0.5, A, V, scalei=S_i, scalej=S_j)
    sync(torch, dev)

    As = scipy_banded(n)
    D = [ssp.diags(s.astype(np.float64)) for s in (si, sj, sk)]
    P_ref = (0.5 * (D[0] @ As @ D[1] @ As @ D[2])).tocsr()
    P_ref.sort_indices()
    P_got = _csr_of(P)
    P_got.sort_indices()
    require(P.nnz == P_ref.nnz, f"MM nnz {P.nnz} vs oracle {P_ref.nnz}")
    require(np.array_equal(P_got.indptr, P_ref.indptr)
            and np.array_equal(P_got.indices, P_ref.indices),
            "MM structure differs from the oracle")
    ok_mm, err_mm = close(P_got.data, P_ref.data, 1e-5, 1e-5)
    require(ok_mm, f"MM values off the oracle (max abs err {err_mm})")

    y_ref = 0.5 * si.astype(np.float64) * (
        As @ (sj.astype(np.float64) * vec.astype(np.float64)))
    keep = y_ref != 0
    require(y.nnz == int(keep.sum()), f"MV nnz {y.nnz}")
    require(np.array_equal(y.indices[: y.nnz, 0].cpu().numpy(),
                           np.nonzero(keep)[0]), "MV structure")
    ok_mv, err_mv = close(y.vals[: y.nnz].cpu().numpy(), y_ref[keep],
                          1e-5, 1e-5)
    require(ok_mv, f"MV values off the oracle (max abs err {err_mv})")
    return {"P": P, "mm_max_abs_err": err_mm, "mv_max_abs_err": err_mv}


def phase_dia(torch, sp, dev, A, vals):
    """Phase 4: to_dia + prepare_dia + best_spmv (K1) vs the plain K1.

    ``A`` holds the benchmark matrix doubled (phase 2); halving its
    diagonals, which is exact, gives the benchmark matrix itself, the
    operand of the SpMV and the chain."""
    from spsparse_torch.ops import (best_spmv, prepare_dia,
                                    spmv_dia_stream_reference)

    n = A.shape[0]
    doubled = sp.to_dia(A)
    require(doubled.offsets == tuple(range(-BAND, BAND + 1)),
            f"to_dia offsets {doubled.offsets}")
    band = np.zeros((n, 2 * BAND + 1), np.float32)
    cols = np.arange(n)[:, None] + np.arange(-BAND, BAND + 1)[None, :]
    band[(cols >= 0) & (cols < n)] = 2 * vals
    require(np.array_equal(doubled.data.cpu().numpy(), band.T),
            "to_dia data differs from the doubled band")
    dia = sp.SparseDIA(data=doubled.data * 0.5, offsets=doubled.offsets,
                       shape=doubled.shape)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, n)
                         .astype(np.float32)).to(dev)
    out = {"dia": dia, "x": x, "err": {}}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(dia, dtype=dtype)
        y = best_spmv(prep, x)
        ref = spmv_dia_stream_reference(prep, x)
        sync(torch, dev)
        ok, err = close(y.cpu().numpy(), ref.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K1 {name} off its plain version (max abs err {err})")
        out[name] = prep
        out["err"][name] = err
    y = best_spmv(dia, x)        # SparseDIA operand: prepared on the fly
    sync(torch, dev)
    ok, err = close(y.cpu().numpy(),
                    spmv_dia_stream_reference(out["f32"], x).cpu().numpy(),
                    1e-5, 1e-5)
    require(ok, f"K1 on a SparseDIA operand (max abs err {err})")
    # A float64 operand takes the plain float64 route (K1 never took
    # float64): float64 out, within 1e-12 of scipy float64 (the same
    # products summed in another order).
    dia64 = sp.SparseDIA(data=dia.data.double(), offsets=dia.offsets,
                         shape=dia.shape)
    y64 = best_spmv(dia64, x.double())
    sync(torch, dev)
    require(y64.dtype == torch.float64, f"float64 DIA SpMV gave {y64.dtype}")
    ok, out["err"]["f64"] = close(
        y64.cpu().numpy(), scipy_banded(n) @ x.cpu().numpy().astype(
            np.float64), 1e-12, 1e-12)
    require(ok, f"float64 DIA best_spmv off scipy ({out['err']['f64']})")
    (out["shape_err"], out["geometry"], out["P"],
     out["P_x"]) = k1_shapes(torch, dev, n)
    return out


def k1_shapes(torch, dev, n):
    """Phase 4's further K1 shapes through ``spmv_dia_stream``, random
    values in every slot (those outside [0, m) must not count): n + 3 rows
    (the single-element path) and data at an odd storage offset, each in
    float32 and bfloat16; m = n/2 and n = m/2 with a far diagonal; offsets
    beyond +-m; the Poisson operator's offsets (0, +-1, +-sqrt(n)); 128
    diagonals on n/4 rows; n = 100. Each against the plain version (rtol
    1e-5, atol 1e-5 of max|ref|), the same bits from a second call, and on
    the card the launch the library reports equal to the host replay's.
    Returns ``({shape: max abs err}, {shape: geometry}, P's operand, x)``;
    the launches are not counted as the path's."""
    from spsparse_torch.ops import (PreparedDIA, spmv_dia_stream,
                                    spmv_dia_stream_reference)

    rng = np.random.default_rng(13)
    side = int(round(n ** 0.5))
    band = tuple(range(-BAND, BAND + 1))

    def operand(rows, cols, offsets, dtype=torch.float32, at=0):
        K = len(offsets)
        store = torch.empty(at + K * rows, dtype=dtype, device=dev)
        store[at:] = torch.from_numpy(rng.uniform(-1, 1, K * rows).astype(
            np.float32)).to(dev).to(dtype)
        return PreparedDIA(data=store[at:].view(K, rows),
                           offsets=tuple(offsets), shape=(rows, cols))

    shapes = {
        "n + 3, f32": operand(n + 3, n + 3, band),
        "n + 3, bf16": operand(n + 3, n + 3, band, torch.bfloat16),
        "odd storage offset, f32": operand(n, n, band, at=1),
        "odd storage offset, bf16": operand(n, n, band, torch.bfloat16, 1),
        "m = n/2": operand(n, n // 2, band + (n // 4,)),
        "n = m/2": operand(n // 2, n, band + (n // 4,)),
        "offsets beyond +-m": operand(n, n, (-n - 3,) + band + (n + 2,)),
        "P's offsets": operand(n, n, (-side, -1, 0, 1, side)),
        "128 diagonals": operand(n // 4, n // 4, range(-64, 64)),
        "n = 100": operand(100, 100, band),
    }
    before = spmv_dia_stream.launches
    errs, geos = {}, {}
    for what, prep in shapes.items():
        x = torch.from_numpy(rng.uniform(-1, 1, prep.shape[1]).astype(
            np.float32)).to(dev)
        y = spmv_dia_stream(prep, x)
        y2 = spmv_dia_stream(prep, x)
        ref = spmv_dia_stream_reference(prep, x)
        sync(torch, dev)
        ok, errs[what] = close(y.cpu().numpy(), ref.cpu().numpy(), 1e-5,
                               1e-5)
        require(ok, f"K1 {what} off its plain version ({errs[what]})")
        require(bitwise_equal(torch, y, y2),
                f"K1 {what}: a second call gave other bits")
        if torch.device(dev).type == "cuda":
            geos[what] = k1_geometry(prep, y)
            require(geos[what] == k1_replay(prep, y),
                    f"K1 {what}: the library's launch {geos[what]} is not "
                    f"dia_spmv_geometry's {k1_replay(prep, y)}")
        if what == "P's offsets":
            p_x = x
    spmv_dia_stream.launches = before
    return errs, geos, shapes["P's offsets"], p_x


def phase_chain(torch, dev, prep, x):
    """Phase 5: K2 against the plain chain."""
    from spsparse_torch.ops import spmv_dia_chain, spmv_dia_chain_reference

    z = spmv_dia_chain(prep, x, CHAIN_ITERS, CHAIN_SCALE)
    ref = spmv_dia_chain_reference(prep, x, CHAIN_ITERS, CHAIN_SCALE)
    sync(torch, dev)
    zn, rn = z.cpu().numpy(), ref.cpu().numpy()
    require(bool(np.all(np.isfinite(zn))), "K2 output is not finite")
    # 64 iterations amplify f32 rounding (FMA vs separate multiply-add):
    # hold the error to 1e-4 of the iterate's scale.
    ok, err = close(zn, rn, 1e-4, 1e-4)
    require(ok, f"K2 off its plain version (max abs err {err})")
    return err


def phase_netcdf(torch, dev, P):
    """Phase 6: save + load the product; exact equality."""
    from spsparse_torch.io import load_netcdf, save_netcdf

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "product.nc")
        save_netcdf(path, {"P": P})
        Q = load_netcdf(path, "P", rank=2, dtype=np.float32, device=dev)
    sync(torch, dev)
    require(Q.shape == P.shape and Q.to_lists() == P.to_lists(),
            "NetCDF round trip is not exact")


def main_path(torch, sp, dev, n=N, mm_n=MM_N) -> dict:
    """Phases 2-6 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    ing = phase_ingest(torch, sp, dev, n)
    log(f"phase 2 ingest+consolidate: {ing['raw_entries']} entries -> "
        f"nnz {ing['A'].nnz} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    mm = phase_multiply(torch, sp, dev, mm_n)
    log(f"phase 3 multiply: MM nnz {mm['P'].nnz}, max abs err "
        f"{mm['mm_max_abs_err']!r}; MV max abs err {mm['mv_max_abs_err']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    dia = phase_dia(torch, sp, dev, ing["A"], ing["vals"])
    log(f"phase 4 DIA SpMV: K1 max abs err {dia['err']}; shapes "
        f"{dia['shape_err']}, bit for bit on a second call, launches "
        f"{dia['geometry']} equal to dia_spmv_geometry's "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    chain_err = phase_chain(torch, dev, dia["f32"], dia["x"])
    log(f"phase 5 DIA chain: K2 max abs err {chain_err!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    phase_netcdf(torch, dev, mm["P"])
    log(f"phase 6 NetCDF round trip exact ({time.perf_counter() - t0:.3f} s)")
    return {"dia": dia, "chain_err": chain_err, "nnz": ing["A"].nnz}


def band_of(n):
    """``(n, 2*BAND+1)`` float32 band of ``B``: column ``d`` holds
    ``B[i, i + d - BAND]``, zero out of range."""
    r, c, v = banded_entries(n)
    band = np.zeros((n, 2 * BAND + 1), np.float32)
    band[r, c - r + BAND] = v
    return band


def spd_coo(sp, dev, n):
    """Phase 7's ``S = (B + B^T)/2`` through the builder, consolidated."""
    r, c, v = banded_entries(n)
    half = (np.float32(0.5) * v).astype(np.float32)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([r, c], axis=1), half)
    b.add_many(np.stack([c, r], axis=1), half)
    return sp.consolidate(b.build(device=dev))


def phase_spd(torch, sp, dev, n):
    """Phase 7: S = (B + B^T)/2 through the builder, consolidate, to_dia."""
    from spsparse_torch.ops import prepare_dia

    S = sp.to_dia(spd_coo(sp, dev, n))
    sync(torch, dev)
    offs = tuple(range(-BAND, BAND + 1))
    require(S.offsets == offs, f"S offsets {S.offsets}")
    want = sum(n - abs(o) for o in offs)
    require(S.nnz_stored == want, f"S stores {S.nnz_stored} slots, not {want}")
    band = band_of(n)
    sband = np.zeros_like(band)
    for d, o in enumerate(offs):
        lo, hi = max(0, -o), min(n, n - o)
        mirror = band[lo + o:hi + o, 2 * BAND - d]     # B[i + o, i]
        sband[lo:hi, d] = (np.float32(0.5) * band[lo:hi, d]
                           + np.float32(0.5) * mirror)
    ok, err = close(S.data.cpu().numpy(), sband.T, 1e-6, 1e-7)
    require(ok, f"S differs from (B + B^T)/2 (max abs err {err})")
    Bs = scipy_banded(n)
    return {"S": S, "prep": prepare_dia(S), "band": band,
            "S_host": (0.5 * (Bs + Bs.T)).tocsr(), "stored": S.nnz_stored}


def phase_mrhs(torch, sp, dev, band):
    """Phase 8: K3 on the config 2b operand B against its plain version,
    against 8 K1 calls, and for R = 7 and a 1-D x."""
    from spsparse_torch.ops import (prepare_dia, spmm_dia_mrhs,
                                    spmm_dia_mrhs_reference, spmv_dia_stream)

    n = band.shape[0]
    dia = sp.SparseDIA(data=torch.from_numpy(band.T.copy()).to(dev),
                       offsets=tuple(range(-BAND, BAND + 1)), shape=(n, n))
    X = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (RHS, n))
                         .astype(np.float32)).to(dev)
    out = {"X": X, "err": {}}
    # Tolerance, as K1's: rtol and atol 1e-5 of max|ref| (the kernel fuses
    # multiply-adds; the plain version rounds every product).
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(dia, dtype=dtype)
        Y = spmm_dia_mrhs(prep, X)
        ref = spmm_dia_mrhs_reference(prep, X)
        sync(torch, dev)
        require(tuple(Y.shape) == (RHS, n), f"K3 shape {tuple(Y.shape)}")
        ok, err = close(Y.cpu().numpy(), ref.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K3 {name} off its plain version (max abs err {err})")
        rows = torch.stack([spmv_dia_stream(prep, X[i]) for i in range(RHS)])
        ok, err_k1 = close(Y.cpu().numpy(), rows.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K3 {name} off 8 K1 calls (max abs err {err_k1})")
        out[name] = prep
        out["err"][name] = max(err, err_k1)
    prep = out["f32"]
    for got, ref in ((spmm_dia_mrhs(prep, X[:7]),
                      spmm_dia_mrhs_reference(prep, X[:7])),
                     (spmm_dia_mrhs(prep, X[0]),
                      spmm_dia_mrhs_reference(prep, X[:1])[0])):
        sync(torch, dev)
        ok, err = close(got.cpu().numpy(), ref.cpu().numpy(), 1e-5, 1e-5)
        require(ok and got.shape == ref.shape,
                f"K3 on {tuple(ref.shape)} off its plain version ({err})")
    return out


def residual_inf(S_host, x, rhs) -> np.ndarray:
    """``max|(S + SHIFT I) x - rhs|`` per column, in float64 on the host."""
    x = np.asarray(x, np.float64)
    rhs = np.asarray(rhs, np.float64)
    r = S_host @ x + SHIFT * x - rhs
    return np.abs(r).max(axis=0)


def spd_dia(torch, dev, n, offsets, seed):
    """A symmetric DIA built on ``dev`` (float32 diagonals from a seeded
    generator): off-diagonals uniform(-0.5, 0.5), ``A[i, i+o] = A[i+o, i]``,
    the main diagonal uniform(0, 1); with 10 off-diagonals at most,
    ``A + SHIFT I`` is SPD by Gershgorin."""
    from spsparse_torch.ops.dia_stream import PreparedDIA

    g = torch.Generator(device=dev).manual_seed(seed)
    offsets = tuple(offsets)
    data = torch.zeros((len(offsets), n), device=dev)
    for k, o in enumerate(offsets):
        if 0 < o < n:
            v = torch.rand(n - o, generator=g, device=dev) - 0.5
            data[k, :n - o] = v
            data[offsets.index(-o), o:] = v
    if 0 in offsets:
        data[offsets.index(0)] = torch.rand(n, generator=g, device=dev)
    return PreparedDIA(data=data, offsets=offsets, shape=(n, n))


def dia_residual_inf(torch, prep, x, b) -> float:
    """``max|(A + SHIFT I) x - b|`` in float64 on the operand's device, for
    the diagonals as stored (bfloat16 ones as rounded: the operator the
    kernel solves)."""
    n = prep.shape[0]
    data, x = prep.data.double(), x.double()
    r = SHIFT * x - b.double()
    for k, o in enumerate(prep.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        if hi > lo:
            r[lo:hi] += data[k, lo:hi] * x[lo + o:hi + o]
    return float(r.abs().max())


def cg_geometry_pair(torch, n, dtype):
    """K4's launch geometry for ``n`` rows as the kernel reports it, and as
    the Python mirror computes it from the card's properties."""
    from spsparse_torch.ops.dia_cg import cg_geometry, cg_kernel_geometry

    props = torch.cuda.get_device_properties(0)
    mirror = cg_geometry(
        n, sms=props.multi_processor_count,
        smem_per_sm=props.shared_memory_per_multiprocessor,
        smem_per_block=props.shared_memory_per_block_optin)
    return cg_kernel_geometry(n, dtype), mirror


def check_cg_case(torch, dev, what, prep, b, *, resident=None):
    """K4 on ``prep`` and ``b`` against its plain version (1e-4 of max|x|)
    and a float64 residual (1e-4 of max|b|); on the card, a second solve
    equal bit for bit and the geometry the kernel reports equal to the
    mirror's (and its mode, where ``resident`` names it)."""
    from spsparse_torch.ops import cg_solve_dia, cg_solve_dia_reference

    n = prep.shape[0]
    x, rs = cg_solve_dia(prep, b, iters=CG_ITERS, shift=SHIFT)
    x_ref, _ = cg_solve_dia_reference(prep, b, iters=CG_ITERS, shift=SHIFT)
    sync(torch, dev)
    require(tuple(x.shape) == (n,) and bool(torch.isfinite(x).all())
            and rs.shape == () and rs.device == x.device,
            f"K4 {what}: not a finite (n,) x with a 0-d device rs")
    scale = float(x_ref.abs().max())
    err = float((x - x_ref).abs().max())
    require(err <= 1e-4 * scale, f"K4 {what} off its plain version "
            f"(max abs err {err}, max|x| {scale})")
    res = dia_residual_inf(torch, prep, x, b)
    bound = 1e-4 * float(b.abs().max())
    require(res <= bound, f"K4 {what}: residual {res} above {bound}")
    out = {"x": x, "err": err, "residual": res, "rs": float(rs)}
    if dev != "cpu":
        x2, rs2 = cg_solve_dia(prep, b, iters=CG_ITERS, shift=SHIFT)
        sync(torch, dev)
        require(torch.equal(x, x2) and torch.equal(rs, rs2),
                f"K4 {what}: two solves differ in some bit")
        kernel_geo, mirror_geo = cg_geometry_pair(torch, n, prep.data.dtype)
        require(kernel_geo == mirror_geo, f"K4 {what}: the kernel's geometry "
                f"{kernel_geo} is not the mirror's {mirror_geo}")
        require(resident is None or kernel_geo.resident == resident,
                f"K4 {what}: geometry {kernel_geo}, not the expected mode")
        out["geometry"] = tuple(kernel_geo)
    return out


def phase_cg(torch, dev, spd):
    """Phase 9: K4 on S against its plain version, the composed solve over
    K1 and a float64 residual; b = 0; then S with bfloat16 diagonals, a
    matrix of 4n rows (the device-memory mode on an H100), offsets of
    +-n/2, n = 100 (below the grid) and n = 2^14, each against its plain
    version and a float64 residual, bit for bit from one solve to the next,
    with the geometry the kernel reports equal to the mirror's."""
    from spsparse_torch.ops import best_spmv, cg_solve_dia, prepare_dia
    from spsparse_torch.solvers import cg_solve

    prep = spd["prep"]
    n = prep.shape[0]
    b = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, n)
                         .astype(np.float32)).to(dev)
    main = check_cg_case(torch, dev, "S", prep, b, resident=True)
    x_cmp, _ = cg_solve(lambda v: best_spmv(prep, v) + SHIFT * v, b,
                        iters=CG_ITERS)
    sync(torch, dev)
    xn = main["x"].cpu().numpy()
    # 50 iterations compound f32 rounding (fused vs separate multiply-adds,
    # block-ordered vs library-ordered dot products): 1e-4 of max|x|, as K2.
    ok, err_cmp = close(xn, x_cmp.cpu().numpy(), 0.0, 1e-4)
    require(ok, f"K4 off the composed cg_solve over K1 ({err_cmp})")
    bn = b.cpu().numpy()
    # The float64 residual of a converged float32 solve is set by the f32
    # rounding of x and of S (about 1e-6 here); 1e-4 of max|b| bounds it
    # with margin and still fails an unconverged or wrong solve.
    res = float(residual_inf(spd["S_host"], xn, bn))
    bound = 1e-4 * float(np.abs(bn).max())
    require(res <= bound, f"K4 residual {res} above scipy's {bound}")
    x0, rs0 = cg_solve_dia(prep, torch.zeros_like(b), iters=5, shift=SHIFT)
    sync(torch, dev)
    require(not bool(x0.any()) and float(rs0) == 0.0,
            "K4 with b = 0 did not give x = 0 and rs = 0")

    def rhs(m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand(m, generator=g, device=dev) * 2 - 1

    big, small = 4 * n, CG_SMALL_N
    band = tuple(range(-BAND, BAND + 1))
    # name: (operand, b, the mode the geometry must report, timed in
    # phase 25)
    cases = {
        "S bf16": (prepare_dia(spd["S"], dtype=torch.bfloat16), b, True,
                   True),
        f"device-memory mode, n = {big}": (
            spd_dia(torch, dev, big, band, 5), rhs(big, 6), False, True),
        "offsets -n/2, -1, 0, 1, n/2": (
            spd_dia(torch, dev, n, (-n // 2, -1, 0, 1, n // 2), 7),
            rhs(n, 8), None, False),
        f"n = {CG_TINY_N}, below the grid": (
            spd_dia(torch, dev, CG_TINY_N, (-3, -1, 0, 1, 3), 9),
            rhs(CG_TINY_N, 10), True, False),
        f"n = {small}": (spd_dia(torch, dev, small, band, 11),
                         rhs(small, 12), True, True),
    }
    checked = {what: {**check_cg_case(torch, dev, what, p, bb, resident=mode),
                      "prep": p, "b": bb, "timed": timed}
               for what, (p, bb, mode, timed) in cases.items()}
    return {"b": b, "x": main["x"], "err": main["err"],
            "err_composed": err_cmp, "residual": res, "rs": main["rs"],
            "geometry": main.get("geometry"), "cases": checked}


def phase_block_cg(torch, dev, spd):
    """Phase 10: cg_solve_mrhs over K3, Jacobi-preconditioned."""
    from spsparse_torch.ops import best_spmv, spmm_dia_mrhs
    from spsparse_torch.solvers import (cg_solve_mrhs, extract_diagonal,
                                        jacobi_preconditioner, pcg_solve)

    prep = spd["prep"]
    n = prep.shape[0]
    B = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (n, RHS))
                         .astype(np.float32)).to(dev)
    minv = jacobi_preconditioner(extract_diagonal(spd["S"]) + SHIFT)
    X, rs = cg_solve_mrhs(
        lambda M: spmm_dia_mrhs(prep, M.T).T + SHIFT * M, B, iters=CG_ITERS,
        minv=minv)
    x0, _ = pcg_solve(lambda v: best_spmv(prep, v) + SHIFT * v, B[:, 0],
                      iters=CG_ITERS, minv=minv)
    sync(torch, dev)
    Xn, Bn = X.cpu().numpy(), B.cpu().numpy()
    require(Xn.shape == (n, RHS) and tuple(rs.shape) == (RHS,)
            and bool(np.all(np.isfinite(Xn))), "block CG output")
    # Per column, the same residual bound as phase 9; column 0 against
    # pcg_solve over K1 at 1e-4 of max|x|, as K4 against the composed solve.
    res = residual_inf(spd["S_host"], Xn, Bn)
    bound = 1e-4 * np.abs(Bn).max(axis=0)
    require(bool(np.all(res <= bound)),
            f"block CG residuals {res.tolist()} above {bound.tolist()}")
    ok, err = close(Xn[:, 0], x0.cpu().numpy(), 0.0, 1e-4)
    require(ok, f"block CG column 0 off pcg_solve over K1 ({err})")
    return {"B": B, "X": X, "minv": minv, "residual": float(res.max()),
            "err_column": err}


def solve_path(torch, sp, dev, n=N) -> dict:
    """Phases 7-10 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    spd = phase_spd(torch, sp, dev, n)
    log(f"phase 7 SPD operator: S stores {spd['stored']} slots in "
        f"{len(spd['S'].offsets)} diagonals "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    mrhs = phase_mrhs(torch, sp, dev, spd["band"])
    log(f"phase 8 K3 SpMM: max abs err {mrhs['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    cg = phase_cg(torch, dev, spd)
    cases = {what: {k: c[k] for k in ("err", "residual", "rs", "geometry")
                    if k in c} for what, c in cg["cases"].items()}
    log(f"phase 9 K4 CG ({CG_ITERS} iterations, shift {SHIFT}): max abs err "
        f"{cg['err']!r} vs plain, {cg['err_composed']!r} vs composed; "
        f"residual inf-norm {cg['residual']!r}; final rs {cg['rs']!r}; "
        f"(grid, CTAs an SM, rows a CTA, resident, smem, scratch) "
        f"{cg['geometry']}; cases {cases} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    blk = phase_block_cg(torch, dev, spd)
    log(f"phase 10 block CG over K3: max residual {blk['residual']!r}; "
        f"column 0 vs pcg_solve {blk['err_column']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    return {"spd": spd, "mrhs": mrhs, "cg": cg, "block": blk,
            "nnz": spd["stored"]}


def regrid_entries(m: int, seed: int = 0):
    """Bench config 3's matrix and dense block (``bench.py:_regrid_matrix``
    and ``config3_spmm``): row r holds SPMM_K entries at columns
    ``clip(2r + U{-SPREAD..SPREAD}, 0, 2m-1)`` with values uniform(-1, 1),
    then X uniform(-1, 1) of shape ``(2m, SPMM_N)``, all from one
    ``default_rng(seed)``. Returns ``(rows, cols, vals, X)``."""
    rng = np.random.default_rng(seed)
    rr = np.repeat(np.arange(m), SPMM_K)
    cc = np.clip(rr * 2 + rng.integers(-SPREAD, SPREAD + 1, rr.size), 0,
                 2 * m - 1)
    vals = rng.uniform(-1, 1, rr.size).astype(np.float32)
    X = rng.uniform(-1, 1, (2 * m, SPMM_N)).astype(np.float32)
    return rr, cc, vals, X


def build_coo(sp, dev, shape, rows, cols, vals):
    b = sp.CooBuilder(shape, dtype=np.float32)
    b.add_many(np.stack([rows, cols], axis=1), vals)
    return b.build(device=dev)


def sampled_rows_ref(rr, cc, vals, X, m, nrows=SAMPLED_ROWS, seed=7):
    """``(rows, float64 A[rows] @ X)`` on sampled rows, by scipy.sparse
    (rows of ``rr`` are sorted and of equal length)."""
    import scipy.sparse as ssp

    rows = np.sort(np.random.default_rng(seed).choice(
        m, min(nrows, m), replace=False))
    sel = (rows[:, None] * SPMM_K + np.arange(SPMM_K)).reshape(-1)
    part = ssp.csr_matrix(
        (vals[sel].astype(np.float64),
         (np.repeat(np.arange(rows.size), SPMM_K), cc[sel])),
        shape=(rows.size, X.shape[0]))
    return rows, part @ X.astype(np.float64)


def csr_host(rows, cols, vals, shape):
    import scipy.sparse as ssp

    return ssp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                          shape=shape)


def check_pair(got, ref, what: str, bf16: bool) -> float:
    """A kernel against its plain version: float32 rtol 1e-5 with atol
    1e-5 of max|ref| (the two sum in another order); bfloat16 blocks atol
    1e-4 of max|ref| (exact products, float32 sums of many terms)."""
    ok, err = close(got.cpu().numpy(), ref.cpu().numpy(),
                    0.0 if bf16 else 1e-5, 1e-4 if bf16 else 1e-5)
    require(ok, f"{what} off (max abs err {err})")
    return err


def check_sampled(Y, rows, ref, what: str, bf16: bool) -> float:
    """Against the float64 scipy rows: float32 rtol/atol 1e-5 of max|ref|;
    bfloat16 operands 2e-2 of max|ref| (bfloat16 rounds A and X)."""
    got = Y.cpu().numpy()[rows]
    ok, err = close(got, ref, 0.0 if bf16 else 1e-5, 2e-2 if bf16 else 1e-5)
    require(ok, f"{what} off the float64 scipy rows (max abs err {err})")
    return err


def phase_regrid(torch, sp, dev, m):
    """Phase 11: config 3's matrix through CooBuilder and to_tiled."""
    rr, cc, vals, X = regrid_entries(m)
    A = build_coo(sp, dev, (m, 2 * m), rr, cc, vals)
    tl = sp.to_tiled(A)
    sync(torch, dev)
    if m == SPMM_M:
        require(tl.n_tiles == 8190 and tl.tile_cap == 4096,
                f"config 3 tiles: n_tiles {tl.n_tiles}, tile_cap "
                f"{tl.tile_cap} (expected 8190 and 4096)")
    nnz = int((tl.vals != 0).sum())
    require(nnz == rr.size, f"tiled nnz {nnz} vs {rr.size} entries")
    return {"A": A, "tl": tl, "X": torch.from_numpy(X).to(dev),
            "entries": (rr, cc, vals), "X_host": X, "m": m,
            "fill": rr.size / tl.n_tiles}


def phase_window(torch, sp, dev, reg):
    """Phase 12: K5 in bfloat16 (group 32) and through prepare_general in
    float32 (route dense_window)."""
    from spsparse_torch.ops import (best_spmm, prepare_general,
                                    prepare_tiled_window, spmm_general,
                                    spmm_tiled_window,
                                    spmm_tiled_window_reference)

    X, m = reg["X"], reg["m"]
    rows, ref = sampled_rows_ref(*reg["entries"], reg["X_host"], m)
    prep_w = prepare_tiled_window(reg["tl"], group=WINDOW_GROUP)
    pg = prepare_general(reg["A"])
    require(pg.kernel == "dense_window",
            f"prepare_general routed config 3 to {pg.kernel}")
    Xp = X if pg.order is None else X[pg.order]
    out = {"prep_bf16": prep_w, "prep_f32": pg.prep, "pg": pg, "Xp": Xp,
           "err": {}, "sampled": rows, "sampled_ref": ref}
    Y_w = spmm_tiled_window(prep_w, X)
    Y_g = spmm_general(pg, X)
    Y_b = best_spmm(pg, X)
    sync(torch, dev)
    for Y in (Y_w, Y_g):
        require(tuple(Y.shape) == (m, SPMM_N) and bool(torch.isfinite(Y)
                                                       .all()),
                "K5 output is not a finite (m, 128) block")
    out["err"]["bf16"] = check_pair(
        Y_w, spmm_tiled_window_reference(prep_w, X), "K5 bf16 vs plain",
        True)
    out["err"]["f32"] = check_pair(
        Y_g, spmm_tiled_window_reference(pg.prep, Xp), "K5 f32 vs plain",
        False)
    require(torch.equal(Y_g, Y_b), "best_spmm and spmm_general differ")
    out["sampled_err"] = {
        "f32": check_sampled(Y_g, rows, ref, "K5 f32", False),
        "bf16": check_sampled(Y_w, rows, ref, "K5 bf16", True)}
    out["Y_bf16"], out["Y_f32"] = Y_w, Y_g
    return out


def phase_dense(torch, sp, dev, reg, win):
    """Phase 13: K6 on the window layout's blocks and on
    prepare_tiled_dense, float32 and bfloat16."""
    from spsparse_torch.ops import (prepare_tiled_dense, spmm_tiled_dense,
                                    spmm_tiled_dense_reference,
                                    to_tiled_dense)

    X = reg["X"]
    out = {"err": {}, "sampled_err": {}}
    rec = to_tiled_dense(win["prep_bf16"])
    Y = spmm_tiled_dense(rec, X)
    sync(torch, dev)
    check_pair(Y, spmm_tiled_dense_reference(rec, X), "K6 bf16 (window "
               "blocks) vs plain", True)
    check_pair(Y, win["Y_bf16"], "K6 bf16 vs K5 bf16", True)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_tiled_dense(reg["tl"], dtype=dtype)
        Y = spmm_tiled_dense(prep, X)
        sync(torch, dev)
        bf16 = name == "bf16"
        err = check_pair(Y, spmm_tiled_dense_reference(prep, X),
                         f"K6 {name} vs plain", bf16)
        out["err"][name] = max(err, check_pair(Y, win[f"Y_{name}"],
                                               f"K6 {name} vs K5", bf16))
        out["sampled_err"][name] = check_sampled(
            Y, win["sampled"], win["sampled_ref"], f"K6 {name}", bf16)
        out[name] = prep
        out[f"Y_{name}"] = Y
    return out


def onehot_entries(m: int, seed: int = 5):
    """A one-hot-tier matrix: 40-48 entries on the diagonal of each block
    row's diagonal tile (one tile a block row, so packing cannot lower the
    tile count), values uniform(-1, 1)."""
    rng = np.random.default_rng(seed)
    nbr = -(-m // 128)
    k = rng.integers(40, 49, nbr)
    r = np.concatenate([b * 128 + np.arange(kk) for b, kk in enumerate(k)])
    r = r[r < m]
    return r, r.copy(), rng.uniform(-1, 1, r.size).astype(np.float32)


def onehot_tiles_entries(m: int, tiles: int = 8, seed: int = 7):
    """A one-hot-tier matrix of several live tiles a block row: ``tiles``
    distinct random block columns a block row, 40-48 entries at random
    (row, column) offsets in each (duplicates summed), values
    uniform(-1, 1); rt * cap > 256 slots a block row, so that K7 takes a
    block row in several pieces."""
    rng = np.random.default_rng(seed)
    nbr = -(-m // 128)
    nbc = nbr
    bc = np.argsort(rng.random((nbr, nbc)), axis=1)[:, :tiles]
    k = rng.integers(40, 49, (nbr, tiles))
    tile_of = np.repeat(np.arange(nbr * tiles), k.ravel())
    br, tc = tile_of // tiles, bc.ravel()[tile_of]
    r = br * 128 + rng.integers(0, 128, tile_of.size)
    c = tc * 128 + rng.integers(0, 128, tile_of.size)
    keep = (r < m) & (c < m)
    r, c = r[keep], c[keep]
    return r, c, rng.uniform(-1, 1, r.size).astype(np.float32)


def cfg3b_entries(m: int, seed: int = 0):
    """Bench config 3b (``bench.py:config3b_packed_general``): 8 uniform
    random columns a row of 8m, values uniform(-1, 1), then X of 128
    columns, from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    ncols = 8 * m
    rr = np.repeat(np.arange(m), 8)
    cc = rng.integers(0, ncols, rr.size)
    vals = rng.uniform(-1, 1, rr.size).astype(np.float32)
    X = rng.uniform(-1, 1, (ncols, SPMM_N)).astype(np.float32)
    return rr, cc, vals, X


def unsorted_tiles(torch, prep, seed: int = 9):
    """``prep`` (a ``PreparedTiledRows``) with each tile's slots (row,
    column and value together) in a random order: the same product, with
    no tile's entries in row order."""
    import dataclasses

    dev = prep.vals.device
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.rand(tuple(prep.vals.shape), generator=g,
                      device=dev).argsort(dim=-1)
    return dataclasses.replace(prep, rows=prep.rows.gather(2, perm),
                               cols=prep.cols.gather(2, perm),
                               vals=prep.vals.gather(2, perm))


def phase_onehot(torch, sp, dev, reg, dense, m_onehot, m_3b):
    """Phase 14: K7 on config 3's tiles, as built (each tile's entries in
    row order) and with each tile's slots shuffled; the one_hot and
    gather_ell routes of prepare_general."""
    from spsparse_torch.ops import (prepare_general, prepare_tiled_rows,
                                    spmm_general, spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    X = reg["X"]
    prep = prepare_tiled_rows(reg["tl"])
    Y = spmm_tiled_onehot(prep, X)
    sync(torch, dev)
    err = check_pair(Y, spmm_tiled_onehot_reference(prep, X),
                     "K7 vs plain", False)
    err = max(err, check_pair(Y, dense["Y_f32"], "K7 vs K6 f32", False))
    # The card's K7 against a second call, bit for bit (on the CPU both
    # sides would be the plain version).
    on_card = dev != "cpu"
    bitwise = {}
    if on_card:
        bitwise["config 3"] = bitwise_equal(torch, Y,
                                            spmm_tiled_onehot(prep, X))
        require(bitwise["config 3"], "K7 at config 3 differs from a second "
                "call, bit for bit")
    unsorted = unsorted_tiles(torch, prep)
    Yu = spmm_tiled_onehot(unsorted, X)
    sync(torch, dev)
    err = max(err, check_pair(Yu, Y, "K7 on unsorted tiles vs sorted",
                              False))
    if on_card:
        bitwise["config 3, rows unsorted"] = bitwise_equal(
            torch, Yu, spmm_tiled_onehot(unsorted, X))
        require(bitwise["config 3, rows unsorted"], "K7 on config 3's "
                "unsorted tiles differs from a second call, bit for bit")

    route = {}
    for what, entries in (("one_hot route", onehot_entries(m_onehot)),
                          ("one_hot route, 8 tiles a block row",
                           onehot_tiles_entries(m_onehot))):
        route[what] = onehot_route(torch, sp, dev, m_onehot, entries, what)
        if on_card:
            bitwise[what] = route[what]["bitwise"]
    require(route["one_hot route, 8 tiles a block row"]["slots"] > 256,
            "the several-tile one_hot layout fits one 256-slot piece")

    rr, cc, vals, X3 = cfg3b_entries(m_3b)
    pg3 = prepare_general(build_coo(sp, dev, (m_3b, 8 * m_3b), rr, cc,
                                    vals))
    require(pg3.kernel == "gather_ell",
            f"config 3b routed to {pg3.kernel}")
    Y3 = spmm_general(pg3, torch.from_numpy(X3).to(dev))
    sync(torch, dev)
    ok, err_3b = close(Y3.cpu().numpy(), csr_host(
        rr, cc, vals, (m_3b, 8 * m_3b)) @ X3, 1e-5, 1e-5)
    require(ok, f"gather_ell route off scipy (max abs err {err_3b})")
    return {"prep": prep, "unsorted": unsorted, "err": err,
            "err_gather_ell": err_3b,
            "bitwise_repeat": bitwise, "ell_kmax": pg3.prep.cols.shape[1],
            "route": route}


def onehot_route(torch, sp, dev, m, entries, what):
    """``prepare_general`` of a one-hot-tier matrix (it must route to K7)
    and its product: against the plain version and scipy, and on the card
    against a second call, bit for bit."""
    from spsparse_torch.ops import (prepare_general, spmm_general,
                                    spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference)

    r, c, v = entries
    pg = prepare_general(build_coo(sp, dev, (m, m), r, c, v))
    require(pg.kernel == "one_hot", f"the {what} matrix routed to {pg.kernel}")
    Xo = np.random.default_rng(6).uniform(-1, 1, (m, SPMM_N)).astype(
        np.float32)
    Xo_dev = torch.from_numpy(Xo).to(dev)
    Xo_p = Xo_dev if pg.order is None else Xo_dev[pg.order]
    Yo = spmm_general(pg, Xo_dev)
    sync(torch, dev)
    err_k = check_pair(Yo, spmm_tiled_onehot_reference(pg.prep, Xo_p),
                       f"K7 ({what}) vs plain", False)
    bitwise = None
    if dev != "cpu":
        Yk = spmm_tiled_onehot(pg.prep, Xo_p)
        bitwise = bitwise_equal(torch, Yk, spmm_tiled_onehot(pg.prep, Xo_p))
        require(bitwise, f"K7 on the {what} differs from a second call, bit "
                "for bit")
    ok, err_o = close(Yo.cpu().numpy(), csr_host(r, c, v, (m, m)) @ Xo,
                      1e-5, 1e-5)
    require(ok, f"{what} off scipy (max abs err {err_o})")
    return {"prep": pg.prep, "X": Xo_dev, "Xp": Xo_p, "entries": (r, c, v),
            "m": m, "err": err_k, "err_scipy": err_o, "bitwise": bitwise,
            "block_rows": pg.prep.nbr,
            "slots": pg.prep.tiles_per_row * pg.prep.tile_cap}


def phase_grad(torch, sp, dev, m):
    """Phase 15: one backward through spmm_general on the dense-window
    layout (K5 forward), against the plain forward and backward on the
    CPU; gradients rtol 1e-4 (atol 1e-4 of max|grad|)."""
    import dataclasses

    from spsparse_torch.ops import prepare_general, spmm_general

    rr, cc, vals, X = regrid_entries(m)
    W = np.random.default_rng(8).uniform(-1, 1, (m, SPMM_N)).astype(
        np.float32)
    grads = {}
    for d in (dev, "cpu"):
        pg = prepare_general(build_coo(sp, d, (m, 2 * m), rr, cc, vals))
        require(pg.kernel == "dense_window", f"grad route {pg.kernel}")
        blocks = pg.prep.blocks.clone().requires_grad_(True)
        pg = dataclasses.replace(pg, prep=dataclasses.replace(
            pg.prep, blocks=blocks))
        Xt = torch.from_numpy(X).to(d).requires_grad_(True)
        (torch.from_numpy(W).to(d) * spmm_general(pg, Xt)).sum().backward()
        grads[str(d)] = (blocks.grad.cpu().numpy(), Xt.grad.cpu().numpy())
    sync(torch, dev)
    err = 0.0
    for got, ref in zip(grads[str(dev)], grads["cpu"]):
        ok, e = close(got, ref, 1e-4, 1e-4)
        require(ok, f"spmm_general gradient off the plain backward ({e})")
        err = max(err, e)
    return err


def spmm_path(torch, sp, dev, m=SPMM_M, m_onehot=SPMM_M, m_3b=CFG3B_M,
              m_grad=GRAD_M) -> dict:
    """Phases 11-15 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    reg = phase_regrid(torch, sp, dev, m)
    log(f"phase 11 config 3 tiles: n_tiles {reg['tl'].n_tiles}, tile_cap "
        f"{reg['tl'].tile_cap}, fill {reg['fill']!r} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    win = phase_window(torch, sp, dev, reg)
    log(f"phase 12 K5: route {win['pg'].kernel}, ws "
        f"{win['prep_bf16'].ws} (group {WINDOW_GROUP}, bf16) / "
        f"{win['prep_f32'].ws} (group {win['prep_f32'].group}, f32); max "
        f"abs err vs plain {win['err']}, vs float64 rows "
        f"{win['sampled_err']} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    dense = phase_dense(torch, sp, dev, reg, win)
    log(f"phase 13 K6: max abs err {dense['err']} vs plain and K5, "
        f"{dense['sampled_err']} vs float64 rows "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    onehot = phase_onehot(torch, sp, dev, reg, dense, m_onehot, m_3b)
    routes = {what: {k: rt[k] for k in ("block_rows", "slots", "err_scipy")}
              for what, rt in onehot["route"].items()}
    log(f"phase 14 K7: max abs err {onehot['err']!r}; bit for bit with a "
        f"second call {onehot['bitwise_repeat']}; one_hot "
        f"routes (block rows, slots a block row, err vs scipy) {routes}; "
        f"gather_ell route (Kmax {onehot['ell_kmax']}) err "
        f"{onehot['err_gather_ell']!r} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    grad_err = phase_grad(torch, sp, dev, m_grad)
    log(f"phase 15 spmm_general backward at m = {m_grad}: max abs err "
        f"{grad_err!r} ({time.perf_counter() - t0:.3f} s)")
    return {"reg": reg, "win": win, "dense": dense, "onehot": onehot}


def cfg4_entries(n: int, seed: int = 0):
    """Bench config 4's matrix (``bench.py:config4_spgemm``): row r holds
    ``min(zipf(2.0), 24)`` entries at columns ``min(2r + U{0,1,2}, 2n-1)``
    with values uniform(0, 1), all from one ``default_rng(seed)``. Returns
    ``(rows, cols, vals)``; the builder stores the values as float32."""
    rng = np.random.default_rng(seed)
    k = np.minimum(rng.zipf(2.0, n), 24).astype(np.int64)
    r = np.repeat(np.arange(n), k)
    c = np.minimum(r * 2 + rng.integers(0, 3, r.size), n * 2 - 1)
    return r, c, rng.uniform(0, 1, r.size)


def traced_routes(fn):
    """``(fn(), [(entry point, route), ...])``: the routes that the SpGEMM
    entry points record in the host event log while ``fn`` runs, in the
    order they finish."""
    from spsparse_torch.utils.trace import enable_event_log, get_event_log

    enable_event_log(True)
    try:
        out = fn()
        events = get_event_log()
    finally:
        enable_event_log(False)
    return out, [(e["op"].split(".")[-1], e["route"]) for e in events
                 if "route" in e]


def check_coo(got, ref, what: str, rtol: float, atol_rel: float) -> float:
    """A sparse result against a float64 scipy product: the same pattern
    and values within ``rtol*|ref| + atol_rel*max|ref|``."""
    g = _csr_of(got)
    g.sort_indices()
    ref = ref.tocsr()
    ref.sort_indices()
    require(g.nnz == ref.nnz and np.array_equal(g.indptr, ref.indptr)
            and np.array_equal(g.indices, ref.indices),
            f"{what}: pattern differs from scipy (nnz {g.nnz} vs {ref.nnz})")
    ok, err = close(g.data, ref.data, rtol, atol_rel)
    require(ok, f"{what} off the float64 scipy product (max abs err {err})")
    return err


def phase_cfg4(torch, sp, dev, n):
    """Phase 16: config 4's A through CooBuilder, consolidate, to_tiled."""
    from spsparse_torch.ops import plan_spgemm_caps

    r, c, v = cfg4_entries(n)
    b = sp.CooBuilder((n, 2 * n), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), v)
    raw = b.build(device=dev)
    A = sp.consolidate(raw)
    tl = sp.to_tiled(A)
    caps = plan_spgemm_caps(raw, raw, transpose_b=True)
    sync(torch, dev)
    if n == CFG4_N:
        require((A.nnz, tl.n_tiles, caps[0]) == (193565, 2540, 262144),
                f"config 4: nnz {A.nnz}, tiles {tl.n_tiles}, products "
                f"{caps[0]} (expected 193565, 2540, 262144)")
    A64 = _csr_of(A)
    return {"A": A, "tl": tl, "caps": caps, "n": n, "raw_entries": r.size,
            "AAT": (A64 @ A64.T).tocsr(),
            "fill": int((tl.vals != 0).sum()) / tl.n_tiles}


def phase_band(torch, sp, dev, cfg):
    """Phase 17: K8 through best_spgemm (f32) and spgemm_tiled (bf16)
    against scipy; the planned band against its plain version, dead slots
    exactly zero."""
    from spsparse_torch.ops import (best_spgemm, plan_window_spgemm,
                                    prepare_tiled_dense, spgemm_tiled,
                                    spgemm_window, spgemm_window_reference)

    A, n = cfg["A"], cfg["n"]
    C, routes = traced_routes(lambda: best_spgemm(A, A, transpose_b=True))
    sync(torch, dev)
    require(routes == [("spgemm_tiled", "window"), ("best_spgemm", "tiled")],
            f"best_spgemm(A, A^T) routes {routes}")
    err = {"f32": check_coo(C, cfg["AAT"], "best_spgemm(A, A^T)", 1e-5,
                            1e-5)}
    Cb = spgemm_tiled(A, A, transpose_b=True, dtype=torch.bfloat16)
    sync(torch, dev)
    # bfloat16 rounds A's values; the check allows 2e-2 of max|ref|.
    err["bf16"] = check_coo(Cb, cfg["AAT"], "spgemm_tiled bf16 A A^T", 0.0,
                            2e-2)
    out = {"C": C, "err": err, "band": {}, "plan": {}, "prep": {}}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_tiled_dense(cfg["tl"], dtype=dtype)
        plan = plan_window_spgemm(prep.tcols, prep.tcols, nbc=prep.nbc,
                                  out_shape=(n, n), dtype=dtype)
        band = spgemm_window(plan, prep.blocks)
        ref = spgemm_window_reference(plan, prep.blocks)
        sync(torch, dev)
        err[f"band_{name}"] = check_pair(band, ref, f"K8 {name} vs plain",
                                         name == "bf16")
        dead = torch.from_numpy(plan.cnt == 0).to(band.device)
        require(not bool(band.reshape(-1, TILE_ELEMS)[dead].any()),
                f"K8 {name}: a band slot with no pair is not exactly zero")
        require(torch.equal(spgemm_window(plan, prep.blocks), band),
                f"K8 {name}: two calls differ")
        out["band"][name], out["plan"][name] = band, plan
        out["prep"][name] = prep
    return out


def phase_pairs(torch, sp, dev, cfg, k8):
    """Phase 18: K9 through spgemm_tiled (config 4's pair plan),
    best_spgemm(C, C) and coo_matrix_power(C, 3) against scipy; K9 and K13
    on both pair plans, in both types, against the plain version and each
    other (float32 K13 equal to K9 bit for bit)."""
    from spsparse_torch.ops import (best_spgemm, coo_matrix_power,
                                    densify_tiled, plan_tiled_spgemm,
                                    spgemm_tiled, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream)
    from spsparse_torch.ops.spgemm_tiled import tiled_blocks_to_coo

    A, C = cfg["A"], k8["C"]
    P, routes = traced_routes(lambda: spgemm_tiled(
        A, A, transpose_b=True, use_window=False))
    sync(torch, dev)
    require(routes == [("spgemm_tiled", "pairs")],
            f"spgemm_tiled(use_window=False) routes {routes}")
    err = {"aat": check_coo(P, cfg["AAT"], "spgemm_tiled pairs A A^T", 1e-5,
                            1e-5)}
    C64 = _csr_of(C)
    CC_ref = (C64 @ C64).tocsr()
    CC, cc_routes = traced_routes(lambda: best_spgemm(C, C))
    sync(torch, dev)
    require(cc_routes == [("spgemm_tiled", "pairs"), ("best_spgemm",
                                                      "tiled")],
            f"best_spgemm(C, C) routes {cc_routes}")
    err["cc"] = check_coo(CC, CC_ref, "best_spgemm(C, C)", 1e-5, 1e-5)
    C3, power_routes = traced_routes(lambda: coo_matrix_power(C, 3))
    sync(torch, dev)
    err["c3"] = check_coo(C3, C64 @ CC_ref, "coo_matrix_power(C, 3)", 1e-5,
                          1e-5)

    tc = {"f32": densify_tiled(sp.to_tiled(C)),
          "bf16": densify_tiled(sp.to_tiled(C), dtype=torch.bfloat16)}
    ta = {"f32": densify_tiled(cfg["tl"]),
          "bf16": densify_tiled(cfg["tl"], dtype=torch.bfloat16)}
    plans = {"A A^T": plan_tiled_spgemm(ta["f32"], ta["f32"],
                                        transpose_b=True),
             "C C": plan_tiled_spgemm(tc["f32"], tc["f32"])}
    runs = [("A A^T", "f32", ta["f32"], cfg["AAT"]),
            ("A A^T", "bf16", ta["bf16"], None),
            ("C C", "f32", tc["f32"], CC_ref),
            ("C C", "bf16", tc["bf16"], None)]
    out = {"err": err, "routes": {"A A^T": routes, "C C": cc_routes,
                                  "C^3": power_routes},
           "plans": plans, "blocks": {}, "bitwise_k9_k13": {}}
    for label, dname, X, oracle in runs:
        plan = plans[label]
        bf16 = dname == "bf16"
        k9 = spgemm_tiled_pairs(X, X, plan)
        k13 = spgemm_tiled_stream(X, X, plan)
        ref = spgemm_tiled_reference(X, X, plan)
        sync(torch, dev)
        what = f"{label} {dname}"
        e = max(check_pair(k9.blocks, ref.blocks, f"K9 {what} vs plain",
                           bf16),
                check_pair(k13.blocks, ref.blocks, f"K13 {what} vs plain",
                           bf16),
                check_pair(k13.blocks, k9.blocks, f"K13 {what} vs K9", bf16))
        if oracle is not None:
            e = max(e, check_coo(tiled_blocks_to_coo(k13), oracle,
                                 f"K13 {what}", 1e-5, 1e-5))
        err[f"{label} {dname}"] = e
        out["bitwise_k9_k13"][what] = bool(torch.equal(k9.blocks,
                                                       k13.blocks))
        # float32 K13 sums each element in K9's order: equal bit for bit.
        require(bf16 or out["bitwise_k9_k13"][what],
                f"K13 {what} differs from K9 in some bit")
        require(torch.equal(spgemm_tiled_stream(X, X, plan).blocks,
                            k13.blocks), f"K13 {what}: two calls differ")
        require(torch.equal(spgemm_tiled_pairs(X, X, plan).blocks,
                            k9.blocks), f"K9 {what}: two calls differ")
        out["blocks"][(label, dname)] = X
    return out


def phase_esc(torch, sp, dev, cfg):
    """Phase 19: the ESC Gram product and the planned ESC (device and host
    plans) against scipy."""
    from spsparse_torch.ops import plan_esc, spgemm_aat, spgemm_planned

    A = cfg["A"]
    E = spgemm_aat(A)
    sync(torch, dev)
    err = {"spgemm_aat": check_coo(E, cfg["AAT"], "spgemm_aat", 1e-5, 1e-5)}
    plans = {}
    for host in (False, True):
        plan, acon, bcon = plan_esc(A, A, transpose_b=True, host=host)
        Q = spgemm_planned(plan, acon.vals, bcon.vals)
        sync(torch, dev)
        key = "host" if host else "device"
        err[key] = check_coo(Q, cfg["AAT"], f"spgemm_planned ({key} plan)",
                             1e-5, 1e-5)
        plans[key] = (plan, acon, bcon)
    return {"err": err, "plans": plans}


def phase_handoff(torch, sp, dev, cfg, k8):
    """Phase 20: C's band as TiledBlocks -> to_prepared_dense -> K6."""
    from spsparse_torch.ops import spmm_tiled_dense
    from spsparse_torch.ops.spgemm_window import band_to_tiled_blocks

    n = cfg["n"]
    prep = band_to_tiled_blocks(k8["band"]["f32"],
                                k8["plan"]["f32"]).to_prepared_dense()
    X = np.random.default_rng(9).uniform(-1, 1, (n, SPGEMM_X)).astype(
        np.float32)
    Y = spmm_tiled_dense(prep, torch.from_numpy(X).to(dev))
    sync(torch, dev)
    ok, err = close(Y.cpu().numpy(), cfg["AAT"] @ X.astype(np.float64),
                    1e-5, 1e-5)
    require(ok, f"C = A A^T blocks through K6 off scipy (max abs err {err})")
    return {"err": err, "tiles": int((prep.tcols < prep.nbc).sum())}


def spgemm_path(torch, sp, dev, n=CFG4_N) -> dict:
    """Phases 16-20 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    cfg = phase_cfg4(torch, sp, dev, n)
    log(f"phase 16 config 4: {cfg['raw_entries']} entries -> nnz "
        f"{cfg['A'].nnz} in {cfg['tl'].n_tiles} tiles (fill "
        f"{cfg['fill']!r}); plan_spgemm_caps {cfg['caps']}; A A^T nnz "
        f"{cfg['AAT'].nnz} ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    k8 = phase_band(torch, sp, dev, cfg)
    plan = k8["plan"]["f32"]
    log(f"phase 17 K8: W {plan.W}, live pairs {plan.n_live}, n_dots "
        f"{plan.n_dots}, band {plan.nbr_pad} x {plan.nband}; max abs err "
        f"{k8['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    pairs = phase_pairs(torch, sp, dev, cfg, k8)
    pt = pairs["plans"]
    log(f"phase 18 K9/K13: pair plans A A^T {pt['A A^T'].n_pairs} pairs -> "
        f"{pt['A A^T'].n_out_tiles} tiles, C C {pt['C C'].n_pairs} pairs -> "
        f"{pt['C C'].n_out_tiles} tiles; routes {pairs['routes']}; K13 == "
        f"K9 bitwise {pairs['bitwise_k9_k13']}; max abs err {pairs['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    esc = phase_esc(torch, sp, dev, cfg)
    log(f"phase 19 ESC: max abs err {esc['err']} "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    hand = phase_handoff(torch, sp, dev, cfg, k8)
    log(f"phase 20 hand-off to K6: {hand['tiles']} tiles, max abs err "
        f"{hand['err']!r} ({time.perf_counter() - t0:.3f} s)")
    return {"cfg": cfg, "k8": k8, "pairs": pairs, "esc": esc}


def cfg2c_entries(n: int, k: int = CFG2C_K, seed: int = 0):
    """Bench config 2c (``bench.py:config2c_unstructured``): row r holds
    ``k`` entries at uniform-random columns of n, values uniform(-1, 1)
    float32, then x uniform(-1, 1), all from one ``default_rng(seed)``.
    Returns ``(rows, cols, vals, x)``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, rows.size)
    vals = rng.uniform(-1, 1, rows.size).astype(np.float32)
    return rows, cols, vals, rng.uniform(-1, 1, n).astype(np.float32)


def heavy_entries(n: int, seed: int = 10):
    """A heavy-row matrix of n x n: 10 uniform-random columns a row, plus
    4096 distinct columns in row 0 and 90 in each of 100 other rows, so
    that ``ell_k = 16`` splits rows (``extra_rows`` non-empty)."""
    rng = np.random.default_rng(seed)
    r = [np.repeat(np.arange(n), CFG2C_K), np.zeros(4096, np.int64)]
    c = [rng.integers(0, n, n * CFG2C_K), rng.permutation(n)[:4096]]
    for row in rng.choice(np.arange(1, n), 100, replace=False):
        r.append(np.full(90, row))
        c.append(rng.permutation(n)[:90])
    r, c = np.concatenate(r), np.concatenate(c)
    return (r, c, rng.uniform(-1, 1, r.size).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32))


def dirty_cache(torch, dev, nbytes: int) -> None:
    """Leave NaN in the caching allocator's free blocks, so that an output
    slot a kernel fails to write shows (a no-op off the card)."""
    if torch.device(dev).type == "cuda":
        junk = torch.full((nbytes // 4 + 1,), float("nan"), device=dev)
        del junk


def check_shuffle(torch, dev, prep, x, host, what: str) -> dict:
    """K11's slot grid against its plain version bit for bit (on an
    allocation left full of NaN), ``best_spmv`` against the plain
    ``spmv_shuffle`` (rtol 1e-5, atol 1e-5 of max|ref|: the same slot
    sums) and against the float64 scipy product (1e-5 of max|y|)."""
    from spsparse_torch.ops import (best_spmv, shuffle_gather,
                                    shuffle_gather_reference,
                                    spmv_shuffle_reference)

    y = best_spmv(prep, x)
    dirty_cache(torch, dev, prep.n_slots * 4)
    slots = shuffle_gather(prep, x)
    ref_slots = shuffle_gather_reference(prep, x)
    sync(torch, dev)
    require(not bool(torch.isnan(slots).any()),
            f"K11 {what}: a slot was left unwritten (NaN)")
    require(torch.equal(slots, ref_slots),
            f"K11 {what}: the slot grid differs from the plain sort pipeline")
    ok, err_plain = close(y.cpu().numpy(),
                          spmv_shuffle_reference(prep, x).cpu().numpy(),
                          1e-5, 1e-5)
    require(ok, f"spmv_shuffle {what} off its plain version ({err_plain})")
    y_ref = host @ x.cpu().numpy().astype(np.float64)
    ok, err = close(y.cpu().numpy(), y_ref, 0.0, 1e-5)
    require(ok and tuple(y.shape) == (prep.shape[0],),
            f"spmv_shuffle {what} off the float64 scipy product ({err})")
    return {"y": y, "err_plain": err_plain, "err": err}


def phase_2c(torch, sp, dev, n):
    """Phase 21: config 2c through CooBuilder and prepare_shuffle_spmv."""
    from spsparse_torch.ops import prepare_shuffle_spmv

    rows, cols, vals, x = cfg2c_entries(n)
    A = build_coo(sp, dev, (n, n), rows, cols, vals)
    sync(torch, dev)
    t0 = time.perf_counter()
    prep = prepare_shuffle_spmv(A)
    sync(torch, dev)
    prep_s = time.perf_counter() - t0
    return {"A": A, "prep": prep, "x": torch.from_numpy(x).to(dev),
            "host": csr_host(rows, cols, vals, (n, n)), "n": n,
            "nnz": rows.size, "prepare_s": prep_s,
            "fill": rows.size / (prep.n_batches * 1024)}


def phase_shuffle(torch, sp, dev, c2, heavy_n):
    """Phase 22: K11 through best_spmv at config 2c and on the heavy-row
    matrix (ell_k 16, split rows)."""
    from spsparse_torch.ops import prepare_shuffle_spmv

    out = {"2c": check_shuffle(torch, dev, c2["prep"], c2["x"], c2["host"],
                               "config 2c")}
    r, c, v, xh = heavy_entries(heavy_n)
    prep = prepare_shuffle_spmv(build_coo(sp, dev, (heavy_n, heavy_n), r, c,
                                          v), ell_k=16)
    require(prep.extra_rows.shape[0] > 0, "the heavy-row matrix split no row")
    out["heavy"] = check_shuffle(torch, dev, prep, torch.from_numpy(xh).to(
        dev), csr_host(r, c, v, (heavy_n, heavy_n)), "heavy rows")
    out["heavy_extra"] = int(prep.extra_rows.shape[0])
    return out


def phase_segsum(torch, sp, dev, c2):
    """Phase 23: K10 on config 2c's CSR products against its plain version
    (rtol 1e-5, atol 1e-5 of max|ref|: another sum order),
    ``spmv_csr_segsum`` against scipy float64 (1e-5 of max|y|), and K10
    on a skewed row pointer (empty rows, one row of 4096)."""
    from spsparse_torch.ops import (csr_products, segmented_row_sums,
                                    segmented_row_sums_reference,
                                    spmv_csr_segsum)

    n, x = c2["n"], c2["x"]
    csr = sp.to_csr(c2["A"])
    prod = csr_products(csr, x)
    y10 = segmented_row_sums(prod, csr.row_ptr, nrows=n, rows_per_block=256,
                             entries_per_block=1024)
    ref10 = segmented_row_sums_reference(prod, csr.row_ptr, n)
    ys = spmv_csr_segsum(csr, x)
    sync(torch, dev)
    err = {"k10": check_pair(y10, ref10, "K10 vs plain", False)}
    ok, err["csr_spmv"] = close(ys.cpu().numpy(), c2["host"] @ x.cpu().numpy()
                                .astype(np.float64), 0.0, 1e-5)
    require(ok, f"spmv_csr_segsum off scipy (max abs err {err['csr_spmv']})")

    rng = np.random.default_rng(11)
    ns = min(1 << 16, n)
    counts = rng.integers(0, 4, ns) * (np.arange(ns) % 5 != 0)
    counts[ns // 3] = 4096
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ph = rng.uniform(-1, 1, int(rp[-1])).astype(np.float32)
    ys = segmented_row_sums(torch.from_numpy(ph).to(dev),
                            torch.from_numpy(rp).to(dev), nrows=ns,
                            rows_per_block=8, entries_per_block=128)
    sync(torch, dev)
    want = np.add.reduceat(np.append(ph.astype(np.float64), 0.0), rp[:-1])
    want[counts == 0] = 0.0
    ok, err["skewed"] = close(ys.cpu().numpy(), want, 1e-5, 1e-5)
    require(ok, f"K10 on the skewed row pointer ({err['skewed']})")
    err["shapes"], geometry = k10_shapes(torch, dev)
    return {"csr": csr, "prod": prod, "err": err, "geometry": geometry}


def k10_shapes(torch, dev):
    """Phase 23's further K10 shapes: 70% empty rows, a row of 20,000
    entries across several CTAs, rp[0] = 4099 (the head not 16-byte
    aligned), nnz = 0, nrows = 0; entries outside [rp[0], rp[nrows]) NaN,
    so that reading one shows. Each against float64 row sums (rtol 1e-5,
    atol 1e-5 of max|ref|), the same bits from a second call, and on the
    card the launch the library reports equal to the host replay's.
    Returns ``({shape: max abs err}, {shape: geometry})``; the launches are
    not counted as the path's."""
    from spsparse_torch.ops import segmented_row_sums

    rng = np.random.default_rng(12)
    cases = {
        "empty rows": (rng.integers(0, 3, 20000)
                       * (rng.random(20000) < 0.3), 0),
        "a row of 20000": (np.where(np.arange(3000) == 1000, 20000,
                                    rng.integers(0, 12, 3000)), 0),
        "rp[0] = 4099": (rng.integers(0, 30, 5000), 4099),
        "nnz = 0": (np.zeros(777, np.int64), 0),
        "nrows = 0": (np.zeros(0, np.int64), 0),
    }
    before = segmented_row_sums.launches
    errs, geos = {}, {}
    for what, (counts, head) in cases.items():
        rp = head + np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        ph = np.full(int(rp[-1]) + 5, np.nan, np.float32)
        ph[head:rp[-1]] = rng.uniform(-1, 1, int(rp[-1]) - head)
        prod = torch.from_numpy(ph).to(dev)
        rpt = torch.from_numpy(rp.astype(np.int32)).to(dev)
        kw = dict(nrows=counts.size, rows_per_block=8, entries_per_block=128)
        y = segmented_row_sums(prod, rpt, **kw)
        y2 = segmented_row_sums(prod, rpt, **kw)
        sync(torch, dev)
        want = np.zeros(counts.size)
        if counts.size:
            np.add.at(want, np.repeat(np.arange(counts.size), counts),
                      ph[head:rp[-1]].astype(np.float64))
        ok, errs[what] = close(y.cpu().numpy(), want, 1e-5, 1e-5)
        require(ok and y.shape == (counts.size,),
                f"K10 {what} off the float64 sums ({errs[what]})")
        require(bitwise_equal(torch, y, y2),
                f"K10 {what}: a second call gave other bits")
        if torch.device(dev).type == "cuda":
            lib, replay = k10_geometry(prod, counts.size)
            require(lib == replay, f"K10 {what}: the library's launch {lib} "
                    f"is not segsum_geometry's {replay}")
            geos[what] = lib
    segmented_row_sums.launches = before
    return errs, geos


def same_up_to_ties(torch, got, ref, num_keys: int, what: str) -> None:
    """Keys exactly equal; payloads equal as a multiset within each run of
    equal keys (a bitonic network is not stable): both sides canonicalised
    by a stable sort over keys and payload bits."""
    from spsparse_torch.ops import sort_blocks_reference

    for g, r in zip(got[:num_keys], ref[:num_keys]):
        require(torch.equal(g, r), f"K12 {what}: keys differ")

    def canon(arrs):
        bits = tuple(a.view(torch.int32) for a in arrs)
        return sort_blocks_reference(bits, num_keys=len(bits))

    require(all(torch.equal(a, b) for a, b in zip(canon(got), canon(ref))),
            f"K12 {what}: payloads differ within runs of equal keys")


def float_keys(rng, shape):
    """float32 keys with ties, both zeros, infinities and subnormals."""
    pool = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.5, -1.5],
                    np.float32)
    k = rng.uniform(-4, 4, shape).astype(np.float32).round(1)
    pick = rng.random(shape) < 0.1
    k[pick] = pool[rng.integers(0, pool.size, int(pick.sum()))]
    return k


def phase_sort(torch, dev, nblk):
    """Phase 24: K12 on (nblk, 64, 128) int32 keys with a float32 payload,
    two keys, sort_blocks_stable packed and not (exact), R = 1,
    (8, 256, 128) with three arrays (past the shared-memory chunk), float32
    keys and ten arrays."""
    from spsparse_torch.ops import (sort_blocks, sort_blocks_reference,
                                    sort_blocks_stable)
    from spsparse_torch.ops.block_sort import MAX_ARRAYS, block_sort_geometry

    rng = np.random.default_rng(12)

    def t(a):
        return torch.from_numpy(a).to(dev)

    def ints(hi, shape):
        return t(rng.integers(0, hi, shape).astype(np.int32))

    def floats(shape):
        return t(rng.uniform(-1, 1, shape).astype(np.float32))

    main = (ints(1 << 30, (nblk, 64, 128)), floats((nblk, 64, 128)))
    nb8 = max(nblk // 8, 1)
    cases = [("(nblk, 64, 128) key + payload", main, 1),
             ("two keys", (ints(8, (nblk // 4, 32, 128)),
                           ints(1 << 20, (nblk // 4, 32, 128)),
                           floats((nblk // 4, 32, 128))), 2),
             ("R = 1", (ints(1 << 12, (nblk, 1, 128)),
                        floats((nblk, 1, 128))), 1),
             ("(8, 256, 128) three arrays", (ints(64, (8, 256, 128)),
                                             ints(1 << 30, (8, 256, 128)),
                                             floats((8, 256, 128))), 2),
             ("float32 keys", (t(float_keys(rng, (nblk // 4, 64, 128))),
                               floats((nblk // 4, 64, 128))), 1),
             ("ten arrays", (ints(16, (nb8, 16, 128)),
                             t(float_keys(rng, (nb8, 16, 128))))
              + tuple(floats((nb8, 16, 128)) for _ in range(8)), 2)]
    bitwise, geometry = {}, {}
    for what, arrays, nk in cases:
        dirty_cache(torch, dev, sum(a.numel() for a in arrays) * 4)
        got = sort_blocks(arrays, num_keys=nk)
        ref = sort_blocks_reference(arrays, num_keys=nk)
        sync(torch, dev)
        same_up_to_ties(torch, got, ref, nk, what)
        if dev != "cpu":
            bitwise[what] = bitwise_equal(
                torch, got, sort_blocks(arrays, num_keys=nk))
            require(bitwise[what], f"K12 {what}: differs from a second call "
                    "bit for bit (keys or payloads)")
            # The arrays K12 sorts: these, or the keys and a position.
            na = (len(arrays) if len(arrays) <= MAX_ARRAYS and all(
                a.dtype == torch.int32 for a in arrays[:nk]) else nk + 1)
            n = arrays[0][0].numel()
            geometry[what] = k12_geometry(n, na, nk)
            require(geometry[what] == block_sort_geometry(n, na, nk),
                    f"K12 {what}: the kernel's chunk {geometry[what]} is not "
                    "block_sort_geometry's")
    kk, pay = ints(8, (nblk // 4, 8, 128)), floats((nblk // 4, 8, 128))
    ref = sort_blocks_reference((kk, pay))
    for bound in (8, None):
        got = sort_blocks_stable(kk, (pay,), key_bound=bound)
        sync(torch, dev)
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"K12 sort_blocks_stable (key_bound {bound}) is not the "
                "stable sort")
    return {"main": main, "cases": [c[0] for c in cases],
            "bitwise_repeat": bitwise, "geometry": geometry}


def unstructured_path(torch, sp, dev, n=N, heavy_n=HEAVY_N,
                      sort_nblk=SORT_NBLK) -> dict:
    """Phases 21-24 on ``dev``; returns what the timing phase reuses."""
    t0 = time.perf_counter()
    c2 = phase_2c(torch, sp, dev, n)
    p = c2["prep"]
    slot_bytes = sum(t.numel() * t.element_size()
                     for t in (p.ell_cols, p.ell_vals))
    log(f"phase 21 config 2c: {c2['nnz']} entries, B {p.n_batches}, n_vrows "
        f"{p.n_vrows}, fillers {p.filler_dest.shape[0]}, gather_fill "
        f"{c2['fill']!r}; slot-order arrays {slot_bytes} bytes; "
        f"prepare_shuffle_spmv {c2['prepare_s']!r} s "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    sh = phase_shuffle(torch, sp, dev, c2, heavy_n)
    log(f"phase 22 K11: config 2c max abs err {sh['2c']['err']!r} vs scipy, "
        f"{sh['2c']['err_plain']!r} vs plain; heavy rows ({sh['heavy_extra']}"
        f" split) {sh['heavy']['err']!r} vs scipy; slot grids bitwise "
        f"({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    seg = phase_segsum(torch, sp, dev, c2)
    log(f"phase 23 K10: max abs err {seg['err']} (shapes bit for bit on "
        f"a second call, launches {seg['geometry']} equal to "
        f"segsum_geometry's) ({time.perf_counter() - t0:.3f} s)")
    t0 = time.perf_counter()
    srt = phase_sort(torch, dev, sort_nblk)
    log(f"phase 24 K12: {srt['cases']}, stable packed and not: keys exact, "
        f"payloads by runs; bit for bit with a second call "
        f"{srt['bitwise_repeat']}; (C, E, threads) as the kernel reports "
        f"them, equal to block_sort_geometry's {srt['geometry']} "
        f"({time.perf_counter() - t0:.3f} s)")
    return {"c2": c2, "shuffle": sh, "segsum": seg, "sort": srt}


def band_coo(sp, dev, n):
    """The benchmark's banded matrix ``B`` through ``CooBuilder``,
    consolidated (row-major, each entry once)."""
    r, c, v = banded_entries(n)
    return sp.consolidate(build_coo(sp, dev, (n, n), r, c, v))


def same_as_scipy(torch, sp, got, ref, what: str, rtol: float = 0.0):
    """``got`` (consolidated on the card) against a scipy matrix: the same
    rows, columns and count exactly; values exactly, or within ``rtol``."""
    c = sp.consolidate(got)
    ref = ref.tocsr()
    ref.sum_duplicates()
    require(c.shape == ref.shape and c.nnz == ref.nnz,
            f"{what}: shape {c.shape} nnz {c.nnz} vs scipy {ref.shape} "
            f"{ref.nnz}")
    idx = c.indices[: c.nnz].cpu().numpy()
    require(np.array_equal(np.bincount(idx[:, 0], minlength=c.shape[0]),
                           np.diff(ref.indptr))
            and np.array_equal(idx[:, 1], ref.indices),
            f"{what}: structure differs from scipy")
    vals = c.vals[: c.nnz].cpu().numpy().astype(np.float64)
    if rtol:
        ok, err = close(vals, ref.data, rtol, 0.0)
        require(ok, f"{what}: values off scipy (max abs err {err})")
    else:
        require(np.array_equal(vals, ref.data), f"{what}: values differ")


def phase_joins(torch, sp, dev, B, n_query: int):
    """Phase C1: join2 / join3 / intersect_mask on the band's keys."""
    n, nnz = B.shape[0], B.nnz
    Bt = sp.consolidate(B.T)
    sent = n * n

    def keys(a, m):
        return a.indices[:m, 0].long() * n + a.indices[:m, 1].long()

    kB, kT = keys(B, nnz), keys(Bt, nnz)
    j2 = sp.join2(kB, nnz, kT, nnz, sentinel=sent)
    require(j2.n_match == nnz, f"join2 n_match {j2.n_match} != nnz {nnz}")
    p1, p2 = j2.pos[0].long(), j2.pos[1].long()
    require(bool(torch.equal(kB[p1], kT[p2])), "join2 matched keys differ")
    r, c, v = banded_entries(n)
    host = csr_host(r, c, v, (n, n))
    pick = torch.from_numpy(np.random.default_rng(3).choice(
        nnz, min(100_000, nnz), replace=False)).to(dev)
    ij = B.indices[p1[pick]].long().cpu().numpy()
    want_ij = np.asarray(host[ij[:, 0], ij[:, 1]]).ravel()
    want_ji = np.asarray(host[ij[:, 1], ij[:, 0]]).ravel()
    require(np.array_equal(B.vals[p1[pick]].cpu().numpy(), want_ij)
            and np.array_equal(Bt.vals[p2[pick]].cpu().numpy(), want_ji),
            "join2 positions do not gather B[i, j] and B[j, i]")
    D = sp.coo_diags([np.ones(n)], [0], (n, n), device=dev)
    j3 = sp.join3(kB, nnz, kT, nnz, keys(D, n), n, sentinel=sent)
    require(j3.n_match == n, f"join3 with the diagonal: n_match {j3.n_match}")
    rng = np.random.default_rng(4)
    qr = rng.integers(0, n, n_query)
    qc = qr + rng.integers(-2 * BAND, 2 * BAND + 1, n_query)
    ok = (qc >= 0) & (qc < n)
    q = np.unique(qr[ok] * n + qc[ok])
    match, pos = sp.core.intersect_mask(torch.from_numpy(q).to(dev), q.size,
                                        kB, nnz, sent)
    kh = kB.cpu().numpy()
    want = np.isin(q, kh)
    m_host = match.cpu().numpy()
    require(np.array_equal(m_host, want), "intersect_mask differs from isin")
    require(np.array_equal(kh[pos.cpu().numpy()[m_host]], q[m_host]),
            "intersect_mask positions do not hold the keys")
    return {"Bt": Bt, "host": host, "n_match": j2.n_match,
            "n_query": int(q.size), "n_found": int(want.sum())}


def phase_algebra(torch, sp, dev, B, Bt, host, kron_n: int):
    """Phase C2: coo_add, tril/triu, row/col sums against K1, scaling,
    stacking and kron, each against its reference."""
    import scipy.sparse as ssp
    from spsparse_torch.ops import best_spmv, prepare_dia

    n, nnz = B.shape[0], B.nnz
    S = sp.coo_add(B, B.T, alpha=0.5, beta=0.5)
    S7 = spd_coo(sp, dev, n)
    m = S.nnz
    require(m == S7.nnz and bool(torch.equal(S.indices[:m], S7.indices[:m])),
            "coo_add(B, B^T)/2 indices differ from phase 7's S")
    ok, err_s = close(S.vals[:m].cpu().numpy(), S7.vals[:m].cpu().numpy(),
                      1e-6, 0.0)
    require(ok, f"coo_add(B, B^T)/2 values off phase 7's S ({err_s})")
    T = sp.coo_add(sp.coo_tril(S), sp.coo_triu(S, 1))
    require(T.nnz == m and bool(torch.equal(T.indices[:m], S.indices[:m]))
            and bool(torch.equal(T.vals[:m], S.vals[:m])),
            "coo_add(tril(S), triu(S, 1)) is not S")
    ones = torch.ones(n, device=dev)
    err = {"coo_add": err_s}
    for what, sums, op in (("row_sums", sp.row_sums(B), B),
                           ("col_sums", sp.col_sums(B), Bt)):
        y = best_spmv(prepare_dia(sp.to_dia(op)), ones)
        ok, err[what] = close(sums.cpu().numpy(), y.cpu().numpy(), 1e-5,
                              1e-5)
        require(ok, f"{what} off K1 (max abs err {err[what]})")
    rng = np.random.default_rng(2)       # phase 3's scale vectors si, sj
    si, sj = (rng.uniform(0.5, 1.5, n).astype(np.float32) for _ in range(2))
    scaled = sp.scale_cols(sp.scale_rows(B, torch.from_numpy(si).to(dev)),
                           torch.from_numpy(sj).to(dev))
    ref = (ssp.diags(si.astype(np.float64)) @ host
           @ ssp.diags(sj.astype(np.float64)))
    same_as_scipy(torch, sp, scaled, ref, "scale_rows/scale_cols", 1e-6)
    h = n // 2
    top = sp.coo_slice(B, (0, 0), (h, n))
    bot = sp.coo_slice(B, (h, 0), (n, n))
    ht, hb = host[:h], host[h:]
    for what, got, want in (
            ("coo_hstack", sp.coo_hstack(top, bot), ssp.hstack([ht, hb])),
            ("coo_vstack", sp.coo_vstack(top, bot), ssp.vstack([ht, hb])),
            ("coo_block_diag", sp.coo_block_diag(top, bot),
             ssp.block_diag([ht, hb]))):
        same_as_scipy(torch, sp, got, want, what)
    small = band_coo(sp, dev, kron_n)
    r, c, v = banded_entries(kron_n)
    hs = csr_host(r, c, v, (kron_n, kron_n))
    K = sp.coo_kron(small, small)
    same_as_scipy(torch, sp, K, ssp.kron(hs, hs, format="csr"), "coo_kron",
                  1e-6)
    return {"S_nnz": m, "err": err, "kron_nnz": K.nnz}


def phase_accum(torch, sp, dev, B, n, m: int, r3_nnz: int):
    """Phase C3: scatter_to_dense on a slice of phase 2's doubled stream,
    scalar_sum, and permute/project on a rank-3 array."""
    r, c, v = banded_entries(n)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    idx = np.stack([r, c], axis=1)
    b.add_many(idx, v)
    b.add_many(idx, v)
    sl = sp.coo_slice(b.build(device=dev), (0, 0), (m, m))
    inside = (r < m) & (c < m)
    require(sl.nnz == 2 * int(inside.sum()), f"slice nnz {sl.nnz}")
    dense = np.zeros((m, m), np.float32)
    dense[r[inside], c[inside]] = v[inside]
    add = sp.scatter_to_dense(sl)
    require(np.array_equal(add.cpu().numpy(), 2 * dense),
            "scatter_to_dense ADD is not the doubled entries")
    # Each entry twice more at -3x: first wins v, last wins -3v.
    sl = sl.compact()
    four = sp.coo_concat(sl, sp.coo_scale(sl, -3.0))
    P = sp.DuplicatePolicy
    first = sp.scatter_to_dense(four, duplicate_policy=P.LEAVE_ALONE)
    last = sp.scatter_to_dense(four, duplicate_policy=P.REPLACE)
    total = sp.scatter_to_dense(four, duplicate_policy=P.ADD)
    require(np.array_equal(first.cpu().numpy(), dense),
            "scatter_to_dense LEAVE_ALONE is not first-wins")
    require(np.array_equal(last.cpu().numpy(), np.float32(-3) * dense),
            "scatter_to_dense REPLACE is not last-wins")
    ok, err_add = close(total.cpu().numpy(), -4.0 * dense.astype(np.float64),
                        1e-6, 0.0)
    require(ok, f"scatter_to_dense ADD of four copies ({err_add})")
    got = float(sp.scalar_sum(B))
    want = float(np.sum(v.astype(np.float64)))
    require(abs(got - want) <= 1e-5 * abs(want),
            f"scalar_sum {got!r} vs float64 {want!r}")
    rng = np.random.default_rng(6)
    shape = (128, 256, 64)
    i3 = np.stack([rng.integers(0, s, r3_nnz) for s in shape], 1)
    v3 = rng.uniform(-1, 1, r3_nnz).astype(np.float32)
    b3 = sp.CooBuilder(shape, dtype=np.float32)
    b3.add_many(i3, v3)
    a3 = b3.build(device=dev)
    pm = sp.permute_output(a3, (2, 0, 1))
    require(pm.shape == (64, 128, 256) and np.array_equal(
        pm.indices[:r3_nnz].cpu().numpy(), i3[:, [2, 0, 1]])
        and np.array_equal(pm.vals[:r3_nnz].cpu().numpy(), v3),
        "permute_output differs")
    pr = sp.consolidate(sp.project_output(a3, (0, 2)))
    want2 = np.zeros((128, 64))
    np.add.at(want2, (i3[:, 0], i3[:, 2]), v3.astype(np.float64))
    ok, err_pr = close(pr.to_dense().cpu().numpy(), want2, 1e-5, 1e-5)
    require(ok, f"project_output + consolidate ({err_pr})")
    return {"slice_nnz": sl.nnz, "scalar_sum": got, "scalar_sum_f64": want,
            "err_add": err_add, "err_project": err_pr}


def phase_reorder(torch, sp, dev, B):
    """Phase C4: scramble, RCM on the host, permute back, to_dia, K1."""
    from spsparse_torch.ops import (best_spmv, prepare_dia,
                                    spmv_dia_stream_reference)
    from spsparse_torch.ops.dia_stream import MAX_DIAGS

    n = B.shape[0]
    scramble = np.random.default_rng(1).permutation(n)
    Bs = sp.coo_permute(B, torch.from_numpy(scramble).to(dev))
    bw_scrambled = sp.bandwidth(Bs)
    require(bw_scrambled > 0.99 * n,
            f"scrambled bandwidth {bw_scrambled} is not near n = {n}")
    sync(torch, dev)
    t0 = time.perf_counter()
    perm = sp.rcm_permutation(Bs)
    rcm_s = time.perf_counter() - t0
    R = sp.coo_permute(Bs, torch.from_numpy(perm).to(dev))
    bw = sp.bandwidth(R)
    require(2 * bw + 1 <= MAX_DIAGS,
            f"RCM bandwidth {bw}: {2 * bw + 1} diagonals > {MAX_DIAGS}")
    dia = sp.to_dia(R)
    idx = Bs.indices[: Bs.nnz].cpu().numpy()
    vals = Bs.vals[: Bs.nnz].cpu()
    x_s = np.random.default_rng(5).uniform(-1, 1, n).astype(np.float32)
    x = torch.from_numpy(x_s[perm]).to(dev)
    err = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(dia, dtype=dtype)
        y = best_spmv(prep, x)
        plain = spmv_dia_stream_reference(prep, x)
        sync(torch, dev)
        ok, e = close(y.cpu().numpy(), plain.cpu().numpy(), 1e-5, 1e-5)
        require(ok, f"K1 {name} after RCM off its plain version ({e})")
        # scipy float64 on the scrambled matrix in the operand's precision,
        # x and y permuted.
        v64 = vals.to(dtype).double().numpy()
        ref = csr_host(idx[:, 0], idx[:, 1], v64, (n, n)) @ x_s.astype(
            np.float64)
        ok, err[name] = close(y.cpu().numpy(), ref[perm], 1e-5, 1e-5)
        require(ok, f"K1 {name} after RCM off scipy float64 ({err[name]})")
    return {"n": n, "bw_scrambled": bw_scrambled, "bw": bw,
            "diags": len(dia.offsets), "rcm_s": rcm_s, "err": err}


def phase_interop(torch, sp, dev, n):
    """Phase C5: config 2c through to_scipy and back through from_scipy."""
    rows, cols, vals, _ = cfg2c_entries(n)
    A = build_coo(sp, dev, (n, n), rows, cols, vals)
    M = sp.core.to_scipy(A)
    require(np.array_equal(M.row, rows) and np.array_equal(M.col, cols)
            and np.array_equal(M.data, vals.astype(np.float64)),
            "to_scipy entries differ")
    k = A.nnz
    for dtype in (np.float32, None):
        back = sp.core.from_scipy(M, dtype=dtype, device=dev)
        require(back.nnz == k and back.shape == A.shape
                and bool(torch.equal(back.indices[:k], A.indices[:k]))
                and bool(torch.equal(back.vals[:k],
                                     A.vals[:k].to(back.vals.dtype))),
                f"from_scipy(to_scipy(A)) differs ({dtype})")
    return {"nnz": k}


def phase_done(torch, dev, what, t0, state):
    """Log a phase's host wall time and the peak device memory so far, and
    keep both in ``state`` under the phase's first word."""
    sync(torch, dev)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else None)
    log(f"phase {what} ({time.perf_counter() - t0:.3f} s; peak device "
        f"memory {peak} bytes)")
    state.setdefault("wall_s", {})[what.split()[0]] = (
        time.perf_counter() - t0)
    state.setdefault("peak_bytes", {})[what.split()[0]] = peak


def core_path(torch, sp, dev, n=N, kron_n=CORE_KRON_N, slice_m=CORE_SLICE_M,
              r3_nnz=CORE_R3_NNZ, n_query=CORE_QUERIES) -> dict:
    """Phases C1-C5 on ``dev``: joins, algebra and constructors,
    accumulators, the reorder-to-K1 path and scipy interop at the main
    path's width. Each phase logs its host wall time and the path's peak
    device memory so far."""
    st: dict = {}
    t0 = time.perf_counter()
    B = band_coo(sp, dev, n)
    j = phase_joins(torch, sp, dev, B, n_query)
    phase_done(torch, dev, f"C1 joins: join2 n_match {j['n_match']} = nnz, "
               f"join3 with the diagonal n; intersect_mask {j['n_found']} "
               f"of {j['n_query']} queries", t0, st)
    t0 = time.perf_counter()
    alg = phase_algebra(torch, sp, dev, B, j["Bt"], j["host"], kron_n)
    phase_done(torch, dev, f"C2 algebra: S nnz {alg['S_nnz']}, max abs err "
               f"{alg['err']}; stacking exact; kron nnz {alg['kron_nnz']}",
               t0, st)
    t0 = time.perf_counter()
    acc = phase_accum(torch, sp, dev, B, n, slice_m, r3_nnz)
    phase_done(torch, dev, f"C3 accumulators: slice nnz {acc['slice_nnz']}; "
               f"scalar_sum {acc['scalar_sum']!r} vs "
               f"{acc['scalar_sum_f64']!r}; ADD err {acc['err_add']!r}, "
               f"project err {acc['err_project']!r}", t0, st)
    del j
    t0 = time.perf_counter()
    ro = phase_reorder(torch, sp, dev, B)
    phase_done(torch, dev, f"C4 reorder: n {ro['n']}, bandwidth "
               f"{ro['bw_scrambled']} scrambled -> {ro['bw']} after RCM "
               f"({ro['diags']} diagonals); host rcm_permutation "
               f"{ro['rcm_s']!r} s; K1 max abs err vs scipy {ro['err']}",
               t0, st)
    t0 = time.perf_counter()
    io = phase_interop(torch, sp, dev, n)
    phase_done(torch, dev, f"C5 interop: config 2c {io['nnz']} entries "
               f"through to_scipy and from_scipy exact", t0, st)
    st.update(reorder=ro, nnz=B.nnz)
    return st


# ----------------------------------------------------------------------
# The solver path: the rest of solvers/ and the native host library
# ----------------------------------------------------------------------

def poisson_entries(side: int):
    """Row-major (rows, cols, vals) of the 2-D 5-point Poisson operator on a
    ``side x side`` grid: 4 on the diagonal, -1 to each grid neighbour
    (offsets 0, +-1, +-side), float32."""
    n = side * side
    i = np.arange(n)
    x = i % side
    parts = [(i, i, np.full(n, 4.0))]
    for d, ok in ((-side, i >= side), (-1, x > 0), (1, x < side - 1),
                  (side, i < n - side)):
        parts.append((i[ok], i[ok] + d, np.full(int(ok.sum()), -1.0)))
    r, c, v = (np.concatenate(p) for p in zip(*parts))
    order = np.lexsort((c, r))
    return (r[order].astype(np.int32), c[order].astype(np.int32),
            v[order].astype(np.float32))


def shifted_spd_coo(sp, dev, n):
    """``S = (B + B^T)/2 + SHIFT I`` through the builder (phase 7's recipe
    plus the shift K4 solves with), consolidated: SPD by Gershgorin."""
    r, c, v = banded_entries(n)
    half = (np.float32(0.5) * v).astype(np.float32)
    b = sp.CooBuilder((n, n), dtype=np.float32)
    b.add_many(np.stack([r, c], axis=1), half)
    b.add_many(np.stack([c, r], axis=1), half)
    d = np.arange(n)
    b.add_many(np.stack([d, d], axis=1), np.full(n, SHIFT, np.float32))
    return sp.consolidate(b.build(device=dev))


def k1_operator(sp, A):
    """``(A, its DIA prepared for K1, host float64 CSR)``; K1's product."""
    from spsparse_torch.ops import prepare_dia

    return A, prepare_dia(sp.to_dia(A)), _csr_of(A)


def solver_operators(torch, sp, dev, side, n):
    """P (Poisson), B (config 2's band) and B^T, S (shifted SPD band), each
    built through ``CooBuilder``, ``to_dia`` and ``prepare_dia`` for K1."""
    P = build_coo(sp, dev, (side * side,) * 2, *poisson_entries(side))
    B = band_coo(sp, dev, n)
    ops = {"P": k1_operator(sp, sp.consolidate(P)), "B": k1_operator(sp, B),
           "Bt": k1_operator(sp, sp.consolidate(B.T)),
           "S": k1_operator(sp, shifted_spd_coo(sp, dev, n))}
    require(ops["P"][1].offsets == (-side, -1, 0, 1, side),
            f"P offsets {ops['P'][1].offsets}")
    return ops


def k1(prep):
    from spsparse_torch.ops import best_spmv

    return lambda v: best_spmv(prep, v)


def rel_residual(A_host, x, b) -> float:
    """``||b - A x|| / ||b||`` in float64 on the host."""
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - A_host @ x) / np.linalg.norm(b))


def host_f32(rng_seed, shape):
    return np.random.default_rng(rng_seed).uniform(-1, 1, shape).astype(
        np.float32)


def phase_amg(torch, sp, dev, ops):
    """V1: AMG setup on P; PCG over K1 with the V-cycle and with Jacobi, 50
    iterations each; float64 residuals on the host."""
    import spsparse_torch.solvers.amg as amg_mod

    P, prep, host = ops["P"]
    n = P.shape[0]
    agg_s = []
    greedy = amg_mod._greedy_aggregate

    def timed(*args):
        t0 = time.perf_counter()
        out = greedy(*args)
        agg_s.append(time.perf_counter() - t0)
        return out

    amg_mod._greedy_aggregate = timed
    t0 = time.perf_counter()
    try:
        h = sp.solvers.amg_setup(P)
    finally:
        amg_mod._greedy_aggregate = greedy
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    sizes = [lvl.a.shape[0] for lvl in h.levels]
    require(len(sizes) >= 2 and sizes[0] == n and sizes[-1] <= 4096,
            f"AMG level sizes {sizes}")
    bh = host_f32(11, n)
    b = torch.from_numpy(bh).to(dev)
    x_amg, _ = sp.solvers.pcg_solve(k1(prep), b, iters=SOLVER_ITERS, minv=h)
    jac = torch.full((n,), 0.25, device=dev)
    x_jac, _ = sp.solvers.pcg_solve(k1(prep), b, iters=SOLVER_ITERS,
                                    minv=jac)
    sync(torch, dev)
    res = {name: rel_residual(host, x.cpu().numpy(), bh)
           for name, x in (("amg", x_amg), ("jacobi", x_jac))}
    require(np.isfinite(res["amg"]) and res["amg"] * 100 <= res["jacobi"],
            f"AMG-PCG residual {res['amg']} not 100x below Jacobi-PCG's "
            f"{res['jacobi']}")
    return {"sizes": sizes, "setup_s": setup_s, "aggregate_s": agg_s,
            "residual": res}


def eigen_residuals(A_host, vals, vecs) -> np.ndarray:
    """``||A v - lam v|| / |lam|`` per pair, float64 on the host."""
    V = np.asarray(vecs, np.float64)
    lam = np.asarray(vals, np.float64)
    return np.linalg.norm(A_host @ V - V * lam, axis=0) / np.abs(lam)


def phase_spectral(torch, sp, dev, ops):
    """V2: Lanczos (k = 6, largest) on S over K1; LOBPCG with a block of 8
    over K3; expm_multiply(-t S) v over K1; against float64 residuals,
    each other and scipy."""
    import scipy.sparse.linalg as sla
    from spsparse_torch.ops import spmm_dia_mrhs

    S, prep, host = ops["S"]
    n = S.shape[0]
    v0 = torch.from_numpy(host_f32(12, n)).to(dev)
    vals, vecs = sp.solvers.lanczos_eigsh(
        k1(prep), v0, k=EIG_K, iters=min(LANCZOS_ITERS, n), which="LA")
    X0 = torch.from_numpy(host_f32(13, (n, RHS))).to(dev)
    lob, _ = sp.solvers.lobpcg_solve(
        lambda M: spmm_dia_mrhs(prep, M.T).T, X0, iters=LOBPCG_ITERS,
        largest=True)
    v = host_f32(14, n)
    y = sp.solvers.expm_multiply(k1(prep), torch.from_numpy(v).to(dev),
                                 t=-EXPM_T)
    sync(torch, dev)
    vals_h = vals.cpu().numpy()
    res = eigen_residuals(host, vals_h, vecs.cpu().numpy())
    require(bool(np.all(res <= 1e-3)),
            f"Lanczos residuals {res.tolist()} above 1e-3 |lam|")
    top_lob, top_lan = float(lob[0]), float(vals_h[-1])
    require(abs(top_lob - top_lan) <= 1e-4 * abs(top_lan),
            f"LOBPCG's top value {top_lob!r} off Lanczos's {top_lan!r}")
    ref = sla.expm_multiply(-EXPM_T * host, v.astype(np.float64))
    ok, err = close(y.cpu().numpy(), ref, 0.0, 1e-4)
    require(ok, f"expm_multiply off scipy (max abs err {err})")
    return {"vals": vals_h.tolist(), "residual": float(res.max()),
            "lobpcg_top": top_lob, "expm_err": err}


def phase_lstsq(torch, sp, dev, ops):
    """V3: LSQR, LSMR and CGLS on B over K1 both ways, normal-equation
    residuals against scipy's lsqr at the same iteration count; svds_lanczos
    (k = 6) with float64 residuals of both singular-vector equations."""
    import scipy.sparse.linalg as sla

    B, prep, host = ops["B"]
    prep_t = ops["Bt"][1]
    n = B.shape[0]
    bh = host_f32(15, n)
    b = torch.from_numpy(bh).to(dev)
    b64 = bh.astype(np.float64)

    def normal_res(x):
        return float(np.linalg.norm(host.T @ (b64 - host @ np.asarray(
            x, np.float64))))

    x_s = sla.lsqr(host, b64, atol=0.0, btol=0.0, conlim=0.0,
                   iter_lim=SOLVER_ITERS)[0]
    want = normal_res(x_s)
    floor = 1e-4 * float(np.linalg.norm(host.T @ b64))
    got = {}
    for name in ("lsqr", "lsmr", "cgls"):
        x, _ = getattr(sp.solvers, f"{name}_solve")(
            k1(prep), k1(prep_t), b, iters=SOLVER_ITERS)
        sync(torch, dev)
        got[name] = normal_res(x.cpu().numpy())
        require(np.isfinite(got[name]) and got[name] <= 2 * want + floor,
                f"{name}: normal-equation residual {got[name]} vs scipy "
                f"lsqr's {want} (floor {floor})")
    U, s, Vt = sp.solvers.svds_lanczos(
        k1(prep), k1(prep_t), torch.from_numpy(host_f32(16, n)).to(dev),
        k=EIG_K, iters=min(LANCZOS_ITERS, n))
    sync(torch, dev)
    Uh, sh, Vh = (t.cpu().numpy().astype(np.float64) for t in (U, s, Vt))
    r_u = np.linalg.norm(host @ Vh.T - Uh * sh, axis=0) / sh
    r_v = np.linalg.norm(host.T @ Uh - Vh.T * sh, axis=0) / sh
    require(bool(np.all(np.diff(sh) <= 0)) and bool(np.all(r_u <= 1e-3))
            and bool(np.all(r_v <= 1e-3)),
            f"svds: s {sh.tolist()}, residuals {r_u.tolist()} "
            f"{r_v.tolist()} above 1e-3 s")
    return {"normal_res": got, "scipy_lsqr": want, "sigma": sh.tolist(),
            "svds_residual": float(max(r_u.max(), r_v.max()))}


def phase_direct(torch, sp, dev, ops, side):
    """V4: splu(S) and spsolve(S, b) (host LU, host substitution) against
    scipy's spsolve; spsolve_triangular(tril(P), b) in float32 by ``auto``,
    which takes the device sweeps (one K1 launch a sweep), against scipy's
    spsolve_triangular."""
    import scipy.sparse as ssp
    import scipy.sparse.linalg as sla
    from spsparse_torch.ops import spmv_dia_stream

    S, _, host = ops["S"]
    n = S.shape[0]
    bh = host_f32(17, n)
    b = torch.from_numpy(bh).to(dev)
    t0 = time.perf_counter()
    lu = sp.solvers.splu(S)
    lu_s = time.perf_counter() - t0
    x1 = lu.solve(b)
    x2 = sp.solvers.spsolve(S, b)
    sync(torch, dev)
    require(lu._lplan.route() == "host" and lu._uplan.route() == "host",
            f"splu(S) routes: levels {lu._lplan.nlev}, {lu._uplan.nlev}")
    ref = sla.spsolve(host.tocsc(), bh.astype(np.float64))
    err = {}
    for name, x in (("splu", x1), ("spsolve", x2)):
        ok, err[name] = close(x.cpu().numpy(), ref, 0.0, 1e-5)
        require(ok and x.dtype == torch.float32 and x.device == b.device,
                f"{name} off scipy's spsolve (max abs err {err[name]})")
    P, _, P_host = ops["P"]
    L = sp.coo_tril(P)
    bp = host_f32(18, P.shape[0])
    before = spmv_dia_stream.launches
    y = sp.solvers.spsolve_triangular(L, torch.from_numpy(bp).to(dev),
                                      lower=True)
    sync(torch, dev)
    sweeps = spmv_dia_stream.launches - before
    levels = 2 * side - 1
    require(dev == "cpu" or sweeps == levels - 1,
            f"spsolve_triangular ran {sweeps} K1 sweeps, not {levels - 1}")
    ref_t = sla.spsolve_triangular(ssp.tril(P_host).tocsr(),
                                   bp.astype(np.float64), lower=True)
    ok, err["triangular"] = close(y.cpu().numpy(), ref_t, 0.0, 1e-4)
    require(ok and y.dtype == torch.float32, f"spsolve_triangular off scipy"
            f" (max abs err {err['triangular']})")
    return {"lu_s": lu_s, "lu_nnz": lu.nnz, "levels": levels,
            "sweeps": sweeps, "err": err}


def phase_shift_invert(torch, sp, dev, ops):
    """V5: eigsh(S, k = 6, sigma) by shift-invert through splu against
    scipy's eigsh(sigma); onenormest of B through a LinearOperator of K1
    both ways against ||B||_1 from the column sums."""
    import scipy.sparse.linalg as sla

    S, _, host = ops["S"]
    vals, vecs = sp.solvers.eigsh(S, k=EIG_K, sigma=SIGMA)
    sync(torch, dev)
    got = vals.cpu().numpy()
    want = np.sort(sla.eigsh(host.tocsc(), k=EIG_K, sigma=SIGMA,
                             return_eigenvectors=False))
    require(np.allclose(got, want, rtol=1e-6, atol=0.0),
            f"eigsh(sigma={SIGMA}) {got.tolist()} vs scipy {want.tolist()}")
    res = eigen_residuals(host, got, vecs.cpu().numpy())
    require(bool(np.all(res <= 1e-6)),
            f"shift-invert residuals {res.tolist()} above 1e-6 |lam|")
    B, prep, host_b = ops["B"]
    n = B.shape[0]
    op = sp.solvers.LinearOperator((n, n), k1(prep), k1(ops["Bt"][1]))
    est = float(sp.solvers.onenormest(op, device=dev))
    colsums = np.asarray(abs(host_b).sum(axis=0)).ravel()
    exact = float(colsums.max())
    # The estimate is a lower bound attained by a probe: the abs sum of one
    # of B's columns (float32 products: rtol 1e-5); the default t = 2
    # probes can stop at a column short of the largest.
    hit = np.abs(colsums - est) <= 1e-5 * est
    require(0.5 * exact <= est <= exact * (1 + 1e-5) and bool(hit.any()),
            f"onenormest {est!r} vs ||B||_1 {exact!r}: not an attained "
            f"column sum at or below the norm")
    return {"vals": got.tolist(), "residual": float(res.max()),
            "onenormest": est, "norm1": exact,
            "column": int(np.argmax(hit))}


def phase_matfuncs(torch, sp, dev, ops, m):
    """V6: inv and expm of B's leading m x m block against scipy (dense
    float64: both results are near-dense)."""
    import scipy.linalg as sl

    B = ops["B"][0]
    Bs = sp.coo_slice(B, (0, 0), (m, m))
    dense = Bs.to_dense().cpu().numpy().astype(np.float64)
    Xi = sp.solvers.inv(Bs)
    Xe = sp.solvers.expm(Bs)
    sync(torch, dev)
    err = {}
    for name, X, ref in (("inv", Xi, sl.inv(dense)),
                         ("expm", Xe, sl.expm(dense))):
        got = X.to_dense().cpu().numpy()
        ok, err[name] = close(got, ref, 0.0, 1e-4 if name == "expm" else
                              1e-6)
        require(ok, f"{name} off scipy (max abs err {err[name]})")
    return {"m": m, "nnz": {"inv": Xi.nnz, "expm": Xe.nnz}, "err": err}


def solver_path(torch, sp, dev, side=POISSON_SIDE, n=N,
                slice_m=MATFUNC_M) -> dict:
    """Phases V1-V6 on ``dev``: AMG-preconditioned CG on the Poisson
    operator, Lanczos/LOBPCG/expm_multiply, least squares and svds, the
    direct solvers (host LU, the device triangular sweeps), shift-invert
    eigsh and onenormest, inv and expm. Each f32 product with P, B, B^T or
    S is kernel K1 (LOBPCG's block products K3). Each phase logs its host
    wall and the path's peak device memory so far."""
    from spsparse_torch import native

    require(native.available(), "the native host library did not build")
    st: dict = {"native": native.available()}
    t0 = time.perf_counter()
    ops = solver_operators(torch, sp, dev, side, n)
    phase_done(torch, dev, f"V0 operators: P {ops['P'][0].nnz} entries "
               f"({side} x {side} grid), B {ops['B'][0].nnz}, S "
               f"{ops['S'][0].nnz}; native.available() True", t0, st)
    t0 = time.perf_counter()
    amg = phase_amg(torch, sp, dev, ops)
    phase_done(torch, dev, f"V1 AMG: level sizes {amg['sizes']}, setup "
               f"{amg['setup_s']!r} s (host aggregation "
               f"{amg['aggregate_s']} s a level); PCG relative residuals "
               f"after {SOLVER_ITERS} iterations {amg['residual']}", t0, st)
    t0 = time.perf_counter()
    spec = phase_spectral(torch, sp, dev, ops)
    phase_done(torch, dev, f"V2 spectral: Lanczos top {EIG_K} "
               f"{spec['vals']}, max residual {spec['residual']!r}; "
               f"LOBPCG top {spec['lobpcg_top']!r}; expm_multiply err "
               f"{spec['expm_err']!r}", t0, st)
    t0 = time.perf_counter()
    lsq = phase_lstsq(torch, sp, dev, ops)
    phase_done(torch, dev, f"V3 least squares: normal-equation residuals "
               f"{lsq['normal_res']} vs scipy lsqr {lsq['scipy_lsqr']!r}; "
               f"svds {lsq['sigma']}, max residual "
               f"{lsq['svds_residual']!r}", t0, st)
    t0 = time.perf_counter()
    dr = phase_direct(torch, sp, dev, ops, side)
    phase_done(torch, dev, f"V4 direct: splu(S) {dr['lu_s']!r} s, LU nnz "
               f"{dr['lu_nnz']}; spsolve_triangular(tril(P)) {dr['levels']}"
               f" levels, {dr['sweeps']} K1 sweeps; max abs err "
               f"{dr['err']}", t0, st)
    t0 = time.perf_counter()
    si = phase_shift_invert(torch, sp, dev, ops)
    phase_done(torch, dev, f"V5 shift-invert: eigsh(sigma={SIGMA}) "
               f"{si['vals']}, max residual {si['residual']!r}; onenormest "
               f"{si['onenormest']!r} (column {si['column']}) vs ||B||_1 "
               f"{si['norm1']!r}", t0, st)
    t0 = time.perf_counter()
    mf = phase_matfuncs(torch, sp, dev, ops, slice_m)
    phase_done(torch, dev, f"V6 matfuncs on a {mf['m']}-row slice: nnz "
               f"{mf['nnz']}, max abs err {mf['err']}", t0, st)
    st.update(amg=amg, direct=dr)
    return st


# ----------------------------------------------------------------------
# The graph path: graph/ (semiring SpMV and the csgraph tier), io/npz.py
# and the tools CLI, ending in a Laplacian Lanczos solve through K1
# ----------------------------------------------------------------------

def grid_pattern(side: int):
    """Off-diagonal (rows, cols) of ``poisson_entries(side)``, row-major:
    the 2-D grid graph of the solver path's Poisson operator."""
    r, c, _ = poisson_entries(side)
    off = r != c
    return r[off].astype(np.int64), c[off].astype(np.int64)


def symmetric_weights(r, c, n: int, seed: int):
    """float64 uniform [0.5, 1.5) weights from ``default_rng(seed)``, one
    an undirected edge, equal in both orientations (so the MST is
    unique)."""
    key = np.minimum(r, c) * n + np.maximum(r, c)
    uniq, inv = np.unique(key, return_inverse=True)
    return np.random.default_rng(seed).uniform(0.5, 1.5, uniq.size)[inv]


def random_digraph(n: int, seed: int = 0):
    """Config 2c's digraph: ``cfg2c_entries(n)``'s pattern (10 random heads
    a node) with duplicates dropped, row-major; float32 weights uniform
    [0.5, 1.5) from ``default_rng(seed + 1)``."""
    rows, cols, _, _ = cfg2c_entries(n, seed=seed)
    key = unique_keys(rows.astype(np.int64) * n + cols)
    w = np.random.default_rng(seed + 1).uniform(0.5, 1.5, key.size)
    return key // n, key % n, w.astype(np.float32)


def unique_keys(keys) -> np.ndarray:
    """``np.unique(keys)`` by a sort: the card machine's numpy took 17.4 s
    for np.unique of config 2c's 10.5M keys, 0.24 s this way
    (``tests_gpu/graph_probe.py``)."""
    keys = np.sort(keys)
    return keys[np.r_[True, keys[1:] != keys[:-1]]]


def host_csr(r, c, w, n):
    """scipy float64 CSR of (rows, cols, values)."""
    import scipy.sparse as sps

    return sps.csr_matrix((w.astype(np.float64), (r, c)), shape=(n, n))


def graph_of(sp, dev, n, r, c, w):
    """``(SparseCOO on dev, scipy float64 CSR)`` of row-major unique
    entries."""
    idx = np.stack([r, c], axis=1).astype(np.int32)
    A = sp.SparseCOO.from_arrays(idx, w, (n, n), sort_order=(0, 1),
                                 device=dev)
    return A, host_csr(r, c, w, n)


def graph_events(sp, state: dict, phase: str) -> tuple[int, int]:
    """Sum the rounds and host syncs the graph tier's loops logged since
    the last call into ``state`` under ``phase``, clear the log, and
    return both."""
    ev = [e for e in sp.utils.get_event_log() if e["op"].startswith("graph.")]
    rounds = state.setdefault("rounds", {})[phase] = sum(
        e["rounds"] for e in ev)
    syncs = state.setdefault("syncs", {})[phase] = sum(e["syncs"] for e in ev)
    sp.utils.enable_event_log(True)
    return rounds, syncs


def first_occurrence(labels) -> np.ndarray:
    """Component labels renumbered in order of first occurrence."""
    labels = np.asarray(labels)
    uniq, first = np.unique(labels, return_index=True)
    remap = np.empty(uniq.size, np.int64)
    remap[np.argsort(first)] = np.arange(uniq.size)
    return remap[np.searchsorted(uniq, labels)]


def phase_semiring(torch, sp, dev, R, host):
    """G1: spmv_semiring with each semiring on R (x of 8 columns) against
    relax on prepare_relax(R); MIN_PLUS and PLUS_TIMES against float64
    oracles on the host."""
    from spsparse_torch import graph as gr

    r, c, w = host
    n = R.shape[0]
    x = host_f32(20, (n, GRAPH_X))
    xt = torch.from_numpy(x).to(dev)
    plan = gr.prepare_relax(R)
    has_in = torch.from_numpy(np.bincount(c, minlength=n) > 0).to(dev)
    out = {}
    for name in SEMIRINGS:
        s = getattr(gr, name)
        xi = (xt > 0).to(xt.dtype) if name == "OR_AND" else xt
        y, yp = gr.spmv_semiring(R, xi, s), gr.relax(plan, xi, s)
        if name == "PLUS_TIMES":
            ok, err = close(y.cpu().numpy(), yp.cpu().numpy(), 1e-5, 1e-5)
            require(ok, f"G1 {name}: segment path off relax (err {err})")
        elif name == "OR_AND":
            # where no edge arrives relax leaves the semiring identity 0,
            # the segment path the empty max -inf (jax.ops.segment_max's)
            require(bool(torch.equal(y[has_in], yp[has_in]))
                    and bool((y[~has_in] == -np.inf).all())
                    and bool((yp[~has_in] == 0).all()),
                    f"G1 {name}: segment path differs from relax")
        else:
            require(bool(torch.equal(y, yp)),
                    f"G1 {name}: segment path differs from relax")
        out[name] = y
    x64 = x.astype(np.float64)
    order = np.argsort(c, kind="stable")
    heads, starts = np.unique(c[order], return_index=True)
    ref = np.full((n, GRAPH_X), np.inf)
    ref[heads] = np.minimum.reduceat(
        w[order].astype(np.float64)[:, None] + x64[r[order]], starts, axis=0)
    got = out["MIN_PLUS"].cpu().numpy()
    fin = np.isfinite(ref)
    require(np.array_equal(np.isfinite(got), fin),
            "G1 MIN_PLUS: unreached nodes differ from the oracle")
    ok, err_mp = close(got[fin], ref[fin], 1e-6, 1e-6)
    require(ok, f"G1 MIN_PLUS off the float64 oracle (err {err_mp})")
    M = host_csr(r, c, w, n)
    ok, err_pt = close(out["PLUS_TIMES"].cpu().numpy(), M.T @ x64, 1e-5,
                       1e-5)
    require(ok, f"G1 PLUS_TIMES off the float64 oracle (err {err_pt})")
    return {"k": plan.k, "err": {"MIN_PLUS": err_mp, "PLUS_TIMES": err_pt}}


def edge_weights(host, n, tails, heads) -> np.ndarray:
    """Stored weights of edges (tails, heads) of row-major unique host
    entries ``(r, c, w)``; every edge must exist."""
    r, c, w = host
    keys = r * n + c
    want = tails.astype(np.int64) * n + heads
    pos = np.searchsorted(keys, want)
    require(bool(np.all(pos < keys.size)) and bool(np.all(
        keys[np.minimum(pos, keys.size - 1)] == want)),
        "a predecessor edge is not an edge of the graph")
    return w[pos]


def phase_paths(torch, sp, dev, W, Wh, host_w, R, Rh, fw_n):
    """G2: Bellman-Ford on W from 8 sources (edge list and RelaxPlan, with
    predecessors) against scipy's dijkstra and a tree check; dijkstra with
    limit and min_only; bfs_levels on R against scipy's BFS;
    floyd_warshall on an induced subgraph of W against scipy."""
    import scipy.sparse.csgraph as csg
    from spsparse_torch import graph as gr

    n = W.shape[0]
    src = np.sort(np.random.default_rng(21).choice(
        n, GRAPH_SOURCES, replace=False))
    d, p = gr.bellman_ford(W, src, return_predecessors=True)
    dp, pp = gr.bellman_ford(gr.prepare_relax(W), src,
                             return_predecessors=True)
    ref = csg.dijkstra(Wh, indices=src)
    dh, ph = d.cpu().numpy(), p.cpu().numpy()
    require(np.array_equal(dh, ref),
            f"G2 bellman_ford(W) differs from scipy's dijkstra (max abs "
            f"err {np.max(np.abs(dh - ref))})")
    require(bool(torch.equal(dp, d)) and bool(torch.equal(pp, p))
            and p.dtype == torch.int32,
            "G2 bellman_ford(RelaxPlan) differs from the edge list")
    for k, s in enumerate(src):
        j = np.flatnonzero(np.arange(n) != s)
        require(ph[k, s] == gr.NEG_SENTINEL and bool(np.all(ph[k, j] >= 0)),
                "G2 predecessors: a node of the connected grid has none")
        wt = edge_weights(host_w, n, ph[k, j], j)
        require(np.array_equal(dh[k, ph[k, j]] + wt, dh[k, j]),
                f"G2 tree edge off d[pred] + w = d (source {s})")
    lim = float(np.median(ref[:2]))
    dl, pl = gr.dijkstra(W, indices=src[:2], limit=lim,
                         return_predecessors=True)
    over = ref[:2] > lim
    require(np.array_equal(dl.cpu().numpy(), np.where(over, np.inf,
                                                      ref[:2]))
            and np.array_equal(pl.cpu().numpy(),
                               np.where(over, gr.NEG_SENTINEL, ph[:2])),
            "G2 dijkstra(limit) differs")
    dm, pm, sm = gr.dijkstra(W, indices=src, min_only=True,
                             return_predecessors=True)
    kbest = ref.argmin(axis=0)
    require(np.array_equal(dm.cpu().numpy(), ref.min(axis=0))
            and np.array_equal(sm.cpu().numpy(), src[kbest])
            and np.array_equal(pm.cpu().numpy(), ph[kbest, np.arange(n)]),
            "G2 dijkstra(min_only) differs")
    lv = gr.bfs_levels(R, 0).cpu().numpy()
    ref_lv = csg.shortest_path(Rh, method="D", unweighted=True, indices=0)
    require(np.array_equal(lv, ref_lv), "G2 bfs_levels differs from scipy")
    r, c, w = host_w
    sub = (r < fw_n) & (c < fw_n)
    Ws, Wsh = graph_of(sp, dev, fw_n, r[sub], c[sub], w[sub])
    D = gr.floyd_warshall(Ws).cpu().numpy()
    ok, err_fw = close(D, csg.dijkstra(Wsh), 1e-12, 0.0)
    require(ok, f"G2 floyd_warshall off scipy (max abs err {err_fw})")
    return {"sources": src.tolist(), "levels": int(lv[np.isfinite(lv)].max()),
            "fw_err": err_fw, "ref": ref}


def phase_components(torch, sp, dev, R, Rh, W, host_w, R16, R16h):
    """G3: weak components of R and of W less a random tenth of its
    edges (on the card), strong components of R16 (host Tarjan), against
    scipy."""
    import scipy.sparse.csgraph as csg
    from spsparse_torch import graph as gr

    out = {}
    nc, lab = gr.connected_components(R)
    ref_nc, ref_lab = csg.connected_components(Rh, connection="weak")
    require(nc == ref_nc and np.array_equal(lab.cpu().numpy(), ref_lab),
            f"G3 weak components of R: {nc} vs scipy {ref_nc}")
    out["R"] = nc
    r, c, w = host_w
    n = W.shape[0]
    key = np.minimum(r, c) * n + np.maximum(r, c)
    uniq, inv = np.unique(key, return_inverse=True)
    keep = ~(np.random.default_rng(23).random(uniq.size) < 0.1)[inv]
    Wc, Wch = graph_of(sp, dev, n, r[keep], c[keep], w[keep])
    nc, lab = gr.connected_components(Wc)
    ref_nc, ref_lab = csg.connected_components(Wch, connection="weak")
    require(nc == ref_nc and np.array_equal(lab.cpu().numpy(), ref_lab),
            f"G3 weak components of W less a tenth: {nc} vs {ref_nc}")
    out["W_cut"] = nc
    nc, lab = gr.connected_components(R16, connection="strong")
    ref_nc, ref_lab = csg.connected_components(R16h, connection="strong")
    require(nc == ref_nc and np.array_equal(lab.cpu().numpy(),
                                            first_occurrence(ref_lab)),
            f"G3 strong components of R16: {nc} vs scipy {ref_nc}")
    out["R16_strong"] = nc
    return out


def phase_mst(torch, sp, dev, W, Wh):
    """G4: Boruvka's minimum_spanning_tree(W) against scipy's: the same
    edge set, weights and total."""
    import scipy.sparse.csgraph as csg
    from spsparse_torch import graph as gr

    n = W.shape[0]
    T = gr.minimum_spanning_tree(W)
    idx = T.indices[: T.nnz].cpu().numpy().astype(np.int64)
    vals = T.vals[: T.nnz].cpu().numpy()
    ref = csg.minimum_spanning_tree(Wh).tocoo()
    rk = np.minimum(ref.row, ref.col).astype(np.int64) * n + np.maximum(
        ref.row, ref.col)
    order = np.argsort(rk)
    require(T.nnz == ref.nnz == n - 1
            and np.array_equal(idx[:, 0] * n + idx[:, 1], rk[order])
            and np.array_equal(vals, ref.data[order]),
            f"G4 MST differs from scipy's ({T.nnz} vs {ref.nnz} edges)")
    total, ref_total = float(vals.sum()), float(ref.data.sum())
    require(abs(total - ref_total) <= 1e-12 * ref_total,
            f"G4 MST weight {total!r} vs scipy {ref_total!r}")
    return {"edges": T.nnz, "weight": total, "scipy_weight": ref_total}


def phase_laplacian(torch, sp, dev, U, Uh, W, Wh, side):
    """G5: laplacian(U) against scipy entry for entry, through to_dia and
    K1: L 1 = 0 exactly; Lanczos (k = 6, largest, 256 steps) over K1
    against the grid's analytic spectrum; laplacian(W, normed=True)
    against scipy."""
    import scipy.sparse.csgraph as csg
    from spsparse_torch import graph as gr
    from spsparse_torch.ops import best_spmv, prepare_dia

    n = U.shape[0]
    L = gr.laplacian(U)
    Lh = csg.laplacian(Uh)
    same_as_scipy(torch, sp, L, Lh, "G5 laplacian(U)")
    dia = sp.to_dia(L)
    y = best_spmv(prepare_dia(dia), torch.ones(n, dtype=torch.float32,
                                               device=dev))
    require(bool((y == 0).all()), "G5 K1: L 1 is not exactly 0")
    op = sp.solvers.aslinearoperator(dia)
    v0 = torch.from_numpy(host_f32(22, n)).to(dev)
    steps = min(LANCZOS_ITERS, n)
    vals, vecs = sp.solvers.lanczos_eigsh(op.matvec, v0, k=EIG_K,
                                          iters=steps, which="LA")
    vals_h = vals.cpu().numpy().astype(np.float64)
    s = 4 * np.sin(np.pi * np.arange(side) / (2 * side)) ** 2
    spec = np.sort((s[:, None] + s[None, :]).ravel())
    top = spec[-1]                          # 8 sin^2((side-1) pi / 2 side)
    V = vecs.cpu().numpy().astype(np.float64)
    V /= np.linalg.norm(V, axis=0)
    res = np.linalg.norm(Lh @ V - V * vals_h, axis=0)
    # float32 rounding: each step adds O(u ||L||) to the Ritz values
    # (u = 2**-24, ||L|| <= 8 by Gershgorin)
    margin = steps * 2.0 ** -24 * 8
    # the same run in float64 on the host, from the same start; the
    # three-term recurrence at full size (CGS2 there would take minutes),
    # where no Ritz value converges far enough to leave a copy
    witness = host_lanczos_top(Lh, v0.cpu().numpy().astype(np.float64),
                               steps, EIG_K, reorth=n * steps <= 1 << 24)
    pos = np.clip(np.searchsorted(spec, vals_h), 1, spec.size - 1)
    gap = np.minimum(np.abs(spec[pos] - vals_h), np.abs(spec[pos - 1] -
                                                        vals_h))
    # Kahan: an eigenvalue lies within a unit Ritz vector's residual norm
    require(bool(np.all(gap <= res + margin))
            and bool(np.all(vals_h <= top + margin)),
            f"G5 Ritz values {vals_h.tolist()} (residuals {res.tolist()}) "
            f"outside the grid's spectrum, whose top is {top!r}")
    # the float64 run stops short of top at full size (1.8e-4: a cluster
    # with gaps ~3e-5), so the 1e-4 holds against it, not against top
    require(bool(np.all(np.abs(vals_h - witness) <= 1e-4)),
            f"G5 Ritz values {vals_h.tolist()} not within 1e-4 of the "
            f"float64 host run's {witness.tolist()}")
    Ln = gr.laplacian(W, normed=True)
    same_as_scipy(torch, sp, Ln, csg.laplacian(Wh, normed=True),
                  "G5 laplacian(W, normed)", rtol=1e-12)
    return {"L_nnz": L.nnz, "diags": len(dia.offsets),
            "ritz": vals_h.tolist(), "top": float(top),
            "top_gap": float(vals_h[-1] - top), "residuals": res.tolist(),
            "witness": witness.tolist(),
            "witness_err": float(np.max(np.abs(vals_h - witness))),
            "margin": margin}


def bipartite_entries(m: int, seed: int):
    """An m x m bipartite graph: 8 random columns a row plus a random
    perfect matching (so a full matching exists), unique, row-major,
    float64 weights uniform [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    rows = np.r_[np.repeat(np.arange(m), 8), np.arange(m)]
    cols = np.r_[rng.integers(0, m, 8 * m), rng.permutation(m)]
    key = unique_keys(rows * m + cols)
    return key // m, key % m, rng.uniform(0.5, 1.5, key.size)


def ladder_entries(m: int):
    """A bipartite ladder whose last row is matched only by one augmenting
    path through all m rows: row i < m meets columns m - i and m - i - 1
    (tried in that order of increasing id), row m meets column 0 only."""
    i = np.arange(m)
    rows = np.r_[np.repeat(i, 2), m]
    cols = np.r_[np.stack([m - i - 1, m - i], 1).ravel(), 0]
    return rows, cols, np.ones(rows.size)


def flow_entries(m: int, seed: int):
    """A flow network of m nodes: 8 random heads a node, no self-loops,
    unique, integer capacities uniform 1..19."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), 8)
    key = unique_keys(rows * m + rng.integers(0, m, rows.size))
    r, c = key // m, key % m
    keep = r != c
    r, c = r[keep], c[keep]
    return r, c, rng.integers(1, 20, r.size).astype(np.float64)


def phase_host_tier(torch, sp, dev, R16, R16h, match_n, ladder_n, flow_n,
                    path_side):
    """G6: BFS/DFS orders and trees on R16; maximum_bipartite_matching
    (and a ladder that needs one augmenting path through all its rows),
    structural_rank and min_weight_full_bipartite_matching; maximum_flow;
    reconstruct_path and construct_dist_matrix; yen — against scipy."""
    import scipy.sparse.csgraph as csg
    from spsparse_torch import graph as gr

    out = {}
    for fn in ("breadth_first_order", "depth_first_order"):
        order, pred = getattr(gr, fn)(R16, 0)
        ro, rp = getattr(csg, fn)(R16h, 0)
        require(np.array_equal(order, ro) and np.array_equal(pred, rp),
                f"G6 {fn} differs from scipy")
        out[fn] = int(order.size)
    for fn in ("breadth_first_tree", "depth_first_tree"):
        same_as_scipy(torch, sp, getattr(gr, fn)(R16, 0),
                      getattr(csg, fn)(R16h, 0), f"G6 {fn}")
    r, c, w = bipartite_entries(match_n, 24)
    B, Bh = graph_of(sp, dev, match_n, r, c, w)
    m = gr.maximum_bipartite_matching(B)
    ref = csg.maximum_bipartite_matching(Bh, perm_type="column")
    hit = np.flatnonzero(m >= 0)
    require((m >= 0).sum() == (ref >= 0).sum()
            and np.unique(m[hit]).size == hit.size
            and bool(np.all(np.asarray(Bh[hit, m[hit]]).ravel() > 0)),
            "G6 maximum_bipartite_matching: cardinality or validity")
    require(gr.structural_rank(B) == csg.structural_rank(Bh),
            "G6 structural_rank differs from scipy")
    ri, ci = gr.min_weight_full_bipartite_matching(B)
    sr, sc = csg.min_weight_full_bipartite_matching(Bh)
    cost = float(np.asarray(Bh[ri, ci]).sum())
    ref_cost = float(np.asarray(Bh[sr, sc]).sum())
    require(ri.size == match_n and np.unique(ci).size == match_n
            and abs(cost - ref_cost) <= 1e-12 * ref_cost,
            f"G6 min_weight_full_bipartite_matching cost {cost!r} vs "
            f"scipy {ref_cost!r}")
    out.update(matching=int(hit.size), cost=cost)
    lr, lc, lw = ladder_entries(ladder_n)
    Lad, _ = graph_of(sp, dev, ladder_n + 1, lr, lc, lw)
    t0 = time.perf_counter()
    lm = gr.maximum_bipartite_matching(Lad)
    out["ladder_s"] = time.perf_counter() - t0
    require(int((lm >= 0).sum()) == ladder_n + 1,
            "G6 ladder: the long augmenting path was not found")
    fr, fc, fw = flow_entries(flow_n, 25)
    F, Fh = graph_of(sp, dev, flow_n, fr, fc, fw)
    res = gr.maximum_flow(F, 0, flow_n - 1)
    ref_flow = csg.maximum_flow(Fh.astype(np.int32), 0, flow_n - 1)
    fl = res.flow
    require(fl.device == F.device, "G6 the flow left the operand's device")
    fi = fl.indices[: fl.nnz].cpu().numpy().astype(np.int64)
    fv = fl.vals[: fl.nnz].cpu().numpy()
    net = (np.bincount(fi[:, 0], fv, flow_n)
           - np.bincount(fi[:, 1], fv, flow_n))
    require(res.flow_value == ref_flow.flow_value
            and bool(np.all((fv >= 0) & (fv <= fw)))
            and bool(np.all(net[1:-1] == 0)) and net[0] == res.flow_value,
            f"G6 maximum_flow {res.flow_value} vs scipy "
            f"{ref_flow.flow_value}, or not a flow")
    out["flow"] = res.flow_value
    pr, pc = grid_pattern(path_side)
    pn = path_side * path_side
    G, Gh = graph_of(sp, dev, pn, pr, pc, symmetric_weights(pr, pc, pn, 26))
    dist, pred = gr.shortest_path(G, return_predecessors=True)
    rd, rp = csg.shortest_path(Gh, method="D", return_predecessors=True)
    pred_h = pred.cpu().numpy()
    require(np.array_equal(dist.cpu().numpy(), rd)
            and np.array_equal(pred_h, rp),
            "G6 shortest_path differs from scipy")
    same_as_scipy(torch, sp, gr.reconstruct_path(G, pred[0]),
                  csg.reconstruct_path(Gh, rp[0]), "G6 reconstruct_path")
    ok, err = close(gr.construct_dist_matrix(G, pred),
                    csg.construct_dist_matrix(Gh, rp), 1e-12, 0.0)
    require(ok, f"G6 construct_dist_matrix off scipy (err {err})")
    costs, preds = gr.yen(G, 0, pn - 1, YEN_K, return_predecessors=True)
    require(costs.size == YEN_K and abs(costs[0] - rd[0, -1]) <= 1e-12 *
            rd[0, -1] and bool(np.all(np.diff(costs) >= 0)),
            f"G6 yen costs {costs.tolist()} vs dijkstra {rd[0, -1]!r}")
    for row in preds:
        path, v = [pn - 1], pn - 1
        while v != 0:
            v = int(row[v])
            require(v >= 0 and v not in path, "G6 yen: a path is not simple")
            path.append(v)
    out["yen"] = costs.tolist()
    return out


def phase_npz(torch, sp, dev, W, host_w, Wh):
    """G7: save_npz(W) read by scipy unchanged; a scipy CSR and CSC file
    read back by load_npz onto the card unchanged."""
    import scipy.sparse as sps

    r, c, w = host_w
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "W.npz")
        sp.io.save_npz(p, W)
        M = sps.load_npz(p)
        require(M.format == "coo" and M.shape == W.shape
                and np.array_equal(M.row, r) and np.array_equal(M.col, c)
                and np.array_equal(M.data, w),
                "G7 scipy.sparse.load_npz(save_npz(W)) differs")
        for fmt in ("csr", "csc"):
            q = os.path.join(tmp, f"W_{fmt}.npz")
            sps.save_npz(q, Wh.asformat(fmt), compressed=False)
            A = sp.io.load_npz(q, device=dev)
            require(A.device.type == torch.device(dev).type,
                    "G7 load_npz left the requested device")
            same_as_scipy(torch, sp, A, Wh, f"G7 load_npz({fmt})")
    return {"nnz": W.nnz}


def run_cli(args: list, extra: list) -> str:
    """``spsparse_torch.tools.__main__.main(args + extra)`` in process; its
    standard output."""
    import contextlib
    import io
    from spsparse_torch.tools.__main__ import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(args + extra)
    require(rc == 0, f"G8 CLI {args[0]} returned {rc}")
    return buf.getvalue()


def cli_json(text: str) -> dict:
    return json.loads(text[: text.rindex("}") + 1])


def host_lanczos_top(A, v, steps: int, k: int,
                     reorth: bool = True) -> np.ndarray:
    """The ``k`` largest Ritz values, ascending, of ``steps`` Lanczos steps
    from ``v`` in float64 numpy on the host, an independent replay of a run
    on the card: with full (CGS2) reorthogonalization, the algorithm of the
    port's ``lanczos_eigsh``, or (``reorth=False``, for long runs) the plain
    three-term recurrence, whose loss of orthogonality only adds copies of
    converged values."""
    alpha, beta = np.zeros(steps), np.zeros(steps)
    if reorth:
        V = np.zeros((steps + 1, v.size))
        V[0] = v / np.linalg.norm(v)
        for j in range(steps):
            w = A @ V[j]
            alpha[j] = V[j] @ w
            for _ in range(2):
                w -= (V[:j + 1] @ w) @ V[:j + 1]
            beta[j] = np.linalg.norm(w)
            V[j + 1] = w / beta[j]
    else:
        prev, cur, b = np.zeros(v.size), v / np.linalg.norm(v), 0.0
        for j in range(steps):
            w = A @ cur - b * prev
            alpha[j] = w @ cur
            w -= alpha[j] * cur
            beta[j] = b = np.linalg.norm(w)
            prev, cur = cur, w / b
    T = np.diag(alpha) + np.diag(beta[:-1], 1) + np.diag(beta[:-1], -1)
    return np.linalg.eigvalsh(T)[-k:]


def phase_cli(torch, sp, dev, W, Wh, side, reorder_n, g2_ref, mst):
    """G8: the CLI in process, on the card by default: info, convert and
    stats on a small file; solve and eigs on the Poisson operator; reorder
    on a scrambled band; graph cc/sssp/mst/laplacian on W against the
    G2-G5 oracles; one subprocess of ``python3 -m spsparse_torch.tools
    info``."""
    import scipy.sparse.csgraph as csg

    n = W.shape[0]
    out = {}
    # no --device on the card, so that the CLI's default (cuda) is what
    # runs; a CPU rehearsal names the CPU
    extra = ["--device", "cpu"] if torch.device(dev).type == "cpu" else []
    with tempfile.TemporaryDirectory() as tmp:
        f = lambda name: os.path.join(tmp, name)  # noqa: E731
        small = sp.SparseCOO.from_arrays(np.array([[1, 3], [4, 4]]),
                                         np.array([2.0, 5.0]), (10, 12),
                                         device=dev)
        sp.io.save_netcdf(f("m.nc"), {"M": small})
        text = run_cli(["info", f("m.nc")], extra)
        require("spsparse arrays: M" in text, "G8 info: no array listed")
        text = run_cli(["convert", f("m.nc"), f("m5.nc"), "--version", "5"],
                       extra)
        st = cli_json(run_cli(["stats", f("m5.nc"), "M"], extra))
        require(st["nnz"] == 2 and st["shape"] == [10, 12]
                and st["bandwidth"] == 2, f"G8 stats {st}")
        pr, pc, pv = poisson_entries(side)
        P = sp.SparseCOO.from_arrays(np.stack([pr, pc], 1),
                                     pv.astype(np.float64), (n, n),
                                     device=dev)
        sp.io.save_netcdf(f("P.nc"), {"P": P})
        res = cli_json(run_cli(["solve", f("P.nc"), "P", "--method", "cg",
                                "--precond", "jacobi", "--iters", "100",
                                "--out", f("x.nc")], extra))
        x = sp.io.load_netcdf(f("x.nc"), "x", device=dev).to_dense()
        Ph = host_csr(pr, pc, pv, n)
        true_res = float(np.linalg.norm(1.0 - Ph @ x.cpu().numpy()))
        # the recursive residual drifts from the true one by rounding,
        # ~1e-10 of ||b|| = sqrt(n) once converged
        require(abs(res["residual_norm"] - true_res)
                <= 1e-6 * true_res + 1e-10 * np.sqrt(n),
                f"G8 solve: residual {res['residual_norm']!r} vs float64 "
                f"{true_res!r}")
        out["solve_residual"] = res["residual_norm"]
        ev = cli_json(run_cli(["eigs", f("P.nc"), "P", "--k", "4"], extra))
        vals = np.asarray(ev["values"])
        # the CLI's run replayed on the host: its start (default_rng(0)
        # normal), its 48 steps, float64 numpy on P
        ref = host_lanczos_top(Ph, np.random.default_rng(0).standard_normal(
            n), CLI_EIGS_STEPS, 4)
        require(vals.size == 4 and bool(np.allclose(vals, ref,
                                                    rtol=CLI_EIGS_RTOL,
                                                    atol=0)),
                f"G8 eigs values {vals.tolist()} vs float64 numpy "
                f"{ref.tolist()}")
        out["eigs"] = vals.tolist()
        out["eigs_err"] = float(np.max(np.abs(vals - ref) / ref))
        br, bc, bv = banded_entries(reorder_n)
        perm = np.random.default_rng(27).permutation(reorder_n)
        inv = np.argsort(perm)
        S = sp.SparseCOO.from_arrays(np.stack([inv[br], inv[bc]], 1),
                                     bv.astype(np.float64),
                                     (reorder_n, reorder_n), device=dev)
        sp.io.save_netcdf(f("band.nc"), {"B": S})
        ro = cli_json(run_cli(["reorder", f("band.nc"), f("rcm.nc"), "B"],
                              extra))
        back = sp.io.load_netcdf(f("rcm.nc"), "B", device=dev)
        require(ro["bandwidth_before"] > reorder_n // 4
                and ro["bandwidth_after"] <= 2 * BAND
                and sp.bandwidth(back) == ro["bandwidth_after"],
                f"G8 reorder {ro}")
        out["reorder"] = [ro["bandwidth_before"], ro["bandwidth_after"]]
        sp.io.save_netcdf(f("W.nc"), {"W": W})
        cc = cli_json(run_cli(["graph", f("W.nc"), "W", "--op", "cc"], extra))
        require(cc["n_components"] == 1 and cc["largest"] == n,
                f"G8 graph cc {cc}")
        ss = cli_json(run_cli(["graph", f("W.nc"), "W", "--op", "sssp",
                               "--source", str(g2_ref["source"])], extra))
        d0 = g2_ref["dist"]
        require(ss["reachable"] == n and ss["max_dist"] == float(d0.max())
                and abs(ss["mean_dist"] - d0.mean()) <= 1e-12 * d0.mean(),
                f"G8 graph sssp {ss}")
        ms = cli_json(run_cli(["graph", f("W.nc"), "W", "--op", "mst"], extra))
        require(ms["tree_edges"] == n - 1
                and abs(ms["tree_weight"] - mst["scipy_weight"])
                <= 1e-12 * mst["scipy_weight"], f"G8 graph mst {ms}")
        la = cli_json(run_cli(["graph", f("W.nc"), "W", "--op", "laplacian",
                               "--out", f("L.nc")], extra))
        Lref = csg.laplacian(Wh)
        require(la["laplacian_nnz"] == Lref.nnz, f"G8 graph laplacian {la}")
        # the degrees are sums of float64 weights (order may differ)
        same_as_scipy(torch, sp, sp.io.load_netcdf(f("L.nc"), "W.laplacian",
                                                   device=dev),
                      Lref, "G8 graph laplacian --out", rtol=1e-12)
        cmd = [sys.executable, "-m", "spsparse_torch.tools", "info",
               f("m.nc")] + extra
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        require(proc.returncode == 0 and "spsparse arrays: M" in proc.stdout,
                f"G8 python -m spsparse_torch.tools info: rc "
                f"{proc.returncode}, {proc.stderr[-400:]}")
    return out


def graph_path(torch, sp, dev, side=POISSON_SIDE, n=N, host_n=HOST_N,
               fw_n=FW_N, match_n=MATCH_N, ladder_n=LADDER_N, flow_n=FLOW_N,
               path_side=PATH_SIDE, reorder_n=REORDER_N) -> dict:
    """Phases G1-G8 on ``dev``: semiring SpMV, shortest paths, components,
    MST, the Laplacian through K1 and Lanczos, the host tier, npz files and
    the CLI, on W and U (the ``side`` x ``side`` grid graph, weighted
    float64 and unweighted float32) and R (config 2c's digraph of ``n``
    nodes); the host tier on smaller graphs. Each phase logs its host
    wall, the rounds and host syncs of the graph tier's device loops, and
    the path's peak device memory so far."""
    st: dict = {}

    def done(phase, msg, t0):
        rounds, syncs = graph_events(sp, st, phase)
        phase_done(torch, dev, f"{phase} {msg}; {rounds} rounds, {syncs} "
                   f"syncs", t0, st)

    sp.utils.enable_event_log(True)
    try:
        t0 = time.perf_counter()
        gn = side * side
        wr, wc = grid_pattern(side)
        host_w = (wr, wc, symmetric_weights(wr, wc, gn, 28))
        W, Wh = graph_of(sp, dev, gn, *host_w)
        U, Uh = graph_of(sp, dev, gn, wr, wc, np.ones(wr.size, np.float32))
        host_r = random_digraph(n)
        R, Rh = graph_of(sp, dev, n, *host_r)
        R16, R16h = graph_of(sp, dev, host_n, *random_digraph(host_n))
        done("G0", f"graphs: W and U {W.nnz} entries ({side} x {side} "
             f"grid), R {R.nnz}, R16 {R16.nnz}", t0)
        t0 = time.perf_counter()
        g1 = phase_semiring(torch, sp, dev, R, host_r)
        done("G1", f"semiring SpMV: six semirings on R equal to relax (K = "
             f"{g1['k']}); float64 oracle err {g1['err']}", t0)
        t0 = time.perf_counter()
        g2 = phase_paths(torch, sp, dev, W, Wh, host_w, R, Rh, fw_n)
        done("G2", f"shortest paths: Bellman-Ford from {GRAPH_SOURCES} "
             f"sources equal to scipy's dijkstra, tree checked; BFS on R "
             f"{g2['levels']} levels; floyd_warshall ({fw_n} nodes) err "
             f"{g2['fw_err']!r}", t0)
        t0 = time.perf_counter()
        g3 = phase_components(torch, sp, dev, R, Rh, W, host_w, R16, R16h)
        done("G3", f"components: {g3}", t0)
        t0 = time.perf_counter()
        g4 = phase_mst(torch, sp, dev, W, Wh)
        done("G4", f"MST: {g4['edges']} edges, weight {g4['weight']!r} "
             f"(scipy {g4['scipy_weight']!r})", t0)
        t0 = time.perf_counter()
        g5 = phase_laplacian(torch, sp, dev, U, Uh, W, Wh, side)
        done("G5", f"Laplacian: L {g5['L_nnz']} entries, {g5['diags']} "
             f"diagonals, L 1 = 0 through K1; Lanczos Ritz values "
             f"{g5['ritz']}, the top {g5['top_gap']!r} off {g5['top']!r}, "
             f"residuals {g5['residuals']}; float64 host run "
             f"{g5['witness']}, max difference {g5['witness_err']!r} "
             f"(ceiling margin {g5['margin']!r})", t0)
        t0 = time.perf_counter()
        g6 = phase_host_tier(torch, sp, dev, R16, R16h, match_n, ladder_n,
                             flow_n, path_side)
        done("G6", f"host tier: {g6}", t0)
        t0 = time.perf_counter()
        phase_npz(torch, sp, dev, W, host_w, Wh)
        done("G7", f"npz: W ({W.nnz} entries) through save_npz/scipy, scipy "
             f"CSR and CSC through load_npz", t0)
        t0 = time.perf_counter()
        g8 = phase_cli(torch, sp, dev, W, Wh, side, reorder_n,
                       {"source": int(g2["sources"][0]),
                        "dist": g2["ref"][0]}, g4)
        done("G8", f"CLI: {g8}", t0)
    finally:
        sp.utils.enable_event_log(False)
    st.update(laplacian=g5, sizes={
        "W": W.nnz, "R": R.nnz, "R16": R16.nnz, "fw_n": fw_n,
        "match_n": match_n, "ladder_n": ladder_n, "flow_n": flow_n,
        "path_side": path_side, "reorder_n": reorder_n},
        ladder_s=g6["ladder_s"])
    return st


# ----------------------------------------------------------------------
# The distributed path: dist/ and io/sharded.py on a StackedMesh, and a
# world of one NCCL rank
# ----------------------------------------------------------------------

DIST_P = 4            # partitions of the distributed path
DIST_N = 1 << 22      # rows of its band: config 5's 2^20 rows a partition
DIST_BS = 128         # block-Jacobi block size (D6)
DIST_TOL = 1e-4       # D6's PCG stops at ||r|| <= DIST_TOL ||b||
DIST_MAXITER = 40     # D6's search for the iteration count stops here
DIST_PCG_ITERS = 16   # D6 also holds both solves after this many
NCCL_PROBE_S = 120    # bound of the two-rank NCCL attempt (D9)
# The kernels whose single-device routes the distributed results are held
# to: K1 (D1, D6), K3 (D2), K11 (D3), K9 (D5).
DIST_KERNELS = ("spmv_dia_stream", "spmm_dia_mrhs", "shuffle_gather",
                "spgemm_tiled_pairs")


def fast_host_csr(A):
    """float64 scipy CSR of a consolidated (row-major, unique) SparseCOO,
    without scipy's COO sort."""
    import scipy.sparse as sps

    idx = A.indices[: A.nnz].cpu().numpy()
    vals = A.vals[: A.nnz].cpu().numpy().astype(np.float64)
    ptr = np.zeros(A.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(idx[:, 0], minlength=A.shape[0]), out=ptr[1:])
    return sps.csr_matrix((vals, idx[:, 1], ptr), shape=A.shape)


def owned_rows(y, n: int | None = None):
    """The first ``n`` global rows (all by default) of a stacked mesh's
    ``(P, rows_local, ...)`` result, on the host."""
    return y.reshape((-1,) + tuple(y.shape[2:]))[:n].cpu().numpy()


def same_dtype(got, ref, what: str) -> float:
    """A distributed result against the single-device port in the same
    dtype: rtol 1e-5, with a floor of 1e-6 of max|ref| for entries that
    cancel to near zero (another order of the same float32 sums)."""
    ok, err = close(got, ref, 1e-5, 1e-6)
    require(ok, f"{what} off the single-device port (max abs err {err})")
    return err


def to_f64(got, ref, what: str) -> float:
    """A float32 result against float64 on the host: each entry within
    1e-5 of max|ref|."""
    ok, err = close(got, ref, 0.0, 1e-5)
    require(ok, f"{what} off the float64 host reference (max abs err "
            f"{err})")
    return err


def dist_events(sp) -> dict:
    """Rounds and host syncs the distributed loops logged since the log was
    last cleared, by op; clears the log."""
    out: dict = {}
    for e in sp.utils.get_event_log():
        if e["op"].startswith("graph.dist_"):
            r, s = out.get(e["op"], (0, 0))
            out[e["op"]] = (r + e["rounds"], s + e["syncs"])
    sp.utils.enable_event_log(True)
    return out


def phase_dist_build(torch, sp, dev, n, P):
    """D0: the band, its row and bucketed partitions, x."""
    from spsparse_torch import dist as D

    wall = {}
    t = time.perf_counter()
    A = band_coo(sp, dev, n)
    sync(torch, dev)
    wall["band"] = time.perf_counter() - t
    t = time.perf_counter()
    part = D.partition_rows(A, P, device=dev)
    sync(torch, dev)
    wall["partition_rows"] = time.perf_counter() - t
    x = np.random.default_rng(1).uniform(-1, 1, n).astype(np.float32)
    t = time.perf_counter()
    xp = D.partition_vector(x, P, device=dev)
    sync(torch, dev)
    wall["partition_vector"] = time.perf_counter() - t
    t = time.perf_counter()
    bkt = D.partition_bucketed(A, P, blk_len=xp.shape[1], device=dev)
    sync(torch, dev)
    wall["partition_bucketed"] = time.perf_counter() - t
    require(part.rows_local == n // P and xp.shape == (P, n // P),
            f"D0 rows_local {part.rows_local}, x {tuple(xp.shape)}")
    require(int(part.nnz.sum()) == A.nnz and int(bkt.nnz.sum()) == A.nnz,
            f"D0 partitions hold {int(part.nnz.sum())} and "
            f"{int(bkt.nnz.sum())} entries, not {A.nnz}")
    return {"A": A, "part": part, "bkt": bkt, "x": x, "xp": xp, "n": n,
            "host": fast_host_csr(A), "wall": wall}


def phase_dist_spmv(torch, sp, dev, b, mesh):
    """D1: the four distributed SpMVs against K1 on the whole band and
    scipy float64; halo 1 (below the bandwidth) must raise."""
    from spsparse_torch import dist as D
    from spsparse_torch.ops import best_spmv, prepare_dia

    n, part, bkt, xp = b["n"], b["part"], b["bkt"], b["xp"]
    prep = prepare_dia(sp.to_dia(b["A"]))
    y_k1 = best_spmv(prep, torch.from_numpy(b["x"]).to(dev)).cpu().numpy()
    y64 = b["host"] @ b["x"].astype(np.float64)
    to_f64(y_k1, y64, "D1 K1")
    runs = {"ring": lambda: D.dist_spmv(part, xp, mesh, method="ring"),
            "all_gather": lambda: D.dist_spmv(part, xp, mesh,
                                              method="all_gather"),
            "halo": lambda: D.dist_spmv_halo(part, xp, mesh, halo=BAND),
            "bucketed": lambda: D.dist_spmv_bucketed(bkt, xp, mesh)}
    err, wall = {}, {}
    for name, fn in runs.items():
        t = time.perf_counter()
        y = fn()
        sync(torch, dev)
        wall[name] = time.perf_counter() - t
        require(tuple(y.shape) == (mesh.n_parts, part.rows_local),
                f"D1 {name} shape {tuple(y.shape)}")
        g = owned_rows(y, n)
        err[name] = (same_dtype(g, y_k1, f"D1 {name}"),
                     to_f64(g, y64, f"D1 {name}"))
    try:
        D.dist_spmv_halo(part, xp, mesh, halo=1)
        require(False, "D1 dist_spmv_halo(halo=1) did not raise")
    except ValueError:
        pass
    return {"prep": prep, "err": err, "wall": wall}


def phase_dist_spmm(torch, sp, dev, b, mesh, prep):
    """D2: dist_spmm and dist_spmm_bucketed with 8 columns against K3 and
    scipy float64."""
    from spsparse_torch import dist as D
    from spsparse_torch.ops import spmm_dia_mrhs

    n = b["n"]
    X = np.random.default_rng(2).uniform(-1, 1, (n, RHS)).astype(np.float32)
    Xp = D.partition_vector(X, mesh.n_parts, device=dev)
    Y_k3 = spmm_dia_mrhs(prep, torch.from_numpy(
        np.ascontiguousarray(X.T)).to(dev)).T.cpu().numpy()
    Y64 = b["host"] @ X.astype(np.float64)
    to_f64(Y_k3, Y64, "D2 K3")
    err = {}
    for name, fn in (("spmm", lambda: D.dist_spmm(b["part"], Xp, mesh)),
                     ("spmm_bucketed",
                      lambda: D.dist_spmm_bucketed(b["bkt"], Xp, mesh))):
        g = owned_rows(fn(), n)
        err[name] = (same_dtype(g, Y_k3, f"D2 {name}"),
                     to_f64(g, Y64, f"D2 {name}"))
    return {"err": err}


def phase_dist_a2a(torch, sp, dev, mesh, n):
    """D3: config 2c through partition_footprint, dist_spmv_a2a and
    dist_spmm_a2a, against K11 (``best_spmv`` on the shuffle layout) and
    scipy float64."""
    from spsparse_torch import dist as D
    from spsparse_torch.ops import best_spmv, prepare_shuffle_spmv

    rows, cols, vals, x = cfg2c_entries(n)
    A = sp.consolidate(build_coo(sp, dev, (n, n), rows, cols, vals))
    host = fast_host_csr(A)
    t = time.perf_counter()
    fp = D.partition_footprint(A, mesh.n_parts, device=dev)
    sync(torch, dev)
    fp_s = time.perf_counter() - t
    prep = prepare_shuffle_spmv(A)
    xd = torch.from_numpy(x).to(dev)
    y_k11 = best_spmv(prep, xd).cpu().numpy()
    y64 = host @ x.astype(np.float64)
    to_f64(y_k11, y64, "D3 K11")
    g = owned_rows(D.dist_spmv_a2a(fp, D.partition_vector(x, mesh.n_parts,
                                                          device=dev),
                                   mesh), n)
    err = {"spmv_a2a": (same_dtype(g, y_k11, "D3 dist_spmv_a2a"),
                        to_f64(g, y64, "D3 dist_spmv_a2a"))}
    X = np.random.default_rng(3).uniform(-1, 1, (n, RHS)).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)
    Y_k11 = np.stack([best_spmv(prep, Xd[:, j].contiguous()).cpu().numpy()
                      for j in range(RHS)], axis=1)
    g = owned_rows(D.dist_spmm_a2a(fp, D.partition_vector(
        X, mesh.n_parts, device=dev), mesh), n)
    err["spmm_a2a"] = (same_dtype(g, Y_k11, "D3 dist_spmm_a2a"),
                       to_f64(g, host @ X.astype(np.float64),
                              "D3 dist_spmm_a2a"))
    return {"err": err, "partition_footprint_s": fp_s, "fp_cap": fp.fp_cap,
            "footprint": [int(f) for f in fp.footprint_per_device]}


def exact_spgemm_caps(Ah, Bh, P: int) -> dict:
    """The smallest caps of the three distributed SpGEMMs for ``Ah @ Bh``
    over ``P`` row partitions (host counts): products and output cells a
    partition, distinct B rows and their entries a (partition, owner)
    pair, products a (partition, ring step)."""
    Ra, Rb = -(-Ah.shape[0] // P), -(-Bh.shape[0] // P)
    blen = np.diff(Bh.indptr)
    C = (Ah @ Bh).tocsr()
    caps = dict(expand=0, out=0, req=0, reply=0, step=0)
    for p in range(P):
        lo, hi = Ah.indptr[min(p * Ra, Ah.shape[0])], \
            Ah.indptr[min((p + 1) * Ra, Ah.shape[0])]
        k = Ah.indices[lo:hi]
        q = k // Rb
        caps["expand"] = max(caps["expand"], int(blen[k].sum()))
        caps["step"] = max(caps["step"], int(np.bincount(
            q, weights=blen[k], minlength=P).max(initial=0)))
        u = np.unique(k)
        caps["req"] = max(caps["req"], int(np.bincount(
            u // Rb, minlength=P).max(initial=0)))
        caps["reply"] = max(caps["reply"], int(np.bincount(
            u // Rb, weights=blen[u], minlength=P).max(initial=0)))
        c0, c1 = C.indptr[min(p * Ra, C.shape[0])], \
            C.indptr[min((p + 1) * Ra, C.shape[0])]
        caps["out"] = max(caps["out"], int(c1 - c0))
    return caps


def phase_dist_spgemm(torch, sp, dev, mesh, n):
    """D4: config 4's ``A·Aᵀ`` through dist_spgemm, dist_spgemm_a2a and
    dist_spgemm_ring with the exact caps (overflow 0 everywhere), each
    against ``best_spgemm`` on one device and scipy float64 (structure
    exactly); each again with caps too small, which must report
    overflow."""
    from spsparse_torch import dist as D
    from spsparse_torch.ops import best_spgemm

    P = mesh.n_parts
    r, c, v = cfg4_entries(n)
    A = sp.consolidate(build_coo(sp, dev, (n, 2 * n), r, c, v))
    At = sp.consolidate(A.T)
    Ah = fast_host_csr(A)
    Ath = fast_host_csr(At)
    caps = exact_spgemm_caps(Ah, Ath, P)
    AAT = (Ah @ Ath).tocsr()
    single, routes = traced_routes(
        lambda: best_spgemm(A, A, transpose_b=True).consolidate())
    check_coo(single, AAT, "D4 best_spgemm", 0.0, 1e-5)
    a_part = D.partition_rows(A, P, device=dev)
    b_part = D.partition_rows(At, P, device=dev)
    a_bkt = D.partition_bucketed(A, P, blk_len=b_part.rows_local,
                                 device=dev)

    def run(name, k):
        if name == "all_gather":
            return D.dist_spgemm(a_part, b_part, mesh, with_overflow=True,
                                 expand_cap=max(caps["expand"] // k, 1),
                                 out_cap=max(caps["out"] // k, 1))
        if name == "a2a":
            return D.dist_spgemm_a2a(
                a_part, b_part, mesh, req_cap=max(caps["req"] // k, 1),
                reply_cap=max(caps["reply"] // k, 1),
                expand_cap=max(caps["expand"] // k, 1),
                out_cap=max(caps["out"] // k, 1))
        return D.dist_spgemm_ring(a_bkt, b_part, mesh,
                                  expand_cap_step=max(caps["step"] // k, 1),
                                  out_cap=max(caps["out"] // k, 1))

    s_idx = single.indices[: single.nnz].cpu().numpy()
    s_val = single.vals[: single.nnz].cpu().numpy()
    err, lost = {}, {}
    for name in ("all_gather", "a2a", "ring"):
        C, ov = run(name, 1)
        require(int(ov.sum()) == 0,
                f"D4 {name}: overflow {ov.tolist()} with the exact caps")
        coo = C.to_coo()
        idx = coo.indices[: coo.nnz].cpu().numpy()
        require(coo.nnz == single.nnz and np.array_equal(idx, s_idx),
                f"D4 {name}: structure differs from best_spgemm "
                f"({coo.nnz} vs {single.nnz} entries)")
        err[name] = (same_dtype(coo.vals[: coo.nnz].cpu().numpy(), s_val,
                                f"D4 {name}"),
                     check_coo(coo, AAT, f"D4 {name}", 0.0, 1e-5))
        _, ov = run(name, 2)
        require(int(ov.sum()) > 0, f"D4 {name}: half caps reported no "
                f"overflow ({ov.tolist()})")
        lost[name] = [int(o) for o in ov.tolist()]
    return {"A": A, "AAT": AAT, "caps": caps, "err": err, "routes": routes,
            "overflow_half_caps": lost, "nnz": single.nnz}


def phase_dist_tiled(torch, sp, dev, mesh, g):
    """D5: plan_dist_spgemm_tiled and dist_spgemm_tiled of config 4's
    ``A·Aᵀ`` against K9 (``spgemm_tiled(..., use_window=False)``) on the
    same operands and scipy float64."""
    from spsparse_torch import dist as D
    from spsparse_torch.ops import spgemm_tiled
    from spsparse_torch.ops.spgemm_tiled import tiled_blocks_to_coo

    A = g["A"]
    t = time.perf_counter()
    plan = D.plan_dist_spgemm_tiled(A, A, mesh.n_parts)
    sync(torch, dev)
    plan_s = time.perf_counter() - t
    got = tiled_blocks_to_coo(D.dist_spgemm_tiled(plan, mesh)).consolidate()
    k9 = spgemm_tiled(A, A, transpose_b=True, use_window=False).consolidate()
    idx = got.indices[: got.nnz].cpu().numpy()
    require(got.nnz == k9.nnz and np.array_equal(
        idx, k9.indices[: k9.nnz].cpu().numpy()),
        f"D5 structure differs from K9 ({got.nnz} vs {k9.nnz} entries)")
    err = (same_dtype(got.vals[: got.nnz].cpu().numpy(),
                      k9.vals[: k9.nnz].cpu().numpy(), "D5"),
           check_coo(got, g["AAT"], "D5", 0.0, 1e-5))
    return {"err": err, "plan_s": plan_s, "pairs_max": int(plan.pa.shape[2]),
            "out_tiles": plan.n_out_tiles}


def pcg_iters_to_tol(torch, matvec, b, minv, tol: float, maxiter: int):
    """The least ``k`` at which ``solvers.pcg_solve(iters=k)`` reports
    ``||r|| <= tol ||b||`` (run afresh for k = 1, 2, ...), and its x."""
    from spsparse_torch.solvers import pcg_solve

    stop = tol * float(torch.linalg.vector_norm(b))
    for k in range(1, maxiter + 1):
        x, rs = pcg_solve(matvec, b, iters=k, minv=minv)
        if float(rs) ** 0.5 <= stop:
            return x, k
    require(False, f"D6 pcg_solve not at {tol} in {maxiter} iterations")


def phase_dist_pcg(torch, sp, dev, mesh, n):
    """D6: the port's ``pcg_solve`` with block-Jacobi (bs 128), its matvec
    the ring dist_spmv on ``S = (B + Bᵀ)/2 + 11 I`` (a layout sharded
    once), against the same ``pcg_solve`` over K1 with the single-device
    block-Jacobi: the iteration counts to DIST_TOL within one; at K1's
    count and at DIST_PCG_ITERS the two x's equal at rtol 1e-5 and both
    float64 host residuals within DIST_TOL."""
    from spsparse_torch import dist as D
    from spsparse_torch.ops import best_spmv, prepare_dia
    from spsparse_torch.solvers import (block_jacobi_preconditioner,
                                        pcg_solve)

    P = mesh.n_parts
    S = shifted_spd_coo(sp, dev, n)
    S_host = fast_host_csr(S)
    b = np.random.default_rng(4).uniform(-1, 1, n).astype(np.float32)
    t = time.perf_counter()
    sp_part = mesh.shard_layout(D.partition_rows(S, P, device=dev))
    pre = mesh.shard_layout(D.dist_block_jacobi(S, P, bs=DIST_BS))
    sync(torch, dev)
    setup_s = time.perf_counter() - t
    prep = prepare_dia(sp.to_dia(S))
    pre1 = block_jacobi_preconditioner(S, bs=DIST_BS)
    bp = D.partition_vector(b, P, device=dev)
    b1 = torch.from_numpy(b).to(dev)
    solves = {"dist": (lambda v: D.dist_spmv(sp_part, v, mesh), bp, pre),
              "K1": (lambda v: best_spmv(prep, v), b1, pre1)}
    iters, wall = {}, {}
    for name, (mv, rhs, m) in solves.items():
        t = time.perf_counter()
        _, iters[name] = pcg_iters_to_tol(torch, mv, rhs, m, DIST_TOL,
                                          DIST_MAXITER)
        sync(torch, dev)
        wall[name] = time.perf_counter() - t
    require(abs(iters["dist"] - iters["K1"]) <= 1,
            f"D6 iterations to {DIST_TOL}: distributed {iters['dist']}, K1 "
            f"{iters['K1']}")
    res, err = {}, {}
    for k in (iters["K1"], DIST_PCG_ITERS):
        x = {name: pcg_solve(mv, rhs, iters=k, minv=m)[0]
             for name, (mv, rhs, m) in solves.items()}
        xd, x1 = owned_rows(x["dist"], n), x["K1"].cpu().numpy()
        err[k] = same_dtype(xd, x1, f"D6 x after {k} iterations")
        res[k] = (rel_residual(S_host, xd, b), rel_residual(S_host, x1, b))
        require(max(res[k]) <= DIST_TOL,
                f"D6 float64 residuals after {k} iterations {res[k]} "
                f"(distributed, K1) above {DIST_TOL}")
    del pre, pre1, prep
    dry = dryrun_checks(torch, sp, dev, P)
    return {"iters": (iters["dist"], iters["K1"]), "residual": res,
            "x_err": err, "setup_s": setup_s, "search_s": wall,
            "dryrun": dry}


def dryrun_checks(torch, sp, dev, P: int) -> int:
    """``__graft_entry__.dryrun_multichip``'s checks on a ``StackedMesh``:
    the three SpGEMMs of a small band against the float64 single-device
    oracle, one CG step on the row-partitioned operator (through the
    bucketed ring, plus 0.1 I), the ring and bucketed SpMV/SpMM, the
    bucketed SpMV on a mesh of 2, the halo SpMV, the footprint SpMV/SpMM on
    a scattered operand, the tiled SpGEMM, and the scaling model's
    claims. Returns the number of checks."""
    from spsparse_torch import dist as D
    from spsparse_torch.solvers import CGState, cg_step

    mesh = D.StackedMesh(P, dev)
    n = 8 * P
    rng = np.random.default_rng(0)
    r, c, v = [], [], []
    for off in (-1, 0, 1):
        rr = np.arange(max(0, -off), min(n, n - off))
        r.append(rr)
        c.append(rr + off)
        v.append(rng.uniform(-1, 1, rr.size).astype(np.float32))
    A = sp.consolidate(build_coo(sp, dev, (n, n), np.concatenate(r),
                                 np.concatenate(c), np.concatenate(v)))
    Ad = fast_host_csr(A).toarray()
    count = 0

    def check(name, got, want, tol=1e-4):
        nonlocal count
        got = np.asarray(got, np.float64)
        err = float(np.abs(got - want).max())
        scale = max(float(np.abs(want).max()), 1.0)
        require(err <= tol * scale, f"D6 dry run: {name} diverges from the "
                f"single-device oracle (max abs err {err})")
        count += 1

    part = D.partition_rows(A, P, device=dev)
    AA = Ad @ Ad
    check("dist_spgemm", D.dist_spgemm(part, part, mesh, expand_cap=1024,
                                       out_cap=512).to_coo().to_dense()
          .cpu(), AA)
    g, ov = D.dist_spgemm_a2a(part, part, mesh, req_cap=32, reply_cap=128,
                              expand_cap=1024, out_cap=512)
    check("dist_spgemm_a2a", g.to_coo().to_dense().cpu(), AA)
    require(int(ov.max()) == 0, "D6 dry run: a2a caps overflowed")
    abkt = D.partition_bucketed(A, P, blk_len=part.rows_local, device=dev)
    g, _ = D.dist_spgemm_ring(abkt, part, mesh, expand_cap_step=256,
                              out_cap=512)
    check("dist_spgemm_ring", g.to_coo().to_dense().cpu(), AA)
    ones = np.ones(n, np.float64)
    b = D.partition_vector(np.ones(n, np.float32), P, device=dev)
    bkt = D.partition_bucketed(A, P, blk_len=b.shape[1], device=dev)

    def matvec(p):
        return D.dist_spmv_bucketed(bkt, p, mesh) + 0.1 * p

    rs0 = torch.vdot(b.reshape(-1), b.reshape(-1))
    state = cg_step(matvec, CGState(x=torch.zeros_like(b), r=b, p=b,
                                    rs=rs0))
    Aop = Ad + 0.1 * np.eye(n)
    Ap = Aop @ ones
    alpha = (ones @ ones) / (ones @ Ap)
    check("cg_step.x", state.x.reshape(-1).cpu(), alpha * ones)
    check("cg_step.r", state.r.reshape(-1).cpu(), ones - alpha * Ap)
    check("dist_spmv_ring", D.dist_spmv(part, b, mesh).reshape(-1).cpu(),
          Ad @ ones)
    X = torch.ones((P, b.shape[1], 8), dtype=torch.float32, device=dev)
    check("dist_spmm_bucketed", D.dist_spmm_bucketed(bkt, X, mesh)
          .reshape(-1, 8).cpu(), Ad @ np.ones((n, 8)))
    check("dist_spmv_bucketed", D.dist_spmv_bucketed(bkt, b, mesh)
          .reshape(-1).cpu(), Ad @ ones)
    mesh2 = D.StackedMesh(2, dev)
    x2 = D.partition_vector(np.ones(n, np.float32), 2, device=dev)
    bkt2 = D.partition_bucketed(A, 2, blk_len=x2.shape[1], device=dev)
    check("dist_spmv_bucketed@P2", D.dist_spmv_bucketed(bkt2, x2, mesh2)
          .reshape(-1).cpu(), Ad @ ones)
    check("dist_spmv_halo", D.dist_spmv_halo(part, b, mesh, halo=1)
          .reshape(-1).cpu(), Ad @ ones)
    rng_s = np.random.default_rng(7)
    rr = np.repeat(np.arange(n), 3)
    S = sp.consolidate(build_coo(
        sp, dev, (n, n), rr, rng_s.integers(0, n, rr.size),
        rng_s.uniform(-1, 1, rr.size).astype(np.float32)))
    Sd = fast_host_csr(S).toarray()
    fp = D.partition_footprint(S, P, device=dev)
    check("dist_spmv_a2a", D.dist_spmv_a2a(fp, b, mesh).reshape(-1).cpu(),
          Sd @ ones)
    check("dist_spmm_a2a", D.dist_spmm_a2a(fp, X, mesh).reshape(-1, 8)
          .cpu(), Sd @ np.ones((n, 8)))
    tplan = D.plan_dist_spgemm_tiled(A, A, P)
    check("dist_spgemm_tiled", D.dist_spgemm_tiled(tplan, mesh).to_dense()
          .cpu(), Ad @ Ad.T)
    # The scaling model's claims (H100 datasheet bandwidths): the halo
    # SpMV meets 80% weak scaling at config 2's per-device workload; a
    # footprint-bounded a2a does at P = 8 and 64; the uniform worst case
    # still beats the ring 3x at 64.
    for pm in (2, max(P, 2)):
        require(D.halo_weak_scaling_efficiency(
            nnz_local=11 << 20, rows_local=1 << 20, halo=8,
            n_devices=pm) >= 0.8, f"D6 dry run: halo model at P={pm}")
    f_ok = D.a2a_footprint_for_target(11 << 20, 1 << 20, target=0.8)
    for pm in (8, 64):
        require(D.a2a_weak_scaling_efficiency(11 << 20, 1 << 20, f_ok, pm)
                >= 0.8, f"D6 dry run: a2a model at P={pm}")
    f_uni = D.uniform_footprint(11 << 20, 64 << 20)
    require(D.a2a_weak_scaling_efficiency(11 << 20, 1 << 20, f_uni, 64)
            > 3 * D.ring_weak_scaling_efficiency(11 << 20, 1 << 20, 64),
            "D6 dry run: the uniform a2a model does not beat the ring 3x")
    return count + 5


def phase_dist_graph(torch, sp, dev, mesh, side):
    """D7: dist_bellman_ford (4 sources), dist_bfs_levels and
    dist_connected_components on W (and on W less a tenth of its edges)
    against the single-device graph tier and scipy."""
    import scipy.sparse.csgraph as csg
    from spsparse_torch import dist as D
    from spsparse_torch import graph as gr

    n = side * side
    wr, wc = grid_pattern(side)
    ww = symmetric_weights(wr, wc, n, 28)
    W, Wh = graph_of(sp, dev, n, wr, wc, ww)
    Wp = D.partition_rows(W, mesh.n_parts, device=dev)
    dist_events(sp)       # (re)opens the host event log, empty
    src = [0, n // 2, n - 1, int(np.random.default_rng(15).integers(n))]
    out = {}
    d = owned_rows(D.dist_bellman_ford(Wp, src, mesh), n)
    out["bellman_ford"] = dist_events(sp)
    ref = gr.bellman_ford(W, src).cpu().numpy().T
    require(np.array_equal(d, ref),
            "D7 dist_bellman_ford differs from bellman_ford on one device")
    ok, err = close(d, csg.dijkstra(Wh, indices=src).T, 1e-12, 0.0)
    require(ok, f"D7 dist_bellman_ford off scipy's dijkstra ({err})")
    lv = owned_rows(D.dist_bfs_levels(Wp, [src[3]], mesh), n)[:, 0]
    out["bfs_levels"] = dist_events(sp)
    require(np.array_equal(lv, gr.bfs_levels(W, src[3]).cpu().numpy()),
            "D7 dist_bfs_levels differs from bfs_levels on one device")
    require(np.array_equal(lv, csg.shortest_path(
        Wh, unweighted=True, indices=src[3])), "D7 BFS levels off scipy")
    key = np.minimum(wr, wc) * n + np.maximum(wr, wc)
    _, inv = np.unique(key, return_inverse=True)
    keep = ~(np.random.default_rng(23).random(inv.max() + 1) < 0.1)[inv]
    Wc, Wch = graph_of(sp, dev, n, wr[keep], wc[keep], ww[keep])
    comps = {}
    for name, G, Gh in (("W", W, Wh), ("W_cut", Wc, Wch)):
        lab = D.dist_connected_components(
            D.partition_rows(G, mesh.n_parts, device=dev),
            mesh)[:n].cpu().numpy()
        ev = dist_events(sp)
        nc, one = gr.connected_components(G, directed=False)
        ref_nc, ref_lab = csg.connected_components(Gh, directed=False)
        require(np.array_equal(lab, one.cpu().numpy()) and nc == ref_nc
                and np.array_equal(lab, first_occurrence(ref_lab)),
                f"D7 dist_connected_components of {name}: {nc} vs scipy "
                f"{ref_nc}")
        comps[name] = nc
        out[f"components {name}"] = ev
    return {"events": out, "components": comps, "sources": src}


def phase_dist_sharded(torch, sp, dev, part):
    """D8: save_netcdf_sharded and load_netcdf_sharded of D0's row
    partition in a temporary directory: every array back bit for bit
    (values as float64, as both packages load them); ``parts=[1, 3]``
    leaves partitions 0 and 2 empty."""
    from spsparse_torch.io import load_netcdf_sharded, save_netcdf_sharded

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "band")
        t = time.perf_counter()
        save_netcdf_sharded(prefix, part)
        save_s = time.perf_counter() - t
        size = sum(os.path.getsize(os.path.join(tmp, f))
                   for f in os.listdir(tmp))
        t = time.perf_counter()
        back = load_netcdf_sharded(prefix, device=dev)
        sync(torch, dev)
        load_s = time.perf_counter() - t
        for k in ("row_ptr", "cols", "nnz"):
            require(torch.equal(getattr(back, k), getattr(part, k)),
                    f"D8 {k} differs after the round trip")
        require(torch.equal(back.vals, part.vals.double()),
                "D8 values differ after the round trip")
        sub = load_netcdf_sharded(prefix, parts=[1, 3], device=dev)
        for p in (0, 2):
            require(int(sub.nnz[p]) == 0 and not bool(sub.row_ptr[p].any())
                    and not bool(sub.vals[p].any()),
                    f"D8 parts=[1, 3] filled partition {p}")
        for p in (1, 3):
            require(torch.equal(sub.cols[p], part.cols[p])
                    and torch.equal(sub.vals[p], part.vals[p].double()),
                    f"D8 parts=[1, 3]: partition {p} differs")
    return {"save_s": save_s, "load_s": load_s, "bytes": size}


NCCL_PAIR = r"""
import os, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
store = dist.FileStore(sys.argv[2], 2)
dev = torch.device("cuda", 0)
try:
    dist.init_process_group("nccl", store=store, rank=rank, world_size=2,
                            device_id=dev)
    t = torch.ones(1, device=dev)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("NCCL_PAIR ran", float(t), flush=True)
except Exception as e:
    print("NCCL_PAIR refused:", type(e).__name__,
          str(e).replace("\n", " ")[:300], flush=True)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def start_nccl_pair(tmp: str):
    """Start two processes that each try to join a two-rank NCCL group on
    card 0 (D9, after the world of one has ended)."""
    store = os.path.join(tmp, "pair_store")
    return [subprocess.Popen([sys.executable, "-c", NCCL_PAIR, str(r), store],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(2)]


def finish_nccl_pair(procs, deadline: float) -> list[str]:
    """Each process's ``NCCL_PAIR`` line, else its last line (killed past
    ``deadline``)."""
    lines = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out = (out or "") + " (killed: no result within the bound)"
        tail = [s for s in (out or "").splitlines() if s.strip()]
        said = [s for s in tail if s.startswith("NCCL_PAIR")]
        lines.append((said or tail or [f"rc {p.returncode}, no output"])[-1])
    return lines


def phase_dist_nccl(torch, sp, dev, b, side, n2c, tmp):
    """D9: a world of one NCCL rank (``FileStore``, no network); D1's four
    SpMVs, dist_spmv_a2a (config 2c) and dist_bellman_ford (W) with P = 1
    on its ``GroupMesh``, equal to ``StackedMesh(1, cuda)`` and the host
    oracles."""
    import torch.distributed as dist
    from spsparse_torch import dist as D

    if dev != "cuda":
        return {"skipped": "no card"}
    n = b["n"]
    t = time.perf_counter()
    store = dist.FileStore(os.path.join(tmp, "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    init_s = time.perf_counter() - t
    try:
        gm = D.GroupMesh()
        require(gm.backend == "nccl" and gm.n_parts == 1
                and gm.device == torch.device("cuda", 0),
                f"D9 GroupMesh {gm!r}")
        sm = D.StackedMesh(1, dev)
        part1 = D.partition_rows(b["A"], 1, device=dev)
        bkt1 = D.partition_bucketed(b["A"], 1, device=dev)
        x1 = D.partition_vector(b["x"], 1, device=dev)
        y64 = b["host"] @ b["x"].astype(np.float64)
        rows, cols, vals, x2c = cfg2c_entries(n2c)
        A2 = sp.consolidate(build_coo(sp, dev, (n2c, n2c), rows, cols, vals))
        fp1 = D.partition_footprint(A2, 1, device=dev)
        x2 = D.partition_vector(x2c, 1, device=dev)
        # The group mesh runs on the layouts it sharded once; the stacked
        # one on the global layouts.
        held = {"part": gm.shard_layout(part1), "bkt": gm.shard_layout(bkt1),
                "fp": gm.shard_layout(fp1)}
        glob = {"part": part1, "bkt": bkt1, "fp": fp1}
        runs = {
            "ring": lambda m, L: D.dist_spmv(L["part"], x1, m,
                                             method="ring"),
            "all_gather": lambda m, L: D.dist_spmv(L["part"], x1, m,
                                                   method="all_gather"),
            "halo": lambda m, L: D.dist_spmv_halo(L["part"], x1, m,
                                                  halo=BAND),
            "bucketed": lambda m, L: D.dist_spmv_bucketed(L["bkt"], x1, m),
            "spmv_a2a": lambda m, L: D.dist_spmv_a2a(L["fp"], x2, m)}
        refs = {k: y64 for k in ("ring", "all_gather", "halo", "bucketed")}
        refs["spmv_a2a"] = fast_host_csr(A2) @ x2c.astype(np.float64)
        err = {}
        for name, fn in runs.items():
            g, s = owned_rows(fn(gm, held)), owned_rows(fn(sm, glob))
            m = refs[name].shape[0]
            err[name] = (same_dtype(g[:m], s[:m], f"D9 {name} (NCCL)"),
                         to_f64(g[:m], refs[name], f"D9 {name} (NCCL)"))
        gn = side * side
        wr, wc = grid_pattern(side)
        W, Wh = graph_of(sp, dev, gn, wr, wc,
                         symmetric_weights(wr, wc, gn, 28))
        Wp1 = D.partition_rows(W, 1, device=dev)
        src = [0, gn - 1]
        dist_events(sp)
        dg = owned_rows(D.dist_bellman_ford(Wp1, src, gm), gn)
        ds = owned_rows(D.dist_bellman_ford(Wp1, src, sm), gn)
        events = dist_events(sp)
        import scipy.sparse.csgraph as csg

        ok, e_bf = close(dg, ds, 1e-12, 0.0)
        ok2, e_sc = close(dg, csg.dijkstra(Wh, indices=src).T, 1e-12, 0.0)
        require(ok and ok2, f"D9 dist_bellman_ford (NCCL): {e_bf} against "
                f"StackedMesh(1), {e_sc} against scipy")
        err["bellman_ford"] = (e_bf, e_sc)
    finally:
        dist.destroy_process_group()
    return {"err": err, "init_s": init_s, "events": events}


def dist_path(torch, sp, dev, n=DIST_N, P=DIST_P, n2c=N, n4=CFG4_N,
              side=POISSON_SIDE) -> dict:
    """Phases D0-D9 on ``dev``: the distributed layer on a
    ``StackedMesh(P)`` at config 5's width a partition (the band of 2^22
    rows in 4 partitions of 2^20), config 2c and config 4 with P = 4, the
    grid graph W, a sharded checkpoint, and a world of one NCCL rank. Each
    phase logs its host wall and the peak device memory so far; the loops
    log their rounds and host syncs."""
    from spsparse_torch import dist as D

    st: dict = {}
    mesh = D.StackedMesh(P, dev)
    sp.utils.enable_event_log(True)
    with tempfile.TemporaryDirectory() as tmp:
        pair = []
        try:
            t0 = time.perf_counter()
            b = phase_dist_build(torch, sp, dev, n, P)
            phase_done(torch, dev, f"D0 build: band {b['A'].nnz} entries, "
                       f"{P} partitions of {b['part'].rows_local} rows, "
                       f"cap_local {b['part'].cap_local}, cap_bucket "
                       f"{b['bkt'].cap_bucket}; host wall {b['wall']}", t0,
                       st)
            t0 = time.perf_counter()
            d1 = phase_dist_spmv(torch, sp, dev, b, mesh)
            phase_done(torch, dev, f"D1 SpMV: ring, all_gather, halo "
                       f"{BAND}, bucketed equal to K1 and scipy (max abs "
                       f"err {d1['err']}); halo 1 raised; host wall "
                       f"{d1['wall']}", t0, st)
            t0 = time.perf_counter()
            d2 = phase_dist_spmm(torch, sp, dev, b, mesh, d1["prep"])
            phase_done(torch, dev, f"D2 SpMM, {RHS} columns: equal to K3 "
                       f"and scipy ({d2['err']})", t0, st)
            del d1
            t0 = time.perf_counter()
            d3 = phase_dist_a2a(torch, sp, dev, mesh, n2c)
            phase_done(torch, dev, f"D3 footprint a2a on config 2c: equal "
                       f"to K11 and scipy ({d3['err']}); fp_cap "
                       f"{d3['fp_cap']}, footprints {d3['footprint']}, "
                       f"partition_footprint {d3['partition_footprint_s']:.3f}"
                       f" s", t0, st)
            t0 = time.perf_counter()
            d4 = phase_dist_spgemm(torch, sp, dev, mesh, n4)
            phase_done(torch, dev, f"D4 SpGEMM A·Aᵀ of config 4 "
                       f"({d4['nnz']} entries): all_gather, a2a, ring equal "
                       f"to best_spgemm (routes {d4['routes']}) and scipy "
                       f"({d4['err']}); exact caps {d4['caps']}; half caps "
                       f"overflow {d4['overflow_half_caps']}", t0, st)
            t0 = time.perf_counter()
            d5 = phase_dist_tiled(torch, sp, dev, mesh, d4)
            phase_done(torch, dev, f"D5 tiled SpGEMM: equal to K9 and scipy "
                       f"({d5['err']}); plan {d5['plan_s']:.3f} s, "
                       f"{d5['pairs_max']} pair slots a step, "
                       f"{d5['out_tiles']} output tiles a partition", t0, st)
            del d4
            t0 = time.perf_counter()
            d6 = phase_dist_pcg(torch, sp, dev, mesh, n)
            phase_done(torch, dev, f"D6 pcg_solve (block-Jacobi "
                       f"{DIST_BS}) to {DIST_TOL}: {d6['iters'][0]} "
                       f"iterations distributed, {d6['iters'][1]} over K1; "
                       f"by iterations, float64 residuals (distributed, K1) "
                       f"{d6['residual']}, x max abs diff {d6['x_err']}; "
                       f"set-up {d6['setup_s']:.3f} s, count searches "
                       f"{d6['search_s']} s; dry-run checks {d6['dryrun']} "
                       f"passed", t0, st)
            t0 = time.perf_counter()
            d7 = phase_dist_graph(torch, sp, dev, mesh, side)
            phase_done(torch, dev, f"D7 graph on W: Bellman-Ford from "
                       f"{d7['sources']}, BFS, components {d7['components']} "
                       f"equal to one device and scipy; (rounds, syncs) "
                       f"{d7['events']}", t0, st)
            t0 = time.perf_counter()
            d8 = phase_dist_sharded(torch, sp, dev, b["part"])
            phase_done(torch, dev, f"D8 sharded NetCDF: {d8['bytes']} bytes "
                       f"saved in {d8['save_s']:.3f} s, loaded in "
                       f"{d8['load_s']:.3f} s, bit for bit; parts=[1, 3] "
                       f"exact", t0, st)
            t0 = time.perf_counter()
            d9 = phase_dist_nccl(torch, sp, dev, b, side, n2c, tmp)
            one_s = time.perf_counter() - t0
            t = time.perf_counter()
            if dev == "cuda":
                pair = start_nccl_pair(tmp)
            pair_lines = finish_nccl_pair(pair, time.monotonic()
                                          + NCCL_PROBE_S)
            pair_s = time.perf_counter() - t
            refused = bool(pair_lines) and all(
                "refused" in s for s in pair_lines)
            phase_done(torch, dev, f"D9 NCCL world of one: init "
                       f"{d9.get('init_s', 0.0):.3f} s; four SpMVs, a2a, "
                       f"Bellman-Ford equal to StackedMesh(1) and the host "
                       f"({d9.get('err')}); {one_s:.3f} s. NCCL refuses two "
                       f"ranks on one card, so a world on this machine holds "
                       f"one rank: {'confirmed' if refused else 'NOT confirmed'}"
                       f" by two ranks on cuda:0 ({pair_s:.3f} s), which gave "
                       f"{pair_lines}", t0, st)
        finally:
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            sp.utils.enable_event_log(False)
    st.update(d3=d3, d5=d5, d6=d6, d7=d7, d8=d8, d9=d9,
              nccl_pair=pair_lines, nccl_pair_refused=refused,
              d9_split_s={"world_of_one": one_s, "nccl_pair": pair_s},
              build_wall=b["wall"])
    return st


UTIL_ITERS = 20      # U2: chained K1 calls a rep
UTIL_REPS = 15       # U2: reps of bench_chained and of time_ms
UTIL_AGREE = 0.15    # U2: bench_chained and time_ms agree within this
UTIL_MAX_PCT = 105.0  # U2: a roofline share above this fails


def phase_util_roofline(torch, dev, prep, n, bw, smi, k1_bound_bytes):
    """U1: the card's name and rate from ``utils.roofline``, and K1's
    traffic model against the prepared operator's bytes and the kernel
    table's bound."""
    import importlib

    R = importlib.import_module("spsparse_torch.utils.roofline")
    if torch.device(dev).type == "cuda":
        name, bw = R.device_hbm_bandwidth()
        require(name == torch.cuda.get_device_name(0),
                f"device_hbm_bandwidth named {name!r}")
    else:
        name = "cpu"
    st = R.spmv_dia_stats(len(prep.offsets), n)
    stored = len(prep.offsets) * n * 4 + 2 * n * 4
    require(st.bytes_moved == stored,
            f"spmv_dia_stats bytes {st.bytes_moved} != the prepared "
            f"diagonals, x and y ({stored})")
    if k1_bound_bytes is not None:
        require(st.bytes_moved == k1_bound_bytes,
                f"spmv_dia_stats bytes {st.bytes_moved} != K1's f32 bound "
                f"bytes {k1_bound_bytes}")
    log(f"U1 roofline: device {name!r} at {bw} B/s (nvidia-smi: {smi}); "
        f"spmv_dia_stats({len(prep.offsets)}, {n}) = {st.bytes_moved} "
        f"bytes, {st.flops} flops, speed of light "
        f"{st.sol_time(bw) * 1e3:.6f} ms; K1 f32 bound bytes "
        f"{k1_bound_bytes}")
    return {"device": name, "bw": bw, "stats": st,
            "sol_ms": st.sol_time(bw) * 1e3}


def host_call_ms(fn, reps: int, inner: int) -> list[float]:
    """Per-call milliseconds of ``reps`` host-clock runs of ``inner``
    calls each (the CPU rehearsal's stand-in for ``time_ms``)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        out.append((time.perf_counter() - t0) / inner * 1e3)
    return out


def phase_util_bench(torch, sp, dev, prep, x, u1):
    """U2: ``bench_chained`` of the chained K1 step against ``time_ms`` of
    the same call (host clock off the card), in turns."""
    import importlib

    from spsparse_torch.ops import spmv_dia_stream
    from spsparse_torch.utils.benchtime import bench_chained

    R = importlib.import_module("spsparse_torch.utils.roofline")
    cuda = torch.device(dev).type == "cuda"

    def chained():
        return bench_chained(lambda y: spmv_dia_stream(prep, y), x,
                             iters=UTIL_ITERS, warmup=3, reps=UTIL_REPS) * 1e3

    def single():
        call = (lambda: spmv_dia_stream(prep, x))
        if cuda:
            return time_ms(torch, call, reps=UTIL_REPS, inner=UTIL_ITERS)
        return host_call_ms(call, UTIL_REPS, UTIL_ITERS)

    b1, t1, t2, b2 = chained(), single(), single(), chained()
    bench = float(np.median([b1, b2]))
    timed = float(np.median(t1 + t2))
    rel = abs(bench - timed) / timed
    roof = R.roofline(u1["stats"], bench / 1e3, dev if not cuda else None,
                      bw=None if cuda else u1["bw"])
    log(f"U2 bench_chained: K1 f32 chained {bench:.6f} ms a call "
        f"({b1:.6f}, {b2:.6f}); time_ms {timed:.6f} ms; off by "
        f"{100 * rel:.2f}%; pct_of_roofline {roof['pct_of_roofline']:.2f} "
        f"({roof['gbytes_per_s']:.1f} GB/s)")
    if cuda:
        require(rel <= UTIL_AGREE,
                f"bench_chained {bench} ms and time_ms {timed} ms differ by "
                f"{100 * rel:.2f}%")
        require(roof["pct_of_roofline"] <= UTIL_MAX_PCT,
                f"K1 at {roof['pct_of_roofline']:.2f}% of its roofline")
    return {"bench_ms": bench, "time_ms": timed, "rel": rel,
            "pct_of_roofline": roof["pct_of_roofline"],
            "gbytes_per_s": roof["gbytes_per_s"]}


def phase_util_nvtx(torch, sp, dev, B, x):
    """U3: NVTX depth around a traced op's scope, after it and after a
    raising body, with ranges on (``enable_ranges``; no profiler records
    here); the event log records the op.

    NVTX reports a range's depth only to an attached tool (without one,
    ``range_push`` returns -2, "no push/pop tracking"), so the depth is
    also counted by wrappers around ``torch.cuda.nvtx.range_push`` and
    ``range_pop`` that call the real ones: ``trace_scope`` must reach
    them, balanced. Where NVTX returns depths, they are held too."""
    from spsparse_torch.utils import trace as T

    cuda = torch.device(dev).type == "cuda"
    require(T._NVTX == cuda, f"trace._NVTX is {T._NVTX} on {dev}")
    nvtx = torch.cuda.nvtx
    real_push, real_pop = nvtx.range_push, nvtx.range_pop
    depth = [0]
    names = []

    def push(name):
        names.append(name)
        depth[0] += 1
        return real_push(name)

    def pop():
        depth[0] -= 1
        return real_pop()

    def probe():
        if not T._NVTX:
            return None
        d = (nvtx.range_push("U3 probe"), depth[0] - 1)
        nvtx.range_pop()
        return d

    @sp.utils.traced("U3 traced op")
    def op():
        return probe(), sp.ops.spmv(B, x)

    sp.utils.enable_event_log(True)
    T.enable_ranges(True)
    nvtx.range_push, nvtx.range_pop = push, pop
    try:
        d0 = probe()
        d_in, y = op()
        d_after = probe()
        try:
            with sp.utils.trace_scope("U3 raising body"):
                raise ValueError("U3")
        except ValueError:
            pass
        d_raise = probe()
        ops = [e["op"] for e in sp.utils.get_event_log()]
    finally:
        nvtx.range_push, nvtx.range_pop = real_push, real_pop
        T.enable_ranges(False)
        sp.utils.enable_event_log(False)
    sync(torch, dev)
    depths = {"outside": d0, "inside": d_in, "after": d_after,
              "after_raise": d_raise}
    tracked = None
    if cuda:
        for k in (1, 0) if d0[0] >= 0 else (1,):
            # k = 1: the counted depths; k = 0: NVTX's own, when tracked
            require(d_in[k] == d0[k] + 1 and d_after[k] == d0[k]
                    and d_raise[k] == d0[k], f"NVTX depths {depths}")
        tracked = d0[0] >= 0
        require(depth[0] == 0, f"NVTX pushes and pops unbalanced by "
                f"{depth[0]}")
        require({"U3 traced op", "spsparse.spmv", "U3 raising body"}
                <= set(names), f"NVTX ranges pushed: {names}")
    require("U3 traced op" in ops and "spsparse.spmv" in ops,
            f"event log {ops}")
    require("U3 raising body" not in ops, f"event log {ops}")
    require(bool(torch.isfinite(y).all()), "U3 spmv not finite")
    log(f"U3 NVTX: depths (NVTX's, counted) {depths}; NVTX tracks depth: "
        f"{tracked}; ranges pushed {names}; event log {ops}")
    return {"depths": depths, "ops": ops, "tracked": tracked}


def phase_util_validate(torch, sp, dev, B):
    """U4: ``validate_coo`` and ``check_capacity`` on the card."""
    import dataclasses

    from spsparse_torch.core.validate import check_capacity, validate_coo

    t0 = time.perf_counter()
    validate_coo(B)
    sync(torch, dev)
    ok_s = time.perf_counter() - t0
    raised = {}
    for what, slot, col in (("high", B.nnz - 1, B.shape[1]),
                            ("negative", B.nnz // 2, -1)):
        idx = B.indices.clone()
        idx[slot, 1] = col
        bad = dataclasses.replace(B, indices=idx)
        try:
            validate_coo(bad)
        except sp.SpSparseError as e:
            raised[what] = str(e)
    require(raised.get("high") == raised.get("negative")
            == "Sparse index out of bounds among live entries",
            f"validate_coo on bad copies raised {raised}")
    pad = B.with_capacity(B.cap + 64)
    validate_coo(pad)
    check_capacity(B.nnz, B.nnz)
    try:
        check_capacity(torch.tensor(B.nnz + 1, device=dev), B.nnz, "U4")
        require(False, "check_capacity did not raise on overflow")
    except sp.SpSparseError as e:
        raised["capacity"] = str(e)
    require(raised["capacity"] == "spsparse U4 overflowed static capacity",
            f"check_capacity raised {raised['capacity']!r}")
    log(f"U4 validate: B ({B.nnz} entries, cap {B.cap}) passed in "
        f"{ok_s:.4f} s; raised {raised}")
    return {"ok_s": ok_s, "raised": raised}


def utils_path(torch, sp, dev, n=N, bw=None, smi=None,
               k1_bound_bytes=None) -> dict:
    """Phases U1-U4 on ``dev`` on config 2's band: the roofline module,
    ``bench_chained`` on K1, NVTX ranges and the eager checks. ``bw`` is
    the memory rate off the card (the table names none for the CPU). Each
    phase logs its host wall."""
    from spsparse_torch.ops import prepare_dia

    st: dict = {}
    t0 = time.perf_counter()
    B = band_coo(sp, dev, n)
    prep = prepare_dia(sp.to_dia(B))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, n)
                         .astype(np.float32)).to(dev)
    phase_done(torch, dev, f"U0 band: {B.nnz} entries, "
               f"{len(prep.offsets)} diagonals", t0, st)
    t0 = time.perf_counter()
    st["u1"] = phase_util_roofline(torch, dev, prep, n, bw, smi,
                                   k1_bound_bytes)
    phase_done(torch, dev, "U1 roofline", t0, st)
    t0 = time.perf_counter()
    st["u2"] = phase_util_bench(torch, sp, dev, prep, x, st["u1"])
    phase_done(torch, dev, "U2 bench_chained", t0, st)
    t0 = time.perf_counter()
    st["u3"] = phase_util_nvtx(torch, sp, dev, B, x)
    phase_done(torch, dev, "U3 NVTX", t0, st)
    t0 = time.perf_counter()
    st["u4"] = phase_util_validate(torch, sp, dev, B)
    phase_done(torch, dev, "U4 validate", t0, st)
    return st


def time_ms(torch, fn, *, reps: int = 15, inner: int = 10,
            warmup: int = 3) -> list[float]:
    """Per-call milliseconds of ``reps`` CUDA-event-timed runs of ``inner``
    calls each, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def host_issue_us(torch, fn, *, calls: int = 100, bursts: int = 15) -> float:
    """Median host microseconds a call of ``fn`` takes to issue: bursts of
    ``calls`` calls on the host clock, not waited for, each after a
    synchronise (so that no backlog of earlier launches holds the host)."""
    fn()
    out = []
    for _ in range(bursts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(out))


def device_ms(torch, fn, what: str, calls: int = 10,
              tries: int = 3) -> float | None:
    """Device milliseconds a call of ``fn``: the CUDA kernels' time under
    ``torch.profiler`` over ``calls`` calls (``tests_gpu/profile_kernels.py``'s
    method). A profile that caught no CUDA kernel is no measurement: it is
    taken again, up to ``tries`` profiles, and if none caught one the
    result is None (printed as null), never 0."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if "CUDA" in str(getattr(e, "device_type", "")):
                t = getattr(e, "device_time_total", None)
                us += e.cuda_time_total if t is None else t
        if us > 0:
            return us / calls / 1e3
        log(f"device_ms: profile {attempt + 1} of {tries} caught no CUDA "
            f"kernel of {what}")
    return None


def compare_times(torch, kernel, plain, **kw) -> tuple[float, float]:
    """Median ms of the kernel and of the plain version, timed in turns
    (plain, kernel, kernel, plain)."""
    p1 = time_ms(torch, plain, **kw)
    k1 = time_ms(torch, kernel, **kw)
    k2 = time_ms(torch, kernel, **kw)
    p2 = time_ms(torch, plain, **kw)
    return float(np.median(k1 + k2)), float(np.median(p1 + p2))


def per_iteration_ms(torch, solves: dict, long: int = 72,
                     short: int = 8) -> dict:
    """ms per CG iteration of each solver in ``solves`` (name -> function
    of ``iters``), as the difference of ``long`` and ``short`` solves over
    ``long - short``: the per-solve set-up cancels. Timed in turns, in the
    order given and then reversed."""
    kw = dict(reps=7, inner=3, warmup=1)
    times = {name: {long: [], short: []} for name in solves}
    for name in list(solves) + list(reversed(solves)):
        for iters in (long, short):
            times[name][iters] += time_ms(
                torch, lambda: solves[name](iters), **kw)
    return {name: (float(np.median(t[long])) - float(np.median(t[short])))
            / (long - short) for name, t in times.items()}


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time on the card for the work: the larger of the bytes over
    its memory rate (``utils.roofline.device_hbm_bandwidth``) and the
    operations over their type's rate on an H100 SXM (float32 outside the
    tensor cores unless ``flops_per_s`` says otherwise)."""
    from spsparse_torch.utils.roofline import device_hbm_bandwidth

    t_bytes = nbytes / device_hbm_bandwidth()[1] * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def torch_csr(torch, M, dev):
    """``torch.sparse_csr_tensor`` (float32, on ``dev``) of a scipy matrix:
    the library yardsticks' operand, used nowhere in the port."""
    M = M.tocsr().astype(np.float32)
    M.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(M.indices.astype(np.int64)).to(dev),
        torch.from_numpy(M.data).to(dev), size=M.shape,
        check_invariants=True)


def k12_geometry(n: int, n_arrays: int, num_keys: int) -> tuple:
    """``(C, E, threads)`` that ``sps_block_sort`` launches for blocks of
    ``n`` elements, as the library reports them
    (``sps_block_sort_geometry``): what the host replay's
    ``block_sort_geometry`` must equal."""
    import ctypes

    from spsparse_torch import backend

    out = (ctypes.c_longlong * 3)()
    backend.check(backend.load_kernels().sps_block_sort_geometry(
        n_arrays, num_keys, n, ctypes.cast(out, ctypes.c_void_p)),
        "sps_block_sort_geometry")
    return tuple(int(v) for v in out)


def k1_geometry(prep, y) -> tuple:
    """K1's launch for ``prep`` writing ``y``, as the library reports it
    (``sps_dia_spmv_geometry``): what the host replay's
    ``dia_spmv_geometry`` must equal."""
    import ctypes

    from spsparse_torch import backend

    op = prep.launch
    out = (ctypes.c_longlong * 4)()
    backend.check(backend.load_kernels().sps_dia_spmv_geometry(
        op.code, op.ld, op.n, op.K, op.offsets_ptr,
        prep.data.data_ptr(), y.data_ptr(),
        ctypes.cast(out, ctypes.c_void_p)), "sps_dia_spmv_geometry")
    return tuple(int(v) for v in out)


def k1_replay(prep, y) -> tuple:
    """``dia_spmv_geometry`` of ``prep`` writing ``y``, as a plain tuple."""
    from spsparse_torch.ops.dia_stream import dia_spmv_geometry

    return tuple(int(v) for v in dia_spmv_geometry(
        prep.data.dtype, prep.launch.ld, prep.shape[0], prep.data.data_ptr(),
        y.data_ptr()))


def k10_geometry(prod, nrows: int) -> tuple:
    """K10's launch for ``prod`` and ``nrows`` rows as the library reports
    it (``sps_segsum_geometry``) and as ``segsum_geometry`` replays it."""
    import ctypes

    from spsparse_torch import backend
    from spsparse_torch.ops.segsum import segsum_geometry

    out = (ctypes.c_longlong * 5)()
    backend.check(backend.load_kernels().sps_segsum_geometry(
        prod.shape[0], nrows, prod.data_ptr(),
        ctypes.cast(out, ctypes.c_void_p)), "sps_segsum_geometry")
    return (tuple(int(v) for v in out),
            tuple(int(v) for v in segsum_geometry(prod.shape[0], nrows,
                                                  prod.data_ptr())))


def bitwise_equal(torch, got, want) -> bool:
    """Two tuples of tensors (or two tensors) equal bit for bit."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape
        and torch.equal(g.view(torch.int32) if g.element_size() == 4 else g,
                        w.view(torch.int32) if w.element_size() == 4 else w)
        for g, w in zip(got, want))


def k11_pr5(prep, x):
    """PR 5's K11 (``sps_shuffle_gather_scatter``: each gather slot's
    product stored straight to its ELL slot, from the column-block ordered
    batches) on a float32 ``x``: the timing yardstick of the slot-order
    pass. Used nowhere in the port."""
    import torch
    from spsparse_torch import backend

    out = torch.empty(prep.n_slots, dtype=torch.float32, device=x.device)
    err = backend.load_kernels().sps_shuffle_gather_scatter(
        0 if prep.dest.dtype == torch.int32 else 1, prep.octet.data_ptr(),
        prep.idx.data_ptr(), prep.vals.data_ptr(), prep.dest.data_ptr(),
        prep.filler_dest.data_ptr(), prep.n_batches,
        prep.filler_dest.shape[0], x.data_ptr(), prep.shape[1],
        prep.n_slots, out.data_ptr(), backend.current_stream(x.device))
    backend.check(err, "sps_shuffle_gather_scatter")
    return out.reshape(prep.n_vrows, prep.ell_k)


def library_csr_of(torch, rows, cols, vals, shape, dev):
    """:func:`torch_csr` of an entry list."""
    return torch_csr(torch, csr_host(rows, cols, vals, shape), dev)


def tile_counts(torch, prep) -> tuple[int, int]:
    """``(live tiles, occupied column blocks)`` of a prepared tiled layout,
    read from its own tile columns (a packed or window layout may hold
    other tiles than ``to_tiled`` gave)."""
    tc = prep.tcols
    tc = tc[tc < prep.nbc]
    return int(tc.numel()), int(torch.unique(tc).numel())


def cg_timings(torch, cases: dict, launches: dict) -> list[dict]:
    """Rows of the kernels line for K4 beyond S in float32: S with
    bfloat16 diagonals, the device-memory mode at 4n rows and n = 2^14,
    where the two grid-wide exchanges of an iteration take most of its
    time, each per iteration against its plain version in turns. The bound
    is the diagonals once an iteration (stored slots times 4 or 2 bytes)."""
    from spsparse_torch.ops import cg_solve_dia, cg_solve_dia_reference

    rows = []
    for what, case in cases.items():
        if not case["timed"]:
            continue
        prep, b = case["prep"], case["b"]
        ms = per_iteration_ms(torch, {
            "plain": lambda it: cg_solve_dia_reference(prep, b, iters=it,
                                                       shift=SHIFT),
            "kernel": lambda it: cg_solve_dia(prep, b, iters=it,
                                              shift=SHIFT)})
        n = prep.shape[0]
        stored = sum(n - abs(o) for o in prep.offsets)
        item = prep.data.element_size()
        b_ms, b_by = bound_ms(stored * item, 2 * stored + 2 * n)
        row = dict(name="cg_solve_dia",
                   dtype="bf16" if item == 2 else "f32",
                   **KERNELS["cg_solve_dia"],
                   launches=launches["cg_solve_dia"],
                   max_abs_err=case["err"], ms=ms["kernel"],
                   plain_ms=ms["plain"], bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, matrix=what, n=n, nnz=stored,
                   geometry=case.get("geometry"))
        if ms["kernel"] < b_ms:
            row["note"] = (f"under the device-memory bound: the "
                           f"{stored * item / 1e6:.1f} MB of diagonals stay "
                           "in the 50 MB L2 from one iteration to the next")
        rows.append(row)
    return rows


def spmm_timings(torch, spmm, launches: dict) -> list[dict]:
    """Rows of the kernels line for K5, K6 and K7 at config 3 (K7 also on
    its tiles shuffled), and for K7 on the two one_hot route layouts (the
    traffic prepare_general sends it):
    kernel and plain version in turns, the bound from each timed layout,
    and one ``torch.sparse_csr_tensor`` product as the library yardstick.

    Every bound counts the bytes the product needs, from the timed layout:
    the live A tiles once (dense blocks, or K7's slot values and each
    entry's row and column), X once per occupied column block (K7: once
    per X row an entry names), Y once in float32."""
    from spsparse_torch.ops import (spmm_tiled_dense,
                                    spmm_tiled_dense_reference,
                                    spmm_tiled_onehot,
                                    spmm_tiled_onehot_reference,
                                    spmm_tiled_window,
                                    spmm_tiled_window_reference)

    reg, win, dense = spmm["reg"], spmm["win"], spmm["dense"]
    X, m = reg["X"], reg["m"]
    nnz = reg["entries"][0].size

    def library_ms(entries, shape, Xl):
        A_csr = library_csr_of(torch, *entries, shape, Xl.device)
        return float(np.median(time_ms(torch, lambda: A_csr @ Xl, reps=7,
                                       inner=5)))

    lib_ms = library_ms(reg["entries"], (m, 2 * m), X)
    kw = dict(reps=5, inner=3, warmup=2)
    rows = []

    def add(name, dtype, matrix, prep, Xk, kernel, plain, item, rate, err,
            lib, nnz, timing_kw=kw):
        ms, plain_ms = compare_times(torch, lambda: kernel(prep, Xk),
                                     lambda: plain(prep, Xk), **timing_kw)
        live, occupied = tile_counts(torch, prep)
        n_rhs = Xk.shape[1]
        x_bytes = occupied * TILE_SIDE * n_rhs * item
        y_bytes = prep.shape[0] * n_rhs * 4
        extra = {}
        if name == "spmm_tiled_onehot":
            extra["ptxas"] = ptxas_of(("onehot_kernel", "onehot_small"))
            # Every slot's value of the live tiles (a padding slot is known
            # only by its zero value), each entry's row and column, and the
            # X rows the entries name (an entry product needs no whole X
            # tile); 2 operations per entry and column.
            tc = prep.tcols.long()[:, :, None]
            keep = (prep.vals != 0) & (tc < prep.nbc)
            entries = int(keep.sum())
            x_rows = int(torch.unique((tc * TILE_SIDE + prep.cols)[keep])
                         .numel())
            x_bytes = x_rows * n_rhs * item
            a_bytes = live * prep.tile_cap * 4 + entries * 8
            flops = 2 * entries * n_rhs
        else:
            a_bytes = live * TILE_ELEMS * item
            flops = 2 * TILE_ELEMS * n_rhs * live
        b_ms, b_by = bound_ms(a_bytes + x_bytes + y_bytes, flops, rate)
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, matrix=matrix, n=prep.shape[0],
                         nnz=nnz, live_tiles=live,
                         occupied_column_blocks=occupied, **extra))

    c3 = "config 3"
    add("spmm_tiled_window", "f32", c3 + " (prepare_general)",
        win["prep_f32"], win["Xp"], spmm_tiled_window,
        spmm_tiled_window_reference, 4, F32_FLOPS_PER_S, win["err"]["f32"],
        lib_ms, nnz)
    add("spmm_tiled_window", "bf16", c3, win["prep_bf16"], X,
        spmm_tiled_window, spmm_tiled_window_reference, 2, BF16_FLOPS_PER_S,
        win["err"]["bf16"], lib_ms, nnz)
    for dname, item, rate in (("f32", 4, F32_FLOPS_PER_S),
                              ("bf16", 2, BF16_FLOPS_PER_S)):
        add("spmm_tiled_dense", dname, c3, dense[dname], X,
            spmm_tiled_dense, spmm_tiled_dense_reference, item, rate,
            dense["err"][dname], lib_ms, nnz)
    for what, key in ((c3, "prep"),
                      (c3 + ", rows unsorted within tiles", "unsorted")):
        add("spmm_tiled_onehot", "f32", what, spmm["onehot"][key], X,
            spmm_tiled_onehot, spmm_tiled_onehot_reference, 4,
            F32_FLOPS_PER_S, spmm["onehot"]["err"], lib_ms, nnz,
            timing_kw=dict(reps=3, inner=2, warmup=1))
    for what, route in spmm["onehot"]["route"].items():
        add("spmm_tiled_onehot", "f32", what, route["prep"], route["Xp"],
            spmm_tiled_onehot, spmm_tiled_onehot_reference, 4,
            F32_FLOPS_PER_S, route["err"],
            library_ms(route["entries"], (route["m"], route["m"]),
                       route["X"]),
            int(route["entries"][0].size))
    return rows


def library_spgemm_ms(torch, left, right, dev):
    """``(ms, error)`` of one ``torch.sparse`` CSR x CSR float32 product on
    the card (cuSPARSE's SpGEMM, the whole product, output pattern
    included) of scipy operands: the yardstick of K8, K9 and K13, used
    nowhere in the port. ``(None, message)`` where this PyTorch refuses
    it."""
    try:
        L, R = torch_csr(torch, left, dev), torch_csr(torch, right, dev)
        return float(np.median(time_ms(torch, lambda: L @ R, reps=5,
                                       inner=3, warmup=2))), None
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:200]}"


def host_ms(torch, fn, reps: int = 3) -> float:
    """Median host milliseconds of ``fn`` ending in a synchronize (after
    one warm-up call): a call of an eager entry point, host work
    included."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def occupied_flops(torch, a_blocks, b_blocks, a_idx, b_idx, transpose_b,
                   bf16) -> int:
    """Operations of the pairs ``a_blocks[a_idx[p]] . b_blocks[b_idx[p]]``
    (``^T`` when ``transpose_b``) over the (warp block, k-chunk) units that
    hold a nonzero on both sides, in the kernels' layout: 32 x 64 output
    blocks and 32-deep chunks in float32, 64 x 32 and 64-deep in bfloat16.
    The other units are exact zeros, which the kernels skip."""
    rm, cn, kd = (64, 32, 64) if bf16 else (32, 64, 32)
    T = TILE_SIDE

    def units(blocks, rows, rows_are_k):
        nz = blocks.reshape(-1, T, T) != 0
        if rows_are_k:     # B of A B: k x n
            u = nz.reshape(-1, T // kd, kd, T // rows, rows).any(4).any(2)
            return u.transpose(1, 2).float()
        return nz.reshape(-1, T // rows, rows, T // kd, kd).any(4).any(
            2).float()

    ua = units(a_blocks, rm, False)
    ub = units(b_blocks, cn, not transpose_b)
    live = 0
    for sl in range(0, a_idx.numel(), 1 << 16):
        live += int(torch.einsum("prk,pnk->", ua[a_idx[sl:sl + (1 << 16)]],
                                 ub[b_idx[sl:sl + (1 << 16)]]).item())
    return live * 2 * rm * cn * kd


def spgemm_timings(torch, spg, launches: dict) -> tuple[list[dict], dict]:
    """Rows of the kernels line for K8, K9 and K13 at config 4, and the
    end-to-end times of the SpGEMM entry points.

    Bounds count what the product needs: K8 reads A's live blocks once
    (the plan is shared) and writes the band once in float32; K9 and K13
    read the distinct operand tiles of their plan once and write the
    output tiles once. ``bound_ms`` takes the operations of the occupied
    (warp block, k-chunk) units (:func:`occupied_flops`), the work that
    the kernels cannot skip; ``dense_bound_ms`` 2*128^3 operations a
    pair. K13 is timed in turns against K9. The library yardstick is cuSPARSE's CSR x CSR SpGEMM of
    the same operands, extraction of the output included."""
    from spsparse_torch.ops import (plan_esc, spgemm_aat, spgemm_planned_vals,
                                    spgemm_tiled, spgemm_tiled_pairs,
                                    spgemm_tiled_reference,
                                    spgemm_tiled_stream, spgemm_window,
                                    spgemm_window_reference)
    from spsparse_torch.ops.spgemm_window import band_pair_stream

    cfg, k8, pairs = spg["cfg"], spg["k8"], spg["pairs"]
    A, n = cfg["A"], cfg["n"]
    A64 = _csr_of(A)
    C64 = _csr_of(k8["C"])
    lib = {"A A^T": library_spgemm_ms(torch, A64, A64.T, "cuda"),
           "C C": library_spgemm_ms(torch, C64, C64, "cuda")}
    kw = dict(reps=5, inner=3, warmup=2)
    flops_pair = 2 * TILE_SIDE ** 3
    rows = []

    def row(name, dtype, matrix, ms, plain_ms, nbytes, flops, dense_flops,
            err, label, **extra):
        rate = BF16_FLOPS_PER_S if dtype == "bf16" else F32_FLOPS_PER_S
        b_ms, b_by = bound_ms(nbytes, flops, rate)
        d_ms, d_by = bound_ms(nbytes, dense_flops, rate)
        lib_ms, lib_err = lib[label]
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_error=lib_err,
                         dense_bound_ms=d_ms, dense_bound_by=d_by,
                         occupied_flops=flops, dense_flops=dense_flops,
                         matrix=matrix, n=n, nnz=A.nnz, **extra))

    for dname in ("f32", "bf16"):
        plan, prep = k8["plan"][dname], k8["prep"][dname]
        ms, plain_ms = compare_times(
            torch, lambda: spgemm_window(plan, prep.blocks),
            lambda: spgemm_window_reference(plan, prep.blocks), **kw)
        live = int((prep.tcols < prep.nbc).sum())
        nbytes = (live * TILE_ELEMS * prep.blocks.element_size()
                  + plan.nbr_pad * plan.nband * TILE_ELEMS * 4)
        _, a_idx, b_idx = (torch.from_numpy(v).to(prep.blocks.device)
                           for v in band_pair_stream(plan))
        flops = occupied_flops(torch, prep.blocks, prep.blocks, a_idx, b_idx,
                               True, dname == "bf16")
        row("spgemm_window", dname, "config 4 A A^T (band)", ms, plain_ms,
            nbytes, flops, plan.n_live * flops_pair,
            k8["err"][f"band_{dname}"], "A A^T")
    for label, dname in (("A A^T", "f32"), ("A A^T", "bf16"),
                         ("C C", "f32"), ("C C", "bf16")):
        plan = pairs["plans"][label]
        X = pairs["blocks"][(label, dname)]
        tiles = np.unique(np.concatenate([plan.pa, plan.pb])).size
        nbytes = (tiles * TILE_ELEMS * X.blocks.element_size()
                  + plan.n_out_tiles * TILE_ELEMS * 4)
        t = plan.tensors(X.device)
        flops = occupied_flops(torch, X.blocks, X.blocks, t["pa"].long(),
                               t["pb"].long(), plan.transpose_b,
                               dname == "bf16")
        for name, fn in (("spgemm_tiled_pairs", spgemm_tiled_pairs),
                         ("spgemm_tiled_stream", spgemm_tiled_stream)):
            ms, plain_ms = compare_times(
                torch, lambda: fn(X, X, plan),
                lambda: spgemm_tiled_reference(X, X, plan), **kw)
            extra = {}
            if fn is spgemm_tiled_stream:
                # K9, K13's yardstick, in turns with K13 in the same run.
                extra["ms_again"], extra["k9_ms"] = compare_times(
                    torch, lambda: fn(X, X, plan),
                    lambda: spgemm_tiled_pairs(X, X, plan), **kw)
            row(name, dname, f"config 4 {label} (pair plan)", ms, plain_ms,
                nbytes, flops, plan.n_pairs * flops_pair,
                pairs["err"][f"{label} {dname}"], label, **extra)

    plan, acon, bcon = spg["esc"]["plans"]["device"]
    ends = {
        "spgemm_tiled(A, A, transpose_b=True) end to end (K8 route)":
            host_ms(torch, lambda: spgemm_tiled(A, A, transpose_b=True)),
        "spgemm_tiled(..., use_window=False) end to end (K9 route)":
            host_ms(torch, lambda: spgemm_tiled(A, A, transpose_b=True,
                                                use_window=False)),
        "spgemm_aat (ESC) end to end": host_ms(torch, lambda: spgemm_aat(A)),
        "plan_esc host plan": host_ms(torch, lambda: plan_esc(
            A, A, transpose_b=True, host=True), reps=1),
        "spgemm_planned_vals apply (events)": float(np.median(time_ms(
            torch, lambda: spgemm_planned_vals(plan, acon.vals, bcon.vals),
            **kw))),
    }
    return rows, {"end_to_end_ms": ends, "library_ms": lib}


def unstructured_timings(torch, un, launches: dict) -> tuple[list, dict]:
    """Rows of the kernels line for K10, K11 and K12, and the end-to-end
    times of the unstructured SpMV entry points at config 2c.

    Bounds count what each function needs, from the timed inputs: K10 reads
    the products and row_ptr once and writes y (one add an entry); K11
    reads the layout (octet, idx, vals, dest, fillers) and x once and
    writes every ELL slot once (one multiply a gather slot); K12 reads and
    writes each array once, and does a compare a key and two selects an
    array for each of the network's n/2 pairs a stage (on the SIMT units,
    counted at the float32 rate). Library yardsticks: cuSPARSE's CSR SpMV
    (``torch.sparse_csr_tensor @ x``) of the 2c matrix for K10 and K11;
    ``torch.sort`` of the flattened blocks carrying the payload through
    ``gather`` for K12 (unstable; the stable variant beside it)."""
    from spsparse_torch.ops import (plan_stages, segmented_row_sums,
                                    segmented_row_sums_reference,
                                    shuffle_gather, shuffle_gather_reference,
                                    sort_blocks, sort_blocks_reference,
                                    spmv_csr_segsum, spmv_shuffle)

    c2, seg = un["c2"], un["segsum"]
    prep, x, n, nnz = c2["prep"], c2["x"], c2["n"], c2["nnz"]
    A_csr = torch_csr(torch, c2["host"], x.device)
    lib_ms = float(np.median(time_ms(torch, lambda: A_csr @ x)))
    rows = []

    def row(name, matrix, ms, plain_ms, nbytes, ops, err, lib, dtype="f32",
            **extra):
        b_ms, b_by = bound_ms(nbytes, ops)
        rows.append(dict(name=name, dtype=dtype, **KERNELS[name],
                         launches=launches[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, matrix=matrix, **extra))

    prod, csr = seg["prod"], seg["csr"]

    def k10():
        return segmented_row_sums(prod, csr.row_ptr, nrows=n,
                                  rows_per_block=256, entries_per_block=1024)

    ms, plain_ms = compare_times(
        torch, k10,
        lambda: segmented_row_sums_reference(prod, csr.row_ptr, n))
    # One PyTorch call computing K10's function: per-row sums of the
    # products by the row pointer.
    live_prod, offsets = prod[:csr.nnz], csr.row_ptr[:n + 1]
    seg_lib = torch.segment_reduce(live_prod, "sum", offsets=offsets)
    ok, seg_lib_err = close(seg_lib.cpu().numpy(), segmented_row_sums(
        prod, csr.row_ptr, nrows=n, rows_per_block=256,
        entries_per_block=1024).cpu().numpy(), 1e-5, 1e-5)
    require(ok, f"segment_reduce differs from K10 ({seg_lib_err})")
    seg_lib_ms = float(np.median(time_ms(
        torch, lambda: torch.segment_reduce(live_prod, "sum",
                                            offsets=offsets))))
    row("segmented_row_sums", "config 2c (CSR products)", ms, plain_ms,
        4 * csr.nnz + 4 * (n + 1) + 4 * n, csr.nnz, seg["err"]["k10"],
        seg_lib_ms, n=n, nnz=csr.nnz, library_call="torch.segment_reduce",
        library_csr_spmv_ms=lib_ms,
        device_ms=device_ms(torch, k10, "segmented_row_sums"),
        host_issue_us=host_issue_us(torch, k10),
        # The same sums over the live prefix of prod (no tiles past nnz),
        # as spmv_csr_segsum hands it to K10.
        device_ms_live=device_ms(torch, lambda: segmented_row_sums(
            prod[:csr.nnz], csr.row_ptr, nrows=n, rows_per_block=256,
            entries_per_block=1024), "segmented_row_sums (live prefix)"))
    ms, plain_ms = compare_times(torch, lambda: shuffle_gather(prep, x),
                                 lambda: shuffle_gather_reference(prep, x),
                                 reps=7, inner=5)
    require(torch.equal(k11_pr5(prep, x), shuffle_gather(prep, x)),
            "K11: the earlier design's slot grid differs")
    ms_again, prior_ms = compare_times(torch, lambda: shuffle_gather(prep, x),
                                       lambda: k11_pr5(prep, x), reps=7,
                                       inner=5)
    # The slot-order layout: each slot's column and value read once, each
    # slot written once, x read once; one multiply a live slot.
    nbytes = (prep.n_slots * (prep.ell_cols.element_size() + 4 + 4)
              + 4 * n)
    row("shuffle_gather", "config 2c (slot-order layout)", ms, plain_ms,
        nbytes, nnz, 0.0, lib_ms, n=n, nnz=nnz, n_slots=prep.n_slots,
        batches=prep.n_batches, gather_fill=c2["fill"], ms_again=ms_again,
        prior_design_ms=prior_ms)
    keys, pay = un["sort"]["main"]
    nblk, R, _ = keys.shape
    nel = keys.numel()
    ms, plain_ms = compare_times(
        torch, lambda: sort_blocks((keys, pay)),
        lambda: sort_blocks_reference((keys, pay)), reps=7, inner=5)
    flat_k, flat_p = keys.reshape(nblk, -1), pay.reshape(nblk, -1)

    def library_sort(stable):
        s, order = torch.sort(flat_k, dim=-1, stable=stable)
        return s, flat_p.gather(1, order)

    sort_lib = float(np.median(time_ms(torch, lambda: library_sort(False),
                                       reps=7, inner=5)))
    sort_lib_stable = float(np.median(time_ms(
        torch, lambda: library_sort(True), reps=7, inner=5)))
    stages = plan_stages(R * 128)[2]
    row("sort_blocks", f"({nblk}, {R}, 128) int32 key + float32 payload",
        ms, plain_ms, 2 * 2 * 4 * nel, stages * (nel // 2) * (1 + 2 * 2),
        0.0, sort_lib, dtype="i32 key, f32 payload",
        library_stable_ms=sort_lib_stable, n=nel, nnz=nel,
        ptxas=ptxas_of(("reg17sort_chunk_kernel",)))
    ends = {
        "spmv_shuffle (best_spmv) ms": float(np.median(time_ms(
            torch, lambda: spmv_shuffle(prep, x), reps=7, inner=5))),
        "spmv_csr_segsum ms": float(np.median(time_ms(
            torch, lambda: spmv_csr_segsum(csr, x), reps=7, inner=5))),
        "library csr @ x ms": lib_ms, "nnz": nnz,
        "prepare_shuffle_spmv host s": c2["prepare_s"]}
    for key in ("spmv_shuffle (best_spmv) ms", "spmv_csr_segsum ms",
                "library csr @ x ms"):
        ends[key.replace(" ms", " Gnnz/s")] = nnz / ends[key] / 1e6
    return rows, ends


def dia_host(prep):
    """scipy CSR (float64) of a prepared DIA operand's in-range slots: the
    library yardstick's matrix."""
    import scipy.sparse as ssp

    n, m = prep.shape
    data = prep.data.float().cpu().numpy().astype(np.float64)
    rows, cols, vals = [], [], []
    for k, off in enumerate(prep.offsets):
        i = np.arange(max(0, -off), max(max(0, -off), min(n, m - off)))
        rows.append(i)
        cols.append(i + off)
        vals.append(data[k, i])
    return ssp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(n, m))


def library_csr(torch, n, dev):
    """``torch.sparse_csr_tensor`` of the benchmark matrix ``B`` on the
    card: the library yardstick, timed here and used nowhere in the port."""
    return library_csr_of(torch, *banded_entries(n), (n, n), dev)


def ptxas_of(patterns) -> dict:
    """Registers and spill bytes that ptxas reported for the kernels whose
    (mangled) names hold one of ``patterns``, from the build's log
    (``backend.PTXAS_LOG``), demangled where ``c++filt`` is on PATH."""
    from spsparse_torch import backend

    path = backend.build().parent / backend.PTXAS_LOG
    out, cur = {}, None
    for line in (path.read_text() if path.exists() else "").splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$.]+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    keep = {k: v for k, v in out.items() if any(p in k for p in patterns)}
    if keep and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(keep),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        keep = dict(zip(names, keep.values()))
    return keep


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def run_path(torch, wrappers: dict, path, *args) -> tuple[dict, dict]:
    """Run ``path`` with every launch counter set to 0 just before it;
    return its state and the counts read just after it."""
    for fn in wrappers.values():
        fn.launches = 0
    state = path(*args)
    torch.cuda.synchronize()
    return state, {name: fn.launches for name, fn in wrappers.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import spsparse_torch as sp
    from spsparse_torch import backend
    from spsparse_torch.ops import (best_spmv, cg_solve_dia,
                                    cg_solve_dia_reference, spmm_dia_mrhs,
                                    spmm_dia_mrhs_reference, spmv_dia_chain,
                                    spmv_dia_chain_reference,
                                    spmv_dia_stream,
                                    spmv_dia_stream_reference)
    from spsparse_torch.ops import (spgemm_tiled_pairs, spgemm_tiled_stream,
                                    spgemm_window, spmm_tiled_dense,
                                    spmm_tiled_onehot, spmm_tiled_window)
    from spsparse_torch.ops import (segmented_row_sums, shuffle_gather,
                                    sort_blocks)
    from spsparse_torch.solvers import cg_solve
    from spsparse_torch.utils.roofline import spmv_dia_stats

    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # Phase 1: build and report.
    t0 = time.perf_counter()
    lib_path = backend.build(verbose=True)
    backend.load_kernels()
    log(f"phase 1 build: {lib_path.name} in {time.perf_counter() - t0:.3f} s;"
        f" {json.dumps(backend.device_report())}; nvidia-smi: {smi}")

    wrappers = {"spmv_dia_stream": spmv_dia_stream,
                "spmv_dia_chain": spmv_dia_chain,
                "spmm_dia_mrhs": spmm_dia_mrhs,
                "cg_solve_dia": cg_solve_dia,
                "spmm_tiled_window": spmm_tiled_window,
                "spmm_tiled_dense": spmm_tiled_dense,
                "spmm_tiled_onehot": spmm_tiled_onehot,
                "spgemm_window": spgemm_window,
                "spgemm_tiled_pairs": spgemm_tiled_pairs,
                "spgemm_tiled_stream": spgemm_tiled_stream,
                "segmented_row_sums": segmented_row_sums,
                "shuffle_gather": shuffle_gather,
                "sort_blocks": sort_blocks}
    torch.cuda.reset_peak_memory_stats()
    state, main_counts = run_path(torch, wrappers, main_path, torch, sp, dev)
    log(f"main path kernel launches: {main_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    for name in ("spmv_dia_stream", "spmv_dia_chain"):
        require(main_counts[name] > 0,
                f"kernel {name} was not launched on the main path")
    torch.cuda.reset_peak_memory_stats()
    solve, solve_counts = run_path(torch, wrappers, solve_path, torch, sp,
                                   dev)
    log(f"solve path kernel launches: {solve_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    for name in ("spmm_dia_mrhs", "cg_solve_dia"):
        require(solve_counts[name] > 0,
                f"kernel {name} was not launched on the solve path")
    torch.cuda.reset_peak_memory_stats()
    spmm, spmm_counts = run_path(torch, wrappers, spmm_path, torch, sp, dev)
    log(f"spmm path kernel launches: {spmm_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    spmm_kernels = ("spmm_tiled_window", "spmm_tiled_dense",
                    "spmm_tiled_onehot")
    for name in spmm_kernels:
        require(spmm_counts[name] > 0,
                f"kernel {name} was not launched on the spmm path")
    torch.cuda.reset_peak_memory_stats()
    spg, spgemm_counts = run_path(torch, wrappers, spgemm_path, torch, sp,
                                  dev)
    log(f"spgemm path kernel launches: {spgemm_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    spgemm_kernels = ("spgemm_window", "spgemm_tiled_pairs",
                      "spgemm_tiled_stream")
    for name in spgemm_kernels:
        require(spgemm_counts[name] > 0,
                f"kernel {name} was not launched on the spgemm path")
    torch.cuda.reset_peak_memory_stats()
    un, un_counts = run_path(torch, wrappers, unstructured_path, torch, sp,
                             dev)
    log(f"unstructured path kernel launches: {un_counts}; peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes")
    un_kernels = ("segmented_row_sums", "shuffle_gather", "sort_blocks")
    for name in un_kernels:
        require(un_counts[name] > 0,
                f"kernel {name} was not launched on the unstructured path")
    launches = {**main_counts, **{k: solve_counts[k] for k in
                                  ("spmm_dia_mrhs", "cg_solve_dia")},
                **{k: spmm_counts[k] for k in spmm_kernels},
                **{k: spgemm_counts[k] for k in spgemm_kernels},
                **{k: un_counts[k] for k in un_kernels}}

    # Phase 25: timing, kernel against plain version, in turns; the
    # library call where one PyTorch call computes the same function.
    t_timing = time.perf_counter()
    dia, mrhs = state["dia"], solve["mrhs"]
    x, X = dia["x"], mrhs["X"]
    nnz = state["nnz"]
    A_csr = library_csr(torch, N, dev)
    spmv_lib = float(np.median(time_ms(torch, lambda: A_csr @ x)))
    mrhs_lib = float(np.median(time_ms(torch, lambda: A_csr @ X.T)))
    rows = []
    # K1 on config 2's band (f32, bf16) and on phase 4's operand with the
    # solver path's Poisson offsets (f32): events a call in turns with the
    # plain version ("ms"), the device time a call (torch.profiler) and the
    # host's issue time a call (bursts of calls not waited for).
    P, P_x = dia["P"], dia["P_x"]
    p_nnz = sum(N - abs(o) for o in P.offsets)
    p_lib = torch_csr(torch, dia_host(P), dev)
    k1_cases = (("f32", 4, dia["f32"], x, nnz, spmv_lib, dia["err"]["f32"],
                 "banded", {}),
                ("bf16", 2, dia["bf16"], x, nnz, spmv_lib,
                 dia["err"]["bf16"], "banded", {}),
                ("f32", 4, P, P_x, p_nnz, float(np.median(time_ms(
                    torch, lambda: p_lib @ P_x))),
                 dia["shape_err"]["P's offsets"],
                 "P's offsets (0, +-1, +-1024)", dict(nnz=p_nnz)))
    for dname, item, prep, xv, nz, lib_ms, err, matrix, extra in k1_cases:
        def call(prep=prep, xv=xv):
            return spmv_dia_stream(prep, xv)

        ms, plain_ms = compare_times(
            torch, call, lambda: spmv_dia_stream_reference(prep, xv))
        if dname == "f32" and matrix == "banded":
            # The roofline module's model (U1 holds it to these bytes):
            # the stored diagonals, out-of-range slots included, x and y.
            st = spmv_dia_stats(len(prep.offsets), N)
            nbytes, flops = st.bytes_moved, st.flops
        else:
            nbytes, flops = nz * item + 8 * N, 2 * nz
        b_ms, b_by = bound_ms(nbytes, flops)
        rows.append(dict(name="spmv_dia_stream", dtype=dname,
                         bound_bytes=nbytes,
                         **KERNELS["spmv_dia_stream"],
                         launches=launches["spmv_dia_stream"],
                         max_abs_err=err, ms=ms,
                         device_ms=device_ms(torch, call,
                                             f"spmv_dia_stream {dname}"),
                         host_issue_us=host_issue_us(torch, call),
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, matrix=matrix, **extra))
    prep = dia["f32"]
    chain = (lambda: spmv_dia_chain(prep, x, CHAIN_ITERS, CHAIN_SCALE))
    ms, plain_ms = compare_times(
        torch, chain,
        lambda: spmv_dia_chain_reference(prep, x, CHAIN_ITERS, CHAIN_SCALE))
    b_ms, b_by = bound_ms((CHAIN_ITERS * nnz * 4 + 8 * N) / CHAIN_ITERS,
                          2 * nnz)
    # Per iteration; the library yardstick is one SpMV, one iteration. The
    # host issues one call (64 launches) a chain.
    chain_dev = device_ms(torch, chain, "spmv_dia_chain")
    rows.append(dict(name="spmv_dia_chain", dtype="f32",
                     **KERNELS["spmv_dia_chain"],
                     launches=launches["spmv_dia_chain"],
                     max_abs_err=state["chain_err"], ms=ms / CHAIN_ITERS,
                     device_ms=(None if chain_dev is None
                                else chain_dev / CHAIN_ITERS),
                     host_issue_us=host_issue_us(torch, chain, calls=10,
                                                 bursts=7),
                     plain_ms=plain_ms / CHAIN_ITERS, bound_ms=b_ms,
                     bound_by=b_by, library_ms=spmv_lib))
    for dname, item in (("f32", 4), ("bf16", 2)):
        prep = mrhs[dname]
        ms, plain_ms = compare_times(
            torch, lambda: spmm_dia_mrhs(prep, X),
            lambda: spmm_dia_mrhs_reference(prep, X))
        b_ms, b_by = bound_ms(nnz * item + 2 * RHS * N * 4, 2 * nnz * RHS)
        rows.append(dict(name="spmm_dia_mrhs", dtype=dname,
                         **KERNELS["spmm_dia_mrhs"],
                         launches=launches["spmm_dia_mrhs"],
                         max_abs_err=mrhs["err"][dname], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=mrhs_lib))
    prep_s, b = solve["spd"]["prep"], solve["cg"]["b"]
    cg_ms = per_iteration_ms(torch, {
        "plain": lambda it: cg_solve_dia_reference(prep_s, b, iters=it,
                                                   shift=SHIFT),
        "kernel": lambda it: cg_solve_dia(prep_s, b, iters=it, shift=SHIFT),
        "composed": lambda it: cg_solve(
            lambda v: best_spmv(prep_s, v) + SHIFT * v, b, iters=it)})
    # Per iteration: the diagonals once (b in and x out are per solve and
    # cancel in the difference); 2 flops per stored slot plus the shift.
    b_ms, b_by = bound_ms(nnz * 4, 2 * nnz + 2 * N)
    k4_ptxas = ptxas_of(("cg_kernel",))
    rows.append(dict(name="cg_solve_dia", dtype="f32",
                     **KERNELS["cg_solve_dia"],
                     launches=launches["cg_solve_dia"],
                     max_abs_err=solve["cg"]["err"], ms=cg_ms["kernel"],
                     plain_ms=cg_ms["plain"], bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, matrix="S = (B + B^T)/2",
                     geometry=solve["cg"]["geometry"], ptxas=k4_ptxas))
    rows += cg_timings(torch, solve["cg"]["cases"], launches)
    rows += spmm_timings(torch, spmm, launches)
    spgemm_rows, spgemm_ends = spgemm_timings(torch, spg, launches)
    rows += spgemm_rows
    un_rows, un_ends = unstructured_timings(torch, un, launches)
    rows += un_rows
    torch.cuda.synchronize()
    log(f"phase 25 timing ({time.perf_counter() - t_timing:.3f} s)")

    # The core path runs after the timing so that its host work and the
    # device memory it leaves cached do not reach the kernels' times.
    torch.cuda.reset_peak_memory_stats()
    core, core_counts = run_path(torch, wrappers, core_path, torch, sp, dev)
    log(f"core path kernel launches: {core_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    require(core_counts["spmv_dia_stream"] > 0,
            "kernel spmv_dia_stream was not launched on the core path")
    for row in rows:
        if row["name"] == "spmv_dia_stream":
            row["launches_core_path"] = core_counts["spmv_dia_stream"]

    torch.cuda.reset_peak_memory_stats()
    solver, solver_counts = run_path(torch, wrappers, solver_path, torch, sp,
                                     dev)
    log(f"solver path kernel launches: {solver_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    for name in ("spmv_dia_stream", "spmm_dia_mrhs"):
        require(solver_counts[name] > 0,
                f"kernel {name} was not launched on the solver path")
    for row in rows:
        if row["name"] in ("spmv_dia_stream", "spmm_dia_mrhs"):
            row["launches_solver_path"] = solver_counts[row["name"]]

    torch.cuda.reset_peak_memory_stats()
    graph, graph_counts = run_path(torch, wrappers, graph_path, torch, sp,
                                   dev)
    log(f"graph path kernel launches: {graph_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    require(graph_counts["spmv_dia_stream"] > 0,
            "kernel spmv_dia_stream was not launched on the graph path")
    for row in rows:
        if row["name"] == "spmv_dia_stream":
            row["launches_graph_path"] = graph_counts["spmv_dia_stream"]

    torch.cuda.reset_peak_memory_stats()
    dist_st, dist_counts = run_path(torch, wrappers, dist_path, torch, sp,
                                    dev)
    log(f"distributed path kernel launches: {dist_counts}; peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes")
    for name in DIST_KERNELS:
        require(dist_counts[name] > 0,
                f"kernel {name} was not launched on the distributed path")
    for row in rows:
        row["launches_dist_path"] = dist_counts[row["name"]]

    k1_bytes = next(row["bound_bytes"] for row in rows
                    if row["name"] == "spmv_dia_stream"
                    and row["dtype"] == "f32"
                    and row.get("matrix", "banded") == "banded")
    torch.cuda.reset_peak_memory_stats()
    util, util_counts = run_path(torch, wrappers, utils_path, torch, sp, dev,
                                 N, None, smi, k1_bytes)
    log(f"utils path kernel launches: {util_counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    require(util_counts["spmv_dia_stream"] > 0,
            "kernel spmv_dia_stream was not launched on the utils path")
    for row in rows:
        row["launches_utils_path"] = util_counts[row["name"]]

    for row in rows:
        print(json.dumps({
            "timing": row["name"], "dtype": row["dtype"],
            "matrix": row.get("matrix", "banded"), "n": row.get("n", N),
            "nnz": row.get("nnz", nnz), "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "library_ms": row["library_ms"],
            "device_ms": row.get("device_ms"),
            "device_ms_live": row.get("device_ms_live"),
            "host_issue_us": row.get("host_issue_us"),
            "prior_design_ms": row.get("prior_design_ms"),
            "geometry": row.get("geometry"), "note": row.get("note"),
            "k9_ms": row.get("k9_ms"),
            "dense_bound_ms": row.get("dense_bound_ms"),
            "roofline_share": row["bound_ms"] / row["ms"],
            "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({
        "timing": "cg_solve over K1 (composed)", "n": N, "nnz": nnz,
        "ms_per_iteration": cg_ms["composed"],
        "k4_ms_per_iteration": cg_ms["kernel"], "device": card,
        "nvidia_smi": smi}), flush=True)
    print(json.dumps({"timing": "spgemm entry points, config 4",
                      **spgemm_ends, "device": card, "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"timing": "unstructured SpMV entry points, config 2c",
                      **un_ends, "device": card, "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"timing": "core path, phases C1-C5",
                      "wall_s": core["wall_s"],
                      "peak_bytes": core["peak_bytes"],
                      "n": core["reorder"]["n"],
                      "rcm_host_s": core["reorder"]["rcm_s"],
                      "bandwidth_scrambled": core["reorder"]["bw_scrambled"],
                      "bandwidth_rcm": core["reorder"]["bw"],
                      "k1_launches": core_counts["spmv_dia_stream"],
                      "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"timing": "solver path, phases V0-V6",
                      "wall_s": solver["wall_s"],
                      "peak_bytes": solver["peak_bytes"],
                      "native_available": solver["native"],
                      "amg_level_sizes": solver["amg"]["sizes"],
                      "amg_aggregate_host_s": solver["amg"]["aggregate_s"],
                      "triangular_sweeps": solver["direct"]["sweeps"],
                      "k1_launches": solver_counts["spmv_dia_stream"],
                      "k3_launches": solver_counts["spmm_dia_mrhs"],
                      "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"timing": "graph path, phases G1-G8",
                      "wall_s": graph["wall_s"],
                      "peak_bytes": graph["peak_bytes"],
                      "rounds": graph["rounds"], "syncs": graph["syncs"],
                      "sizes": graph["sizes"],
                      "ladder_host_s": graph["ladder_s"],
                      "lanczos_top_gap": graph["laplacian"]["top_gap"],
                      "lanczos_residuals": graph["laplacian"]["residuals"],
                      "k1_launches": graph_counts["spmv_dia_stream"],
                      "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"timing": "distributed path, phases D0-D9",
                      "wall_s": dist_st["wall_s"],
                      "peak_bytes": dist_st["peak_bytes"],
                      "build_wall_s": dist_st["build_wall"],
                      "pcg_iterations": dist_st["d6"]["iters"],
                      "pcg_residuals": dist_st["d6"]["residual"],
                      "graph_rounds_syncs": dist_st["d7"]["events"],
                      "sharded_bytes": dist_st["d8"]["bytes"],
                      "nccl_pair": dist_st["nccl_pair"],
                      "nccl_pair_refused": dist_st["nccl_pair_refused"],
                      "d9_split_s": dist_st["d9_split_s"],
                      "launches": {k: v for k, v in dist_counts.items()
                                   if v},
                      "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"timing": "utils path, phases U0-U4",
                      "wall_s": util["wall_s"],
                      "peak_bytes": util["peak_bytes"],
                      "hbm_bytes_per_s": util["u1"]["bw"],
                      "k1_f32_bound_bytes": k1_bytes,
                      "k1_sol_ms": util["u1"]["sol_ms"],
                      "bench_chained_ms": util["u2"]["bench_ms"],
                      "time_ms": util["u2"]["time_ms"],
                      "pct_of_roofline": util["u2"]["pct_of_roofline"],
                      "nvtx_depths": util["u3"]["depths"],
                      "validate_s": util["u4"]["ok_s"],
                      "launches": {k: v for k, v in util_counts.items()
                                   if v},
                      "script_wall_s": time.perf_counter() - t_script,
                      "device": card, "nvidia_smi": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
