"""Rank program of the ``GroupMesh`` tests (``tests/test_torch_dist_group.py``;
not a pytest module) and the battery they share with the parent process.

    python tests/torch_dist_worker.py battery|multihost|both RANK WORLD DIR

Each rank joins a Gloo process group through a ``FileStore`` in ``DIR``
(no TCP port), runs on the CPU with one thread, and writes what it
computed to ``DIR/rank<RANK>.pt``:

* ``battery`` (4 ranks): every op of ``spsparse_torch.dist.__all__`` that
  takes a mesh, plus ``DistBlockJacobi``, on a ``GroupMesh`` over the
  world, given the global layouts and again given the layouts
  ``mesh.shard_layout`` made once. The parent runs :func:`run_battery` on
  a ``StackedMesh`` of the same size and holds each rank's blocks against
  its own.
* ``multihost`` (2 ranks): ``multihost.initialize``, ``is_multiprocess``,
  ``pod_mesh``, a ring SpMV across the ranks against the dense oracle,
  ``save_netcdf_sharded(..., parts=my_partitions(4))`` of a 4-way
  partition, and ``save_netcdf_sharded`` of a rank's sharded layout of a
  2-way one; the parent reloads both checkpoints whole.
* ``both`` (4 ranks): ``battery`` in ``DIR/battery``; then the group is
  destroyed, and ranks 0 and 1 run ``multihost`` in a world of two in
  ``DIR/multihost`` (one spawn of processes for both).
"""

import os
import sys

import numpy as np
import torch

P_BATTERY = 4
P_CHECKPOINT = 4
N = 61            # rows of the battery's matrices
BAND = 3


def band_csr(n, band, seed, ncols=None, dtype=np.float64):
    """``(row_ptr, cols, vals)`` host CSR of a band with values from
    ``default_rng(seed)``."""
    import scipy.sparse as sps

    ncols = ncols or n
    rng = np.random.default_rng(seed)
    r, c = [], []
    for off in range(-band, band + 1):
        rr = np.arange(max(0, -off), min(n, ncols - off))
        r.append(rr)
        c.append(rr + off)
    r, c = np.concatenate(r), np.concatenate(c)
    m = sps.csr_matrix((rng.uniform(-1, 1, r.size).astype(dtype), (r, c)),
                       shape=(n, ncols))
    m.sort_indices()
    return m


def torch_csr(m):
    """The port's ``SparseCSR`` (CPU) of a scipy CSR matrix."""
    from spsparse_torch.core.structure import SparseCSR

    return SparseCSR(row_ptr=torch.from_numpy(m.indptr.astype(np.int32)),
                     cols=torch.from_numpy(m.indices.astype(np.int32)),
                     vals=torch.from_numpy(m.data.copy()), nnz=m.nnz,
                     shape=m.shape)


def battery_inputs():
    """The battery's host operands (numpy/scipy), the same in every rank
    and in the parent."""
    rng = np.random.default_rng(11)
    A = band_csr(N, BAND, 1)
    G = band_csr(N, 2, 2)
    G.data = np.abs(G.data) + 0.1
    T = band_csr(300, 2, 3)
    return dict(A=A, G=G, T=T, x=rng.uniform(-1, 1, N),
                X=rng.uniform(-1, 1, (N, 5)))


def run_battery(mesh) -> dict:
    """Every mesh op of ``spsparse_torch.dist`` on the battery's operands;
    each result is the blocks ``mesh`` owns (or, for the components, the
    replicated labels). ``held`` holds the same ops given the layouts
    ``mesh.shard_layout`` made (``held_checks`` what was seen of them)."""
    import spsparse_torch.dist as td
    from spsparse_torch import SparseCOO

    inp = battery_inputs()
    P = mesh.n_parts
    A, G = torch_csr(inp["A"]), torch_csr(inp["G"])
    part = td.partition_rows(A, P, device="cpu")
    xp = td.partition_vector(inp["x"], P, device="cpu")
    Xp = td.partition_vector(inp["X"], P, device="cpu")
    bkt = td.partition_bucketed(A, P, blk_len=xp.shape[1], device="cpu")
    abkt = td.partition_bucketed(A, P, blk_len=part.rows_local,
                                 device="cpu")
    fp = td.partition_footprint(A, P, device="cpu")
    gp = td.partition_rows(G, P, device="cpu")
    T = inp["T"].tocoo()
    Tc = SparseCOO.from_arrays(np.stack([T.row, T.col], 1),
                               T.data.astype(np.float32), T.shape,
                               device="cpu")
    plan = td.plan_dist_spgemm_tiled(Tc, Tc, P)
    pre = td.dist_block_jacobi(A.to_coo(), P, bs=4)
    layouts = dict(part=part, bkt=bkt, abkt=abkt, fp=fp, gp=gp, plan=plan,
                   pre=pre)
    out = ops_on(mesh, xp, Xp, **layouts)
    held = {k: mesh.shard_layout(v) for k, v in layouts.items()}
    out["held"] = ops_on(mesh, xp, Xp, **held)
    halo_raises = False
    try:
        td.dist_spmv_halo(held["part"], xp, mesh, halo=1)
    except ValueError:
        halo_raises = True
    out["held_checks"] = {
        "same_object": all(mesh.shard_layout(v) is v
                           for v in held.values()),
        "leading": sorted({v.owner.parts for v in held.values()}),
        "halo_raises": halo_raises,
    }
    return out


def ops_on(mesh, xp, Xp, *, part, bkt, abkt, fp, gp, plan, pre) -> dict:
    import spsparse_torch.dist as td

    def coo_blocks(res):
        c, ov = res if isinstance(res, tuple) else (res, None)
        out = {"indices": c.indices, "vals": c.vals, "nnz": c.nnz}
        if ov is not None:
            out["overflow"] = ov
        return out

    pre = mesh.shard_layout(pre)
    caps = dict(expand_cap=2048, out_cap=256)
    return {
        "spmv_ring": td.dist_spmv(part, xp, mesh, method="ring"),
        "spmv_all_gather": td.dist_spmv(part, xp, mesh,
                                        method="all_gather"),
        "spmv_bucketed": td.dist_spmv_bucketed(bkt, xp, mesh),
        "spmv_halo": td.dist_spmv_halo(part, xp, mesh, halo=BAND),
        "spmm": td.dist_spmm(part, Xp, mesh),
        "spmm_bucketed": td.dist_spmm_bucketed(bkt, Xp, mesh),
        "spmv_a2a": td.dist_spmv_a2a(fp, xp, mesh),
        "spmm_a2a": td.dist_spmm_a2a(fp, Xp, mesh),
        "spgemm": coo_blocks(td.dist_spgemm(part, part, mesh,
                                            with_overflow=True, **caps)),
        "spgemm_a2a": coo_blocks(td.dist_spgemm_a2a(
            part, part, mesh, req_cap=32, reply_cap=256, **caps)),
        "spgemm_ring": coo_blocks(td.dist_spgemm_ring(
            abkt, part, mesh, expand_cap_step=2048, out_cap=256)),
        "spgemm_tiled": td.dist_spgemm_tiled(plan, mesh).blocks,
        "bellman_ford": td.dist_bellman_ford(gp, [0, N // 2, N - 1], mesh),
        "bfs_levels": td.dist_bfs_levels(gp, [5], mesh),
        "connected_components": td.dist_connected_components(gp, mesh),
        "block_jacobi": pre(mesh.shard(xp)),
    }


def _join(rank: int, world: int, workdir: str, multihost: bool):
    import torch.distributed as dist

    store = dist.FileStore(os.path.join(workdir, "store"), world)
    if multihost:
        from spsparse_torch.dist import multihost as mh

        mh.initialize(backend="gloo", store=store, rank=rank,
                      world_size=world)
    else:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)


def multihost_run(rank: int, workdir: str) -> dict:
    """The two-rank counterpart of ``tests/multihost_worker.py``."""
    import spsparse_torch.dist as td
    from spsparse_torch.dist import multihost as mh
    from spsparse_torch.io import save_netcdf_sharded

    assert mh.is_multiprocess(), "expected 2 processes"
    mesh = mh.pod_mesh()
    A = battery_inputs()["A"]
    x = battery_inputs()["x"]
    part = td.partition_rows(torch_csr(A), mesh.n_parts, device="cpu")
    y = td.dist_spmv(part, td.partition_vector(x, mesh.n_parts,
                                               device="cpu"), mesh,
                     method="ring")
    y_global = mesh.gather(y).reshape(-1)[:N]
    ck = td.partition_rows(torch_csr(A), P_CHECKPOINT, device="cpu")
    mine = list(mh.my_partitions(P_CHECKPOINT))
    save_netcdf_sharded(os.path.join(workdir, "ck"), ck, "A", parts=mine)
    save_netcdf_sharded(os.path.join(workdir, "ck_held"),
                        mesh.shard_layout(part), "A")
    return {"y": y_global, "owns": mine, "n_parts": mesh.n_parts,
            "mesh": repr(mesh)}


def run_mode(mode: str, rank: int, world: int, workdir: str) -> None:
    import torch.distributed as dist

    os.makedirs(workdir, exist_ok=True)
    _join(rank, world, workdir, multihost=mode == "multihost")
    try:
        if mode == "battery":
            from spsparse_torch.dist import GroupMesh

            out = run_battery(GroupMesh())
        else:
            out = multihost_run(rank, workdir)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    mode, rank, world, workdir = argv[1], int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    if mode != "both":
        run_mode(mode, rank, world, workdir)
        return 0
    run_mode("battery", rank, world, os.path.join(workdir, "battery"))
    if rank < 2:
        run_mode("multihost", rank, 2, os.path.join(workdir, "multihost"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
