"""The distributed layer on a ``GroupMesh``: one partition a rank of a Gloo
process group on the CPU, against the ``StackedMesh`` run of the same ops.

One spawn of four processes in all (each rank is
``tests/torch_dist_worker.py both``, joined through a ``FileStore`` under
``tmp_path``, one thread, the whole spawn bounded at 180 s so that a hung
rank fails its cases instead of the suite's clock):

* 4 ranks run the battery (every op of ``spsparse_torch.dist.__all__``
  that takes a mesh, plus ``DistBlockJacobi``); each rank's blocks must
  equal the ``StackedMesh(4)`` run's (float64: rtol 1e-12, integers
  exactly) and, assembled, the float64 oracle; given the layouts
  ``mesh.shard_layout`` made once (a rank's own blocks only), each op
  gives what it gives on the global layouts, bit for bit;
* then, in a world of their own, ranks 0 and 1 run the counterpart of
  ``tests/multihost_worker.py``:
  ``multihost.initialize``, ``pod_mesh``, a ring SpMV across the ranks,
  and two sharded checkpoints, one written a rank's partitions at a time
  and one from each rank's sharded layout, which both packages read back
  whole here.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.csgraph as csgraph
import torch

import torch_dist_worker as w
from port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 180
RTOL = 1e-12


def spawn(mode: str, world: int, workdir: Path) -> dict:
    """Run ``world`` ranks of the worker; return each rank's exit code,
    output and saved results (None where it saved none)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(w.__file__)), mode, str(r), str(world),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                out = b"rank timed out"
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"rcs": [p.returncode for p in procs], "outs": outs}


def results(run: dict, workdir: Path, world: int) -> dict:
    """Each of ``world`` ranks' exit code, output and results saved in
    ``workdir`` (None where it saved none)."""
    ranks = []
    for r in range(world):
        path = workdir / f"rank{r}.pt"
        ranks.append({"rc": run["rcs"][r], "out": run["outs"][r],
                      "res": torch.load(path) if path.exists() else None})
    return {"ranks": ranks}


def ok(run: dict) -> list:
    for r, rank in enumerate(run["ranks"]):
        assert rank["rc"] == 0 and rank["res"] is not None, (
            f"rank {r} failed (rc {rank['rc']}):\n{rank['out'][-3000:]}")
    return [rank["res"] for rank in run["ranks"]]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The one spawn of 4 ranks: the battery, then the 2-rank multihost
    run on ranks 0 and 1."""
    workdir = tmp_path_factory.mktemp("group")
    return workdir, spawn("both", w.P_BATTERY, workdir)


@pytest.fixture(scope="module")
def battery(spawned):
    """The 4 ranks' battery, and the same battery on ``StackedMesh(4)``."""
    from spsparse_torch.dist import StackedMesh

    workdir, run = spawned
    out = results(run, workdir / "battery", w.P_BATTERY)
    out["stacked"] = w.run_battery(StackedMesh(w.P_BATTERY, "cpu"))
    return out


@pytest.fixture(scope="module")
def multihost(spawned):
    workdir, run = spawned
    out = results(run, workdir / "multihost", 2)
    out["dir"] = workdir / "multihost"
    return out


OPS = ["spmv_ring", "spmv_all_gather", "spmv_bucketed", "spmv_halo", "spmm",
       "spmm_bucketed", "spmv_a2a", "spmm_a2a", "spgemm", "spgemm_a2a",
       "spgemm_ring", "spgemm_tiled", "bellman_ford", "bfs_levels",
       "connected_components", "block_jacobi"]
REPLICATED = ("connected_components",)


def fields(v) -> dict:
    return v if isinstance(v, dict) else {"": v}


def stacked_block(name, t, r):
    """Rank ``r``'s share of the stacked run's result."""
    if name in REPLICATED:
        return t
    if name == "spgemm_tiled":
        return t.reshape(w.P_BATTERY, -1, 128, 128)[r]
    return t[r:r + 1]


def same(got, want):
    if got.dtype.is_floating_point:
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(), rtol=RTOL,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", OPS)
def test_group_ranks_equal_stacked_mesh(name, battery):
    ranks = ok(battery)
    for r, res in enumerate(ranks):
        for k, t in fields(battery["stacked"][name]).items():
            got = fields(res[name])[k]
            if name == "spgemm_tiled":
                got = got.reshape(-1, 128, 128)
            same(got, stacked_block(name, t, r))


@pytest.mark.parametrize("name", OPS)
def test_group_held_layouts_equal_global(name, battery):
    """The ops given ``mesh.shard_layout``'s layouts compute what they do
    on the global ones, on every rank and on the stacked mesh."""
    for res in ok(battery) + [battery["stacked"]]:
        for k, t in fields(res[name]).items():
            got = fields(res["held"][name])[k]
            assert got.dtype == t.dtype
            np.testing.assert_array_equal(got.numpy(), t.numpy())


def test_group_shard_layout_holds_own_blocks_once(battery):
    for r, res in enumerate(ok(battery)):
        checks = res["held_checks"]
        assert checks["same_object"]
        assert checks["leading"] == [(r,)]
        assert checks["halo_raises"]
    stacked = battery["stacked"]["held_checks"]
    assert stacked["leading"] == [tuple(range(w.P_BATTERY))]
    assert stacked["same_object"] and stacked["halo_raises"]


def oracle(name):
    """The float64 reference of op ``name`` on the battery's operands."""
    inp = w.battery_inputs()
    A, G, T = inp["A"].toarray(), inp["G"], inp["T"].toarray()
    n = w.N
    if name in ("spmv_ring", "spmv_all_gather", "spmv_bucketed",
                "spmv_halo", "spmv_a2a"):
        return A @ inp["x"]
    if name in ("spmm", "spmm_bucketed", "spmm_a2a"):
        return A @ inp["X"]
    if name.startswith("spgemm") and name != "spgemm_tiled":
        return A @ A
    if name == "spgemm_tiled":
        t32 = T.astype(np.float32).astype(np.float64)
        return t32 @ t32.T
    if name == "bellman_ford":
        return csgraph.dijkstra(G, indices=[0, n // 2, n - 1]).T
    if name == "bfs_levels":
        return csgraph.shortest_path(G, unweighted=True, indices=[5]).T
    if name == "connected_components":
        return csgraph.connected_components(G, directed=False)[1]
    # block_jacobi: 4 x 4 diagonal blocks of A padded to P * rows_local
    # rows, a unit diagonal where A's is empty, applied to x
    rl = -(-n // w.P_BATTERY)
    m = w.P_BATTERY * rl
    D = np.zeros((m, m))
    D[:n, :n] = A
    x = np.zeros(m)
    x[:n] = inp["x"]
    z = []
    for i in range(0, m, 4):
        blk = D[i:i + 4, i:i + 4].copy()
        blk[np.diag_indices(4)] += np.abs(np.diag(blk)) <= 1e-12
        z.append(np.linalg.solve(blk, x[i:i + 4]))
    return np.concatenate(z)[:n]


def assembled(name, ranks):
    from spsparse_torch.dist import RowPartitionedCOO
    from spsparse_torch.ops.spgemm_tiled import TiledBlocks

    n = w.N
    if name in REPLICATED:
        return ranks[0][name][:n].numpy()
    if name.startswith("spgemm") and name != "spgemm_tiled":
        rl = -(-n // w.P_BATTERY)
        out = np.zeros((n, n))
        for r, res in enumerate(ranks):
            f = res[name]
            coo = RowPartitionedCOO(indices=f["indices"], vals=f["vals"],
                                    nnz=f["nnz"], shape=(n, n),
                                    rows_local=rl, parts=(r,)).to_coo()
            out += coo.to_dense().numpy()
        return out
    if name == "spgemm_tiled":
        from spsparse_torch.dist import plan_dist_spgemm_tiled
        from spsparse_torch import SparseCOO

        T = w.battery_inputs()["T"].tocoo()
        Tc = SparseCOO.from_arrays(np.stack([T.row, T.col], 1),
                                   T.data.astype(np.float32), T.shape,
                                   device="cpu")
        plan = plan_dist_spgemm_tiled(Tc, Tc, w.P_BATTERY)
        blocks = torch.cat([res[name].reshape(-1, 128, 128)
                            for res in ranks])
        tb = TiledBlocks(
            tile_row=torch.from_numpy(plan.out_tile_row.reshape(-1)),
            tile_col=torch.from_numpy(plan.out_tile_col.reshape(-1)),
            blocks=blocks, shape=plan.out_shape)
        return tb.to_dense().numpy()
    y = torch.cat([res[name] for res in ranks])
    return y.reshape((-1,) + tuple(y.shape[2:]))[:n].numpy()


@pytest.mark.parametrize("name", OPS)
def test_group_ranks_match_oracle(name, battery):
    got, want = assembled(name, ok(battery)), oracle(name)
    if name == "connected_components":
        # same partition of the nodes, first-occurrence numbering
        _, first = np.unique(want, return_index=True)
        remap = np.empty(first.size, np.int64)
        remap[np.argsort(np.argsort(first))] = np.arange(first.size)
        np.testing.assert_array_equal(got, remap[want])
        return
    rtol = 1e-5 if name == "spgemm_tiled" else RTOL
    scale = max(np.abs(want[np.isfinite(want)]).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_multihost_ring_spmv_across_ranks(multihost):
    ranks = ok(multihost)
    inp = w.battery_inputs()
    for res in ranks:
        assert res["n_parts"] == 2 and "GroupMesh" in res["mesh"]
        np.testing.assert_allclose(res["y"].numpy(),
                                   inp["A"].toarray() @ inp["x"],
                                   rtol=RTOL, atol=RTOL)


def test_multihost_ranks_own_partitions_modulo_world(multihost):
    owns = [res["owns"] for res in ok(multihost)]
    assert owns == [[0, 2], [1, 3]]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_multihost_checkpoint_reads_back_whole(reader, multihost):
    read_back_whole("ck", reader, multihost)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_multihost_held_layout_checkpoint_reads_back_whole(reader,
                                                           multihost):
    read_back_whole("ck_held", reader, multihost)


def read_back_whole(ck, reader, multihost):
    ok(multihost)
    prefix = str(multihost["dir"] / ck)
    if reader == "port":
        from spsparse_torch.io import load_netcdf_sharded

        back = load_netcdf_sharded(prefix, device="cpu")
        dense_back = back.to_dense().numpy()
    else:
        from spsparse_tpu.io.sharded import load_netcdf_sharded

        dense_back = np.asarray(load_netcdf_sharded(prefix).to_dense())
    np.testing.assert_array_equal(dense_back[:w.N],
                                  w.battery_inputs()["A"].toarray())
