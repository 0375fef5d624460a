"""Parity of the port's command line (``python -m spsparse_torch.tools``),
``apidoc`` and ``.npz`` files with the JAX package's.

Every subcommand of both CLIs runs in process on the same files, the
port's with ``--device cpu``; their JSON must agree: integers, strings and
flags exactly, floats to rtol 1e-8 (the solvers' arithmetic is the same,
reductions may run in another order), and a solve's floats also to an
atol of 1e-10, for residuals that are rounding noise (a direct solve, or
an exact preconditioner: block Jacobi and ILU on these small operators).
Files written by the two CLIs must hold the same arrays.
``save_npz``/``load_npz`` round-trip against scipy and the JAX package in
both directions, field for field. The golden cases of
``tests/test_tools.py`` (info, convert, stats, each solve method and
preconditioner, eigs and svd, Arnoldi, reorder, the four graph ops with
their outputs, apidoc) are cases here.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from spsparse_tpu import CooBuilder as JBuilder
from spsparse_tpu.io import load_netcdf as j_load
from spsparse_tpu.io import load_npz as j_load_npz
from spsparse_tpu.io import save_netcdf as j_save
from spsparse_tpu.io import save_npz as j_save_npz
from spsparse_tpu.tools.__main__ import main as j_main
from spsparse_torch import CooBuilder as TBuilder, SpSparseError
from spsparse_torch.convert import coo_to_numpy
from spsparse_torch.io import load_netcdf as t_load
from spsparse_torch.io import load_npz as t_load_npz
from spsparse_torch.io import save_npz as t_save_npz
from spsparse_torch.tools import apidoc
from spsparse_torch.tools.__main__ import main as t_main
from port_threads import one_torch_thread  # noqa: F401 (autouse)


def save(path, name, dense):
    ii, jj = np.nonzero(dense)
    b = JBuilder(dense.shape, dtype=np.float64)
    b.add_many(np.stack([ii, jj], 1), dense[ii, jj])
    j_save(path, {name: b.build()})
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    out = {"dir": d}
    m = np.zeros((10, 12))
    m[1, 3], m[4, 4] = 2.0, 5.0
    out["m"] = save(str(d / "m.nc"), "M", m)
    n = 24
    A = (np.diag(rng.uniform(1.5, 2.5, n))
         + np.diag(rng.uniform(0.1, 0.4, n - 1), 1))
    A = A + np.triu(A, 1).T
    out["spd"] = save(str(d / "spd.nc"), "A", A)
    b = JBuilder((n,), dtype=np.float64)
    b.add_many(np.arange(n)[:, None], rng.uniform(-1, 1, n))
    out["rhs"] = str(d / "rhs.nc")
    j_save(out["rhs"], {"b": b.build()})
    G = np.triu(rng.standard_normal((20, 20)), 1) + np.diag(
        rng.uniform(1, 3, 20))
    out["gen"] = save(str(d / "gen.nc"), "A", G)
    band = np.zeros((32, 32))
    v = rng.uniform(0.5, 1.5, 31)
    band[np.arange(31), np.arange(1, 32)] = v
    band[np.arange(1, 32), np.arange(31)] = v
    p = rng.permutation(32)
    out["scr"] = save(str(d / "scr.nc"), "A", band[np.ix_(p, p)])
    g = np.zeros((16, 16))
    r, c = rng.integers(0, 16, 40), rng.integers(0, 16, 40)
    g[r, c] = rng.uniform(0.5, 3.0, 40)
    np.fill_diagonal(g, 0.0)
    out["g"] = save(str(d / "g.nc"), "G", g)
    out["gsym"] = save(str(d / "gsym.nc"), "G", np.maximum(g, g.T))
    return out


def run_both(capsys, argv):
    """The JAX CLI and the port's (on the CPU) on ``argv``: their return
    codes and standard outputs."""
    rj = j_main(argv)
    oj = capsys.readouterr().out
    rt = t_main(argv + ["--device", "cpu"])
    ot = capsys.readouterr().out
    assert rt == rj
    return oj, ot


def same_json(a, b, rtol=1e-8, atol=0.0):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            same_json(a[k], b[k], rtol, atol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            same_json(x, y, rtol, atol)
    elif isinstance(a, float):
        assert isinstance(b, float)
        assert np.isclose(b, a, rtol=rtol, atol=atol), (a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def json_of(out):
    """The JSON object at the start of a CLI's output."""
    return json.loads(out[: out.rindex("}") + 1])


def same_file_arrays(pj, pt, name, rank=None):
    j = j_load(pj, name, rank=rank)
    t = t_load(pt, name, rank=rank, device="cpu")
    ti, tv, tn, tshape, _ = coo_to_numpy(t)
    assert (tn, tshape) == (int(j.nnz), tuple(j.shape))
    np.testing.assert_array_equal(ti[:tn], np.asarray(j.indices)[:tn])
    np.testing.assert_allclose(tv[:tn], np.asarray(j.vals)[:tn], rtol=1e-8,
                               atol=1e-12)


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------

def test_info_convert_stats(files, capsys):
    oj, ot = run_both(capsys, ["info", files["m"]])
    assert ot == oj and "spsparse arrays: M" in ot
    d = files["dir"]
    for version in ("5", "4"):
        pj, pt = str(d / f"cj{version}.nc"), str(d / f"ct{version}.nc")
        assert j_main(["convert", files["m"], pj, "--version", version]) == 0
        assert t_main(["convert", files["m"], pt, "--version", version,
                       "--device", "cpu"]) == 0
        capsys.readouterr()
        oj, ot = run_both(capsys, ["info", pt])
        assert ot == oj
        assert ot.replace(pt, "F") == run_both(
            capsys, ["info", pj])[1].replace(pj, "F")
        same_file_arrays(pj, pt, "M")
        oj, ot = run_both(capsys, ["stats", pt, "M"])
        same_json(json_of(oj), json_of(ot))
    oj, ot = run_both(capsys, ["stats", files["spd"], "A"])
    same_json(json_of(oj), json_of(ot))
    empty = str(d / "empty.nc")
    from spsparse_tpu.io import NcFile, write_cdf
    write_cdf(empty, NcFile(version=5))
    assert t_main(["convert", empty, str(d / "o.nc"), "--device", "cpu"]) \
        == j_main(["convert", empty, str(d / "o.nc")]) == 1


@pytest.mark.parametrize("method,precond,iters", [
    ("cg", "jacobi", "8"), ("cg", "blockjacobi", "6"),
    ("bicgstab", "ilu", "3"),
    ("cgs", "none", "6"), ("tfqmr", "jacobi", "6"), ("minres", "none", "8"),
    ("gmres", "jacobi", "30"), ("direct", "jacobi", "0")])
def test_solve(files, capsys, method, precond, iters):
    d = files["dir"]
    argv = ["solve", files["spd"], "A", "--method", method, "--precond",
            precond, "--iters", iters, "--rhs", files["rhs"] + ":b"]
    oj, ot = run_both(capsys, argv + ["--out", str(d / f"x{method}.nc")])
    same_json(json_of(oj), json_of(ot), atol=1e-10)
    assert "wrote" in ot
    x = t_load(str(d / f"x{method}.nc"), "x", device="cpu").to_dense()
    # the port wrote last: compare against the JAX CLI's own x from a
    # second run into another file
    pj = str(d / f"xj{method}.nc")
    assert j_main(argv + ["--out", pj]) == 0
    capsys.readouterr()
    np.testing.assert_allclose(
        x.numpy(), np.asarray(j_load(pj, "x").to_dense()), rtol=1e-8,
        atol=1e-12)


def test_solve_guards(files, capsys):
    run_both(capsys, ["solve", files["m"], "M"])         # not square: 1


@pytest.mark.parametrize("argv", [
    ["--k", "2", "--which", "LA"], ["--k", "3", "--which", "SA"],
    ["--k", "2", "--svd"]])
def test_eigs(files, capsys, argv):
    oj, ot = run_both(capsys, ["eigs", files["spd"], "A"] + argv)
    same_json(json_of(oj), json_of(ot))


def test_eigs_arnoldi_and_guards(files, capsys):
    oj, ot = run_both(capsys, ["eigs", files["gen"], "A", "--k", "3",
                               "--which", "LM"])
    same_json(json_of(oj), json_of(ot), rtol=1e-6, atol=1e-10)
    oj, ot = run_both(capsys, ["eigs", files["m"], "M", "--k", "1", "--svd",
                               "--iters", "8"])
    same_json(json_of(oj), json_of(ot))
    run_both(capsys, ["eigs", files["m"], "M"])          # rectangular: 1


def test_reorder(files, capsys):
    d = files["dir"]
    pj, pt = str(d / "rj.nc"), str(d / "rt.nc")
    assert j_main(["reorder", files["scr"], pj, "A"]) == 0
    oj = json_of(capsys.readouterr().out)
    assert t_main(["reorder", files["scr"], pt, "A", "--device", "cpu"]) == 0
    ot = json_of(capsys.readouterr().out)
    oj["dst"] = pt
    same_json(oj, ot)
    assert ot["bandwidth_after"] <= 2 < ot["bandwidth_before"]
    same_file_arrays(pj, pt, "A", rank=2)
    same_file_arrays(pj, pt, "A.perm", rank=1)


@pytest.mark.parametrize("graph,argv", [
    ("g", ["--op", "cc"]), ("g", ["--op", "cc", "--strong"]),
    ("g", ["--op", "sssp", "--source", "2"]),
    ("g", ["--op", "sssp", "--source", "0", "--undirected"]),
    ("gsym", ["--op", "mst"]), ("gsym", ["--op", "laplacian"]),
    ("gsym", ["--op", "laplacian", "--normed"])])
def test_graph(files, capsys, graph, argv):
    d = files["dir"]
    oj, ot = run_both(capsys, ["graph", files[graph], "G"] + argv)
    same_json(json_of(oj), json_of(ot))
    if argv[1] == "cc":
        return
    # the --out file of each
    name = {"sssp": "dist", "mst": "G.mst",
            "laplacian": "G.laplacian"}[argv[1]]
    pj, pt = str(d / "oj.nc"), str(d / "ot.nc")
    assert j_main(["graph", files[graph], "G", "--out", pj] + argv) == 0
    assert t_main(["graph", files[graph], "G", "--out", pt, "--device",
                   "cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert '"dst"' in out
    same_file_arrays(pj, pt, name)


def test_cli_needs_cuda_by_default(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_main(["info", files["m"]])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_main(["graph", files["g"], "G"])


def test_apidoc(tmp_path, monkeypatch):
    out = tmp_path / "API_torch.md"
    n = apidoc.generate(str(out))
    assert n > 300
    text = out.read_text()
    for name in ("spsparse_torch.graph", "spsparse_torch.io.npz",
                 "bellman_ford", "RelaxPlan", "save_npz", "SparseCOO"):
        assert name in text
    assert "import failed" not in text
    monkeypatch.setattr(apidoc, "MODULES",
                        apidoc.MODULES + ["spsparse_torch.no_such_module"])
    with pytest.raises(ModuleNotFoundError):
        apidoc.generate(str(tmp_path / "bad.md"))


def test_apidoc_committed_reference_is_current(tmp_path):
    """``docs/API_torch.md`` is what ``apidoc.generate`` writes now: an API
    change that was not regenerated into it fails here."""
    out = tmp_path / "API_torch.md"
    apidoc.generate(str(out))
    committed = os.path.join(apidoc._ROOT, "docs", "API_torch.md")
    with open(committed) as f:
        assert out.read_text() == f.read(), (
            "docs/API_torch.md is stale: run python -m "
            "spsparse_torch.tools.apidoc")


# ----------------------------------------------------------------------
# .npz files
# ----------------------------------------------------------------------

def entries(seed=0, shape=(9, 7), nnz=20):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, shape[0], nnz),
                    rng.integers(0, shape[1], nnz)], 1)
    return idx, rng.uniform(-1, 1, nnz)


def test_save_npz_read_by_scipy_and_jax(tmp_path):
    idx, vals = entries()
    b = TBuilder((9, 7), dtype=np.float64)
    b.add_many(idx, vals)
    t = b.build(device="cpu")
    for compressed in (True, False):
        p = str(tmp_path / f"t{compressed}.npz")
        t_save_npz(p, t, compressed=compressed)
        M = sps.load_npz(p)
        assert M.format == "coo" and M.shape == (9, 7)
        np.testing.assert_array_equal(M.row, idx[:, 0])
        np.testing.assert_array_equal(M.col, idx[:, 1])
        np.testing.assert_array_equal(M.data, vals)
        j = j_load_npz(p)
        ti, tv, tn, tshape, _ = coo_to_numpy(t_load_npz(p, device="cpu"))
        assert (tn, tshape) == (int(j.nnz), tuple(j.shape))
        np.testing.assert_array_equal(ti, np.asarray(j.indices))
        np.testing.assert_array_equal(tv, np.asarray(j.vals))


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc"])
def test_load_npz_from_scipy_and_jax(tmp_path, fmt):
    idx, vals = entries(1)
    M = sps.coo_matrix((vals, (idx[:, 0], idx[:, 1])), shape=(9, 7))
    M = M.asformat(fmt)
    p = str(tmp_path / f"{fmt}.npz")
    sps.save_npz(p, M)
    t = t_load_npz(p, device="cpu")
    j = j_load_npz(p)
    ti, tv, tn, tshape, torder = coo_to_numpy(t)
    assert (tn, tshape, torder) == (int(j.nnz), tuple(j.shape),
                                    j.sort_order)
    np.testing.assert_array_equal(ti, np.asarray(j.indices))
    np.testing.assert_array_equal(tv, np.asarray(j.vals))
    np.testing.assert_array_equal(t.to_dense().numpy(), M.toarray())
    # and the JAX package's own file
    q = str(tmp_path / f"j{fmt}.npz")
    j_save_npz(q, j)
    back = t_load_npz(q, device="cpu")
    np.testing.assert_array_equal(back.to_dense().numpy(), M.toarray())


def test_npz_errors(tmp_path):
    v = TBuilder((5,), dtype=np.float64).build(device="cpu")
    with pytest.raises(SpSparseError, match="rank-2"):
        t_save_npz(str(tmp_path / "v.npz"), v)
    p = str(tmp_path / "bad.npz")
    np.savez(p, format=np.bytes_(b"coo"), shape=np.array([2, 2]))
    with pytest.raises(SpSparseError, match="missing member"):
        t_load_npz(p, device="cpu")
    q = str(tmp_path / "dia.npz")
    np.savez(q, format="dia", shape=np.array([2, 2]), data=np.zeros(1))
    with pytest.raises(SpSparseError, match="unsupported"):
        t_load_npz(q, device="cpu")


# ----------------------------------------------------------------------
# chip_smoke.graph_path, rehearsed
# ----------------------------------------------------------------------

def test_chip_smoke_graph_path_rehearsal():
    """``chip_smoke.graph_path`` on a 32 x 32 grid, a 4096-node digraph and
    small host-tier graphs (CPU, the CLI with ``--device cpu``): every
    phase's checks against scipy run, and the device loops log their
    rounds."""
    import chip_smoke
    import spsparse_torch as tsp

    st = chip_smoke.graph_path(
        torch, tsp, "cpu", side=32, n=1 << 12, host_n=1 << 10, fw_n=256,
        match_n=128, ladder_n=1000, flow_n=512, path_side=8,
        reorder_n=1 << 10)
    assert set(st["wall_s"]) == {f"G{i}" for i in range(9)}
    assert st["rounds"]["G2"] > 0 and st["syncs"]["G4"] > 0
    assert st["laplacian"]["diags"] == 5
