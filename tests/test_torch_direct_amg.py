"""The port's native host binding (``spsparse_torch/native.py``), direct
solvers (``solvers/direct.py``), AMG (``solvers/amg.py``), the scipy-style
eigen entry points (``solvers/eigs_api.py``), ``inv``/``expm``
(``solvers/matfuncs.py``) and ``plan_esc(host=True)`` against the JAX
package, on the CPU, plus the ``chip_smoke.solver_path`` rehearsal.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` (x64
is on, ``tests/conftest.py``) and ``spsparse_torch``. Each JAX reference is
computed once per module.

Tolerances: the native binding, ``splu``'s factors and permutations and the
AMG aggregates are exact (the same C++, built with the same fused
multiply-adds, and the same host loops); the planned product with host
consolidation equal bit for bit; float64 solves, V-cycles, eigenvalues and
matrix functions rtol 1e-8 (atol 1e-12 of the largest entry); the float32
device sweep rtol 1e-5; eigenvectors up to sign within 1e-7.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spsparse_torch as tsp
import spsparse_tpu as jsp
import spsparse_tpu.native as jn
import spsparse_tpu.solvers as js
from spsparse_torch import native as tn
from spsparse_torch import solvers as ts
from spsparse_torch.convert import coo_to_numpy
from port_threads import one_torch_thread  # noqa: F401 (autouse)

jdirect = importlib.import_module("spsparse_tpu.solvers.direct")
tdirect = importlib.import_module("spsparse_torch.solvers.direct")
jamg = importlib.import_module("spsparse_tpu.solvers.amg")
tamg = importlib.import_module("spsparse_torch.solvers.amg")

N = 40


def both(dense):
    """The nonzeros of ``dense`` as a float64 COO in each package, marked
    row-major consolidated (``np.nonzero`` lists them so, once each): the
    JAX package's eager consolidate compiles for seconds per capacity, and
    the entry points skip it for consolidated operands."""
    ii, jj = np.nonzero(dense)
    idx, v = np.stack([ii, jj], 1), dense[ii, jj]
    return (jsp.SparseCOO.from_arrays(idx, v, dense.shape, sort_order=(0, 1)),
            tsp.SparseCOO.from_arrays(idx, v, dense.shape, sort_order=(0, 1),
                                      device="cpu"))


def poisson(m):
    n = m * m
    A = 4.0 * np.eye(n)
    for i in range(n):
        x = i % m
        for j, ok in ((i - m, i >= m), (i - 1, x > 0), (i + 1, x < m - 1),
                      (i + m, i < n - m)):
            if ok:
                A[i, j] = -1.0
    return A


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(7)
    G = np.where(rng.random((N, N)) < 0.12, rng.uniform(-1, 1, (N, N)), 0.0)
    G[np.arange(N), np.arange(N)] = rng.uniform(0.2, 0.6, N)  # pivots
    L = np.tril(np.where(rng.random((96, 96)) < 0.08,
                         rng.uniform(-0.3, 0.3, (96, 96)), 0.0), -1)
    L[np.arange(96), np.arange(96)] = rng.uniform(1.0, 2.0, 96)
    P = poisson(12)
    # distinct eigenvalues; 32 rows keep the JAX package's consolidate
    # capacities those of Q's operands, whose compiles it then reuses
    i = np.arange(32)
    T = np.diag(2.0 + 0.01 * i) - np.eye(32, k=1) - np.eye(32, k=-1)
    # a 1-D operator whose AMG hierarchy has one level above the coarsest
    i = np.arange(12)
    Q = np.diag(2.0 + 0.01 * i) - np.eye(12, k=1) - np.eye(12, k=-1)
    return {"G": (G, *both(G)), "L": (L, *both(L)), "P": (P, *both(P)),
            "T": (T, *both(T)), "Q": (Q, *both(Q)), "rng": rng, "refs": {}}


def ref(mats, key, fn):
    if key not in mats["refs"]:
        mats["refs"][key] = fn()
    return mats["refs"][key]


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def assert_close(got, want, rtol=1e-8):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    floor = 1e-12 * max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


# ----------------------------------------------------------------------
# The native binding
# ----------------------------------------------------------------------
def _csc(A):
    """``(colptr, rowind, val)`` of a dense matrix's nonzeros."""
    nz = [np.nonzero(A[:, j])[0] for j in range(A.shape[1])]
    return (np.concatenate([[0], np.cumsum([r.size for r in nz])]),
            np.concatenate(nz), np.concatenate(
                [A[r, j] for j, r in enumerate(nz)]))


def _native_cases(mod, rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    idx = rng.integers(0, 12, (400, 2))
    vals = rng.standard_normal(400)
    vals[::7] = 0.0
    vals[::11] = np.nan
    lead = np.sort(rng.integers(0, 30, 100))
    A = np.where(rng.random((30, 30)) < 0.2, rng.standard_normal((30, 30)),
                 0.0) + np.diag(rng.uniform(0.1, 1.0, 30))
    cp, ri, va = _csc(A)
    pc = rng.permutation(30)
    L, U = _csc(np.tril(A)), _csc(np.triu(A))
    B = rng.standard_normal((30, 2))
    return {
        "consolidate_add": lambda P: mod.consolidate_host(
            idx, np.nan_to_num(vals), (12, 12), duplicate_policy=P.ADD),
        "consolidate_replace_colmajor": lambda P: mod.consolidate_host(
            idx, np.nan_to_num(vals), (12, 12), (1, 0),
            duplicate_policy=P.REPLACE),
        "consolidate_leave_alone_zero_nan": lambda P: mod.consolidate_host(
            idx, vals, (12, 12), duplicate_policy=P.LEAVE_ALONE,
            zero_nan=True),
        "dim_beginnings": lambda P: mod.dim_beginnings_host(lead),
        "csr_row_ptr": lambda P: (mod.csr_row_ptr_host(lead, 30),),
        "check_bounds": lambda P: (np.asarray(mod.check_bounds_host(
            np.concatenate([idx, [[3, 12]]]), (12, 12))),),
        "lu": lambda P: mod.lu_factor_host(30, cp, ri, va, pc),
        "lu_threshold": lambda P: mod.lu_factor_host(
            30, cp, ri, va, pc, pivot_threshold=0.1),
        "ilut": lambda P: mod.lu_factor_host(
            30, cp, ri, va, pc, drop_tol=0.05, max_keep_l=3, max_keep_u=3),
        "trisolve_lower": lambda P: (mod.trisolve_host(
            30, *L, B, lower=True),),
        "trisolve_upper_unit": lambda P: (mod.trisolve_host(
            30, *U, B[:, 0], lower=False, unit_diagonal=True),),
    }


def _flatten(out):
    if isinstance(out, tuple):
        return [a for o in out for a in _flatten(o)]
    return [np.asarray(out)]


NATIVE = list(_native_cases(tn))


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("case", NATIVE)
def test_native_matches_jax(monkeypatch, case, backend):
    """Each entry point equals the JAX package's bit for bit, through the
    C++ library and through the numpy fallbacks (``_lib`` returns None in
    both packages)."""
    from spsparse_torch.core.errors import DuplicatePolicy as TP
    from spsparse_tpu.core.errors import DuplicatePolicy as JP
    if backend == "numpy":
        monkeypatch.setattr(tn, "_lib", lambda: None)
        monkeypatch.setattr(jn, "_lib", lambda: None)
    got = _flatten(_native_cases(tn)[case](TP))
    want = _flatten(_native_cases(jn)[case](JP))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_native_builds_from_sources():
    """The port's library is built from ``csrc/*.cpp`` into
    ``spsparse_torch/_kernels/host-<hash>/``, never the tracked
    ``csrc/libspsparse_host.so``."""
    assert tn.available()
    lib = tn.build()
    assert lib.parent.parent == tn.KERNEL_DIR
    assert lib.parent.name.startswith("host-")
    assert tn._lib()._name == str(lib)
    assert [s.name for s in tn.SOURCES] == ["spsparse_host.cpp",
                                            "spsparse_lu.cpp"]


def test_native_singular_and_zero_diagonal_raise():
    cp = np.array([0, 1, 1])
    with pytest.raises(ValueError, match="singular at column 1"):
        tn.lu_factor_host(2, cp, np.array([0]), np.array([1.0]))
    with pytest.raises(ValueError, match="zero diagonal at column 0"):
        tn.trisolve_host(2, np.array([0, 0, 1]), np.array([1]),
                         np.array([1.0]), np.ones(2), lower=True)


# ----------------------------------------------------------------------
# Direct solvers
# ----------------------------------------------------------------------
def _factors(lu):
    return [lu._lplan.colptr, lu._lplan.rowind, lu._lplan.val,
            lu._uplan.colptr, lu._uplan.rowind, lu._uplan.val,
            lu.perm_r, lu.perm_c, np.asarray(lu.nnz)]


SPLU = ["NATURAL", "RCM", "threshold", "spilu"]


@pytest.mark.parametrize("case", SPLU)
def test_splu_matches_jax(mats, case):
    """L, U, perm_r and perm_c exact; ``Pr A Pc = L U`` from the port's
    factor COOs; solves of ``A x = b`` and ``A^T x = b`` (host route)
    rtol 1e-8."""
    G, jA, tA = mats["G"]
    kw = {"NATURAL": dict(permc_spec="NATURAL"),
          "RCM": dict(permc_spec="RCM"),
          "threshold": dict(pivot_threshold=0.1),
          "spilu": dict(drop_tol=0.05, fill_factor=2.0)}[case]
    make = (lambda m, a: m.spilu(a, solve_method="host", **kw)) \
        if case == "spilu" else \
        (lambda m, a: m.splu(a, solve_method="host", **kw))
    jlu, tlu = make(js, jA), make(ts, tA)
    for g, w in zip(_factors(tlu), _factors(jlu)):
        np.testing.assert_array_equal(g, w)
    n = G.shape[0]
    Pr = np.zeros((n, n))
    Pr[tlu.perm_r, np.arange(n)] = 1
    Pc = np.zeros((n, n))
    Pc[np.arange(n), tlu.perm_c] = 1
    LU = tlu.L.to_dense().numpy() @ tlu.U.to_dense().numpy()
    if case != "spilu":
        np.testing.assert_allclose(Pr @ G @ Pc, LU, atol=1e-12)
    b = np.linspace(-1, 2, n)
    for trans in ("N", "T"):
        want = ref(mats, ("splu", case, trans),
                   lambda: jlu.solve(jnp.asarray(b), trans=trans))
        assert_close(tlu.solve(t64(b), trans=trans), want)


LAYOUTS = ["dia", "ell", "coo", "host", "dia_f32", "upper_multi_rhs"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spsolve_triangular_matches_jax(mats, monkeypatch, layout):
    """Each sweep layout (forced in both packages by their layout limits)
    and the host route: the same layout as the JAX package, solutions rtol
    1e-8 in float64, 1e-5 for the float32 DIA sweep (kernel K1's plain
    version)."""
    L, jL, tL = mats["L"]
    n = L.shape[0]
    if layout in ("ell", "coo"):
        for mod in (jdirect, tdirect):
            monkeypatch.setattr(mod, "_DIA_MAX_OFFSETS", 0)
            if layout == "coo":
                monkeypatch.setattr(mod, "_ELL_MAX_WIDTH", 1)
    lower, b = True, np.cos(np.arange(n))
    if layout == "upper_multi_rhs":
        lower, b = False, np.stack([b, np.sin(np.arange(n))], 1)
        jL, tL = both(L.T.copy())[0], both(L.T.copy())[1]
    method = "host" if layout == "host" else "device"
    dt = np.float32 if layout == "dia_f32" else np.float64
    want = ref(mats, ("tri", layout), lambda: js.spsolve_triangular(
        jL, jnp.asarray(b.astype(dt)), lower=lower, method=method))
    got = ts.spsolve_triangular(tL, torch.as_tensor(b.astype(dt)),
                                lower=lower, method=method)
    assert got.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
    assert_close(got, np.asarray(want), rtol=1e-5 if dt == np.float32
                 else 1e-8)
    colptr, rowind, val = tdirect._coo_to_csc_host(tL)
    plan = tdirect._TriPlan(n, colptr, rowind, val, lower=lower)
    jplan = jdirect._TriPlan(n, *jdirect._coo_to_csc_host(jL), lower=lower)
    assert (plan.kind, plan.nlev) == (jplan.kind, jplan.nlev)
    assert plan.kind == {"ell": "ell", "coo": "coo"}.get(layout, "dia")


def test_auto_route_and_levels(mats):
    """``auto`` takes the sweeps for a shallow factor and the host for a
    deep one (the JAX package's rule off the TPU); the levels equal the JAX
    package's."""
    L, jL, tL = mats["L"]
    n = L.shape[0]
    args = tdirect._coo_to_csc_host(tL)
    plan = tdirect._TriPlan(n, *args, lower=True)
    jplan = jdirect._TriPlan(n, *jdirect._coo_to_csc_host(jL), lower=True)
    np.testing.assert_array_equal(
        tdirect._levels_from_csc(n, args[0], args[1], lower=True),
        jdirect._levels_from_csc(n, *jdirect._coo_to_csc_host(jL)[:2],
                                 lower=True))
    assert plan.route() == ("device" if plan.nlev <= 64 else "host")
    chain = np.eye(n) + np.diag(np.full(n - 1, 0.5), -1)   # nlev = n
    tc = both(chain)[1]
    deep = tdirect._TriPlan(n, *tdirect._coo_to_csc_host(tc), lower=True)
    assert deep.nlev == n and deep.route() == "host"
    assert deep.route("device") == "device"


def test_spsolve_factorized_and_errors(mats):
    """``spsolve`` with a dense (n, 2) and a sparse right-hand side and
    ``factorized`` against the JAX package (rtol 1e-8); singular and
    missing-diagonal inputs raise as there."""
    G, jA, tA = mats["G"]
    B = np.stack([np.ones(N), np.arange(N, dtype=float)], 1)
    want = ref(mats, "spsolve", lambda: js.spsolve(jA, jnp.asarray(B),
                                                   solve_method="host"))
    assert_close(ts.spsolve(tA, t64(B), solve_method="host"), want)
    assert_close(ts.factorized(tA, solve_method="host")(t64(B[:, 1])),
                 np.asarray(want)[:, 1])
    sb = both(np.diag(np.arange(1.0, N + 1)))[1]
    xs = ts.spsolve(tA, sb, solve_method="host")
    assert isinstance(xs, tsp.SparseCOO)
    assert_close(xs.to_dense(), np.linalg.solve(G, np.diag(
        np.arange(1.0, N + 1))), rtol=1e-8)
    sing = both(np.diag(np.r_[1.0, 0.0, np.ones(N - 2)]))[1]
    with pytest.raises(tsp.SpSparseError, match="splu"):
        ts.splu(sing)
    nodiag = both(np.tril(np.ones((4, 4)), -1) + np.diag([1, 0, 1, 1.0]))[1]
    with pytest.raises(tsp.SpSparseError, match="missing diagonal"):
        ts.spsolve_triangular(nodiag, torch.ones(4, dtype=torch.float64))


# ----------------------------------------------------------------------
# AMG
# ----------------------------------------------------------------------
def _level_arrays(h, to_np):
    out = []
    for lvl in h.levels:
        out += [to_np(lvl.a.to_dense()), to_np(lvl.dinv)]
        if lvl.p is not None:
            out += [to_np(lvl.p.to_dense()), to_np(lvl.pt.to_dense())]
    return out + [to_np(h.coarse_dense)]


def test_amg_aggregates_match_jax(mats):
    """The strength graph and greedy aggregates of the Poisson operator and
    of a random SPD matrix equal the JAX package's element for element."""
    rng = np.random.default_rng(5)
    R = np.where(rng.random((80, 80)) < 0.05, rng.uniform(-1, 1, (80, 80)),
                 0.0)
    R = R + R.T + np.diag(np.full(80, 6.0))
    for A in (mats["P"][0], R):
        r, c = np.nonzero(A)
        v, d = A[r, c], np.diag(A).copy()
        sj = jamg._strength_graph(r, c, v, d, A.shape[0], 0.08)
        st = tamg._strength_graph(r, c, v, d, A.shape[0], 0.08)
        for g, w in zip(st, sj):
            np.testing.assert_array_equal(g, w)
        aj, nj = jamg._greedy_aggregate(A.shape[0], *sj)
        at, nt = tamg._greedy_aggregate(A.shape[0], *st)
        assert nt == nj
        np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("op", ["Q", "P"])
def test_amg_setup_and_vcycle(mats, op):
    """Q (12 rows, coarse size 4): the hierarchy equals the JAX package's,
    level sizes exact, operators, smoothers, prolongators and the coarsest
    matrix rtol 1e-8, and one V-cycle of a vector rtol 1e-8 (the JAX
    package's setup compiles for about 20 s on the CPU, so it is run at
    this one size). P (144 rows, coarse size 8, three levels): the port's
    Galerkin identity ``A_c = P^T A P`` per level (rtol 1e-12) and
    AMG-preconditioned CG to 1e-8 in 20 iterations."""
    A, jA, tA = mats[op]
    cs = 4 if op == "Q" else 8
    th = ts.amg_setup(tA, coarse_size=cs)
    r = np.sin(np.arange(A.shape[0]))
    if op == "Q":
        jh = ref(mats, "amg", lambda: js.amg_setup(jA, coarse_size=cs))
        assert [lvl.a.shape for lvl in th.levels] == \
            [lvl.a.shape for lvl in jh.levels]
        for g, w in zip(_level_arrays(th, lambda t: t.numpy()),
                        _level_arrays(jh, np.asarray)):
            assert_close(g, w)
        want = ref(mats, "vcycle", lambda: jh(jnp.asarray(r)))
        assert_close(th(t64(r)), want)
    assert len(th.levels) >= 2
    for fine, coarse in zip(th.levels, th.levels[1:]):
        Pd = fine.p.to_dense().numpy()
        np.testing.assert_allclose(
            Pd.T @ fine.a.to_dense().numpy() @ Pd,
            coarse.a.to_dense().numpy(), rtol=1e-12, atol=1e-12)
    x, _ = ts.pcg_solve(lambda v: t64(A) @ v, t64(r), iters=20, minv=th)
    assert np.linalg.norm(A @ x.numpy() - r) < 1e-8 * np.linalg.norm(r)


# ----------------------------------------------------------------------
# eigs / eigsh, inv / expm
# ----------------------------------------------------------------------
EIGS = ["eigsh_sigma", "eigsh_LM", "eigs_sigma"]


@pytest.mark.parametrize("case", EIGS)
def test_eigs_api_matches_jax(mats, case):
    """Shift-invert ``eigsh``/``eigs`` (through ``splu`` with RCM) and
    ``eigsh(which='LM')`` on a tridiagonal operator with distinct
    eigenvalues: values rtol 1e-8, ``eigsh``'s vectors up to sign; the
    values against numpy too."""
    P, jP, tP = mats["T"]
    if case == "eigsh_sigma":
        jv, jV = ref(mats, case, lambda: js.eigsh(jP, k=3, sigma=2.1))
        tv, tV = ts.eigsh(tP, k=3, sigma=2.1)
        exact = np.sort(np.linalg.eigvalsh(P)[np.argsort(np.abs(
            np.linalg.eigvalsh(P) - 2.1))[:3]])
    elif case == "eigsh_LM":
        jv, jV = ref(mats, case, lambda: js.eigsh(jP, k=3))
        tv, tV = ts.eigsh(tP, k=3)
        exact = np.sort(np.linalg.eigvalsh(P))[-3:]
    else:
        jv, jV = ref(mats, case, lambda: js.eigs(jP, k=2, sigma=2.1,
                                                 ncv=40, restarts=2))
        tv, tV = ts.eigs(tP, k=2, sigma=2.1, ncv=40, restarts=2)
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-8)
        return
    assert_close(tv, jv)
    np.testing.assert_allclose(tv.numpy(), exact, rtol=1e-8)
    for c in range(3):
        s = np.sign(np.dot(tV[:, c].numpy(), np.asarray(jV)[:, c]))
        np.testing.assert_allclose(s * tV[:, c].numpy(),
                                   np.asarray(jV)[:, c], atol=1e-7)


@pytest.mark.parametrize("fn", ["inv", "expm"])
def test_matfuncs_match_jax(mats, fn):
    """``inv`` of the 32-row tridiagonal and ``expm`` of the 1-D operator Q
    scaled to 1-norm 0.01 (Pade degree 3): the same entries as the JAX
    package, values rtol 1e-8; the values against numpy/scipy too."""
    import scipy.linalg as sl
    if fn == "inv":
        T, jA, tA = mats["T"]
        want, dense = ref(mats, fn, lambda: js.inv(jA)), np.linalg.inv(T)
        got = ts.inv(tA)
    else:
        Q = mats["Q"][0] * (0.01 / 4.02)
        jA, tA = both(Q)
        want, dense = ref(mats, fn, lambda: js.expm(jA)), sl.expm(Q)
        got = ts.expm(tA)
    assert isinstance(got, tsp.SparseCOO) and got.nnz == int(want.nnz)
    assert_close(got.to_dense(), np.asarray(want.to_dense()))
    assert_close(got.to_dense(), dense, rtol=1e-8)


# ----------------------------------------------------------------------
# plan_esc(host=True) through the native consolidate
# ----------------------------------------------------------------------
def test_plan_esc_host_matches_jax_bitwise():
    """float32 operands whose duplicates cancel (1e8, 1, -1e8 in one cell):
    summed in float64 in insertion order by the native consolidate, as the
    JAX package's, they give 1; a float32 running sum would give 0. The
    planned product equals the JAX package's bit for bit."""
    from spsparse_torch.ops.spgemm_planned import plan_esc as t_plan
    from spsparse_torch.ops.spgemm_planned import spgemm_planned as t_apply
    from spsparse_tpu.ops.spgemm_planned import plan_esc as j_plan
    from spsparse_tpu.ops.spgemm_planned import spgemm_planned as j_apply
    rng = np.random.default_rng(9)
    idx = np.concatenate([[[0, 1], [0, 1], [0, 1]],
                          rng.integers(0, 6, (30, 2))])
    vals = np.concatenate([[1e8, 1.0, -1e8],
                           rng.uniform(-1, 1, 30)]).astype(np.float32)
    jb = jsp.CooBuilder((6, 6), dtype=np.float32)
    tb = tsp.CooBuilder((6, 6), dtype=np.float32)
    jb.add_many(idx, vals)
    tb.add_many(idx, vals)
    jA, tA = jb.build(), tb.build(device="cpu")
    jp, jac, jbc = j_plan(jA, jA, transpose_b=True, host=True)
    tp, tac, tbc = t_plan(tA, tA, transpose_b=True, host=True)
    cell = np.nonzero((tac.indices[:tac.nnz].numpy() == [0, 1]).all(1))[0]
    assert tac.vals[cell].tolist() == [1.0]
    np.testing.assert_array_equal(tac.vals.numpy(), np.asarray(jac.vals))
    got = coo_to_numpy(t_apply(tp, tac.vals, tbc.vals))
    want = j_apply(jp, jac.vals, jbc.vals)
    assert got[2] == int(want.nnz)
    np.testing.assert_array_equal(got[0][:got[2]],
                                  np.asarray(want.indices)[:got[2]])
    np.testing.assert_array_equal(got[1][:got[2]],
                                  np.asarray(want.vals)[:got[2]])


# ----------------------------------------------------------------------
# chip_smoke.solver_path, rehearsed
# ----------------------------------------------------------------------
def test_chip_smoke_solver_path_rehearsal():
    """``chip_smoke.solver_path`` on a 32 x 32 Poisson grid and a 1024-row
    band (plain kernel versions): every phase's checks against scipy, numpy
    and float64 residuals run, and the native library is the one used."""
    import chip_smoke

    st = chip_smoke.solver_path(torch, tsp, "cpu", side=32, n=1024,
                                slice_m=128)
    assert st["native"] is True
    assert set(st["wall_s"]) == {f"V{i}" for i in range(7)}
    assert st["amg"]["sizes"][0] == 1024 and len(st["amg"]["sizes"]) >= 2
    assert st["direct"]["levels"] == 63
