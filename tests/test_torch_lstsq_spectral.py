"""The port's least-squares, norm-estimation and spectral solvers
(``solvers/lstsq.py``, ``norms.py``, ``spectral.py``) against the JAX
package, on the CPU.

The same numpy inputs (made from a seed) go through ``spsparse_tpu`` (x64
is on, ``tests/conftest.py``) and ``spsparse_torch`` in float64. The JAX
side applies its operators as dense matmuls, the port's as its own sparse
CSR products (``aslinearoperator`` of a COO), so the two differ only in
summation order. Each JAX reference is computed once per module, under
``jax.jit`` where the JAX function is jittable (one compile instead of one
per eager op: a third of the time).

Tolerances: fixed-count Krylov results (x, residual estimates) rtol 1e-8
with an absolute floor of 1e-10 of the largest entry; eigen- and singular
values rtol 1e-8; eigen- and singular vectors up to sign within 1e-7 of
unit norm; ``onenormest`` exactly (the same probes, the same sums of the
same entries up to order: rtol 1e-12).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spsparse_torch as tsp
import spsparse_tpu.solvers as js
from spsparse_torch import solvers as ts
from port_threads import one_torch_thread  # noqa: F401 (autouse)

N = 48          # square operators
M = 64          # rows of the rectangular operator
ITERS = 20


def _coo(dense):
    ii, jj = np.nonzero(dense)
    b = tsp.CooBuilder(dense.shape, dtype=np.float64)
    b.add_many(np.stack([ii, jj], 1), dense[ii, jj])
    return b.build(device="cpu")


def _spd(rng, n):
    """A sparse SPD matrix with distinct eigenvalues: a random symmetric
    band of 7 diagonals, diagonally dominant."""
    A = np.zeros((n, n))
    for off in range(1, 4):
        v = rng.uniform(-1, 1, n - off)
        A[np.arange(n - off), np.arange(off, n)] = v
        A[np.arange(off, n), np.arange(n - off)] = v
    A[np.arange(n), np.arange(n)] = 6.0 + np.arange(n) * 0.25
    return A


@pytest.fixture(scope="module")
def ops():
    rng = np.random.default_rng(0)
    A = _spd(rng, N)
    R = np.where(rng.random((M, N)) < 0.15, rng.uniform(-1, 1, (M, N)), 0.0)
    R[np.arange(N), np.arange(N)] += 3.0      # full column rank
    # nonsymmetric with real, distinct eigenvalues: upper triangle + small
    # strictly lower noise
    G = np.triu(rng.uniform(-0.3, 0.3, (N, N)), 1)
    G[np.arange(N), np.arange(N)] = np.linspace(-4.0, 5.0, N)
    G += np.tril(rng.uniform(-0.01, 0.01, (N, N)), -1)
    out = {}
    for name, D in (("A", A), ("R", R), ("G", G)):
        J = jnp.asarray(D)
        lo = ts.aslinearoperator(_coo(D))
        out[name] = dict(dense=D, jmv=lambda v, J=J: J @ v,
                         jrmv=lambda u, J=J: J.T @ u, top=lo)
    out["b_m"] = rng.standard_normal(M)
    out["b_n"] = rng.standard_normal(N)
    out["X0"] = rng.standard_normal((N, 3))
    out["refs"] = {}
    return out


def ref(ops, key, fn, *args):
    """A JAX reference computed once per module: ``fn(*args)``, compiled
    whole by ``jax.jit`` when it takes array arguments."""
    if key not in ops["refs"]:
        ops["refs"][key] = jax.jit(fn)(*args) if args else fn()
    return ops["refs"][key]


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def assert_close(got, want, rtol=1e-8):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    floor = 1e-10 * max(float(np.max(np.abs(want), initial=0.0)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def assert_same_up_to_sign(got, want, axis=0):
    """Columns (``axis=0``) or rows (``axis=1``) equal up to sign."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if axis == 1:
        got, want = got.T, want.T
    for c in range(want.shape[1]):
        s = np.sign(np.dot(got[:, c], want[:, c]))
        np.testing.assert_allclose(s * got[:, c], want[:, c], atol=1e-7)


# ----------------------------------------------------------------------
# Least squares
# ----------------------------------------------------------------------
LSTSQ = [("cgls", 0.0, "b"), ("lsqr", 0.0, "b"), ("lsmr", 0.0, "b"),
         ("lsqr", 0.5, "b"), ("lsmr", 0.5, "b"), ("cgls", 0.5, "x0"),
         ("lsqr", 0.0, "zero")]


@pytest.mark.parametrize("solver,damp,case", LSTSQ,
                         ids=[f"{s}-damp{d}-{c}" for s, d, c in LSTSQ])
def test_lstsq_matches_jax(ops, solver, damp, case):
    """x and the returned residual estimate, rtol 1e-8; b = 0 gives x = 0
    and a zero estimate in both packages (the masked breakdowns)."""
    R = ops["R"]
    b = np.zeros(M) if case == "zero" else ops["b_m"]
    kw = dict(iters=ITERS, damp=damp)
    jkw, tkw = dict(kw), dict(kw)
    if case == "x0":
        x0 = np.linspace(-1, 1, N)
        jkw["x0"], tkw["x0"] = jnp.asarray(x0), t64(x0)
    jx, jr = ref(ops, (solver, damp, case), lambda bb: getattr(
        js, f"{solver}_solve")(R["jmv"], R["jrmv"], bb, **jkw),
        jnp.asarray(b))
    tx, tr = getattr(ts, f"{solver}_solve")(
        R["top"].matvec, R["top"].rmatvec, t64(b), **tkw)
    assert tx.dtype == torch.float64 and tr.shape == ()
    assert_close(tx, jx)
    assert_close(tr, jr)
    if case == "zero":
        assert not bool(tx.any()) and float(tr) == 0.0


# ----------------------------------------------------------------------
# onenormest
# ----------------------------------------------------------------------
def _replay_onenormest(A, t, itmax, seed, lower_first):
    """numpy replay of the estimator, ties broken to the lower index (the
    JAX package's ``top_k``) or to the higher one."""
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    X = np.ones((n, t))
    if t > 1:
        X[:, 1:] = rng.choice([-1.0, 1.0], size=(n, t - 1))
    X /= n
    visited = np.zeros(n, bool)
    best = 0.0
    for _ in range(itmax):
        Y = A @ X
        best = max(best, np.abs(Y).sum(axis=0).max())
        Z = A.T @ np.where(Y >= 0, 1.0, -1.0)
        h = np.where(visited, -np.inf, np.abs(Z).max(axis=1))
        order = np.argsort(-h, kind="stable")
        if not lower_first:
            order = (n - 1 - np.argsort(-h[::-1], kind="stable"))
        idx = order[:t]
        visited[idx] = True
        X = np.zeros((n, t))
        X[idx, np.arange(t)] = 1.0
    return best


def _tied():
    """Columns 0 and 1 tie on the first round's ``h`` (both 2) but have
    column norms 2 and 4: with t = 1 and two rounds the estimate is 2 when
    the lower index wins the tie and 4 otherwise."""
    A = np.zeros((6, 6))
    A[0, 0], A[1, 0] = 1.0, 1.0               # h 2, norm 2
    A[0, 1], A[1, 1] = 3.0, -1.0              # h 2, norm 4
    A[2:, 2:] = 0.1 * np.eye(4)
    return A


@pytest.mark.parametrize("case", ["random", "tied"])
def test_onenormest_matches_jax(ops, case):
    """The estimate equals the JAX package's (rtol 1e-12); on tied column
    sums both take the lower index, as a replay shows, and the other tie
    order would give another estimate."""
    if case == "random":
        A, kw = ops["G"]["dense"], dict(t=2, itmax=5, seed=3)
    else:
        A, kw = _tied(), dict(t=1, itmax=2, seed=0)
    want = ref(ops, ("onenormest", case), lambda: js.onenormest(
        js.aslinearoperator(jnp.asarray(A)), **kw))
    got = ts.onenormest(_coo(A), **kw)
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    lower = _replay_onenormest(A, kw["t"], kw["itmax"], kw["seed"], True)
    np.testing.assert_allclose(float(got), lower, rtol=1e-12)
    if case == "tied":
        assert lower == 2.0
        assert _replay_onenormest(A, 1, 2, 0, False) == 4.0
        # a LinearOperator without a COO takes the device argument
        op = ts.aslinearoperator(t64(A))
        assert float(ts.onenormest(op, device="cpu", **kw)) == 2.0


# ----------------------------------------------------------------------
# Lanczos, matrix functions, LOBPCG, svds, Arnoldi
# ----------------------------------------------------------------------
def _breakdown():
    """A diagonal operator and a start vector in a 3-dimensional invariant
    subspace: Lanczos breaks down after 3 steps of 24."""
    d = np.linspace(1.0, 4.0, N)
    v0 = np.zeros(N)
    v0[[3, 17, 40]] = [1.0, 2.0, -1.0]
    return np.diag(d), v0


@pytest.mark.parametrize("which", ["LA", "SA", "breakdown"])
def test_lanczos_eigsh_matches_jax(ops, which):
    """Values rtol 1e-8, vectors up to sign; after a breakdown only the
    live Ritz pairs are chosen, in both packages."""
    if which == "breakdown":
        D, v0 = _breakdown()
        top, jmv, k, w = ts.aslinearoperator(_coo(D)), \
            (lambda v, J=jnp.asarray(D): J @ v), 2, "LA"
    else:
        top, jmv, v0, k, w = ops["A"]["top"], ops["A"]["jmv"], \
            ops["b_n"], 4, which
    jv, jV = ref(ops, ("lanczos", which), lambda v: js.lanczos_eigsh(
        jmv, v, k=k, which=w), jnp.asarray(v0))
    tv, tV = ts.lanczos_eigsh(top, t64(v0), k=k, which=w)
    assert_close(tv, jv)
    assert_same_up_to_sign(tV, jV)
    if which == "breakdown":
        np.testing.assert_allclose(tv.numpy(), np.diag(D)[[17, 40]],
                                   rtol=1e-10)


@pytest.mark.parametrize("f", ["exp", "sqrt"])
def test_funm_multiply_matches_jax(ops, f):
    """``expm_multiply(t=0.3)`` and ``funm_multiply(sqrt)``, rtol 1e-8."""
    A, v = ops["A"], ops["b_n"]
    if f == "exp":
        want = ref(ops, ("funm", f), lambda u: js.expm_multiply(
            A["jmv"], u, t=0.3), jnp.asarray(v))
        got = ts.expm_multiply(A["top"], t64(v), t=0.3)
    else:
        want = ref(ops, ("funm", f), lambda u: js.funm_multiply(
            A["jmv"], u, f=jnp.sqrt, iters=24), jnp.asarray(v))
        got = ts.funm_multiply(A["top"], t64(v), f=torch.sqrt, iters=24)
    assert_close(got, want)


@pytest.mark.parametrize("case", ["smallest", "largest", "jacobi"])
def test_lobpcg_matches_jax(ops, case):
    """Eight LOBPCG iterations on a block of 3: values rtol 1e-8, vectors
    up to sign."""
    A = ops["A"]
    J = jnp.asarray(A["dense"])
    kw = dict(iters=8, largest=case == "largest")
    jkw, tkw = dict(kw), dict(kw)
    if case == "jacobi":
        d = 1.0 / np.diag(A["dense"])
        jkw["minv"], tkw["minv"] = jnp.asarray(d), t64(d)
    jv, jX = ref(ops, ("lobpcg", case), lambda X0: js.lobpcg_solve(
        lambda X: J @ X, X0, **jkw), jnp.asarray(ops["X0"]))
    tv, tX = ts.lobpcg_solve(A["top"].matmat, t64(ops["X0"]), **tkw)
    assert_close(tv, jv)
    assert_same_up_to_sign(tX, jX)


def test_svds_matches_jax(ops):
    """Top 3 singular triplets of the 64 x 48 operator: values rtol 1e-8,
    vectors up to sign (the same sign on u and v)."""
    R = ops["R"]
    v0 = np.ones(N)
    jU, js_, jVt = ref(ops, "svds", lambda v: js.svds_lanczos(
        R["jmv"], R["jrmv"], v, k=3), jnp.asarray(v0))
    tU, ts_, tVt = ts.svds_lanczos(R["top"].matvec, R["top"].rmatvec,
                                   t64(v0), k=3)
    assert_close(ts_, js_)
    assert_same_up_to_sign(tU, jU)
    assert_same_up_to_sign(tVt, jVt, axis=1)


@pytest.mark.parametrize("which", ["LM", "SR"])
def test_arnoldi_eigs_matches_jax(ops, which):
    """Four eigenpairs of the nonsymmetric operator: values rtol 1e-8,
    vectors up to a unit factor (|<u, v>| = 1 within 1e-7)."""
    G = ops["G"]
    v0 = ops["b_n"]
    jv, jV = ref(ops, ("arnoldi", which), lambda: js.arnoldi_eigs(
        G["jmv"], jnp.asarray(v0), k=4, which=which))
    tv, tV = ts.arnoldi_eigs(G["top"], t64(v0), k=4, which=which)
    assert isinstance(tv, np.ndarray) and tv.dtype == np.complex128
    np.testing.assert_allclose(tv, jv, rtol=1e-8)
    for c in range(4):
        assert abs(abs(np.vdot(tV[:, c], jV[:, c])) - 1.0) < 1e-7
