"""The port's banded SPD solve path against the JAX package, on the CPU.

Kernels K3 (multi-RHS DIA SpMM) and K4 (CG on a DIA operator) run their
plain PyTorch versions here; they are held against the JAX package's Pallas
kernels in interpret mode, as ``tests/test_pallas.py`` runs them. The
autograd Functions of K1 and K3 are held against ``jax.grad`` of the Pallas
entries; the solvers, preconditioners and operators of
``spsparse_torch.solvers`` against ``spsparse_tpu.solvers`` in float64 (x64
is on, ``tests/conftest.py``), with the same numpy inputs made from a seed.

Tolerances: K3 rtol/atol 2e-5 (f32 sums of a few products in another
order); K4 and the f32 multi-RHS solve 1e-4 of max|x| (rounding differences
compound through the CG recurrences); gradients rtol 1e-5 / atol 1e-6 (1e-4
/ 1e-5 where the JAX test allows it); the float64 solvers rtol 1e-9 /
atol 1e-11 (the same arithmetic in another summation order); the
eigenvalue bounds rtol 1e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spsparse_torch as tsp
import spsparse_tpu as jsp
from spsparse_tpu.core.dia import SparseDIA as JDIA
from spsparse_tpu.ops.pallas_cg import cg_solve_dia_pallas
from spsparse_tpu.ops.pallas_dia import prepare_dia as j_prepare
from spsparse_tpu.ops.pallas_dia import spmv_dia_pallas
from spsparse_tpu.ops.pallas_dia_mrhs import spmm_dia_mrhs_pallas
from spsparse_torch import solvers as ts
from spsparse_torch.convert import dia_from_numpy, tensor_to_numpy
from spsparse_torch.ops import (cg_solve_dia, cg_solve_dia_reference,
                                prepare_dia, spmm_dia_mrhs,
                                spmm_dia_mrhs_reference, spmv_dia_stream)
import spsparse_tpu.solvers as js
from port_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = dict(rtol=1e-9, atol=1e-11)


def banded(rng, n, offsets, dtype=np.float32):
    offs = np.asarray(offsets)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    data = np.where(valid, rng.uniform(-1, 1, (n, offs.size)), 0)
    return data.T.astype(dtype).copy(), tuple(int(o) for o in offs)


def both(data, offsets, n):
    return (JDIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n)),
            dia_from_numpy(data, offsets, (n, n), device="cpu"))


def spd_dense(rng, n, band=2):
    """Diagonally dominant SPD band matrix, float64."""
    A = np.zeros((n, n))
    for off in range(1, band + 1):
        v = rng.uniform(-0.3, 0.3, n - off)
        A[np.arange(n - off), np.arange(off, n)] = v
        A[np.arange(off, n), np.arange(n - off)] = v
    A[np.arange(n), np.arange(n)] = np.abs(A).sum(1) + rng.uniform(0.5, 1.5,
                                                                    n)
    return A


def coo_both(A, dtype=np.float64):
    ii, jj = np.nonzero(A)
    idx = np.stack([ii, jj], 1)
    jb = jsp.CooBuilder(A.shape, dtype=dtype)
    tb = tsp.CooBuilder(A.shape, dtype=dtype)
    jb.add_many(idx, A[ii, jj])
    tb.add_many(idx, A[ii, jj])
    return jb.build(), tb.build(device="cpu")


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def rng_vec(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, n)


def close(t, j, **tol):
    np.testing.assert_allclose(tensor_to_numpy(t), np.asarray(j),
                               **(tol or F64))


# ----------------------------------------------------------------------
# K3: multi-RHS DIA SpMM
# ----------------------------------------------------------------------
# name: (n, offsets, R (None: a 1-D x), JAX block, data dtype)
K3_CASES = {
    "dense_R8": (2000, (-2, 0, 1, 3), 8, 512, "float32"),
    "native_layout_R8": (1024, (-2, -1, 0, 1, 2), 8, 512, "float32"),
    "padded_R7": (1536, (-2, -1, 0, 1, 2), 7, 512, "float32"),
    "odd_n_R1": (1000, (-3, -1, 0, 2, 5), 1, 128, "float32"),
    "odd_n_vector": (1000, (-3, 0, 4), None, 128, "float32"),
    "odd_n_R8_bf16": (1000, (-3, -1, 0, 2, 5), 8, 128, "bfloat16"),
    "odd_n_R7_bf16": (1000, (-3, -1, 0, 2, 5), 7, 128, "bfloat16"),
    "offsets_past_128": (700, (-200, -129, 0, 130), 3, 256, "float32"),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_plain_matches_pallas_interpret(case):
    n, offsets, R, block, dtype = K3_CASES[case]
    rng = np.random.default_rng(len(case) + n)
    data, offs = banded(rng, n, offsets)
    X = rng.uniform(-1, 1, (n,) if R is None else (R, n)).astype(np.float32)
    jd, td = both(data, offs, n)
    jp = j_prepare(jd, block=block, dtype=getattr(jnp, dtype))
    tp = prepare_dia(td, dtype=getattr(torch, dtype))
    Y_j = np.asarray(spmm_dia_mrhs_pallas(jp, X, interpret=True))
    before = spmm_dia_mrhs.launches
    Y_t = spmm_dia_mrhs(tp, torch.from_numpy(X))
    assert spmm_dia_mrhs.launches == before          # CPU: plain version
    assert tuple(Y_t.shape) == Y_j.shape and Y_t.dtype == torch.float32
    np.testing.assert_allclose(tensor_to_numpy(Y_t), Y_j, rtol=2e-5,
                               atol=2e-5)


def test_k3_rows_match_k1():
    rng = np.random.default_rng(3)
    n = 777
    data, offs = banded(rng, n, (-4, 0, 1, 9))
    _, td = both(data, offs, n)
    X = torch.from_numpy(rng.uniform(-1, 1, (8, n)).astype(np.float32))
    Y = spmm_dia_mrhs(td, X)
    for r in range(8):
        torch.testing.assert_close(Y[r], spmv_dia_stream(td, X[r]),
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(Y, spmm_dia_mrhs_reference(prepare_dia(td), X),
                               rtol=0, atol=0)


def test_k3_too_many_rhs_raises():
    b = jsp.CooBuilder((64, 64), dtype=np.float32)
    b.add((0, 0), 1.0)
    with pytest.raises(ValueError):
        spmm_dia_mrhs_pallas(jsp.to_dia(b.build()),
                             np.ones((9, 64), np.float32), interpret=True)
    data, offs = banded(np.random.default_rng(0), 64, (0,))
    _, td = both(data, offs, 64)
    with pytest.raises(ValueError, match="at most 8"):
        spmm_dia_mrhs(td, torch.ones((9, 64)))


# ----------------------------------------------------------------------
# K4: CG on a DIA operator
# ----------------------------------------------------------------------
def _tridiagonal(rng, n, main_lo, main_hi, off_scale):
    b = jsp.CooBuilder((n, n), dtype=np.float32)
    if main_hi:
        b.add_many(np.stack([np.arange(n), np.arange(n)], 1),
                   rng.uniform(main_lo, main_hi, n).astype(np.float32))
    off1 = rng.uniform(-off_scale, off_scale, n - 1).astype(np.float32)
    b.add_many(np.stack([np.arange(n - 1), np.arange(1, n)], 1), off1)
    b.add_many(np.stack([np.arange(1, n), np.arange(n - 1)], 1), off1)
    jd = jsp.to_dia(b.build())
    td = dia_from_numpy(np.asarray(jd.data), jd.offsets, jd.shape,
                        device="cpu")
    return jd, td


# name: (n, main diagonal range (None: no main diagonal), off-diagonal
#        scale, shift, iters, JAX block, b = 0)
K4_CASES = {
    "spd_tridiagonal": (1500, (2.5, 3.5), 1.0, 0.0, 60, 512, False),
    "shift_term": (600, None, 0.4, 2.0, 80, 512, False),
    "few_iters_final_rs": (600, (2.5, 3.5), 1.0, 0.5, 4, 512, False),
    "zero_rhs": (600, (2.5, 3.5), 1.0, 0.0, 5, 512, True),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_plain_matches_pallas_interpret(case):
    n, main, off_scale, shift, iters, block, zero = K4_CASES[case]
    rng = np.random.default_rng(n + iters)
    jd, td = _tridiagonal(rng, n, *(main or (0, 0)), off_scale)
    rhs = (np.zeros(n, np.float32) if zero
           else rng.uniform(-1, 1, n).astype(np.float32))
    x_j, rs_j = cg_solve_dia_pallas(jd, rhs, iters=iters, shift=shift,
                                    block=block, interpret=True)
    before = cg_solve_dia.launches
    x_t, rs_t = cg_solve_dia(td, torch.from_numpy(rhs), iters=iters,
                             shift=shift)
    assert cg_solve_dia.launches == before           # CPU: plain version
    assert x_t.dtype == torch.float32 and rs_t.shape == ()
    x_j = np.asarray(x_j)
    if zero:
        assert not x_t.any() and float(rs_t) == 0.0 and float(rs_j) == 0.0
        return
    np.testing.assert_allclose(tensor_to_numpy(x_t), x_j, rtol=0,
                               atol=1e-4 * np.abs(x_j).max())
    dense = tensor_to_numpy(td.to_dense()).astype(np.float64) + shift * np.eye(
        n)
    if iters >= 60:
        ref = np.linalg.solve(dense, rhs.astype(np.float64))
        np.testing.assert_allclose(tensor_to_numpy(x_t).astype(np.float64),
                                   ref, rtol=1e-4, atol=1e-5)
        assert float(rs_t) < 1e-8
    else:
        np.testing.assert_allclose(float(rs_t), float(rs_j), rtol=1e-4)


def test_k4_reference_is_the_wrapper_on_cpu():
    rng = np.random.default_rng(9)
    n = 300
    _, td = _tridiagonal(rng, n, 2.5, 3.5, 1.0)
    b = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    x1, rs1 = cg_solve_dia(td, b, iters=7, shift=0.25)
    x2, rs2 = cg_solve_dia_reference(prepare_dia(td), b, iters=7, shift=0.25)
    assert torch.equal(x1, x2) and torch.equal(rs1, rs2)
    x0, rs0 = cg_solve_dia(td, b, iters=0)
    assert not x0.any() and float(rs0) == pytest.approx(float(b.dot(b)))


@pytest.mark.parametrize("bad", ["nonsquare", "negative_iters"])
def test_k4_rejects(bad):
    if bad == "nonsquare":
        td = dia_from_numpy(np.ones((1, 4), np.float32), (0,), (4, 5),
                            device="cpu")
        args = (td, torch.ones(5))
        kw = dict(iters=1)
    else:
        td = dia_from_numpy(np.ones((1, 4), np.float32), (0,), (4, 4),
                            device="cpu")
        args = (td, torch.ones(4))
        kw = dict(iters=-1)
    with pytest.raises(ValueError):
        cg_solve_dia(*args, **kw)


# ----------------------------------------------------------------------
# Autograd of K1 and K3 against jax.grad of the Pallas entries
# ----------------------------------------------------------------------
def _grads_torch(data, offs, n, X, W, fn):
    data_t = torch.from_numpy(data).requires_grad_(True)
    X_t = torch.from_numpy(X).requires_grad_(True)
    d = tsp.SparseDIA(data=data_t, offsets=offs, shape=(n, n))
    (torch.from_numpy(W) * fn(d, X_t)).sum().backward()
    return tensor_to_numpy(data_t.grad), tensor_to_numpy(X_t.grad)


# name: (n, offsets, R (None: K1 on a vector), JAX block, rtol, atol)
GRAD_CASES = {
    "k1_offsets_past_128": (300, (-7, -1, 0, 2, 130), None, 128, 1e-5, 1e-6),
    "k3_padded_R3": (260, (-2, 0, 3), 3, 128, 1e-5, 1e-6),
    "k3_native_layout_R8": (512, (-2, -1, 0, 1, 2), 8, 512, 1e-4, 1e-5),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grads_match_jax(case):
    n, offsets, R, block, rtol, atol = GRAD_CASES[case]
    rng = np.random.default_rng(n)
    data, offs = banded(rng, n, offsets)
    shape = (n,) if R is None else (R, n)
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    W = rng.uniform(-1, 1, shape).astype(np.float32)
    if R is None:
        def j_fn(d, x):
            return spmv_dia_pallas(d, x, block=block, interpret=True)
        t_fn = spmv_dia_stream
    else:
        def j_fn(d, x):
            return spmm_dia_mrhs_pallas(d, x, block=block, interpret=True)
        t_fn = spmm_dia_mrhs

    def loss(dj, Xj):
        d = JDIA(data=dj, offsets=offs, shape=(n, n))
        return jnp.sum(jnp.asarray(W) * j_fn(d, Xj))

    # under jax.jit: one compile, where the eager gradient's primitives
    # compiled ~40 times a case
    gj = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(data),
                                                 jnp.asarray(X))
    gt = _grads_torch(data, offs, n, X, W, t_fn)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def test_k1_grad_through_prepared_operand_matches_jax():
    rng = np.random.default_rng(5)
    n = 200
    data, offs = banded(rng, n, (-1, 0, 1))
    jd, td = both(data, offs, n)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    jp = j_prepare(jd, block=128)
    gj = jax.jit(jax.grad(lambda v: jnp.sum(
        spmv_dia_pallas(jp, v, interpret=True) ** 2)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (spmv_dia_stream(prepare_dia(td), xt) ** 2).sum().backward()
    np.testing.assert_allclose(tensor_to_numpy(xt.grad), np.asarray(gj),
                               rtol=1e-4, atol=1e-5)


def test_bf16_data_grad_reaches_f32_diagonals():
    rng = np.random.default_rng(6)
    n = 300
    data, offs = banded(rng, n, (-1, 0, 2))
    data_t = torch.from_numpy(data).requires_grad_(True)
    prep = prepare_dia(tsp.SparseDIA(data=data_t, offsets=offs,
                                     shape=(n, n)), dtype=torch.bfloat16)
    X = torch.from_numpy(rng.uniform(-1, 1, (2, n)).astype(np.float32))
    spmm_dia_mrhs(prep, X).sum().backward()
    assert data_t.grad.dtype == torch.float32
    want = torch.zeros_like(data_t)
    for k, o in enumerate(offs):
        lo, hi = max(0, -o), min(n, n - o)
        want[k, lo:hi] = X[:, lo + o:hi + o].sum(0)
    torch.testing.assert_close(data_t.grad, want.bfloat16().float(),
                               rtol=0, atol=0)


# ----------------------------------------------------------------------
# The CG family in float64 against the JAX package
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(17)
    A = spd_dense(rng, 48, band=3)
    return {"A": A, "b": rng.uniform(-1, 1, 48),
            "B": rng.uniform(-1, 1, (48, 5)),
            "jA": jnp.asarray(A), "tA": t64(A)}


def test_cg_solve_and_step_match_jax(system):
    jA, tA = system["jA"], system["tA"]
    b = system["b"]
    xj, rj = js.cg_solve(lambda v: jA @ v, jnp.asarray(b), iters=25)
    xt, rt = ts.cg_solve(lambda v: tA @ v, t64(b), iters=25)
    close(xt, xj)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-6, atol=1e-24)
    np.testing.assert_allclose(tensor_to_numpy(xt),
                               np.linalg.solve(system["A"], b), rtol=1e-8)
    x0 = rng_vec(48, 3)
    close(ts.cg_solve(lambda v: tA @ v, t64(b), iters=4, x0=t64(x0))[0],
          js.cg_solve(lambda v: jA @ v, jnp.asarray(b), iters=4,
                      x0=jnp.asarray(x0))[0])


@pytest.mark.parametrize("kind", ["jacobi", "callable", "block_jacobi",
                                  "neumann"])
def test_pcg_solve_matches_jax(system, kind):
    A, jA, tA, b = system["A"], system["jA"], system["tA"], system["b"]
    jc, tc = coo_both(A)
    if kind == "jacobi":
        mj = js.jacobi_preconditioner(js.extract_diagonal(jc))
        mt = ts.jacobi_preconditioner(ts.extract_diagonal(tc))
        close(mt, mj)
    elif kind == "callable":
        d = np.diag(A)
        mj, mt = (lambda r: r / jnp.asarray(d)), (lambda r: r / t64(d))
    elif kind == "block_jacobi":
        mj = js.block_jacobi_preconditioner(jc, bs=8)
        mt = ts.block_jacobi_preconditioner(tc, bs=8)
    else:
        mj = js.neumann_preconditioner(lambda v: jA @ v, jnp.diag(jA), k=3)
        mt = ts.neumann_preconditioner(lambda v: tA @ v, torch.diag(tA), k=3)
    xj, rj = js.pcg_solve(lambda v: jA @ v, jnp.asarray(b), iters=12,
                          minv=mj)
    xt, rt = ts.pcg_solve(lambda v: tA @ v, t64(b), iters=12, minv=mt)
    close(xt, xj)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-6, atol=1e-24)


def test_cg_solve_mrhs_columns_match_jax(system):
    jA, tA, B = system["jA"], system["tA"], system["B"]
    Xj, rj = js.cg_solve_mrhs(lambda M: jA @ M, jnp.asarray(B), iters=30)
    Xt, rt = ts.cg_solve_mrhs(lambda M: tA @ M, t64(B), iters=30)
    assert tuple(Xt.shape) == (48, 5) and tuple(rt.shape) == (5,)
    close(Xt, Xj)
    for k in range(5):
        xk, _ = ts.cg_solve(lambda v: tA @ v, t64(B[:, k]), iters=30)
        close(Xt[:, k], tensor_to_numpy(xk))
    np.testing.assert_allclose(tensor_to_numpy(Xt),
                               np.linalg.solve(system["A"], B), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("minv_kind", ["row", "full", "callable"])
def test_cg_solve_mrhs_preconditioned_matches_jax(system, minv_kind):
    A, jA, tA, B = system["A"], system["jA"], system["tA"], system["B"]
    d = np.diag(A)
    if minv_kind == "row":
        mj, mt = 1 / jnp.asarray(d), 1 / t64(d)
    elif minv_kind == "full":
        mj, mt = 1 / jnp.asarray(d)[:, None], 1 / t64(d)[:, None]
    else:
        mj = lambda R: R / jnp.asarray(d)[:, None]  # noqa: E731
        mt = lambda R: R / t64(d)[:, None]  # noqa: E731
    Xj, _ = js.cg_solve_mrhs(lambda M: jA @ M, jnp.asarray(B), iters=20,
                             minv=mj)
    Xt, _ = ts.cg_solve_mrhs(lambda M: tA @ M, t64(B), iters=20, minv=mt)
    close(Xt, Xj)
    for k in range(2):
        xk, _ = ts.pcg_solve(lambda v: tA @ v, t64(B[:, k]), iters=20,
                             minv=1 / t64(d))
        close(Xt[:, k], tensor_to_numpy(xk))


def test_cg_solve_mrhs_breakdown_isolated_per_column(system):
    jA, tA = system["jA"], system["tA"]
    B = system["B"].copy()
    B[:, 0] = 0.0
    Xj, rj = js.cg_solve_mrhs(lambda M: jA @ M, jnp.asarray(B), iters=30)
    Xt, rt = ts.cg_solve_mrhs(lambda M: tA @ M, t64(B), iters=30)
    assert torch.isfinite(Xt).all() and not Xt[:, 0].any()
    assert float(rt[0]) == 0.0
    close(Xt, Xj)


# name: (B shape, minv shape or None)
MRHS_BAD = {
    "vector_rhs": ((8,), None),
    "per_column_vector": ((8, 3), (3,)),
    "unbroadcastable": ((8, 3), (4, 3)),
}


@pytest.mark.parametrize("bad", list(MRHS_BAD))
def test_cg_solve_mrhs_shape_checks_match_jax(bad):
    shape, mshape = MRHS_BAD[bad]
    B = np.ones(shape)
    minv = None if mshape is None else np.ones(mshape)
    with pytest.raises(ValueError):
        js.cg_solve_mrhs(lambda M: M, jnp.asarray(B), iters=1,
                         minv=None if minv is None else jnp.asarray(minv))
    with pytest.raises(ValueError):
        ts.cg_solve_mrhs(lambda M: M, t64(B), iters=1,
                         minv=None if minv is None else t64(minv))


def test_cg_solve_mrhs_over_k3_matches_jax_over_pallas():
    rng = np.random.default_rng(23)
    n = 256
    A = spd_dense(rng, n, band=2).astype(np.float32)
    jc, _ = coo_both(A, np.float32)
    jd = jsp.to_dia(jc)
    td = dia_from_numpy(np.asarray(jd.data), jd.offsets, jd.shape,
                        device="cpu")
    B = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    Xj, _ = js.cg_solve_mrhs(
        lambda M: spmm_dia_mrhs_pallas(jd, M.T, interpret=True).T,
        jnp.asarray(B), iters=30)
    prep = prepare_dia(td)
    Xt, _ = ts.cg_solve_mrhs(lambda M: spmm_dia_mrhs(prep, M.T).T,
                             torch.from_numpy(B), iters=30)
    Xj = np.asarray(Xj)
    np.testing.assert_allclose(tensor_to_numpy(Xt), Xj, rtol=0,
                               atol=1e-4 * np.abs(Xj).max())
    np.testing.assert_allclose(tensor_to_numpy(Xt),
                               np.linalg.solve(A.astype(np.float64), B),
                               rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------------
# The rest of solvers/iterative.py
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def general():
    rng = np.random.default_rng(29)
    n = 40
    A = np.eye(n) * 4 + rng.uniform(-1, 1, (n, n)) / np.sqrt(n)
    S = spd_dense(rng, n, band=2)
    M = S.copy()
    M[np.arange(n), np.arange(n)] -= 1.2 * np.median(np.diag(S))
    return {"A": A, "S": S, "M": M, "b": rng.uniform(-1, 1, n),
            "v0": rng.uniform(-1, 1, n)}


def _pair(mat):
    j, t = jnp.asarray(mat), t64(mat)
    return (lambda v: j @ v), (lambda v: t @ v)


SOLVER_CASES = {
    "bicgstab": ("A", lambda pkg, mv, b: pkg.bicgstab_solve(mv, b,
                                                            iters=15)),
    "bicgstab_precond": ("A", lambda pkg, mv, b: pkg.bicgstab_solve(
        mv, b, iters=10, minv=b * 0 + 0.25)),
    "cgs": ("A", lambda pkg, mv, b: pkg.cgs_solve(mv, b, iters=12)),
    "tfqmr": ("A", lambda pkg, mv, b: pkg.tfqmr_solve(mv, b, iters=12)),
    "minres_indefinite": ("M", lambda pkg, mv, b: pkg.minres_solve(
        mv, b, iters=30)),
    "chebyshev": ("S", lambda pkg, mv, b: pkg.chebyshev_solve(
        mv, b, lam_min=0.3, lam_max=4.0, iters=17)),
    "gmres": ("A", lambda pkg, mv, b: pkg.gmres_solve(mv, b, m=8,
                                                      restarts=3)),
    "gmres_precond": ("A", lambda pkg, mv, b: pkg.gmres_solve(
        mv, b, m=6, restarts=2, minv=b * 0 + 0.25)),
    "power_iteration": ("S", lambda pkg, mv, b: pkg.power_iteration(
        mv, b, iters=20)),
    "lanczos_bounds": ("S", lambda pkg, mv, b: pkg.lanczos_bounds(
        mv, b, iters=12)),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_matches_jax(general, case):
    which, run = SOLVER_CASES[case]
    jmv, tmv = _pair(general[which])
    b = general["v0" if case in ("power_iteration", "lanczos_bounds")
                else "b"]
    oj = run(js, jmv, jnp.asarray(b))
    ot = run(ts, tmv, t64(b))
    for t, j in zip(ot, oj):
        if case == "lanczos_bounds":
            np.testing.assert_allclose(float(t), float(j), rtol=1e-8)
        else:
            np.testing.assert_allclose(tensor_to_numpy(t), np.asarray(j),
                                       rtol=1e-8, atol=1e-10)


def test_minres_and_gmres_solve_the_system(general):
    for which, fn in (("M", lambda mv, b: ts.minres_solve(mv, b, iters=60)),
                      ("A", lambda mv, b: ts.gmres_solve(mv, b, m=20,
                                                         restarts=3))):
        _, tmv = _pair(general[which])
        x, _ = fn(tmv, t64(general["b"]))
        np.testing.assert_allclose(
            tensor_to_numpy(x),
            np.linalg.solve(general[which], general["b"]), rtol=1e-7,
            atol=1e-9)


def test_breakdown_guards_give_zero_not_nan(general):
    _, tmv = _pair(general["A"])
    z = torch.zeros(40, dtype=torch.float64)
    for fn in (lambda: ts.cg_solve(tmv, z, iters=3),
               lambda: ts.pcg_solve(tmv, z, iters=3, minv=z + 1),
               lambda: ts.bicgstab_solve(tmv, z, iters=3),
               lambda: ts.cgs_solve(tmv, z, iters=3),
               lambda: ts.tfqmr_solve(tmv, z, iters=3),
               lambda: ts.minres_solve(tmv, z, iters=3)):
        x, rs = fn()
        assert not x.any() and float(rs) == 0.0
    assert float(ts.safe_div(torch.tensor(1.0), torch.tensor(0.0))) == 0.0


def test_cg_solve_implicit_grads_match_jax(system):
    A, b = system["A"], system["b"]
    w = rng_vec(48, 7)

    def j_loss(bj, t):
        x = js.cg_solve_implicit(
            lambda v: jnp.asarray(A) @ v + t * v, bj, iters=40)
        return jnp.sum(jnp.asarray(w) * x)

    gj = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(b), 0.7)
    bt = t64(b).requires_grad_(True)
    tt = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    tA = system["tA"]
    x = ts.cg_solve_implicit(lambda v: tA @ v + tt * v, bt, iters=40)
    close(x.detach(), js.cg_solve_implicit(
        lambda v: jnp.asarray(A) @ v + 0.7 * v, jnp.asarray(b), iters=40))
    (t64(w) * x).sum().backward()
    close(bt.grad, gj[0], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(tt.grad), float(gj[1]), rtol=1e-8)
    with torch.no_grad():
        assert not ts.cg_solve_implicit(lambda v: tA @ v, bt,
                                        iters=5).requires_grad


# ----------------------------------------------------------------------
# solvers/precond.py and solvers/linop.py
# ----------------------------------------------------------------------
def test_extract_diagonal_and_blocks_match_jax():
    rng = np.random.default_rng(31)
    n = 20
    b_j = jsp.CooBuilder((n, n), dtype=np.float64)
    b_t = tsp.CooBuilder((n, n), dtype=np.float64)
    idx = np.stack([rng.integers(0, n, 90), rng.integers(0, n, 90)], 1)
    idx = np.concatenate([idx, np.stack([np.arange(n)] * 2, 1), idx[:5]])
    vals = rng.uniform(-1, 1, len(idx))
    for bb in (b_j, b_t):
        bb.add_many(idx, vals)
    jc, tc = b_j.build(), b_t.build(device="cpu")
    want = np.asarray(js.extract_diagonal(jc))
    for conv_t in (lambda a: a, tsp.to_csr,
                   lambda a: tsp.to_dia(a.consolidate((0, 1)))):
        close(ts.extract_diagonal(conv_t(tc)), want)
    close(ts.extract_diag_blocks(tc, 6), js.extract_diag_blocks(jc, 6))
    r = rng.uniform(-1, 1, n)
    close(ts.block_jacobi_preconditioner(tc, bs=6)(t64(r)),
          js.block_jacobi_preconditioner(jc, bs=6)(jnp.asarray(r)),
          rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", ["SparseBSR", "SparseTiledCOO"])
def test_unported_formats_name_their_roadmap_item(name):
    # Every operand type is ported: BSR and tiled operands (slice 3), on
    # which extract_diagonal and aslinearoperator match the JAX package, and
    # the shuffle layout (slice 5), whose operator matches the JAX one.
    rng = np.random.default_rng(33)
    A = np.where(rng.random((24, 24)) < 0.3, rng.uniform(-1, 1, (24, 24)),
                 0).astype(np.float32)
    np.fill_diagonal(A, rng.uniform(1, 2, 24))
    jc, tc = coo_both(A, dtype=np.float32)
    conv = {"SparseBSR": lambda pkg, a: pkg.to_bsr(a, (8, 8)),
            "SparseTiledCOO": lambda pkg, a: pkg.to_tiled(a)}[name]
    ja, ta = conv(jsp, jc), conv(tsp, tc)
    assert type(ta).__name__ == name
    f32 = dict(rtol=1e-6, atol=1e-6)
    close(ts.extract_diagonal(ta), js.extract_diagonal(ja), rtol=0, atol=0)
    x = rng.uniform(-1, 1, 24).astype(np.float32)
    close(ts.aslinearoperator(ta).matvec(torch.from_numpy(x)),
          js.aslinearoperator(ja).matvec(jnp.asarray(x)), **f32)
    close(ts.aslinearoperator(ta).matvec(torch.from_numpy(x)), A @ x, **f32)
    from spsparse_torch.ops import prepare_shuffle_spmv
    from spsparse_tpu.ops.spmv_shuffle import prepare_shuffle_spmv as j_prep

    close(ts.aslinearoperator(prepare_shuffle_spmv(tc)).matvec(
        torch.from_numpy(x)), js.aslinearoperator(j_prep(jc)).matvec(
        jnp.asarray(x)), **f32)


def test_neumann_k1_is_jacobi_and_rejects_k0(system):
    A, tA = system["A"], system["tA"]
    r = t64(system["b"])
    m = ts.neumann_preconditioner(lambda v: tA @ v, torch.diag(tA), k=1)
    close(m(r), system["b"] / np.diag(A))
    with pytest.raises(tsp.SpSparseError):
        ts.neumann_preconditioner(lambda v: tA @ v, torch.diag(tA), k=0)


def test_linear_operator_algebra_matches_jax():
    rng = np.random.default_rng(37)
    A = np.where(rng.random((12, 9)) < 0.3, rng.uniform(-1, 1, (12, 9)), 0)
    _, tc = coo_both(A)
    x = rng.uniform(-1, 1, 9)
    u = rng.uniform(-1, 1, 12)
    X = rng.uniform(-1, 1, (9, 3))
    # The JAX package's dense operator (its COO operator compiles for ~10 s).
    J, T = js.aslinearoperator(jnp.asarray(A)), ts.aslinearoperator(tc)
    close(T.matvec(t64(x)), J.matvec(jnp.asarray(x)), rtol=1e-12)
    close(T.rmatvec(t64(u)), J.rmatvec(jnp.asarray(u)), rtol=1e-12)
    close(T @ t64(X), J.matmat(jnp.asarray(X)), rtol=1e-12)
    # The composed operator against its dense value.
    N = 0.5 * A.T @ A + 0.25 * np.eye(9)
    Nt = T.T @ T + 0.25 * ts.identity_operator(9) - T.T @ T * 0.5
    close(Nt(t64(x)), N @ x, rtol=1e-12)
    close(Nt.matmat(t64(X)), N @ X, rtol=1e-12)
    close((-Nt).T.rmatmat(t64(X)), -N @ X, rtol=1e-12)
    xs_t, _ = ts.cg_solve(Nt + ts.identity_operator(9), t64(x), iters=9)
    close(xs_t, np.linalg.solve(N + np.eye(9), x), rtol=1e-9)
    dense_t = ts.aslinearoperator(t64(A))
    close(dense_t.T @ t64(u), A.T @ u, rtol=1e-12)
    for bad in (lambda: T * T, lambda: T @ T, lambda: T + dense_t.T,
                lambda: ts.aslinearoperator(tsp.to_csr(tc)).T):
        with pytest.raises(tsp.SpSparseError):
            bad()


def test_linear_operator_over_dia_runs_k1_plain():
    rng = np.random.default_rng(41)
    n = 64
    data, offs = banded(rng, n, (-1, 0, 2))
    jd, td = both(data, offs, n)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    want = np.asarray(js.aslinearoperator(jd).matvec(jnp.asarray(x)))
    for op in (td, prepare_dia(td)):
        L = ts.aslinearoperator(op)
        np.testing.assert_allclose(tensor_to_numpy(L(torch.from_numpy(x))),
                                   want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            tensor_to_numpy(L.matmat(torch.from_numpy(X))),
            tensor_to_numpy(td.to_dense()) @ X, rtol=2e-5, atol=2e-5)


def test_best_spmv_float64_dia_matches_jax_and_cg_solves():
    """A float64 ``SparseDIA`` goes to the plain float64 DIA product (the
    JAX package's route off the TPU; K1 takes float32 and bfloat16), so
    ``best_spmv`` keeps float64 and the CG solve over its operator reaches
    a float64 residual."""
    from spsparse_torch.ops import best_spmv as t_best
    from spsparse_tpu.ops.spmv_kernels import best_spmv as j_best

    rng = np.random.default_rng(43)
    n = 200
    off = rng.uniform(-1, 1, n - 1)
    A = np.diag(4 + rng.uniform(0, 1, n)) + np.diag(off, 1) + np.diag(off, -1)
    offs = (-1, 0, 1)
    data = np.zeros((3, n))
    data[0, 1:], data[1], data[2, :-1] = off, np.diag(A), off
    jd, td = both(data, offs, n)
    x = rng.uniform(-1, 1, n)
    y = t_best(td, torch.from_numpy(x))
    assert y.dtype == torch.float64
    close(y, j_best(jd, jnp.asarray(x)), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tensor_to_numpy(y), A @ x, rtol=1e-12)
    b = rng.uniform(-1, 1, n)
    xt, _ = ts.cg_solve(ts.aslinearoperator(td).matvec, t64(b), iters=100)
    xj, _ = js.cg_solve(js.aslinearoperator(jd).matvec, jnp.asarray(b),
                        iters=100)
    res_t = np.abs(A @ tensor_to_numpy(xt) - b).max()
    res_j = np.abs(A @ np.asarray(xj) - b).max()
    assert res_t <= 1e-12 and res_j <= 1e-12
    close(xt, xj)


# ----------------------------------------------------------------------
# The whole slice at small size
# ----------------------------------------------------------------------
def test_solve_path_rehearsal_matches_jax():
    """``chip_smoke.solve_path`` on the CPU at n = 4096 (its own checks
    run inside), then its CG and block-CG solutions against the JAX
    package's composed solvers over its XLA DIA SpMV, in float32."""
    import importlib.util
    from pathlib import Path

    from spsparse_tpu.ops.spmv_kernels import spmv_dia as j_spmv_dia

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.solve_path(torch, tsp, "cpu", n=4096)
    S = out["spd"]["S"]
    jS = JDIA(data=jnp.asarray(tensor_to_numpy(S.data)), offsets=S.offsets,
              shape=S.shape)

    def jmv(v):
        return j_spmv_dia(jS, v) + cs.SHIFT * v

    # the JAX solves under jax.jit: one compile each, where eagerly every
    # primitive of their set-up compiled at these shapes
    b = jnp.asarray(tensor_to_numpy(out["cg"]["b"]))
    xj, _ = jax.jit(lambda b: js.cg_solve(jmv, b, iters=cs.CG_ITERS))(b)
    xj = np.asarray(xj)
    np.testing.assert_allclose(tensor_to_numpy(out["cg"]["x"]), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())
    blk = out["block"]
    Xj, _ = jax.jit(lambda B, minv: js.cg_solve_mrhs(
        lambda M: jax.vmap(jmv, in_axes=1, out_axes=1)(M), B,
        iters=cs.CG_ITERS, minv=minv))(
        jnp.asarray(tensor_to_numpy(blk["B"])),
        jnp.asarray(tensor_to_numpy(blk["minv"])))
    Xj = np.asarray(Xj)
    np.testing.assert_allclose(tensor_to_numpy(blk["X"]), Xj, rtol=0,
                               atol=1e-4 * np.abs(Xj).max())
