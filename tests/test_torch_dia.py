"""Kernels K1 (banded SpMV) and K2 (chained SpMV) of the port.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX package's Pallas kernels in interpret mode, as
``tests/test_pallas.py`` runs them. Tolerances: K1 rtol/atol 2e-5 (f32
sums of a handful of products in another order); K2 rtol 1e-4 / atol 1e-6
after 3 iterations (the rounding differences compound). The CUDA kernels
themselves are tested on the card by ``tests_gpu/``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spsparse_tpu.core.dia import SparseDIA as JDIA
from spsparse_tpu.ops.pallas_dia import prepare_dia as j_prepare
from spsparse_tpu.ops.pallas_dia import spmv_dia_pallas
from spsparse_tpu.ops.pallas_dia_chain import spmv_dia_chain_pallas
from spsparse_torch.convert import (dia_from_numpy, prepared_dia_from_jax,
                                    tensor_to_numpy)
from spsparse_torch.ops import (best_spmv, prepare_dia, spmv_dia_chain,
                                spmv_dia_chain_reference, spmv_dia_stream,
                                spmv_dia_stream_reference)
from spsparse_torch.ops.dia_stream import MAX_DIAGS, PreparedDIA


def banded(rng, n, offsets):
    offs = np.asarray(offsets)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    data = np.where(valid, rng.uniform(-1, 1, (n, offs.size)), 0)
    return data.T.astype(np.float32).copy(), tuple(int(o) for o in offs)


def both(data, offsets, n):
    return (JDIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n)),
            dia_from_numpy(data, offsets, (n, n), device="cpu"))


K1_CASES = {
    "odd_n_f32": (1000, [-3, -1, 0, 2, 5], 128, "float32"),
    "odd_n_bf16": (1000, [-3, -1, 0, 2, 5], 128, "bfloat16"),
    "offsets_past_128_f32": (2048, [-300, -129, -128, 0, 127, 128, 301], 256,
                             "float32"),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_plain_matches_pallas_interpret(case):
    n, offsets, block, dtype = K1_CASES[case]
    rng = np.random.default_rng(len(case))
    data, offs = banded(rng, n, offsets)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    jd, td = both(data, offs, n)
    jp = j_prepare(jd, block=block, dtype=getattr(jnp, dtype))
    tp = prepare_dia(td, dtype=getattr(torch, dtype))
    y_j = np.asarray(spmv_dia_pallas(jp, x, interpret=True))
    before = spmv_dia_stream.launches
    y_t = tensor_to_numpy(spmv_dia_stream(tp, torch.from_numpy(x)))
    assert spmv_dia_stream.launches == before      # CPU: plain version
    np.testing.assert_allclose(y_t, y_j, rtol=2e-5, atol=2e-5)


def test_k2_plain_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    n = 1024
    data, offs = banded(rng, n, [-1, 0, 2])
    data *= 0.5
    x = rng.uniform(-1, 1, n).astype(np.float32)
    jd, td = both(data, offs, n)
    y_j = np.asarray(spmv_dia_chain_pallas(jd, x, iters=3, scale=0.7,
                                           block=256, interpret=True))
    y_t = tensor_to_numpy(spmv_dia_chain(td, torch.from_numpy(x), 3, 0.7))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block", [(1000, 128), (4096, 512)])
def test_prepared_layout_round_trips_jax(dtype, n, block):
    rng = np.random.default_rng(n)
    data, offs = banded(rng, n, [-2, 0, 1, 4])
    jd, td = both(data, offs, n)
    jp = j_prepare(jd, block=block, dtype=getattr(jnp, dtype))
    tp = prepare_dia(td, dtype=getattr(torch, dtype))
    from_jax = prepared_dia_from_jax(np.asarray(jp.data3), jp.offsets,
                                     jp.shape, block, device="cpu")
    assert from_jax.data.dtype == tp.data.dtype
    assert torch.equal(from_jax.data, tp.data)
    assert from_jax.offsets == tp.offsets and from_jax.shape == tp.shape


def test_best_spmv_routes_dia_to_k1_plain_on_cpu():
    rng = np.random.default_rng(12)
    n = 300
    data, offs = banded(rng, n, [-4, 0, 3])
    td = dia_from_numpy(data, offs, (n, n), device="cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    ref = spmv_dia_stream_reference(prepare_dia(td), x)
    before = spmv_dia_stream.launches
    for op in (td, prepare_dia(td)):
        y = best_spmv(op, x)
        assert y.dtype == torch.float32
        torch.testing.assert_close(y, ref, rtol=0, atol=0)
    assert spmv_dia_stream.launches == before
    dense = tensor_to_numpy(td.to_dense()).astype(np.float64)
    np.testing.assert_allclose(tensor_to_numpy(ref), dense @ x.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_best_spmv_rejects_unported_formats():
    # Every operand format of the JAX package is ported (the shuffle layout
    # in slice 5): best_spmv routes the real layout, and an object that only
    # bears its name is not taken for it.
    from spsparse_torch.core.coo import SparseCOO
    from spsparse_torch.ops import prepare_shuffle_spmv

    class PreparedShuffleSpMV:
        pass

    with pytest.raises((AttributeError, TypeError)):
        best_spmv(PreparedShuffleSpMV(), torch.zeros(3))
    dense = torch.tensor([[0.0, 2.0, 0.0], [1.0, 0.0, -3.0]])
    x = torch.tensor([0.5, -1.0, 2.0])
    prep = prepare_shuffle_spmv(SparseCOO.from_dense(dense, device="cpu"))
    torch.testing.assert_close(best_spmv(prep, x), dense @ x)


def _prep(n=16, K=3, dtype=torch.float32):
    data = torch.zeros((K, n), dtype=dtype)
    return PreparedDIA(data=data, offsets=tuple(range(K)), shape=(n, n))


@pytest.mark.parametrize("bad", ["x_length", "x_int", "data_dtype",
                                 "data_noncontig", "too_many_diags",
                                 "chain_nonsquare"])
def test_wrappers_check_operands(bad):
    prep, x = _prep(), torch.zeros(16)
    fn = spmv_dia_stream
    if bad == "x_length":
        x = torch.zeros(15)
    elif bad == "x_int":
        x = torch.zeros(16, dtype=torch.int32)
    elif bad == "data_dtype":
        prep = _prep(dtype=torch.float64)
    elif bad == "data_noncontig":
        prep = PreparedDIA(data=torch.zeros((16, 3)).T, offsets=(0, 1, 2),
                           shape=(16, 16))
    elif bad == "too_many_diags":
        prep = _prep(K=MAX_DIAGS + 1)
    else:
        prep = PreparedDIA(data=torch.zeros((1, 16)), offsets=(0,),
                           shape=(16, 17))
        x = torch.zeros(17)
        fn = spmv_dia_chain
    with pytest.raises((ValueError, TypeError)):
        fn(prep, x, 2) if fn is spmv_dia_chain else fn(prep, x)


def test_chain_zero_iterations_copies_x():
    prep, x = _prep(), torch.arange(16, dtype=torch.float32)
    y = spmv_dia_chain(prep, x, 0)
    assert torch.equal(y, x)
