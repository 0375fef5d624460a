"""The port's CUDA kernels against their plain PyTorch versions, on a card.

    python -m pytest tests_gpu -m gpu -q

Every test is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is false; the decision is made inside each test. This lane imports neither
JAX nor the JAX package (the CPU parity tests under ``tests/`` hold the
plain versions against JAX). Tolerances: K1 rtol/atol 1e-5 (the kernel
fuses multiply-adds, the plain version rounds each product); K2 rtol 1e-4 /
atol 1e-6 over up to 7 iterations.
"""

import numpy as np
import pytest
import torch

import spsparse_torch.ops.dia_stream as dia_stream_mod
from spsparse_torch.convert import dia_from_numpy
from spsparse_torch.ops import (best_spmv, prepare_dia, spmv_dia_chain,
                                spmv_dia_chain_reference, spmv_dia_stream,
                                spmv_dia_stream_reference)

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def banded(rng, n, offsets, scale=1.0):
    offs = np.asarray(offsets)
    cols = np.arange(n)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n)
    data = np.where(valid, rng.uniform(-1, 1, (n, offs.size)), 0) * scale
    return data.T.astype(np.float32).copy(), tuple(int(o) for o in offs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,offsets", [
    (100_003, [-300, -5, 0, 1, 7, 129]),
    (1, [0]),
    (777, list(range(-60, 61))),
])
def test_k1_matches_plain(dtype, n, offsets):
    dev = _cuda()
    rng = np.random.default_rng(n)
    data, offs = banded(rng, n, offsets)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev),
                       dtype=getattr(torch, dtype))
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    before = spmv_dia_stream.launches
    y = spmv_dia_stream(prep, x)
    torch.cuda.synchronize()
    assert spmv_dia_stream.launches == before + 1
    torch.testing.assert_close(y, spmv_dia_stream_reference(prep, x),
                               rtol=1e-5, atol=1e-5)


def test_k1_rectangular_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(3)
    n, m = 5000, 3000
    offs = (-2, 0, 1, 2500)
    cols = np.arange(n)[:, None] + np.asarray(offs)[None, :]
    valid = (cols >= 0) & (cols < m)
    data = np.where(valid, rng.uniform(-1, 1, (n, len(offs))), 0)
    prep = prepare_dia(dia_from_numpy(data.T.astype(np.float32).copy(), offs,
                                      (n, m), device=dev))
    x = torch.from_numpy(rng.uniform(-1, 1, m).astype(np.float32)).to(dev)
    torch.testing.assert_close(spmv_dia_stream(prep, x),
                               spmv_dia_stream_reference(prep, x),
                               rtol=1e-5, atol=1e-5)


def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    dev = _cuda()
    rng = np.random.default_rng(4)
    n = 4096
    data, offs = banded(rng, n, [-1, 0, 1])
    dia = dia_from_numpy(data, offs, (n, n), device=dev)
    x = torch.ones(n, device=dev)
    want = spmv_dia_stream_reference(prepare_dia(dia), x)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(dia_stream_mod, "spmv_dia_stream_reference", refuse)
    torch.testing.assert_close(best_spmv(dia, x), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("iters", [1, 2, 7])
def test_k2_matches_plain(iters):
    dev = _cuda()
    rng = np.random.default_rng(14)
    n = 65_537
    data, offs = banded(rng, n, [-2, 0, 3, 200], scale=0.5)
    prep = prepare_dia(dia_from_numpy(data, offs, (n, n), device=dev))
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    before = spmv_dia_chain.launches
    z = spmv_dia_chain(prep, x, iters, 0.9)
    torch.cuda.synchronize()
    assert spmv_dia_chain.launches == before + 1
    torch.testing.assert_close(
        z, spmv_dia_chain_reference(prep, x, iters, 0.9),
        rtol=1e-4, atol=1e-6)
