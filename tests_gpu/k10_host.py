#!/usr/bin/env python3
"""Where the host time of a K10 call goes, on one CUDA card.

    python3 tests_gpu/k10_host.py

Builds bench config 2c's CSR products as ``chip_smoke.py`` does (2**20
rows, 10 uniform-random columns a row) and times ``segmented_row_sums`` on
them: by CUDA events at 10 and at 100 calls a timed run
(``chip_smoke.time_ms``), by the host clock over bursts of 100 calls that
are not waited for (``chip_smoke.host_issue_us``: the rate at which the
host issues them), and the parts of the
wrapper one by one on the host clock (its checks, the output's allocation,
the stream lookup, the carry slots, the library lookup, and the ctypes
call with its launch on arguments made beforehand), and the device time a
call from ``torch.profiler``; beside them, a ``copy_`` that moves the same
bytes. When the host
issues a call more slowly than the card runs it, the event time of a run
of calls is the host's. Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import spsparse_torch as sp  # noqa: E402
from spsparse_torch import backend  # noqa: E402
from spsparse_torch.ops import csr_products, segmented_row_sums  # noqa: E402
from spsparse_torch.ops import segsum as segsum_mod  # noqa: E402


def us_or_none(ms):
    """Microseconds of a ``cs.device_ms`` reading; None stays None (the
    profiler caught no kernel)."""
    return None if ms is None else 1e3 * ms


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_host: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    dev, n = "cuda", cs.N
    r, c, v, x = cs.cfg2c_entries(n)
    csr = sp.to_csr(cs.build_coo(sp, dev, (n, n), r, c, v))
    prod = csr_products(csr, torch.from_numpy(x).to(dev))
    rp = csr.row_ptr
    y = torch.empty(n, device=dev)
    lib = backend.load_kernels()
    stream = backend.current_stream_of(prod.device.index)
    tiles = segsum_mod.segsum_geometry(prod.shape[0], n, prod.data_ptr()).ctas

    def call():
        return segmented_row_sums(prod, csr.row_ptr, nrows=n,
                                  rows_per_block=256, entries_per_block=1024)

    def raw():
        carries, tag = segsum_mod._carry_slots(prod.device, stream, tiles)
        err = lib.sps_segsum(prod.data_ptr(), prod.shape[0], rp.data_ptr(),
                             n, y.data_ptr(), carries.data_ptr(),
                             carries.shape[0], tag, stream)
        if err:
            backend.check(err, "sps_segsum")

    parts = {
        "checks of prod and row_ptr (no cast, no copy)": lambda: (
            prod.ndim, rp.ndim, prod.is_cuda, rp.is_cuda, prod.get_device(),
            rp.get_device(), prod.dtype is torch.float32,
            prod.is_contiguous(), rp.dtype is torch.int32, rp.shape[0],
            rp.is_contiguous()),
        "torch.empty(n)": lambda: torch.empty(n, dtype=torch.float32,
                                              device=prod.device),
        "backend.current_stream_of": lambda: backend.current_stream_of(
            prod.device.index),
        "_carry_slots": lambda: segsum_mod._carry_slots(prod.device, stream,
                                                        tiles),
        "backend.load_kernels": backend.load_kernels,
        "ctypes call and launch (carry slots included), arguments made "
        "beforehand": raw,
    }
    # A copy moving K10's bytes (products, row pointers and y once each).
    src = torch.ones((4 * csr.nnz + 8 * n) // 8, device=dev)
    dst = torch.empty_like(src)
    out = {
        "events ms of a copy of the same bytes (copy_), 20 calls a run":
            float(np.median(cs.time_ms(torch, lambda: dst.copy_(src),
                                       reps=9, inner=20))),
        "events ms, 10 calls a run": float(np.median(cs.time_ms(
            torch, call))),
        "events ms, 100 calls a run": float(np.median(cs.time_ms(
            torch, call, reps=7, inner=100))),
        "events ms of the bare ctypes call, 10 calls a run": float(
            np.median(cs.time_ms(torch, raw))),
        "device us a call (torch.profiler)": us_or_none(cs.device_ms(
            torch, call, "segmented_row_sums")),
        "host us a call, segmented_row_sums": cs.host_issue_us(torch, call),
        "host us a part": {name: cs.host_issue_us(torch, fn)
                           for name, fn in parts.items()},
        "nnz": csr.nnz, "n": n,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
