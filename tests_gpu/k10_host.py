#!/usr/bin/env python3
"""Where the host time of a K10 call goes, on one CUDA card.

    python3 tests_gpu/k10_host.py

Builds bench config 2c's CSR products as ``chip_smoke.py`` does (2**20
rows, 10 uniform-random columns a row) and times ``segmented_row_sums`` on
them: by CUDA events at 10 and at 100 calls a timed run
(``chip_smoke.time_ms``), by the host clock over 2000 calls that are not
waited for (the rate at which the host issues them), and the parts of the
wrapper one by one on the host clock (its checks and casts, the row pointer,
the output's allocation, the stream lookup, the library lookup, and the
ctypes call with its launch on arguments made beforehand). When the host
issues a call more slowly than the card runs it, the event time of a run
of calls is the host's. Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import spsparse_torch as sp  # noqa: E402
from spsparse_torch import backend  # noqa: E402
from spsparse_torch.ops import csr_products, segmented_row_sums  # noqa: E402
from spsparse_torch.ops import segsum as segsum_mod  # noqa: E402

CALLS = 2000


def host_us(fn, calls: int = CALLS) -> float:
    """Microseconds a call of ``fn`` on the host clock, not waited for."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("k10_host: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    dev, n = "cuda", cs.N
    r, c, v, x = cs.cfg2c_entries(n)
    csr = sp.to_csr(cs.build_coo(sp, dev, (n, n), r, c, v))
    prod = csr_products(csr, torch.from_numpy(x).to(dev))
    rp = segsum_mod._row_ptr(csr.row_ptr, n)
    y = torch.empty(n, device=dev)
    lib = backend.load_kernels()
    lanes = segsum_mod._lanes_per_row(prod.shape[0], n)
    stream = backend.current_stream(prod.device)

    def call():
        return segmented_row_sums(prod, csr.row_ptr, nrows=n,
                                  rows_per_block=256, entries_per_block=1024)

    def raw():
        backend.check(lib.sps_segsum(prod.data_ptr(), rp.data_ptr(), n, lanes,
                                     y.data_ptr(), stream), "sps_segsum")

    parts = {
        "checks and casts of prod": lambda: prod.to(torch.float32)
        .contiguous(),
        "_row_ptr": lambda: segsum_mod._row_ptr(csr.row_ptr, n),
        "torch.empty(n)": lambda: torch.empty(n, dtype=torch.float32,
                                              device=prod.device),
        "backend.current_stream": lambda: backend.current_stream(
            prod.device),
        "backend.load_kernels": backend.load_kernels,
        "_lanes_per_row": lambda: segsum_mod._lanes_per_row(
            prod.shape[0], n),
        "ctypes call and launch, arguments made beforehand": raw,
    }
    out = {
        "events ms, 10 calls a run": float(np.median(cs.time_ms(
            torch, call))),
        "events ms, 100 calls a run": float(np.median(cs.time_ms(
            torch, call, reps=7, inner=100))),
        "events ms of the bare ctypes call, 10 calls a run": float(
            np.median(cs.time_ms(torch, raw))),
        "host us a call, segmented_row_sums": host_us(call),
        "host us a part": {name: host_us(fn) for name, fn in parts.items()},
        "nnz": csr.nnz, "n": n,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
