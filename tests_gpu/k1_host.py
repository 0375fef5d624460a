#!/usr/bin/env python3
"""Where the host time of a K1 call goes, on one CUDA card.

    python3 tests_gpu/k1_host.py

Builds config 2's band as ``chip_smoke.py`` does (2**20 rows, offsets
-5..5) and prepares it in float32 and bfloat16. For each it times
``spmv_dia_stream`` and ``best_spmv`` (the route the solvers take): by CUDA
events at 10 and at 100 calls a timed run (``chip_smoke.time_ms``), by the
host clock over bursts of 100 calls that are not waited for, each burst
after a synchronise (``chip_smoke.host_issue_us``: the rate at which the
host issues them), and the parts of the wrapper one by one on the host
clock (the operand and x checks, the autograd test, the output's
allocation, the stream lookup, the library lookup, a ctypes call of the
same arguments that launches nothing, and the ctypes call with its launch
on arguments made beforehand), and the device time a call from
``torch.profiler`` (``chip_smoke.device_ms``, ``profile_kernels.py``'s
method); beside them, a ``copy_`` that moves the same bytes, the rate at
which the card streams that much. When the host issues
a call more slowly than the card runs it, the event time of a run of calls
is the host's. Prints one JSON line a dtype with the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import spsparse_torch as sp  # noqa: E402
from spsparse_torch import backend  # noqa: E402
from spsparse_torch.ops import best_spmv, prepare_dia  # noqa: E402
from spsparse_torch.ops import spmv_dia_stream  # noqa: E402
from spsparse_torch.ops import dia_stream as dia_mod  # noqa: E402


def us_or_none(ms):
    """Microseconds of a ``cs.device_ms`` reading; None stays None (the
    profiler caught no kernel)."""
    return None if ms is None else 1e3 * ms


def parts(prep, x):
    """``(the bare ctypes call, {part: function})``: the wrapper's parts,
    each to be timed on the host clock."""
    op = prep.launch
    lib = backend.load_kernels()
    y = torch.empty(op.n, device=x.device)
    stream = backend.current_stream_of(op.device_index)

    def raw():
        err = lib.sps_dia_spmv(op.code, prep.data.data_ptr(), op.ld, op.n,
                               op.m, op.K, op.offsets_ptr, x.data_ptr(),
                               y.data_ptr(), 1.0, stream)
        if err:
            backend.check(err, "sps_dia_spmv")

    geo = (ctypes.c_longlong * 7)()

    def no_launch():
        lib.sps_dia_spmv_geometry(op.code, op.ld, op.n, op.K,
                                  op.offsets_ptr, prep.data.data_ptr(),
                                  y.data_ptr(), ctypes.addressof(geo))

    return raw, {
        "check_operands (operand cached, x as it is)":
            lambda: dia_mod.check_operands(prep, x),
        "needs_grad": lambda: dia_mod.needs_grad(prep, x),
        "torch.empty(n)": lambda: torch.empty(op.n, dtype=torch.float32,
                                              device=op.device),
        "backend.current_stream_of": lambda: backend.current_stream_of(
            op.device_index),
        "backend.load_kernels": backend.load_kernels,
        "ctypes call of sps_dia_spmv_geometry (8 arguments, the same "
        "offsets and geometry work, no launch)": no_launch,
        "ctypes call and launch, arguments made beforehand": raw,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_host: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    n = cs.N
    band = cs.band_of(n)
    B = sp.SparseDIA(data=torch.from_numpy(band.T.copy()).cuda(),
                     offsets=tuple(range(-cs.BAND, cs.BAND + 1)),
                     shape=(n, n))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, n)
                         .astype(np.float32)).cuda()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_dia(B, dtype=dtype)

        def call():
            return spmv_dia_stream(prep, x)

        def routed():
            return best_spmv(prep, x)

        raw, part = parts(prep, x)
        # A copy moving K1's bytes (diagonals, x and y once each): the rate
        # at which this card streams that much.
        nbytes = (sum(n - abs(o) for o in prep.offsets)
                  * prep.data.element_size() + 8 * n)
        src = torch.ones(nbytes // 8, device="cuda")
        dst = torch.empty_like(src)
        out = {
            "dtype": name,
            "events ms of a copy of the same bytes (copy_), 20 calls a run":
                float(np.median(cs.time_ms(torch, lambda: dst.copy_(src),
                                           reps=9, inner=20))),
            "events ms, 10 calls a run": float(np.median(cs.time_ms(
                torch, call))),
            "events ms, 100 calls a run": float(np.median(cs.time_ms(
                torch, call, reps=7, inner=100))),
            "events ms of best_spmv, 10 calls a run": float(np.median(
                cs.time_ms(torch, routed))),
            "events ms of the bare ctypes call, 10 calls a run": float(
                np.median(cs.time_ms(torch, raw))),
            "device us a call (torch.profiler)": us_or_none(cs.device_ms(
                torch, call, "spmv_dia_stream")),
            "host us a call, spmv_dia_stream": cs.host_issue_us(torch, call),
            "host us a call, best_spmv": cs.host_issue_us(torch, routed),
            "host us a part": {k: cs.host_issue_us(torch, fn)
                               for k, fn in part.items()},
            "n": n, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
