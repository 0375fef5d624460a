#!/usr/bin/env python3
"""K4's cases and per-iteration times in one short run, on one CUDA card.

    python3 tests_gpu/k4_quick.py

Builds the kernels, prints ptxas's registers and spill bytes for K4's four
instantiations, then solves ``(A + 11 I) x = b`` by 50 CG iterations on
symmetric, diagonally dominant DIA matrices built on the card
(``chip_smoke.spd_dia``: 11 diagonals at n = 2**20 in float32 and
bfloat16, at 2**22 (the device-memory mode) and 2**14; offsets
(-n/2, -1, 0, 1, n/2); n = 100 and 1 (below the grid); one diagonal at
4099), checks each as ``chip_smoke.check_cg_case`` does (the plain
version, a float64 residual, a second solve bit for bit, the geometry
against the Python mirror; a failed check raises) and prints the error,
the residual, rs and the geometry. Then the time of an iteration of five of them by CUDA events (solves of 72
and 8 iterations) beside the bound (the diagonals once at 3.35 TB/s).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from spsparse_torch import backend  # noqa: E402
from spsparse_torch.ops import cg_solve_dia  # noqa: E402
from spsparse_torch.ops.dia_stream import PreparedDIA  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_quick: needs a CUDA card", file=sys.stderr)
        return 1
    dev, n = "cuda", cs.N
    print(cs.nvidia_smi_line(), flush=True)
    backend.build()
    print(json.dumps(cs.ptxas_of(("cg_kernel",))), flush=True)
    band = tuple(range(-cs.BAND, cs.BAND + 1))
    cases = {
        "f32 2^20": (n, band, torch.float32),
        "bf16 2^20": (n, band, torch.bfloat16),
        "device-memory mode 2^22": (4 * n, band, torch.float32),
        "offsets -n/2, -1, 0, 1, n/2": (n, (-n // 2, -1, 0, 1, n // 2),
                                        torch.float32),
        "n = 100": (100, (-3, -1, 0, 1, 3), torch.float32),
        "n = 1": (1, (0,), torch.float32),
        "one diagonal": (4099, (0,), torch.float32),
        "2^14": (cs.CG_SMALL_N, band, torch.float32),
    }
    preps = {}
    for name, (m, offs, dtype) in cases.items():
        p = cs.spd_dia(torch, dev, m, offs, 1)
        prep = PreparedDIA(data=p.data.to(dtype), offsets=p.offsets,
                           shape=p.shape)
        preps[name] = prep
        b = torch.from_numpy(np.random.default_rng(2).uniform(
            -1, 1, m).astype(np.float32)).to(dev)
        out = cs.check_cg_case(torch, dev, name, prep, b)
        print(json.dumps({"case": name, **{k: out[k] for k in (
            "err", "residual", "rs", "geometry")}}), flush=True)
    for name in ("f32 2^20", "bf16 2^20", "device-memory mode 2^22", "2^14",
                 "offsets -n/2, -1, 0, 1, n/2"):
        prep = preps[name]
        m = prep.shape[0]
        b = torch.rand(m, device=dev)
        ms = cs.per_iteration_ms(torch, {"kernel": lambda it: cg_solve_dia(
            prep, b, iters=it, shift=cs.SHIFT)})["kernel"]
        stored = sum(m - abs(o) for o in prep.offsets)
        bound, _ = cs.bound_ms(stored * prep.data.element_size(), 0)
        print(json.dumps({"timing": name, "ms_per_iteration": ms,
                          "bound_ms": bound,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
