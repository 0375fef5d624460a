#!/usr/bin/env python3
"""Where the staged K7 kernel spends its cycles, on one CUDA card.

    python3 tests_gpu/k7_phases.py

Copies ``spsparse_torch/csrc`` into a temporary directory twice, adds
``clock64()`` counters to the copies' ``onehot_kernel`` (thread 0 of each
CTA; the sums are kept in a ``__device__`` array), compiles each with the
repository's nvcc flags and runs it on bench config 3's tiles
(``chip_smoke.regrid_entries``, 2**18 rows, X of 128 columns), where it
must equal the repository's K7 bit for bit:

* ``loop``: a unit's staging (``stage_next``: grouping, the X copy's
  issue, the walk to the next unit and its slot loads), the wait for its
  X rows, the compute phase, and the store of a block row's Y rows with
  the loop's last barrier;
* ``staging``: the parts of ``stage_next``: the pass over the slots up to
  the first barrier, the grouping after it, the issue of the X copy, the
  walk to the next unit, the issue of its slot loads; and how many units
  came in row order.

Prints one JSON line each, cycles a unit (sums over the CTAs / units),
with the time of one call of the instrumented copy by CUDA events and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import spsparse_torch as sp  # noqa: E402
from spsparse_torch import backend  # noqa: E402
from spsparse_torch.ops import prepare_tiled_rows, spmm_tiled_onehot  # noqa: E402

COUNT = ("if (threadIdx.x == 0) atomicAdd(&g_cyc[{i}], "
         "(unsigned long long)(clock64() - {t}));")

# (anchor in tiled.cu, text added after it), per variant; the counters are
# g_cyc[0..7].
LOOP = [
    ("  for (int it = 0;; ++it) {\n",
     "    const long long c0 = clock64();\n"),
    ("    stage_next((it + NS - 1) % NS);   // computed at it - 1: free\n",
     "    const long long c1 = clock64(); " + COUNT.format(i=0, t="c0") + "\n"),
    ("    __syncthreads();   // unit it's rows and entries are in place for all\n",
     "    const long long c2 = clock64(); " + COUNT.format(i=1, t="c1") + "\n"),
    ("    compute_unit(stage_at(smem, s, ecap), acc, warp, lane);\n",
     "    const long long c3 = clock64(); " + COUNT.format(i=2, t="c2") + "\n"),
    ("    __syncthreads();   // stage s is free for the unit NS - 1 ahead\n",
     "    " + COUNT.format(i=3, t="c3")
     + " if (threadIdx.x == 0) atomicAdd(&g_cyc[7], 1ull);\n"),
]
STAGING = [
    ("  const unsigned lt = (1u << lane) - 1u;\n  // The row of the nonzero",
     "  const unsigned lt = (1u << lane) - 1u;\n"
     "  const long long a0 = clock64();\n  // The row of the nonzero"),
    ("  __syncthreads();\n  // Every warp reads the summaries",
     "  __syncthreads();\n  const long long a1 = clock64(); "
     + COUNT.format(i=0, t="a0") + "\n  // Every warp reads the summaries"),
    ("  // Warp w copies rows w*8 ... w*8 + 7, lane l columns n0 + 4l ... + 3.\n",
     "  const long long a2 = clock64(); " + COUNT.format(i=1, t="a1")
     + " if (threadIdx.x == 0 && ordered) atomicAdd(&g_cyc[6], 1ull);\n"
     "  // Warp w copies rows w*8 ... w*8 + 7, lane l columns n0 + 4l ... + 3.\n"),
    ("        cp_async4(dst + q, ok ? src + q : X, ok);\n      }\n    }\n  }\n",
     "        cp_async4(dst + q, ok ? src + q : X, ok);\n      }\n    }\n  }\n"
     "  " + COUNT.format(i=2, t="a2") + "\n"),
    ("      nxt = L.next(nxt, empty);\n",
     "      const long long b1 = clock64();\n      nxt = L.next(nxt, empty);\n"
     "      const long long b2 = clock64(); " + COUNT.format(i=3, t="b1") + "\n"),
    ("      load_slots(L, nxt, S, warp, lane);\n    }\n",
     "      load_slots(L, nxt, S, warp, lane);\n      "
     + COUNT.format(i=4, t="b2")
     + " if (threadIdx.x == 0) atomicAdd(&g_cyc[7], 1ull);\n    }\n"),
]


def instrument(src: str, variant: str) -> str:
    """tiled.cu with the variant's counters added."""
    if variant == "loop":
        edits = [(anchor, anchor + add) for anchor, add in LOOP]
    else:
        edits = STAGING
    for anchor, text in edits:
        if anchor not in src:
            raise RuntimeError(f"k7_phases: anchor not found: {anchor!r}")
        src = src.replace(anchor, text, 1)
    src = src.replace("namespace k7 {\n",
                      "namespace k7 {\n__device__ unsigned long long g_cyc[8];\n",
                      1)
    return src + '''
extern "C" int sps_k7_counters(void* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {};
    return (int)cudaMemcpyToSymbol(k7::g_cyc, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, k7::g_cyc, 8 * sizeof(long long));
}
'''


def build(tmp: Path) -> dict:
    procs = {}
    for variant in ("loop", "staging"):
        d = tmp / variant
        shutil.copytree(backend.CSRC_DIR, d)
        (d / "tiled.cu").write_text(instrument((d / "tiled.cu").read_text(),
                                               variant))
        so = d / "libk7.so"
        procs[variant] = (so, subprocess.Popen(
            [backend.find_nvcc(), *backend.NVCC_FLAGS, "-shared", "-o",
             str(so), str(d / "tiled.cu")], stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for variant, (so, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"{variant}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.sps_tiled_onehot.argtypes = backend._SIGNATURES["sps_tiled_onehot"]
        lib.sps_k7_counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[variant] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_phases: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    m = cs.SPMM_M
    rr, cc, vals, Xh = cs.regrid_entries(m)
    prep = prepare_tiled_rows(sp.to_tiled(cs.build_coo(sp, "cuda", (m, 2 * m),
                                                       rr, cc, vals)))
    X = torch.from_numpy(Xh).cuda()
    want = spmm_tiled_onehot(prep, X)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for variant, lib in libs.items():
            def run():
                Y = torch.empty_like(want)
                err = lib.sps_tiled_onehot(
                    prep.tcols.data_ptr(), prep.rows.data_ptr(),
                    prep.cols.data_ptr(), prep.vals.data_ptr(), prep.nbr,
                    prep.tiles_per_row, prep.tile_cap, prep.nbc,
                    X.data_ptr(), X.shape[0], X.shape[1], Y.data_ptr(),
                    prep.shape[0], torch.cuda.current_stream().cuda_stream)
                backend.check(err, f"instrumented K7 ({variant})")
                return Y

            if not torch.equal(run().view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"instrumented K7 ({variant}) differs")
            torch.cuda.synchronize()
            lib.sps_k7_counters(None, 1)
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            lib.sps_k7_counters(ctypes.cast(buf, ctypes.c_void_p), 0)
            c = list(buf)
            units = max(c[7], 1)
            names = (("stage_next", "wait for X", "compute", "store + barrier")
                     if variant == "loop" else
                     ("slot pass to barrier 1", "grouping", "X copy issue",
                      "walk to next unit", "slot loads issue"))
            row = {"k7 phases": variant, "matrix": "config 3", "units": c[7],
                   "cycles a unit (thread 0 of each CTA)": {
                       name: c[i] / units for i, name in enumerate(names)},
                   "ms": float(np.median(cs.time_ms(torch, run, reps=5,
                                                    inner=3))),
                   "device": torch.cuda.get_device_name(0),
                   "nvidia_smi": smi}
            if variant == "staging":
                row["units in row order"] = c[6]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
