#!/usr/bin/env python3
"""Where the persistent K4 kernel spends its cycles, on one CUDA card.

    python3 tests_gpu/k4_phases.py

Copies ``spsparse_torch/csrc`` into a temporary directory, adds
``clock64()`` counters to the copy's ``cg_kernel`` (thread 0 of each CTA;
the sums are kept in a ``__device__`` array), compiles it with the
repository's nvcc flags and runs 40 CG iterations on ``chip_smoke.spd_dia``
11-diagonal matrices at n = 2**20, 2**14 and 2**22 (float32; the last in
the device-memory mode), where it must equal the repository's K4 bit for
bit. The counters, per CTA and iteration:

* the iteration's phases: ``p update`` (with the barrier after it),
  ``SpMV`` (thread 0's own chunks), ``p.Ap exchange``, ``x, r update``
  (with the publishing of rows), ``r.r exchange``;
* the parts of both exchanges together: ``block sum`` (the CTA's
  reduction, which waits for its slowest warp), ``fence and store`` (the
  slot's release store), ``timer read``, ``wait for the slots`` (the acquire
  loads until every slot carries the epoch), ``tree and barrier`` (the
  shuffle tree and the CTA's barrier).

Prints one JSON line a case: cycles per CTA and iteration, the SM clock
nvidia-smi reports, the time of an iteration of the instrumented copy and
of the repository's kernel by CUDA events (``chip_smoke.per_iteration_ms``)
and the card's name and power limit.
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
from spsparse_torch import backend  # noqa: E402
from spsparse_torch.ops import cg_solve_dia  # noqa: E402
from spsparse_torch.ops.dia_cg import cg_kernel_geometry  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ab_kernels import k4_call  # noqa: E402

ITERS = 40
NAMES = ["p update", "SpMV", "p.Ap exchange", "x, r update",
         "r.r exchange", "block sum", "fence and store", "timer read",
         "wait for the slots", "tree and barrier"]


def count(i: int, t: str) -> str:
    return (f"if (threadIdx.x == 0) atomicAdd(&g_cyc[{i}], "
            f"(unsigned long long)(clock64() - {t}));")


# (anchor in dia_cg.cu, replacement), each anchor found exactly once.
PROBES = [
    ("namespace {\n\nusing sps::DiaOffsets;\n",
     "namespace {\n\n__device__ unsigned long long g_cyc[16];\n\n"
     "using sps::DiaOffsets;\n"),
    ("  for (int it = 0; it < a.iters; ++it) {\n",
     "  for (int it = 0; it < a.iters; ++it) {\n"
     "    const long long c0 = clock64();\n"),
    ("    // Ap = (A + shift I) p and this CTA's share of p.Ap.\n",
     "    const long long c1 = clock64(); " + count(0, "c0") + "\n"
     "    // Ap = (A + shift I) p and this CTA's share of p.Ap.\n"),
    ("    const float pap =\n",
     "    const long long c2 = clock64(); " + count(1, "c1") + "\n"
     "    const float pap =\n"),
    ("    const float alpha = rs / (pap == 0.f ? 1.f : pap);\n",
     "    const float alpha = rs / (pap == 0.f ? 1.f : pap);\n"
     "    const long long c3 = clock64(); " + count(2, "c2") + "\n"),
    ("    const float rsnew =\n",
     "    const long long c4 = clock64(); " + count(3, "c3") + "\n"
     "    const float rsnew =\n"),
    ("    rs = rsnew;\n",
     "    rs = rsnew;\n    " + count(4, "c4") + "\n"),
    ("  const float total = block_sum(part, scratch);\n",
     "  const long long gs = clock64();\n"
     "  const float total = block_sum(part, scratch);\n"
     "  const long long g1 = clock64(); " + count(5, "gs") + "\n"),
    ("  if (threadIdx.x < 32) {\n    const unsigned lane = threadIdx.x;\n"
     "    const unsigned long long t0 = global_ns();\n",
     "  const long long g2 = clock64(); " + count(6, "g1") + "\n"
     "  long long g3 = 0;\n"
     "  if (threadIdx.x < 32) {\n    const unsigned lane = threadIdx.x;\n"
     "    const unsigned long long t0 = global_ns();\n"
     "    const long long gt = clock64(); " + count(7, "g2") + "\n"),
    ("#pragma unroll\n    for (int o = 16; o > 0; o >>= 1) v += "
     "__shfl_down_sync(0xffffffffu, v, o);\n    if (lane == 0) scratch[slot]",
     "    g3 = clock64(); " + count(8, "gt") + "\n"
     "#pragma unroll\n    for (int o = 16; o > 0; o >>= 1) v += "
     "__shfl_down_sync(0xffffffffu, v, o);\n    if (lane == 0) scratch[slot]"),
    ("  __syncthreads();\n  return scratch[slot];\n",
     "  __syncthreads();\n  " + count(9, "g3") + "\n"
     "  return scratch[slot];\n"),
]
READER = """
extern "C" int sps_k4_cycles(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));
}
extern "C" int sps_k4_cycles_zero() {
  const unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_cyc, z, sizeof(z));
}
"""


def instrumented(tmp: Path) -> ctypes.CDLL:
    d = tmp / "csrc"
    shutil.copytree(backend.CSRC_DIR, d)
    src = (d / "dia_cg.cu").read_text()
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} not found once")
        src = src.replace(anchor, text)
    (d / "dia_cg.cu").write_text(src + READER)
    so = d / "lib.so"
    res = subprocess.run([backend.find_nvcc(), *backend.NVCC_FLAGS,
                          "-shared", "-o", str(so), str(d / "dia_cg.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("sps_dia_cg", "sps_dia_cg_geometry"):
        getattr(lib, fn).argtypes = backend._SIGNATURES[fn]
    lib.sps_k4_cycles.argtypes = [ctypes.c_void_p]
    return lib


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_phases: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    band = tuple(range(-cs.BAND, cs.BAND + 1))
    with tempfile.TemporaryDirectory() as tmp:
        lib = instrumented(Path(tmp))
        for n in (cs.N, cs.CG_SMALL_N, 4 * cs.N):
            prep = cs.spd_dia(torch, "cuda", n, band, 5)
            b = torch.from_numpy(np.random.default_rng(6).uniform(
                -1, 1, n).astype(np.float32)).cuda()
            copy = k4_call(lib, False, prep, b)
            x, _ = copy(ITERS)
            want, _ = cg_solve_dia(prep, b, iters=ITERS, shift=cs.SHIFT)
            torch.cuda.synchronize()
            if not torch.equal(x, want):
                raise RuntimeError(f"n = {n}: the instrumented copy differs")
            backend.check(lib.sps_k4_cycles_zero(), "sps_k4_cycles_zero")
            copy(ITERS)
            torch.cuda.synchronize()
            cyc = (ctypes.c_ulonglong * 16)()
            backend.check(lib.sps_k4_cycles(ctypes.cast(cyc, ctypes.c_void_p)),
                          "sps_k4_cycles")
            grid = cg_kernel_geometry(n).grid
            per = {name: cyc[i] / (grid * ITERS)
                   for i, name in enumerate(NAMES)}
            ms = cs.per_iteration_ms(torch, {
                "instrumented": copy,
                "kernel": lambda it: cg_solve_dia(prep, b, iters=it,
                                                  shift=cs.SHIFT)})
            print(json.dumps({
                "case": f"K4 f32, n = {n}", "grid": grid, "iterations": ITERS,
                "cycles_per_cta_iteration": per,
                "exchange_parts_are_summed_over_both_exchanges": True,
                "sm_clock_mhz_now_max": sm_clock(),
                "instrumented_ms_per_iteration": ms["instrumented"],
                "kernel_ms_per_iteration": ms["kernel"],
                "device": torch.cuda.get_device_name(0),
                "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
