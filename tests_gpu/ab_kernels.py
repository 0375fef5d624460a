#!/usr/bin/env python3
"""K1, K4, K7, K10 and K12 of this checkout against scratch variants of
their sources and against another checkout's, on one CUDA card.

    python3 tests_gpu/ab_kernels.py [--other DIR]
                                    [--kernels k1,k4,k7,k10,k12] [--out FILE]

Copies ``spsparse_torch/csrc`` into a temporary directory once for each
variant, edits the copy's ``dia.cu`` (K1, K2), ``dia_cg.cu`` (K4),
``tiled.cu`` (K7), ``segsum.cu`` (K10) or ``block_sort.cu`` (K12),
compiles each edited source on its own with the
repository's nvcc flags (all in parallel, ``-Xptxas -v``) and times the
copy's kernel against this checkout's library in turns (copy, this, this,
copy):

* ``other`` (with ``--other DIR``): the sources as another checkout of
  the repository holds them (the parent commit unpacked with
  ``git archive``, say). K7 and K12 compute the same function there, so
  their results must equal this checkout's bit for bit; K4 is held to this
  checkout's within 1e-4 of max|x| (a two-pass K4, the design before the
  persistent one, sums in another order; its C signature is told apart by
  its source). K1 and K2 sum each row's diagonals in the same order with
  the same fused multiply-adds in both designs, so the bits are compared
  and reported (``bit_for_bit``), and the results held to rtol 1e-5; K10
  (a group of lanes a row before, a fixed range of entries a CTA now: two
  sum orders) is held to rtol 1e-5 and atol 1e-5 of max|y|. The earlier
  K10's C signature (lanes a row, no carry slots) is told apart by its
  source.
* K1 variants (the same function, so bit for bit): ``K1 batches of 8``
  (diagonals in flight a thread, four in this checkout), with and without
  a floor of four CTAs an SM (a cap of 64 registers), ``K1 four CTAs an
  SM`` and ``K1 f32 8 rows a thread`` (two 16-byte loads a diagonal, half
  the CTAs); and an ablation, ``K1 no x loads`` (wrong results; only the
  time is kept).
* ``K10 search only``: every tile finds its rows by the 32-way search
  and the rounds of row pointers, never from its row-pointer window (the
  same function, so bit for bit); and two ablations (wrong results, only
  the time is kept): ``K10 loads only`` (each tile's loads and nothing
  after) and ``K10 no carry waits``.
* K4 ablations, each with a part of the persistent kernel's work taken out
  (the results are wrong, save without the prefetch; only the time is
  kept): ``K4 no diagonal stream`` (every tap's coefficient 1, no load),
  ``K4 no foreign taps`` (a tap into another CTA's rows reads 0 instead of
  the published rows), ``K4 no prefetch`` (no L2 prefetch of the next
  iteration's diagonals), ``K4 no fences`` (the exchange's release store
  and acquire loads relaxed), ``K4 no wait`` (each CTA loads the slots
  once and goes on, ready or not: the exchange without its wait). The time
  each saves is what that part costs.
* ``ranking only``: the staged K7 without its compaction path, so that
  every unit is grouped by the stable ranking, in row order or not; the
  same function, so bit for bit.
* ``ring block rows only``: the staged K7 keeping only the block row of
  each ring stage's unit (not the whole unit), a register-allocation
  variant; bit for bit.
* K12 ablations, each with a part of the chunk kernel's work taken out
  (the results are wrong; only the time is kept): ``no shuffle stages``,
  ``no register stages``, ``no exchanges`` (the placement flag flips, no
  data moves through shared memory), and ``loads and stores only`` (all
  three out). The time each saves is what that part costs.

Cases: K1 at n = 2**20 on config 2's band (offsets -5..5, f32 and bf16),
on the solver path's Poisson offsets (0, +-1, +-1024; span 2048) and on
11 diagonals spread evenly over spans of 64 and 4096 (config 2's bytes,
past the 50 MB L2);
K2 (64 iterations) on config 2's band; K10 on bench config 2c's CSR
products (``chip_smoke.cfg2c_entries``, 2**20 rows) and on
``chip_smoke.phase_segsum``'s skewed row pointer; K4 per CG iteration
(``chip_smoke.per_iteration_ms``: solves of 72 and 8 iterations) on
``chip_smoke.spd_dia`` 11-diagonal matrices at n =
2**20 (float32 and bfloat16 diagonals), 2**22 (the device-memory mode) and
2**14 (where the exchanges dominate); K7 on bench config 3's tiles
(``chip_smoke.regrid_entries``, 2**18 rows, X of 128 columns; as built,
each tile in row order, and with each tile's slots shuffled) and on the
two one_hot-route layouts of ``chip_smoke`` phase 14 (one diagonal tile a
block row; eight tiles a block row); K12 at (1024, 64, 128) int32 keys
with a float32 payload. Prints one JSON line per (variant, case), with
each copy's ptxas registers and spill bytes and the card's name and power
limit; ``--out`` also writes the lines to a file.

With K7 selected, last, the spill sites of this checkout's staged K7 where
config 3 runs it (``onehot_kernel<true, 2>``), from ``cuobjdump -sass`` of
the library: each local-memory store and load (``STL``, ``LDL``) with the
loops around it (a loop: the range from a backward branch's target to the
branch), so that how often a spill runs can be read off: once a launch,
once a unit, or once an entry.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
from spsparse_torch.ops import prepare_general, prepare_tiled_rows  # noqa: E402
from spsparse_torch.ops.dia_stream import launch_args  # noqa: E402

# variant -> (source, [(text, replacement, occurrences)])
ABLATIONS = {
    "K4 no diagonal stream": ("dia_cg.cu", [
        ("load_stream(col + 32 * e, live)", "(live ? 1.f : 0.f)", 1)]),
    "K4 no prefetch": ("dia_cg.cu", [
        ("    prefetch_next(a.data, a.ld, row0, nloc, offs.k);\n", "", 1)]),
    "K4 no foreign taps": ("dia_cg.cu", [
        ("foreign ? __ldcg(a.pub_p + j) : 0.f;", "0.f;", 1),
        ("foreign ? __ldcg(a.pub_r + j) : 0.f;", "0.f;", 1)]),
    "K4 no fences": ("dia_cg.cu", [
        ("st.release.gpu.global.u64", "st.relaxed.gpu.global.u64", 1),
        ("ld.acquire.gpu.global.u64", "ld.relaxed.gpu.global.u64", 1)]),
    "K4 no wait": ("dia_cg.cu", [
        ("        if (ready) break;\n", "        break;\n", 1)]),
    "ranking only": ("tiled.cu", [
        ("  if (ordered) {\n", "  if (false) {\n", 1)]),
    "ring block rows only": ("tiled.cu", [
        ("  Unit unit[NS];\n", "  int ub[NS];\n", 1),
        ("    unit[s] = nxt;\n", "    ub[s] = nxt.b;\n", 1),
        ("    if (unit[s].b >= L.nbr) break;\n",
         "    if (ub[s] >= L.nbr) break;\n", 1),
        ("    if (unit[(s + 1) % NS].b != unit[s].b)",
         "    if (ub[(s + 1) % NS] != ub[s])", 1),
        ("      store_rows<kVec>(acc, unit[s].b, Y, M, N, n0, warp, lane);",
         "      store_rows<kVec>(acc, ub[s], Y, M, N, n0, warp, lane);", 1)]),
    "no shuffle stages": ("block_sort.cu", [
        ("          ch.shuffle_stage(k);\n", "          (void)0;\n", 1)]),
    "no register stages": ("block_sort.cu", [
        ("        ch.template reg_stage<true>(k - ch.sh);\n",
         "        (void)0;\n", 1),
        ("          ch.template reg_stage<false>(k);\n",
         "          (void)0;\n", 1)]),
    "no exchanges": ("block_sort.cu", [
        ("  __device__ __forceinline__ void exchange(int* sm) {\n",
         "  __device__ __forceinline__ void exchange(int* sm) {\n"
         "    if (sm) {\n      l1 = !l1;\n      return;\n    }\n", 1)]),
}
ABLATIONS["loads and stores only"] = ("block_sort.cu", [
    e for name in ("no shuffle stages", "no register stages", "no exchanges")
    for e in ABLATIONS[name][1]])
ABLATIONS["K1 batches of 8"] = ("dia.cu", [
    ("constexpr int kBatch = 4;", "constexpr int kBatch = 8;", 1)])
ABLATIONS["K1 batches of 8, four CTAs an SM"] = ("dia.cu", [
    ("constexpr int kBatch = 4;", "constexpr int kBatch = 8;", 1),
    ("__launch_bounds__(kThreads)\n    dia_spmv_kernel(",
     "__launch_bounds__(kThreads, 4)\n    dia_spmv_kernel(", 1)])
ABLATIONS["K1 four CTAs an SM"] = ("dia.cu", [
    ("__launch_bounds__(kThreads)\n    dia_spmv_kernel(",
     "__launch_bounds__(kThreads, 4)\n    dia_spmv_kernel(", 1)])
ABLATIONS["K1 f32 8 rows a thread"] = ("dia.cu", [
    ("struct Rows<float> {\n  static constexpr int V = 4;",
     "struct Rows<float> {\n  static constexpr int V = 8;", 1)])
# K1 without its reads of x (wrong results; only the time is kept): what
# the V scalar loads of x a diagonal cost a thread.
ABLATIONS["K1 no x loads"] = ("dia.cu", [
    ("acc[v] = fmaf(d[b].get(v), __ldg(x + j), acc[v]);",
     "acc[v] = fmaf(d[b].get(v), 1.f, acc[v]);", 1)])
ABLATIONS["K10 search only"] = ("segsum.cu", [
    ("  const bool from_window =\n", "  const bool from_window = false &&\n",
     1)])
# K10 with parts of its work taken out (wrong results; only the time is
# kept): the loads alone (rp[0], rp[nrows], then the row-pointer window and
# the entries), and everything but the waits for earlier tiles' carries.
ABLATIONS["K10 loads only"] = ("segsum.cu", [
    ("  // Mark where the tile's rows end; empty rows are 0; note where the row",
     "  if (v[0][0] == 1.5f) y[t] = v[1][1] + v[2][2] + v[3][3] + s_rp[t];\n"
     "  return;\n"
     "  // Mark where the tile's rows end; empty rows are 0; note where the row",
     1)])
ABLATIONS["K10 no carry waits"] = ("segsum.cu", [
    ("    if (!before.f && s_lead < a) {", "    if (false) {", 1)])
WRONG_RESULTS = {"K10 loads only", "K10 no carry waits", "K1 no x loads"}
# K10's tile (the same function; another sum order, so held to rtol 1e-5):
# 2 or 8 groups of four a lane (tiles of 2048 or 8192 entries), and 512
# threads a CTA (8192 entries).
ABLATIONS["K10 2 groups a lane"] = ("segsum.cu", [
    ("constexpr int kGroups = 4;", "constexpr int kGroups = 2;", 1)])
ABLATIONS["K10 8 groups a lane"] = ("segsum.cu", [
    ("constexpr int kGroups = 4;", "constexpr int kGroups = 8;", 1)])
ABLATIONS["K10 512 threads"] = ("segsum.cu", [
    ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;", 1)])
RETILED = {"K10 2 groups a lane", "K10 8 groups a lane", "K10 512 threads"}


# The instantiations the timed cases run: K4 (every one; the two-pass
# kernels too), K7 on 16-byte vectors (both kernels), K12 with one key and
# one payload.
K4_KERNELS = r"cg_(kernel|pass_a|pass_b|init)"
K7_VEC = r"onehot_(small_)?kernelILb1"
K12_TIMED = r"sort_chunk_kernelILi1ELi2E"


def ptxas_summary(text: str, pattern: str) -> dict:
    """Registers and spill bytes of the kernels whose mangled names match
    the regular expression ``pattern``, from ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {})["spill"] = [int(m.group(1)),
                                                 int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def spill_sites(so: Path, pattern: str) -> dict:
    """The ``STL``/``LDL`` instructions of the functions matching
    ``pattern`` in ``cuobjdump -sass so``, each with the sizes (in
    instructions) of the loops that contain it, innermost first."""
    cuobjdump = Path(backend.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
        step = ins[1][0] - ins[0][0] if len(ins) > 1 else 16
        sites = []
        for addr, text in ins:
            if re.search(r"\b(STL|LDL)\b", text):
                inside = sorted((b - a) // step + 1 for a, b in loops
                                if a <= addr <= b)
                sites.append({"at": hex(addr), "sass": text,
                              "loops_around": inside})
        out[name] = {"instructions": len(ins), "loops": len(loops),
                     "spill_sites": sites}
    return out


SOURCES = {"k1": "dia.cu", "k4": "dia_cg.cu", "k7": "tiled.cu",
           "k10": "segsum.cu", "k12": "block_sort.cu"}
ENTRY_POINTS = {"dia.cu": ("sps_dia_spmv", "sps_dia_chain"),
                "dia_cg.cu": ("sps_dia_cg", "sps_dia_cg_geometry"),
                "tiled.cu": ("sps_tiled_onehot",),
                "segsum.cu": ("sps_segsum",),
                "block_sort.cu": ("sps_block_sort",)}
# The K10 C signature before the fixed-range design (lanes a row).
GROUP_K10 = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
# The two-pass K4's C signature (before the persistent kernel).
TWO_PASS_K4 = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_float] + [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p]
# The persistent K4's C signature before its cycle counters (no stats).
NO_STATS_K4 = backend._SIGNATURES["sps_dia_cg"][:-1]


def build(tmp: Path, other: Path | None, sources: set) -> dict:
    """``{variant: {source: (CDLL, ptxas text)}}``, compiled in parallel."""
    jobs = {}
    if other is not None:
        for src in sorted(sources):
            jobs[("other", src)] = other / "spsparse_torch" / "csrc"
    for name, (src, _) in ABLATIONS.items():
        if src in sources:
            jobs[(name, src)] = backend.CSRC_DIR
    procs = {}
    for i, ((name, src), csrc) in enumerate(jobs.items()):
        d = tmp / f"v{i}"
        shutil.copytree(csrc, d)
        if name in ABLATIONS:
            text = (d / src).read_text()
            for old, new, count in ABLATIONS[name][1]:
                if text.count(old) != count:
                    raise RuntimeError(f"{name}: {old!r} not found {count} "
                                       "times")
                text = text.replace(old, new)
            (d / src).write_text(text)
        so = d / "lib.so"
        procs[(name, src)] = (so, d / src, subprocess.Popen(
            [backend.find_nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(so), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict = {}
    for (name, src), (so, path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} ({src}): nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        # An earlier design with its own C signature: the two-pass K4, the
        # K10 of a group of lanes a row.
        text = path.read_text()
        two_pass = (src == "dia_cg.cu" and "cg_pass_a" in text
                    or src == "segsum.cu" and "int group" in text)
        no_stats = src == "dia_cg.cu" and "void* stats" not in text
        for fn in ENTRY_POINTS[src]:
            if two_pass and fn == "sps_dia_cg_geometry":
                continue
            getattr(lib, fn).argtypes = (
                TWO_PASS_K4 if two_pass and fn == "sps_dia_cg"
                else GROUP_K10 if two_pass and fn == "sps_segsum"
                else NO_STATS_K4 if no_stats and fn == "sps_dia_cg"
                else backend._SIGNATURES[fn])
        libs.setdefault(name, {})[src] = (lib, log, two_pass)
    return libs


def k4_call(lib, two_pass: bool, prep, b):
    """A solve of ``iters`` iterations (a function of ``iters``) by the K4
    of ``lib``: the persistent kernel's arguments from its own geometry
    function, or the two-pass kernel's buffers."""
    code, offs = launch_args(prep)
    n = prep.shape[0]
    dev = b.device
    offs_p = ctypes.cast(offs, ctypes.c_void_p)

    def run(iters):
        x = torch.empty(n, device=dev)
        scal = torch.empty(3, device=dev)    # two-pass: rs, alpha, beta
        stream = torch.cuda.current_stream().cuda_stream
        if two_pass:
            r, p_a, p_b, ap = torch.empty((4, n), device=dev).unbind(0)
            nparts = -(-n // 256)
            partial = torch.empty(nparts, device=dev)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            err = lib.sps_dia_cg(
                code, prep.data.data_ptr(), prep.data.stride(0), n,
                len(prep.offsets), offs_p, cs.SHIFT, b.data_ptr(),
                x.data_ptr(), r.data_ptr(), p_a.data_ptr(), p_b.data_ptr(),
                ap.data_ptr(), partial.data_ptr(), nparts,
                counter.data_ptr(), scal.data_ptr(), iters, stream)
        else:
            geo = (ctypes.c_longlong * 6)()
            backend.check(lib.sps_dia_cg_geometry(
                code, n, ctypes.cast(geo, ctypes.c_void_p)),
                "sps_dia_cg_geometry")
            scratch = torch.empty(geo[5], device=dev)
            stats = (None,) * (len(lib.sps_dia_cg.argtypes)
                               - len(NO_STATS_K4))
            err = lib.sps_dia_cg(
                code, prep.data.data_ptr(), prep.data.stride(0), n,
                len(prep.offsets), offs_p, cs.SHIFT, b.data_ptr(),
                x.data_ptr(), scratch.data_ptr(), scratch.numel(),
                scal.data_ptr(), iters, stream, *stats)
        backend.check(err, "sps_dia_cg")
        return x, scal[0]
    return run


def k4_cases():
    """``{case: (prep, b)}``: 11-diagonal SPD matrices on the card."""
    band = tuple(range(-cs.BAND, cs.BAND + 1))
    cases = {}
    for what, n, dtype in (("K4 f32, n = 2^20", cs.N, torch.float32),
                           ("K4 bf16, n = 2^20", cs.N, torch.bfloat16),
                           ("K4 f32, n = 2^22 (device-memory mode)",
                            4 * cs.N, torch.float32),
                           ("K4 f32, n = 2^14", cs.CG_SMALL_N,
                            torch.float32)):
        prep = cs.spd_dia(torch, "cuda", n, band, 5)
        prep = type(prep)(data=prep.data.to(dtype), offsets=prep.offsets,
                          shape=prep.shape)
        b = torch.from_numpy(np.random.default_rng(6).uniform(
            -1, 1, n).astype(np.float32)).cuda()
        cases[what] = (prep, b)
    return cases


def k7_call(lib, fn, prep, X):
    def run():
        Y = torch.empty((prep.shape[0], X.shape[1]), device=X.device)
        backend.check(getattr(lib, fn)(
            prep.tcols.data_ptr(), prep.rows.data_ptr(),
            prep.cols.data_ptr(), prep.vals.data_ptr(), prep.nbr,
            prep.tiles_per_row, prep.tile_cap, prep.nbc, X.data_ptr(),
            X.shape[0], X.shape[1], Y.data_ptr(), prep.shape[0],
            torch.cuda.current_stream().cuda_stream), fn)
        return Y
    return run


def k12_call(lib, arrays):
    def run():
        outs = [torch.empty_like(a) for a in arrays]
        ip = (ctypes.c_void_p * len(arrays))(*[a.data_ptr() for a in arrays])
        op = (ctypes.c_void_p * len(outs))(*[a.data_ptr() for a in outs])
        nblk, R, L = arrays[0].shape
        backend.check(lib.sps_block_sort(
            ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(op, ctypes.c_void_p),
            len(arrays), 1, nblk, R * L,
            torch.cuda.current_stream().cuda_stream), "sps_block_sort")
        return tuple(outs)
    return run


def k1_call(lib, prep, x):
    """K1 of ``lib`` on ``prep`` and ``x`` (the library's C signature is
    the same in both designs)."""
    op = prep.launch

    def run():
        y = torch.empty(op.n, device=x.device)
        backend.check(lib.sps_dia_spmv(
            op.code, prep.data.data_ptr(), op.ld, op.n, op.m, op.K,
            op.offsets_ptr, x.data_ptr(), y.data_ptr(), 1.0,
            torch.cuda.current_stream().cuda_stream), "sps_dia_spmv")
        return y
    return run


def k2_call(lib, prep, x, iters):
    """``iters`` chained SpMVs of ``lib``'s K2 (scale 0.3)."""
    op = prep.launch

    def run():
        a, b = x.clone(), torch.empty_like(x)
        backend.check(lib.sps_dia_chain(
            op.code, prep.data.data_ptr(), op.ld, op.n, op.K,
            op.offsets_ptr, a.data_ptr(), b.data_ptr(), iters,
            cs.CHAIN_SCALE, torch.cuda.current_stream().cuda_stream),
            "sps_dia_chain")
        return a if iters % 2 == 0 else b
    return run


def k1_cases():
    """``{case: (prep, x)}`` at n = 2**20: config 2's band in f32 and bf16,
    the Poisson offsets and five diagonals of each span."""
    from spsparse_torch.ops import prepare_dia

    n = cs.N
    band = cs.band_of(n)
    B = sp.SparseDIA(data=torch.from_numpy(band.T.copy()).cuda(),
                     offsets=tuple(range(-cs.BAND, cs.BAND + 1)),
                     shape=(n, n))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, n)
                         .astype(np.float32)).cuda()
    cases = {"K1 f32, config 2": (prepare_dia(B), x),
             "K1 bf16, config 2": (prepare_dia(B, dtype=torch.bfloat16), x)}
    rng = np.random.default_rng(3)
    spans = [("K1 f32, P's offsets (span 2048)", (-1024, -1, 0, 1, 1024))]
    spans += [(f"K1 f32, 11 diagonals over span {s}",
               tuple(int(o) for o in np.linspace(-s // 2, s // 2, 11)))
              for s in (64, 4096)]
    for what, offs in spans:
        data = torch.from_numpy(rng.uniform(-1, 1, (len(offs), n))
                                .astype(np.float32)).cuda()
        cases[what] = (prepare_dia(sp.SparseDIA(data=data, offsets=offs,
                                                shape=(n, n))), x)
    return cases


def k10_call(lib, group: bool, prod, rp, nrows):
    """K10 of ``lib``: the fixed-range kernel with this checkout's carry
    slots, or the earlier kernel with its lanes a row (its wrapper's rule:
    the power of two at or above a quarter of the mean row length, at most
    32)."""
    from spsparse_torch.ops.segsum import _TILE, _carry_slots

    def run():
        y = torch.empty(nrows, device=prod.device)
        stream = torch.cuda.current_stream().cuda_stream
        if group:
            quarter = -(-prod.shape[0] // (4 * max(nrows, 1)))
            lanes = min(1 << max(quarter - 1, 0).bit_length(), 32)
            err = lib.sps_segsum(prod.data_ptr(), rp.data_ptr(), nrows,
                                 lanes, y.data_ptr(), stream)
        else:
            # Slots for tiles down to a quarter of this checkout's.
            carries, tag = _carry_slots(
                prod.device, stream, max(1, -(-prod.shape[0] // (_TILE // 4))))
            err = lib.sps_segsum(prod.data_ptr(), prod.shape[0],
                                 rp.data_ptr(), nrows, y.data_ptr(),
                                 carries.data_ptr(), carries.shape[0], tag,
                                 stream)
        backend.check(err, "sps_segsum")
        return y
    return run


def k10_cases():
    """``{case: (prod, row_ptr, nrows)}``: config 2c's CSR products and
    phase 23's skewed row pointer."""
    from spsparse_torch.ops import csr_products

    n = cs.N
    r, c, v, x = cs.cfg2c_entries(n)
    csr = sp.to_csr(cs.build_coo(sp, "cuda", (n, n), r, c, v))
    prod = csr_products(csr, torch.from_numpy(x).cuda())
    rng = np.random.default_rng(11)
    ns = 1 << 16
    counts = rng.integers(0, 4, ns) * (np.arange(ns) % 5 != 0)
    counts[ns // 3] = 4096
    rp = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    ph = rng.uniform(-1, 1, int(rp[-1])).astype(np.float32)
    return {"K10 config 2c": (prod, csr.row_ptr[:n + 1].contiguous(), n),
            "K10 skewed row pointer": (torch.from_numpy(ph).cuda(),
                                       torch.from_numpy(rp).cuda(), ns)}


def k7_cases():
    m = cs.SPMM_M
    rr, cc, vals, Xh = cs.regrid_entries(m)
    prep = prepare_tiled_rows(sp.to_tiled(cs.build_coo(
        sp, "cuda", (m, 2 * m), rr, cc, vals)))
    X3 = torch.from_numpy(Xh).cuda()
    cases = {"K7 config 3": (prep, X3),
             "K7 config 3, rows unsorted within tiles": (
                 cs.unsorted_tiles(torch, prep), X3)}
    for what, entries in (("K7 one_hot route", cs.onehot_entries(m)),
                          ("K7 one_hot route, 8 tiles a block row",
                           cs.onehot_tiles_entries(m))):
        pg = prepare_general(cs.build_coo(sp, "cuda", (m, m), *entries))
        if pg.kernel != "one_hot":
            raise RuntimeError(f"{what} routed to {pg.kernel}")
        X = torch.from_numpy(np.random.default_rng(6).uniform(
            -1, 1, (m, cs.SPMM_N)).astype(np.float32)).cuda()
        cases[what] = (pg.prep, X if pg.order is None else X[pg.order])
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--kernels", default="k1,k4,k7,k10,k12")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    chosen = {k.strip() for k in args.kernels.split(",") if k.strip()}
    if not chosen <= set(SOURCES):
        print(f"ab_kernels: --kernels takes {sorted(SOURCES)}",
              file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    this = backend.load_kernels()
    kw = dict(reps=7, inner=3, warmup=2)
    # K1 and K10 run for tens of us: 20 calls a timed run.
    kw_short = dict(reps=15, inner=20, warmup=3)
    lines = []

    def emit(row):
        row.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)

    k1 = k1_cases() if "k1" in chosen else {}
    k10 = k10_cases() if "k10" in chosen else {}
    k4 = k4_cases() if "k4" in chosen else {}
    k7 = k7_cases() if "k7" in chosen else {}
    if "k12" in chosen:
        rng = np.random.default_rng(12)
        sort_arrays = (
            torch.from_numpy(rng.integers(0, 1 << 30, (cs.SORT_NBLK, 64, 128))
                             .astype(np.int32)).cuda(),
            torch.from_numpy(rng.uniform(-1, 1, (cs.SORT_NBLK, 64, 128))
                             .astype(np.float32)).cuda())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), args.other,
                     {SOURCES[k] for k in chosen})
        for name, by_src in libs.items():
            for src, (lib, log, two_pass) in by_src.items():
                if src == "dia.cu":
                    cases = [(what, k1_call(this, prep, x),
                              k1_call(lib, prep, x))
                             for what, (prep, x) in k1.items()]
                    if name == "other":
                        prep, x = k1["K1 f32, config 2"]
                        cases.append((
                            "K2 f32, config 2, 64 iterations",
                            k2_call(this, prep, x, cs.CHAIN_ITERS),
                            k2_call(lib, prep, x, cs.CHAIN_ITERS)))
                    for what, mine, theirs in cases:
                        y, z = mine(), theirs()
                        same = torch.equal(y.view(torch.int32),
                                           z.view(torch.int32))
                        err = float((y - z).abs().max())
                        if name not in WRONG_RESULTS and not (
                                same or name == "other" and err <= 1e-5
                                * float(y.abs().max())):
                            raise RuntimeError(f"{name}: {what} differs "
                                               f"({err})")
                        ms, var_ms = cs.compare_times(torch, mine, theirs,
                                                      **kw_short)
                        emit({"variant": name, "case": what, "this_ms": ms,
                              "variant_ms": var_ms, "bit_for_bit": same,
                              "max_abs_err": err,
                              "ptxas": ptxas_summary(log, "dia_spmv")})
                elif src == "segsum.cu":
                    for what, (prod, rp, nrows) in k10.items():
                        mine = k10_call(this, False, prod, rp, nrows)
                        theirs = k10_call(lib, two_pass, prod, rp, nrows)
                        y, z = mine(), theirs()
                        err = float((y - z).abs().max())
                        if name not in WRONG_RESULTS and not (
                                err <= 1e-5 * float(y.abs().max())
                                and (name in RETILED | {"other"}
                                     or torch.equal(y.view(torch.int32),
                                                    z.view(torch.int32)))):
                            raise RuntimeError(f"{name}: {what} differs "
                                               f"({err})")
                        ms, var_ms = cs.compare_times(torch, mine, theirs,
                                                      **kw_short)
                        emit({"variant": name, "case": what, "this_ms": ms,
                              "variant_ms": var_ms, "max_abs_err": err,
                              "ptxas": ptxas_summary(log, "segsum")})
                elif src == "dia_cg.cu":
                    for what, (prep, b) in k4.items():
                        mine = k4_call(this, False, prep, b)
                        theirs = k4_call(lib, two_pass, prep, b)
                        row = {"variant": name, "case": what,
                               "two_pass": two_pass}
                        if name == "other":
                            x, _ = mine(cs.CG_ITERS)
                            y, _ = theirs(cs.CG_ITERS)
                            err = float((x - y).abs().max())
                            if not err <= 1e-4 * float(x.abs().max()):
                                raise RuntimeError(f"other: {what} differs "
                                                   f"({err})")
                            row["max_abs_err"] = err
                        ms = cs.per_iteration_ms(
                            torch, {"this": mine, "variant": theirs})
                        row.update(this_ms_per_iteration=ms["this"],
                                   variant_ms_per_iteration=ms["variant"],
                                   ptxas=ptxas_summary(log, K4_KERNELS))
                        emit(row)
                elif src == "tiled.cu":
                    for what, (prep, X) in k7.items():
                        mine = k7_call(this, "sps_tiled_onehot", prep, X)
                        theirs = k7_call(lib, "sps_tiled_onehot", prep, X)
                        same = torch.equal(mine().view(torch.int32),
                                           theirs().view(torch.int32))
                        if not same:
                            raise RuntimeError(f"{name}: {what} differs")
                        ms, var_ms = cs.compare_times(torch, mine, theirs,
                                                      **kw)
                        emit({"variant": name, "case": what, "this_ms": ms,
                              "variant_ms": var_ms, "bit_for_bit": same,
                              "ptxas": ptxas_summary(log, K7_VEC)})
                else:
                    mine = k12_call(this, sort_arrays)
                    theirs = k12_call(lib, sort_arrays)
                    row = {"variant": name,
                           "case": "K12 (1024, 64, 128) key + payload"}
                    if name == "other":
                        row["bit_for_bit"] = cs.bitwise_equal(torch, mine(),
                                                              theirs())
                        if not row["bit_for_bit"]:
                            raise RuntimeError("other: K12 differs")
                    else:
                        theirs()   # a wrong result: launched, not compared
                    row["this_ms"], row["variant_ms"] = cs.compare_times(
                        torch, mine, theirs, **kw)
                    row["ptxas"] = ptxas_summary(log, K12_TIMED)
                    emit(row)
    if "k7" in chosen:
        so = next(backend.KERNEL_DIR.glob("*/" + backend._LIB_NAME))
        emit({"spill sites": "this checkout's staged K7 at config 3",
              "sass": spill_sites(so, r"onehot_kernelILb1ELi2E")})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
