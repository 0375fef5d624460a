#!/usr/bin/env python3
"""K7 and K12 of this checkout against scratch variants of their sources and
against another checkout's, on one CUDA card.

    python3 tests_gpu/ab_kernels.py [--other DIR] [--out FILE]

Copies ``spsparse_torch/csrc`` into a temporary directory once for each
variant, edits the copy's ``tiled.cu`` (K7) or ``block_sort.cu`` (K12),
compiles each edited source on its own with the repository's nvcc flags
(all in parallel, ``-Xptxas -v``) and times the copy's kernel against this
checkout's library in turns (copy, this, this, copy):

* ``other`` (with ``--other DIR``): both sources as another checkout of
  the repository holds them (the parent commit unpacked with
  ``git archive``, say). It computes the same function, so its results
  must equal this checkout's bit for bit.
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

Cases: K7 on bench config 3's tiles (``chip_smoke.regrid_entries``,
2**18 rows, X of 128 columns; as built, each tile in row order, and with
each tile's slots shuffled) and on the two one_hot-route layouts of
``chip_smoke`` phase 14 (one diagonal tile a block row; eight tiles a
block row), each also against the first SIMT body
(``sps_tiled_onehot_simt``) in turns; K12 at (1024, 64, 128) int32 keys
with a float32 payload. Prints one JSON line per (variant, case), with
each copy's ptxas registers and spill bytes and the card's name and power
limit; ``--out`` also writes the lines to a file.

Last, the spill sites of this checkout's staged K7 where config 3 runs it
(``onehot_kernel<true, 2>``), from ``cuobjdump -sass`` of the library:
each local-memory store and load (``STL``, ``LDL``) with the loops around
it (a loop: the range from a backward branch's target to the branch), so
that how often a spill runs can be read off: once a launch, once a unit,
or once an entry.
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

# variant -> (source, [(text, replacement, occurrences)])
ABLATIONS = {
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


# The instantiations the timed cases run: K7 on 16-byte vectors (both
# kernels), K12 with one key and one payload.
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


def build(tmp: Path, other: Path | None) -> dict:
    """``{variant: {source: (CDLL, ptxas text)}}``, compiled in parallel."""
    jobs = {}
    if other is not None:
        for src in ("tiled.cu", "block_sort.cu"):
            jobs[("other", src)] = other / "spsparse_torch" / "csrc"
    for name, (src, _) in ABLATIONS.items():
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
        procs[(name, src)] = (so, subprocess.Popen(
            [backend.find_nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(so), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict = {}
    for (name, src), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} ({src}): nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in (("sps_tiled_onehot", "sps_tiled_onehot_simt")
                   if src == "tiled.cu" else ("sps_block_sort",)):
            getattr(lib, fn).argtypes = backend._SIGNATURES[fn]
        libs.setdefault(name, {})[src] = (lib, log)
    return libs


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
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    this = backend.load_kernels()
    rng = np.random.default_rng(12)
    sort_arrays = (
        torch.from_numpy(rng.integers(0, 1 << 30, (cs.SORT_NBLK, 64, 128))
                         .astype(np.int32)).cuda(),
        torch.from_numpy(rng.uniform(-1, 1, (cs.SORT_NBLK, 64, 128))
                         .astype(np.float32)).cuda())
    k7 = k7_cases()
    kw = dict(reps=7, inner=3, warmup=2)
    lines = []

    def emit(row):
        row.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), args.other)
        # K7 of this checkout against its first SIMT body.
        for what, (prep, X) in k7.items():
            ms, simt_ms = cs.compare_times(
                torch, k7_call(this, "sps_tiled_onehot", prep, X),
                k7_call(this, "sps_tiled_onehot_simt", prep, X), **kw)
            emit({"variant": "this vs first SIMT body", "case": what,
                  "ms": ms, "simt_ms": simt_ms,
                  "slots_a_block_row": prep.tiles_per_row * prep.tile_cap,
                  "tile_cap": prep.tile_cap})
        for name, by_src in libs.items():
            for src, (lib, log) in by_src.items():
                if src == "tiled.cu":
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
    so = next(backend.KERNEL_DIR.glob("*/" + backend._LIB_NAME))
    emit({"spill sites": "this checkout's staged K7 at config 3",
          "sass": spill_sites(so, r"onehot_kernelILb1ELi2E")})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
