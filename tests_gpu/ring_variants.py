#!/usr/bin/env python3
"""The SpGEMM ring of ``spsparse_torch/csrc/spgemm.cu`` against scratch
variants of itself, on one CUDA card.

    python3 tests_gpu/ring_variants.py

Copies ``spsparse_torch/csrc`` into a temporary directory once for each
variant, edits the copy's ``spgemm.cu``, compiles it with the repository's
nvcc flags (all copies in parallel) and times the repository's library
against the copy's, in turns (copy, repository, repository, copy):

* ``no zero test``: the warps' zero-block tests removed (float32 before a
  chunk's step, bfloat16 before the mma's of each 16-deep step), so every
  step runs. Timed with K9 and K13 on a plan of full random tiles, where
  nothing can be skipped (256 operand tiles uniform(-1, 1) from
  ``default_rng(0)``, 2000 output tiles of 3 random pairs each, A B and
  A B^T, float32 and bfloat16): the cost of the test; and with K8 and K9
  on bench config 4's A A^T (band and pair plans): what the skipping
  gains there. float32 results must agree bit for bit.
* ``K8 persistent``: K8 launched as K13 is, persistent CTAs (two an SM)
  over slot ranges balanced by pair count, instead of one CTA a band
  slot. Timed on bench config 4's band plan (``chip_smoke.cfg4_entries``,
  2**17 rows), float32 and bfloat16; the bands must agree bit for bit.

Prints one JSON line per case with the card's name and power limit.
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

TILES, N_OUT, PER_TILE = 256, 2000, 3
# (text in spgemm.cu, its replacement, occurrences)
VARIANTS = {
    "no zero test": (
        ("    if (warp_block_empty<kTransB>(st, flags, tid)) return;\n", "",
         1),
        ("    if (frags_empty(a, b)) continue;\n", "", 2)),
    "K8 persistent": (
        ("launch_ring<float, true, false>(a, b, pairs, nslots",
         "launch_ring<float, true, true>(a, b, pairs, nslots", 1),
        ("launch_ring<__nv_bfloat16, true, false>(a, b, pairs, nslots",
         "launch_ring<__nv_bfloat16, true, true>(a, b, pairs, nslots", 1),
        # a CTA's range spans slots: the producer tracks its pair's slot
        ("  int p_load = p0, k_load = 0, ta = 0, tb = 0;\n",
         "  int p_load = p0, k_load = 0, ta = 0, tb = 0, t_cur = t0;\n", 1),
        ("    if (k_load == 0) pairs.tiles(t0, p_load, ta, tb);\n",
         "    if (k_load == 0) {\n"
         "      while (pstart[t_cur + 1] <= p_load) ++t_cur;\n"
         "      pairs.tiles(t_cur, p_load, ta, tb);\n"
         "    }\n", 1)),
}
ENTRIES = ("sps_spgemm_pairs", "sps_spgemm_pairs_stream", "sps_spgemm_window")


def build_variants(tmp: Path) -> dict:
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = tmp / f"v{i}"
        shutil.copytree(backend.CSRC_DIR, src)
        text = (src / "spgemm.cu").read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} not found {count} times")
            text = text.replace(old, new)
        (src / "spgemm.cu").write_text(text)
        lib = src / "lib.so"
        procs[name] = (lib, subprocess.Popen(
            [backend.find_nvcc(), *backend.NVCC_FLAGS, "-shared", "-o",
             str(lib), str(src / "spgemm.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            getattr(libs[name], entry).argtypes = backend._SIGNATURES[entry]
            getattr(libs[name], entry).restype = ctypes.c_int
    return libs


def report(variant, case, ms, ms_variant, same, smi, **extra):
    print(json.dumps({
        "variant": variant, **case, "ms": ms, "ms_variant": ms_variant,
        "ratio": ms / ms_variant, "bitwise_equal": same, **extra,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
        flush=True)


def time_pair(run, repo, variant):
    """Run once each (compare), then time in turns."""
    o1, o2 = run(repo), run(variant)
    torch.cuda.synchronize()
    same = bool(torch.equal(o1, o2))
    ms, ms_v = cs.compare_times(torch, lambda: run(repo),
                                lambda: run(variant), reps=15, inner=5)
    return ms, ms_v, same


def no_zero_test(repo, variant, dev, smi):
    rng = np.random.default_rng(0)
    blocks32 = torch.from_numpy(rng.uniform(-1, 1, (TILES, 128, 128)).astype(
        np.float32)).to(dev)
    pa, pb = (torch.from_numpy(rng.integers(0, TILES, N_OUT * PER_TILE)
                               .astype(np.int32)).to(dev) for _ in range(2))
    pstart = torch.arange(0, N_OUT * PER_TILE + 1, PER_TILE,
                          dtype=torch.int32, device=dev)
    out = torch.empty((N_OUT, 128, 128), device=dev)
    for dname, code, blocks in (("f32", 0, blocks32),
                                ("bf16", 1, blocks32.to(torch.bfloat16))):
        for transpose_b in (0, 1):
            for entry in ("sps_spgemm_pairs", "sps_spgemm_pairs_stream"):
                def run(lib):
                    o = torch.empty_like(out)
                    backend.check(getattr(lib, entry)(
                        code, transpose_b, blocks.data_ptr(),
                        blocks.data_ptr(), pa.data_ptr(), pb.data_ptr(),
                        pstart.data_ptr(), N_OUT, o.data_ptr(),
                        backend.current_stream(dev)), entry)
                    return o

                ms, ms_v, same = time_pair(run, repo, variant)
                if dname == "f32" and not same:
                    raise RuntimeError(f"{entry} f32: the copy differs")
                report("no zero test", dict(
                    kernel=entry, dtype=dname,
                    transpose_b=bool(transpose_b)), ms, ms_v, same, smi,
                    tiles=TILES, n_out=N_OUT, pairs=N_OUT * PER_TILE)


def config4(repo, libs, dev, smi):
    """K8 on bench config 4's band plan against both variants, and K9 on
    its A A^T pair plan against ``no zero test``, float32 and bfloat16."""
    from spsparse_torch.ops import (densify_tiled, plan_tiled_spgemm,
                                    plan_window_spgemm, prepare_tiled_dense)
    from spsparse_torch.ops.tiled_spmm import _DTYPE_CODE, check_blocks

    n = cs.CFG4_N
    r, c, v = cs.cfg4_entries(n)
    b = sp.CooBuilder((n, 2 * n), dtype=np.float32)
    b.add_many(np.stack([r, c], 1), v)
    tl = sp.to_tiled(sp.consolidate(b.build(device=dev)))
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        prep = prepare_tiled_dense(tl, dtype=dt)
        plan = plan_window_spgemm(prep.tcols, prep.tcols, nbc=prep.nbc,
                                  out_shape=(n, n), dtype=dt)
        t = plan.tensors(dev)
        NB = plan.nband

        def k8(lib):
            band = torch.empty((plan.nbr_pad, NB, 128, 128), device=dev)
            backend.check(lib.sps_spgemm_window(
                check_blocks(prep.blocks, "A"), prep.blocks.data_ptr(),
                prep.blocks.data_ptr(), t["slot_pstart"].data_ptr(),
                t["pt"].data_ptr(), t["pu"].data_ptr(),
                t["prefix"].data_ptr(), plan.nbr_pad * NB, NB, plan.W,
                sum(plan.pmax_band), plan.rt_a, plan.rt_b, band.data_ptr(),
                backend.current_stream(dev)), "sps_spgemm_window")
            return band

        for name in ("K8 persistent", "no zero test"):
            ms, ms_v, same = time_pair(k8, repo, libs[name])
            if dname == "f32" and not same:
                raise RuntimeError(f"K8 {dname}: {name} differs")
            report(name, dict(kernel="sps_spgemm_window", dtype=dname,
                              matrix="config 4 A A^T band"), ms, ms_v, same,
                   smi, slots=plan.nbr_pad * NB, live_pairs=plan.n_live)

        X = densify_tiled(tl, dtype=dt)
        pplan = plan_tiled_spgemm(X, X, transpose_b=True)
        pt = pplan.tensors(dev)

        def k9(lib):
            out = torch.empty((pplan.n_out_tiles, 128, 128), device=dev)
            backend.check(lib.sps_spgemm_pairs(
                _DTYPE_CODE[dt], 1, X.blocks.data_ptr(), X.blocks.data_ptr(),
                pt["pa"].data_ptr(), pt["pb"].data_ptr(),
                pt["pstart"].data_ptr(), pplan.n_out_tiles, out.data_ptr(),
                backend.current_stream(dev)), "sps_spgemm_pairs")
            return out

        ms, ms_v, same = time_pair(k9, repo, libs["no zero test"])
        if dname == "f32" and not same:
            raise RuntimeError(f"K9 {dname}: no zero test differs")
        report("no zero test", dict(kernel="sps_spgemm_pairs", dtype=dname,
                                    matrix="config 4 A A^T pairs"), ms, ms_v,
               same, smi, pairs=pplan.n_pairs, n_out=pplan.n_out_tiles)


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = cs.nvidia_smi_line()
    dev = torch.device("cuda")
    repo = backend.load_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        no_zero_test(repo, libs["no zero test"], dev, smi)
        config4(repo, libs, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
