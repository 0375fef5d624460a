#!/usr/bin/env python3
"""What a round of the graph tier's device loops costs on the card, and
the two layout choices of ``spsparse_torch/graph`` beside their
alternatives.

    python3 tests_gpu/graph_probe.py

On W, the 1024 x 1024 grid graph of the chip smoke's graph path (2**20
nodes, 4,190,208 entries), CUDA events a call (20 calls after one warm-up):

* the gather of a frontier of 8 sources by the edges' tails, the frontier
  held ``(n, 8)`` (a row a node) and ``(8, n)`` (a row a source, the
  port's ``by_column`` layout), float64 and float32;
* ``segment_reduce`` (``scatter_reduce_`` ``amin``) of int32 labels over
  W's edges in both orientations (8,380,416) with three quarters of them
  dead: the dead slots all on node 0 (the JAX package's padding
  convention) against the live edges only (``live_edges``);
* a Bellman-Ford round (gather, add, reduce, minimum) and a label
  propagation round as the port runs them, each with its host sync, by
  the host clock.

It also times, on the host, ``np.unique`` of config 2c's 10,485,760 keys
against a sort and a mask (``chip_smoke.unique_keys``). Prints one JSON
line with the card's name and power limit. Needs a CUDA card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import spsparse_torch as sp  # noqa: E402
from spsparse_torch.graph import csgraph as cg  # noqa: E402
from spsparse_torch.graph import edge_arrays  # noqa: E402
from spsparse_torch.graph.semiring import segment_reduce  # noqa: E402


def events_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = "cuda"
    out = {}
    n = 1 << 20
    rows, cols, _, _ = cs.cfg2c_entries(n)
    keys = rows.astype(np.int64) * n + cols
    t0 = time.perf_counter()
    a = np.unique(keys)
    out["np_unique_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = cs.unique_keys(keys)
    out["sort_unique_s"] = time.perf_counter() - t0
    assert np.array_equal(a, b)

    side = 1024
    wr, wc = cs.grid_pattern(side)
    W, _ = cs.graph_of(sp, dev, n, wr, wc,
                       cs.symmetric_weights(wr, wc, n, 28))
    tails = torch.from_numpy(wr).to(dev)
    for dt in (torch.float64, torch.float32):
        d = torch.rand(n, 8, dtype=dt, device=dev)
        dk = d.T.contiguous()
        tag = "f64" if dt == torch.float64 else "f32"
        out[f"gather_n8_{tag}_ms"] = events_ms(lambda: d[tails])
        out[f"gather_8n_{tag}_ms"] = events_ms(lambda: dk[:, tails])

    t, h, w, live = edge_arrays(W)
    both_t, both_h = torch.cat([t, h]).long(), torch.cat([h, t]).long()
    e = both_t.shape[0]
    alive = torch.rand(e, device=dev) < 0.25
    lab = torch.randint(0, n, (n,), dtype=torch.int32, device=dev)
    dead_t = torch.where(alive, both_t, 0)
    dead_h = torch.where(alive, both_h, 0)
    none = torch.tensor(n, dtype=torch.int32, device=dev)
    out["labels_dead_on_node0_ms"] = events_ms(lambda: segment_reduce(
        torch.where(alive, lab[dead_t], none), dead_h, n, "min"))
    keep = torch.nonzero(alive).squeeze(1)
    lt, lh = both_t[keep], both_h[keep]
    out["labels_live_only_ms"] = events_ms(
        lambda: segment_reduce(lab[lt], lh, n, "min"))
    out["live_fraction"] = float(keep.numel()) / e

    step = cg._relax_step(t, h, w, live, n, torch.float64)
    d = torch.rand(8, n, dtype=torch.float64, device=dev)
    out["bf_round_8n_wall_ms"] = wall_ms(lambda: bool((step(d) < d).any()))
    ones = torch.ones(e, dtype=torch.bool, device=dev)
    lt, lh = cg.live_edges(ones, both_t, both_h)

    def label_round():
        inc = segment_reduce(lab[lt], lh, n, "min")
        nl = torch.minimum(lab, inc)
        nl = torch.minimum(nl, nl[nl.long()])
        nl = torch.minimum(nl, nl[nl.long()])
        return bool((nl != lab).any())

    out["label_round_wall_ms"] = wall_ms(label_round)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
