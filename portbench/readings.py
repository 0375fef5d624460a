"""Readings that the limits of ``correct`` are set from, at the cell's own
size on the card: the program's numbers on many seeds, and the control's
(the reference in bfloat16 in the program's place, on the same inputs and
the same sampled jobs) on some of them. One process a cell; each seed
builds its inputs and runs a short window as a benchmark run does.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 3 [--out FILE]

Prints one JSON line a seed (and appends it to ``FILE``). The benchmark's
own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main() -> int:
    from portbench import harness as h
    import torch

    p = argparse.ArgumentParser(prog="portbench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    h.cache_env()
    spec = h.load_spec()
    cell = h.find_cell(spec, a.workload)
    cfg, mix = h.load_config(cell["config"]), h.load_mix(cell["traffic"])
    mod = h.job_module(mix)
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        control = {}

        def checker(cfg_, mix_, seed_, dev_, samples, seed=seed):
            got = mod.check(cfg_, mix_, seed_, dev_, samples)
            if seed in controls:
                control.update(mod.check(cfg_, mix_, seed_, dev_, samples,
                                         control=True))
            return got

        t0 = time.perf_counter()
        r = h.run_cell(a.workload, cfg, mix, [], seed=seed,
                       seconds=a.seconds, trace=False, device=device,
                       t_start=t0, checker=checker)
        line = {"workload": a.workload, "seed": seed,
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "control": control or None, "correct": r["correct"],
                "attempted": r["attempted"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    bad = h.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
