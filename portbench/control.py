#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card:

    python3 portbench/control.py --workload cornell_box.frames \\
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control-seeds 1 2 3

For each seed, the program is set up and runs `--units` units at the
cell's own size; the numbers compared (the judge of `kinds.py`) are
printed for the program and, on the control seeds, for the control: the
configuration's reference computed in bfloat16 in the program's place.
The benchmark's own runs never run the control.  One JSON line a seed."""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]
    import torch

    import harness
    _, _, config, traffic, _ = harness.resolve(ROOT, a.workload)
    for seed in sorted(set(a.seeds) | set(a.control_seeds)):
        kind = harness.cell_kind(ROOT, config, traffic, seed, a.device)
        kind.setup(tempfile.gettempdir())
        for k in range(a.units):
            kind.run_unit(k)
        kind.free()
        if a.device == "cuda":
            torch.cuda.empty_cache()
        out = {"workload": a.workload, "seed": seed}
        if seed in a.seeds:
            t0 = time.perf_counter()
            out["program"] = kind.judge(a.device, diag=True)
            out["judge_s"] = time.perf_counter() - t0
        if seed in a.control_seeds:
            t0 = time.perf_counter()
            out["control"] = kind.judge(a.device, control=True, diag=True)
            out["control_s"] = time.perf_counter() - t0
        kind.close()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
