#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (`actinon_tpu_torch`).

    python3 portbench/run.py --workload cornell_box.frames --seed 7 \\
        --seconds 20 --trace 0

Run from the root of a checkout.  Sets the cell of BENCHMARK.json up,
measures it for `--seconds` (the unit in flight at the close runs to its
end), reads the per-layer metrics with `--trace 1`, checks what the timed
units produced against the plain reference, and prints one JSON line as
the last line of standard output, the numbers compared beside their
limits as the last lines of standard error.  Exits non-zero without a
result when the cells' cards are missing, or when JAX or the JAX package
was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # every build and kernel cache of the run at a fixed path inside the
    # checkout; no library may load JAX through flax
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [ROOT, HERE]

    import harness
    _, cell, *_ = harness.resolve(ROOT, a.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(ROOT, a.workload, a.seed, a.seconds,
                                     a.trace, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
