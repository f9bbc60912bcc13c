"""Fixtures of the benchmark's tests: the harness's modules on the path,
a checkout cut to a small size for the CPU, and the card check."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH]

# the CPU sizes: render settings and the tile of the radiance checks
TINY = dict(image_width=16, image_height=16, direct_samples=2,
            path_samples=2, tile=8)
SMALL = dict(image_width=32, image_height=32, direct_samples=4,
             path_samples=4, tile=16)


def cut_checkout(root, size):
    """A copy of the benchmark (BENCHMARK.json and portbench/) under root
    whose configurations render at `size`; the scenes are read from this
    checkout."""
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = root / c["file"]
        conf = json.loads(path.read_text())
        conf["scene"] = os.path.join(ROOT, conf["scene"])
        conf["render"].update({k: v for k, v in size.items()
                               if k != "tile"})
        conf["check"]["tile"] = size["tile"]
        path.write_text(json.dumps(conf))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture
def tiny_root(tmp_path):
    return cut_checkout(tmp_path / "checkout", TINY)


@pytest.fixture
def small_root(tmp_path):
    return cut_checkout(tmp_path / "checkout", SMALL)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
