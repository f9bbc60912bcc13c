"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: `actinon_tpu_torch` begins with `actinon_tpu`."""

import ast
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "actinon_tpu"}


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """The top-level names of every module a file imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(BENCH)))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path)), path


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(BENCH, "reference.py")
    assert "actinon_tpu_torch" not in set(imported(path)), path


def test_loaded_modules():
    """In a process that imports the harness, the reference and every
    metric, and renders a few samples with the reference, no forbidden
    module is loaded, nor any of the program by the reference."""
    code = f"""
import sys, os, json
import numpy as np
sys.path[:0] = [{ROOT!r}, {BENCH!r}]
import reference, timing, devtrace, kinds, harness
for f in os.listdir(os.path.join({BENCH!r}, "metrics")):
    harness.reader({ROOT!r}, f[:-3])
conf = json.load(open(os.path.join({BENCH!r}, "configs", "cornell_box.json")))
sc = reference.Scene(conf, "cpu")
reference.Render(sc, 1).radiance(np.array([[256.5, 300.5], [100.2, 50.7]]))
bad = [m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}
       or m.split(".")[0] == "actinon_tpu_torch"]
print(bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
