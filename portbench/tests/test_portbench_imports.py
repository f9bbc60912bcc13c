"""Nothing of the benchmark imports JAX or the JAX package, and the
references (`reference.py`, `references/*.py`) import nothing of the
program; nor does a traffic kind's module (`traffic/*.py`) when it is
imported: it drives the program from inside its methods, as `kinds.py`
does.  Top-level module names are compared whole: `actinon_tpu_torch`
begins with `actinon_tpu`."""

import ast
import glob
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


def imported(path, on_import=False):
    """The top-level names of every module a file imports; on_import:
    only where importing the file runs the statement (outside function
    bodies)."""
    todo = [ast.parse(open(path).read(), path)]
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        if not (on_import and isinstance(node, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))):
            todo.extend(ast.iter_child_nodes(node))


def references():
    return [os.path.join(BENCH, "reference.py")] + \
        sorted(glob.glob(os.path.join(BENCH, "references", "*.py")))


def traffic_kinds():
    return sorted(glob.glob(os.path.join(BENCH, "traffic", "*.py")))


@pytest.mark.parametrize("path", sorted(sources(BENCH)))
def test_no_jax(path):
    assert not FORBIDDEN & set(imported(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in references():
        assert "actinon_tpu_torch" not in set(imported(path)), path
    for path in traffic_kinds():
        assert "actinon_tpu_torch" not in set(imported(path, True)), path


def test_imported_on_import_leaves_out_function_bodies(tmp_path):
    path = tmp_path / "kind.py"
    path.write_text("import kinds\n\n\nclass K:\n    def setup(self):\n"
                    "        import actinon_tpu_torch.render\n")
    assert set(imported(str(path))) == {"kinds", "actinon_tpu_torch"}
    assert set(imported(str(path), True)) == {"kinds"}


def test_loaded_modules():
    """In a process that imports the harness, the references, every
    traffic kind's module and every metric, and renders a few samples
    with the reference, no forbidden module is loaded, nor any of the
    program by the references and kinds."""
    code = f"""
import sys, os, json
import numpy as np
sys.path[:0] = [{ROOT!r}, {BENCH!r}]
import reference, timing, devtrace, kinds, harness
for f in os.listdir(os.path.join({BENCH!r}, "metrics")):
    harness.reader({ROOT!r}, f[:-3])
for i, path in enumerate({references() + traffic_kinds()!r}):
    harness.load(path, "portbench_plain_%d" % i)
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
