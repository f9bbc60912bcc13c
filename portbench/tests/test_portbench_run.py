"""Runs of the cells at a tiny size on the CPU: the result line's shape,
the reference against the port, what a run writes, and run.py's refusal
without a card; the scene's two descriptions (the program's `.acn`, the
reference's numbers) hit the same surfaces."""

import json
import os
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT

import harness

CELLS = ("cornell_box.frames",)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_and_line_shape(tiny_root, workload):
    result, lines = harness.run_cell(tiny_root, workload, 2**31 + 17, 0.1,
                                     0, time.perf_counter(), device="cpu")
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(result)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    b = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    want = {m["name"] for m in harness.cell_metrics(b, workload, 0)}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for n in ("positions_off", "image_off"):
        assert result["checks"][n]["value"] == 0.0
    assert lines[-len(result["checks"]):] == [
        f"check {n}: {c['value']!r} (limit {c['limit']!r})"
        for n, c in result["checks"].items()]
    json.dumps(result)


def test_traced_run_reports_per_layer_only(tiny_root):
    result, _ = harness.run_cell(tiny_root, "cornell_box.frames", 3, 0.1,
                                 1, time.perf_counter(), device="cpu")
    b = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    layer = {m["name"] for m in harness.cell_metrics(b, "cornell_box.frames",
                                                     1)}
    assert set(result["metrics"]) <= layer
    # the host-clock readers read on any device; the device ones need one
    assert {"scene_load_s", "image_setup_s"} <= set(result["metrics"])
    assert result["correct"]


WRITES = """
import os, sys, time
sys.path[:0] = [{root!r}, {bench!r}]
allowed = [os.path.realpath(p) for p in ({checkout!r}, {root!r},
           os.environ["HOME"], os.environ["XDG_CACHE_HOME"],
           os.environ["TMPDIR"])]
bad = []
def hook(event, args):
    if event == "open" and args[1] and any(c in str(args[1]) for c in "wax+"):
        p = os.path.realpath(str(args[0]))
        if p != "/dev/null" and not any(p == a or p.startswith(a + os.sep)
                                        for a in allowed):
            bad.append(p)
sys.addaudithook(hook)
import tempfile
tempfile.tempdir = None
import harness
r, _ = harness.run_cell({checkout!r}, "cornell_box.frames", 9, 0.1, 0,
                        time.perf_counter(), device="cpu")
print("BAD", bad)
print("CORRECT", r["correct"])
"""


def test_writes_only_inside_allowed_dirs(tiny_root, tmp_path):
    """A run writes only inside the checkout (the program's build
    directory included), HOME, XDG_CACHE_HOME and TMPDIR: the PNM goes to
    TMPDIR and is removed; nothing lands in /dev/shm or a fixed /tmp
    path."""
    env = dict(os.environ)
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[k] = str(tmp_path / k.lower())
        os.makedirs(env[k])
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    code = WRITES.format(root=ROOT, bench=BENCH, checkout=tiny_root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
    assert "CORRECT True" in out.stdout
    assert os.listdir(env["TMPDIR"]) == []
    if os.path.isdir("/dev/shm"):
        assert set(os.listdir("/dev/shm")) <= shm


def test_run_py_refuses_without_card(card_absent):
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                          "--workload", "cornell_box.frames", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.cuda
def test_cell_on_card(card):
    """One short run of the cell on the card: a result line that reads
    correct."""
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                          "--workload", "cornell_box.frames", "--seed", "11",
                          "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


def test_scene_descriptions_agree():
    """Primary rays over the image: the program's tracer (in float64 on
    the CPU) and the reference's scene, built from the configuration's
    numbers, find the first surface at the same distance, of the same
    colour, with the same normal."""
    import numpy as np
    import torch

    import kinds
    import reference
    from actinon_tpu_torch.render.driver import camera_rays
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    config = json.load(open(os.path.join(BENCH, "configs",
                                         "cornell_box.json")))
    config["render"].update(image_width=48, image_height=48)
    sc, _ = kinds.program_scene(os.path.join(ROOT, config["scene"]),
                                config["render"])
    ir = sir.compile_scene(sc)
    tr = Tracer(ir, dtype=np.float64, device="cpu")
    ys, xs = np.mgrid[0:48, 0:48]
    pos = np.stack([xs.reshape(-1) + 0.25, ys.reshape(-1) + 0.75], -1)
    p, d = camera_rays(ir, pos, np.float64)
    t, nor, enter, _ = tr.trans_hit(torch.as_tensor(p), torch.as_tensor(d))
    t, nor, enter = t.numpy(), -nor.numpy(), enter.numpy()
    ref = reference.Scene(config, "cpu")
    rp, rd = ref.camera_rays(pos)
    assert np.allclose(rp.numpy(), p) and np.allclose(rd.numpy(), d)
    rt, ro, rn = (v.numpy() for v in ref.first(rp, rd, matter_only=False))
    hit = np.isfinite(rt)
    assert np.array_equal(hit, np.isfinite(t)) and hit.mean() > 0.9
    assert np.allclose(t[hit], rt[hit], atol=1e-5)
    colour = np.stack([o.color for o in ir.objects])[enter[hit]]
    assert np.allclose(colour, ref.colour.numpy()[ro[hit]])
    assert np.allclose(nor[hit], rn[hit], atol=1e-6)
