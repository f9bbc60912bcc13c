"""BENCHMARK.json resolves by name, keeps to its contract's shape, and a
cell, configuration, traffic mix and metric can be added by adding
files and entries alone."""

import json
import os
import re

import pytest
from conftest import ROOT

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert all(w["chips"] == 1 for w in b["workloads"])


@pytest.mark.parametrize("workload", [w["name"]
                                      for w in bench()["workloads"]])
def test_cell_resolves(workload):
    """The cell's configuration, traffic, limits and every metric it
    reports are found by name, and it reports setup_s, another
    end-to-end metric and a per-layer metric."""
    b, cell, config, traffic, limits = harness.resolve(ROOT, workload)
    assert os.path.exists(os.path.join(ROOT, config["scene"]))
    assert config["reduced"] == [] and limits
    e2e = [m["name"] for m in harness.cell_metrics(b, workload, 0)]
    layer = [m["name"] for m in harness.cell_metrics(b, workload, 1)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in e2e + layer:
        assert callable(harness.reader(ROOT, name))
    ref = harness.reference(ROOT, config)
    assert callable(ref.Scene) and callable(ref.Render)
    # every per-layer metric moves an end-to-end metric the cell reports
    for m in harness.cell_metrics(b, workload, 1):
        assert m["moves"] in e2e


def test_added_by_files_alone(tiny_root):
    """A throwaway configuration, traffic mix, per-layer metric and cell
    in a copy: new files and new entries only, and a run of the new cell
    reports the new metric."""
    import time
    root = tiny_root
    home = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    conf = json.load(open(os.path.join(root, b["configs"][0]["file"])))
    conf["render"].update(image_width=8, image_height=6, path_samples=0)
    with open(os.path.join(home, "configs", "throwaway.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(home, "traffic", "still.json"), "w") as f:
        json.dump({"kind": "render_frames", "camera_jitter": 0.0,
                   "frames": 1}, f)
    with open(os.path.join(home, "metrics", "images_n.py"), "w") as f:
        f.write("def read(rec):\n    return float(len(rec['units']))\n")
    with open(os.path.join(home, "limits", "throwaway.still.json"),
              "w") as f:
        json.dump({"positions_off": 0, "image_off": 0}, f)
    b["configs"].append({"name": "throwaway", "source": "x",
                         "file": "portbench/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "throwaway.still", "config": "throwaway",
                           "traffic": "still", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "images_n", "unit": "images",
                           "better": "higher", "source": "host_clock",
                           "layer": "driver", "moves": "render_s",
                           "workloads": ["throwaway.still"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    result, _ = harness.run_cell(root, "throwaway.still", 5, 0.1, 1,
                                 time.perf_counter(), device="cpu")
    assert result["correct"]
    assert result["metrics"]["images_n"]["value"] >= 1


# a scene reference of its own: the Cornell reference's radiance plus
# OFFSET in every channel
OWN_REFERENCE = """
import reference
from reference import Scene

OFFSET = {offset!r}


class Render(reference.Render):
    def radiance(self, pos):
        return super().radiance(pos) + OFFSET
"""

# a traffic kind of its own: every image from the configuration's camera
# (its mix has no `frames` or `camera_jitter`, which render_frames reads)
OWN_KIND = """
import kinds


class StillFrames(kinds.RenderFrames):
    def camera(self, k):
        return self.cam0


KIND = StillFrames
"""


@pytest.mark.parametrize("offset,correct", [(0.0, True), (0.5, False)])
def test_reference_and_kind_added_by_files_alone(tiny_root, offset,
                                                 correct):
    """A throwaway configuration that names its own reference module and
    a mix that names its own kind, added as new files under
    `portbench/references/` and `portbench/traffic/` and new entries: the
    run judges with the named module, so a reference off by 0.5 reads
    not correct."""
    import time

    import kinds
    root = tiny_root
    home = os.path.join(root, "portbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    conf = json.load(open(os.path.join(root, b["configs"][0]["file"])))
    conf["render"].update(image_width=8, image_height=6, path_samples=0)
    conf["reference"] = "portbench/references/throwaway.py"
    with open(os.path.join(home, "configs", "throwaway.json"), "w") as f:
        json.dump(conf, f)
    os.makedirs(os.path.join(home, "references"))
    with open(os.path.join(home, "references", "throwaway.py"), "w") as f:
        f.write(OWN_REFERENCE.format(offset=offset))
    assert "still_frames" not in kinds.KINDS
    with open(os.path.join(home, "traffic", "still_frames.py"), "w") as f:
        f.write(OWN_KIND)
    with open(os.path.join(home, "traffic", "still.json"), "w") as f:
        json.dump({"kind": "still_frames"}, f)
    with open(os.path.join(home, "limits", "cornell_box.frames.json")) as f:
        limits = f.read()
    with open(os.path.join(home, "limits", "throwaway.still.json"),
              "w") as f:
        f.write(limits)
    b["configs"].append({"name": "throwaway", "source": "x",
                         "file": "portbench/configs/throwaway.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "throwaway.still", "config": "throwaway",
                           "traffic": "still", "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    result, _ = harness.run_cell(root, "throwaway.still", 2**32 + 3, 0.1,
                                 0, time.perf_counter(), device="cpu")
    assert result["attempted"] >= 1
    assert result["correct"] is correct
    assert (result["failed"] == 0) is correct
    for n in ("positions_off", "image_off"):
        assert result["checks"][n]["value"] == 0.0


def synthetic_passes(cfg, seed):
    """An image's two passes, drawn from seed: every pixel centre, then
    sub-pixel positions anywhere in the image; radiance below 0.8."""
    import numpy as np
    W, H = cfg["image_width"], cfg["image_height"]
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    centres = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    subs = rng.random((4 * W * H, 2)) * [W, H]
    return [(pos, rng.random((len(pos), 3)) * 0.8)
            for pos in (centres, subs)]


@pytest.mark.parametrize("control", [False, True])
def test_default_reference_judges_bit_for_bit(tiny_root, control):
    """A configuration without "reference" resolves to
    `portbench/reference.py`, and judge_image through that module gives
    the numbers it gives through `reference` itself, bit for bit."""
    import numpy as np

    import kinds
    import reference
    _, _, config, _, _ = harness.resolve(tiny_root, "cornell_box.frames")
    assert "reference" not in config
    ref = harness.reference(tiny_root, config)
    assert os.path.samefile(ref.__file__, os.path.join(
        tiny_root, "portbench", "reference.py"))
    assert ref is not reference
    config["render"].update(image_width=8, image_height=6)
    passes = synthetic_passes(config["render"], 17)
    img = np.zeros((6, 8, 3))

    def judged(mod):
        sc = mod.Scene(config, "cpu").with_camera([2.8, 2.7, -7.9])
        return kinds.judge_image(mod, sc, img, passes, 4, (2**40 + 9, 3),
                                 control, diag=True)
    assert json.dumps(judged(ref)) == json.dumps(judged(reference))
