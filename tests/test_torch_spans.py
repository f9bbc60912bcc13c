"""The render call's record (render/spans.py): spans at the layers'
boundaries, nested in one another and covering the call; counters fed
from the integrator's and the graphs' own counts; a profiler range for
each span while a profiler records, and the call's stats kept for a
reader of the profile; and images that recording leaves
bit for bit as they were.  The CPU cases render a tiny scene (16x16,
depth 3, one gradient pass) with the eager drain; the card cases
(marker `cuda`) render it with the graph drain and also check the
device spans and the captures:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q
"""

import numpy as np
import pytest
import torch

from actinon_tpu_torch.acn.interp import run_source
from actinon_tpu_torch.render import image as aimg
from actinon_tpu_torch.render import spans
from actinon_tpu_torch.render.driver import render_scene
from actinon_tpu_torch.render.integrator import Integrator

SRC = """
def scene = scene_s;
scene.image_width = 16; scene.image_height = 16;
scene.trace_depth = 3; scene.direct_samples = 2; scene.path_samples = 0;
scene.gradient_cycles = 1; scene.gradient_samples = 2;
scene.gradient_threshold = 0.05;
scene.camera_position = vec(0,-7,3);
scene.camera_view_direction = vec(0,7,-1.6);
scene.camera_top_direction = vec(0,0,1);
scene.background_color = color(0.1,0.12,0.2);
def lamp = create_sphere(0.5) + vec(2,-1,6);
lamp.set_radiance( 25 );
scene.push( lamp );
def floor = create_plane();
scene.push( floor );
def ball = create_sphere(1.0) + vec(-0.8,0,1.2);
ball.set_material( "glass" );
scene.push( ball );
scene.create_image( "x" );
"""

# the spans of every call, and those of the graph drain's captures
CALL = {"driver.image", "driver.compile", "driver.tracer",
        "driver.integrator", "driver.positions", "driver.accumulate",
        "driver.output", "driver.release", "drain.fill", "drain.stage",
        "drain.read", "drain.collect"}
GRAPHS = {"graphs.capture", "graphs.warmup", "graphs.record"}


@pytest.fixture(scope="module")
def scene():
    cap = []
    run_source(SRC, render_fn=lambda sc, fn: cap.append(sc.clone()))
    return cap[0]


def render(scene, path, device, stats):
    return render_scene(scene.clone(), str(path), force=True,
                        dtype=np.float32, verbose=False, device=device,
                        stats=stats)


@pytest.fixture
def passes(monkeypatch):
    """After each pass's drain: the integrator's host reads, and its
    graphs' captures and replays so far."""
    got = []
    orig = Integrator.run_samples

    def run_samples(integ, pos):
        out = orig(integ, pos)
        g = integ._graphs
        got.append(dict(reads=integ.last_host_reads,
                        captures=g.captures if g else 0,
                        replays=g.replays if g else 0))
        return out

    monkeypatch.setattr(Integrator, "run_samples", run_samples)
    return got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph drain has no CPU mode")


def check_spans(st, names):
    """Every span in `names` is there; each lies within its parent and
    has a self time of 0 or more; the root's children cover it to within
    5 % of its wall."""
    sp = st["spans"]
    assert sp[0][0] == "driver.image" and sp[0][3] is None
    assert {s[0] for s in sp} == names
    children = {i: [] for i in range(len(sp))}
    for i, (name, a, b, parent) in enumerate(sp[1:], 1):
        pa, pb = sp[parent][1:3]
        assert pa <= a <= b <= pb, (name, sp[parent][0])
        children[parent].append(i)
    for i, (name, a, b, _) in enumerate(sp):
        covered = sum(sp[j][2] - sp[j][1] for j in children[i])
        assert b - a - covered >= 0, name
    wall = sp[0][2] - sp[0][1]
    covered = sum(sp[j][2] - sp[j][1] for j in children[0])
    assert covered >= 0.95 * wall, (covered, wall)
    assert 0 < st["seconds"] <= wall


def test_spans_nest_and_cover_the_call(scene, tmp_path, passes):
    st = {}
    render(scene, tmp_path / "a.pnm", "cpu", st)
    check_spans(st, CALL)
    assert len(passes) == 2
    assert st["counters"] == {
        "drain.host_reads": sum(p["reads"] for p in passes)}
    assert st["counters"]["drain.host_reads"] >= 2
    assert st["device_spans"] == []
    # one drain.stage span a host read, on each pass
    names = [s[0] for s in st["spans"]]
    assert names.count("drain.stage") == names.count("drain.read") \
        == st["counters"]["drain.host_reads"]


def test_record_leaves_the_image_alone(scene, tmp_path):
    img0 = render(scene, tmp_path / "a.pnm", "cpu", None)
    st = {}
    img1 = render(scene, tmp_path / "b.pnm", "cpu", st)
    np.testing.assert_array_equal(img0, img1)
    assert st["hash"] == aimg.image_hash(aimg.pack_cps(img0))
    assert (tmp_path / "a.pnm").read_bytes() == \
        (tmp_path / "b.pnm").read_bytes()


def test_spans_are_profiler_ranges_only_under_a_profiler(
        scene, tmp_path, monkeypatch):
    """Under a profiler each span is a range and the call's stats are
    kept in spans.profiled; without one, neither."""
    from torch.profiler import ProfilerActivity, profile
    st = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, tmp_path / "a.pnm", "cpu", st)
    assert CALL <= {e.name for e in prof.events()}
    assert spans.profiled[-1] is st
    n = len(spans.profiled)
    opened = []
    orig = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or orig(name))
    render(scene, tmp_path / "b.pnm", "cpu", {})
    assert opened == []
    assert len(spans.profiled) == n and spans.profiled[-1] is st


def test_without_a_record_spans_are_one_shared_noop():
    assert spans.span(None, "a") is spans.span(None, "b")
    spans.count(None, "a", 3)
    with spans.Span(None, "a") as t:
        pass
    assert t.seconds >= 0
    rec = spans.Record()
    with spans.span(rec, "a"):
        with spans.span(rec, "b"):
            spans.count(rec, "n", 2)
        spans.count(rec, "n")
    assert [s[0] for s in rec.spans] == ["a", "b"]
    assert [s[3] for s in rec.spans] == [None, 0]
    assert rec.result() == dict(spans=rec.spans, counters={"n": 3},
                                device_spans=[])


@pytest.mark.cuda
def test_device_spans_and_captures_on_card(card, scene, tmp_path, passes):
    """On the card: a device span a replay, the captures counted as the
    call's graphs count them, and the image that a call without a record
    renders."""
    st = {}
    img = render(scene, tmp_path / "a.pnm", "cuda", st)
    check_spans(st, CALL | GRAPHS)
    last = passes[-1]
    assert len(st["device_spans"]) == last["replays"] > 0
    assert all(k > 0 and s > 0 for k, s in st["device_spans"])
    assert st["counters"]["graphs.captures"] == last["captures"] > 0
    assert st["counters"]["graphs.pool_bytes"] >= 0
    assert st["counters"]["drain.host_reads"] == \
        sum(p["reads"] for p in passes)
    names = [s[0] for s in st["spans"]]
    assert names.count("graphs.capture") == last["captures"]
    img0 = render(scene, tmp_path / "b.pnm", "cuda", None)
    np.testing.assert_array_equal(img, img0)
    assert st["hash"] == aimg.image_hash(aimg.pack_cps(img0))


@pytest.mark.cuda
def test_profiler_ranges_on_card(card, scene, tmp_path):
    """The spans' ranges in a profile of the host (the device collection
    stays off: a profiled graph replay has faulted the card)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, tmp_path / "a.pnm", "cuda", {})
    assert CALL | GRAPHS <= {e.name for e in prof.events()}
