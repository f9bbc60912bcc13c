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
from actinon_tpu_torch.render import driver, spans
from actinon_tpu_torch.render.driver import render_scene
from actinon_tpu_torch.render.integrator import Integrator

import _torch_scenes as S
from _torch_threads import one_torch_thread  # noqa: F401


# the spans of a call that builds its renderer, of one that takes the
# renderer the last call kept, and those of the graph drain's captures
CALL = {"driver.image", "driver.compile", "driver.tracer",
        "driver.integrator", "driver.positions", "driver.accumulate",
        "driver.output", "driver.release", "drain.fill", "drain.stage",
        "drain.read", "drain.collect"}
KEPT = CALL - {"driver.tracer", "driver.integrator", "driver.release"}
GRAPHS = {"graphs.capture", "graphs.warmup", "graphs.record"}


@pytest.fixture(scope="module")
def scene():
    return S.small_scene(run_source)


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
    driver.release()
    st = {}
    render(scene, tmp_path / "a.pnm", "cpu", st)
    check_spans(st, CALL)
    assert len(passes) == 2
    assert st["counters"] == {
        "driver.renderer_kept": 0,
        "drain.host_reads": sum(p["reads"] for p in passes)}
    assert st["counters"]["drain.host_reads"] >= 2
    assert st["device_spans"] == []
    # one drain.stage span a host read, on each pass
    names = [s[0] for s in st["spans"]]
    assert names.count("drain.stage") == names.count("drain.read") \
        == st["counters"]["drain.host_reads"]


def test_kept_call_spans(scene, tmp_path, passes):
    """A call that takes the renderer the last call kept: no build, no
    release, and the counter says so."""
    render(scene, tmp_path / "a.pnm", "cpu", None)
    del passes[:]
    st = {}
    render(scene, tmp_path / "b.pnm", "cpu", st)
    check_spans(st, KEPT)
    assert len(passes) == 2
    assert st["counters"] == {
        "driver.renderer_kept": 1,
        "drain.host_reads": sum(p["reads"] for p in passes)}


def test_record_leaves_the_image_alone(scene, tmp_path):
    driver.release()
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
    driver.release()
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
    renders (on the renderer this call kept)."""
    driver.release()
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
    driver.release()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, tmp_path / "a.pnm", "cuda", {})
    assert CALL | GRAPHS <= {e.name for e in prof.events()}


@pytest.mark.cuda
def test_kept_renderer_captures_nothing_on_card(card, scene, tmp_path):
    """A second render of the scene from another camera takes the kept
    renderer: it captures no graph, replays one graph a stage it reads,
    and renders bit for bit what a fresh build renders.  (Its spans'
    nesting and cover are test_kept_call_spans's: on the card this call
    takes about 20 ms, so the allocator's and the drain's host work
    between spans passes 5 % of it.)"""
    other = scene.clone()
    other.cfg.camera_position = (0.4, -7.2, 3.1)
    driver.release()
    render(scene, tmp_path / "a.pnm", "cuda", {})
    st = {}
    img = render(other, tmp_path / "b.pnm", "cuda", st)
    assert {s[0] for s in st["spans"]} == KEPT
    c = st["counters"]
    assert c["driver.renderer_kept"] == 1
    assert c.get("graphs.captures", 0) == 0
    assert len(st["device_spans"]) == c["drain.host_reads"] > 0
    driver.release()
    fresh = {}
    img0 = render(other, tmp_path / "c.pnm", "cuda", fresh)
    assert fresh["counters"]["graphs.captures"] > 0
    np.testing.assert_array_equal(img, img0)
    for k in ("hash", "rays_traced", "samples", "trips"):
        assert st[k] == fresh[k], k
