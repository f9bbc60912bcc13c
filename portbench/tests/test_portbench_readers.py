"""The readers of the program's own record (each render call's `stats`,
which the program keeps in `spans.profiled` while a profiler records:
records.py) on a synthetic window of two images: each reads its spans
or counters as a mean an image, and reads nothing where the program
keeps no record (an older program), where a unit has no call of its own
in the record, or, for device spans, where no replay ran; and a traced
run on the CPU, where they read the program itself."""

import sys
import time
from types import SimpleNamespace

import pytest
from conftest import ROOT

import harness
import records


def program(k):
    """Image k's record: spans [name, start, end, parent], counters and
    device spans [stage batch, seconds]; the cell's batch is 4096."""
    spans = [["driver.image", 0.0, 3.0, None],
             ["driver.compile", 0.0, 0.01, 0],
             ["driver.tracer", 0.01, 0.03, 0],
             ["driver.integrator", 0.03, 0.04, 0],
             ["driver.positions", 0.04, 0.05 + k, 0],
             ["drain.stage", 0.1, 0.6, 0],
             ["graphs.capture", 0.1, 0.4, 5],
             ["graphs.warmup", 0.1, 0.2, 6],
             ["graphs.record", 0.2, 0.4, 6],
             ["driver.accumulate", 2.0, 2.25, 0],
             ["driver.output", 2.25, 2.5, 0],
             ["driver.release", 2.9, 2.95, 0]]
    return dict(seconds=2.5 + k, spans=spans,
                counters={"drain.host_reads": 3 + k, "graphs.captures": 2,
                          "graphs.pool_bytes": 1 << 20},
                device_spans=[[4096, 1.0], [512, 0.25 + k], [64, 0.5]])


def window(monkeypatch, programs, before=()):
    """The harness's record of a window of one unit a program record,
    with those records (after `before`'s) in the program's log."""
    monkeypatch.setitem(sys.modules, records.MODULE, SimpleNamespace(
        profiled=[*before, *programs]))
    return dict(cell=SimpleNamespace(batch=4096),
                units=[dict(wall_s=3.0, seconds=p["seconds"])
                       for p in programs])


WANT = {"image_build_s": 0.01 + 0.02 + 0.01 + 0.05,
        "capture_s": 0.3,
        "captures_per_image": 2.0,
        "host_reads_per_image": 3.5,
        "pass_host_s": (0.01 + 1.01) / 2 + 0.25 + 0.25,
        "drain_tail_device_s": (0.75 + 1.75) / 2}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name, monkeypatch):
    read = harness.reader(ROOT, name)
    # the warm-up image's record comes before the window's
    assert read(window(monkeypatch, [program(0), program(1)],
                       before=[program(5)])) == pytest.approx(WANT[name])
    # a unit whose call is not in the log
    rec = window(monkeypatch, [program(0), program(1)])
    rec["units"][0]["seconds"] = 9.0
    assert read(rec) is None
    # an older program: no log
    monkeypatch.delitem(sys.modules, records.MODULE)
    assert read(dict(rec, units=rec["units"][1:])) is None
    assert read(dict(cell=SimpleNamespace(batch=4096), units=[])) is None


def test_device_reader_reads_nothing_without_replays(monkeypatch):
    cpu = [dict(program(k), device_spans=[]) for k in (0, 1)]
    assert harness.reader(ROOT, "drain_tail_device_s")(
        window(monkeypatch, cpu)) is None


def test_traced_cpu_run_reads_the_program(tiny_root):
    """The program's own readers in a traced run of the cell on the CPU;
    the device one reads nothing there (the eager drain replays no
    graph)."""
    result, _ = harness.run_cell(tiny_root, "cornell_box.frames", 2**33 + 5,
                                 0.1, 1, time.perf_counter(), device="cpu")
    got = result["metrics"]
    assert set(WANT) - set(got) == {"drain_tail_device_s"}
    assert got["image_build_s"]["value"] > 0
    assert got["pass_host_s"]["value"] > 0
    assert got["host_reads_per_image"]["value"] >= 2
    assert got["captures_per_image"]["value"] == 0
    assert got["capture_s"]["value"] == 0
