"""render_scene keeps its renderer (the tracer and the integrator, with
the drain's states and graphs) for the next call whose scene differs
only in the camera (render/driver.py).  A kept call renders bit for bit
what a fresh build renders, with the same per-call counts; any other
change to the scene, the settings or the classes builds anew.  On the
CPU with the eager drain, on tests/_torch_scenes.py's SMALL scene; the
card's case (no capture on a kept call) is in tests/test_torch_spans.py."""

import numpy as np
import pytest

from actinon_tpu_torch.acn.interp import run_source
from actinon_tpu_torch.render import driver
from actinon_tpu_torch.render.integrator import Integrator

import _torch_scenes as S
from _torch_threads import one_torch_thread  # noqa: F401


def render(sc, path, **kw):
    st = {}
    img = driver.render_scene(sc.clone(), str(path), force=True,
                              verbose=False, device="cpu", stats=st, **kw)
    return img, st


def kept(got):
    return got[1]["counters"]["driver.renderer_kept"]


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for k in ("hash", "rays_traced", "samples", "trips"):
        assert got[1][k] == want[1][k], k


def test_other_camera_takes_the_kept_renderer(tmp_path):
    base = S.small_scene(run_source)
    moved = base.clone()
    moved.cfg.camera_position = (0.4, -7.2, 3.1)
    driver.release()
    first = render(base, tmp_path / "a.pnm")
    got = render(moved, tmp_path / "b.pnm")
    driver.release()
    fresh = render(moved, tmp_path / "c.pnm")
    assert (kept(first), kept(got), kept(fresh)) == (0, 1, 0)
    assert_same(got, fresh)
    # the first camera again, on the renderer the other camera left: the
    # counts are the call's own
    again = render(base, tmp_path / "d.pnm")
    assert kept(again) == 1
    assert_same(again, first)
    assert driver._kept[2].record is None


@pytest.mark.parametrize("change", ["material", "moved_object",
                                    "trace_depth", "batch", "dtype",
                                    "integrator_class"])
def test_other_changes_build_anew(change, tmp_path, monkeypatch):
    sc, kw = S.small_scene(run_source), {}
    if change == "material":
        sc = S.small_scene(run_source, material="diffuse")
    elif change == "moved_object":
        sc = S.small_scene(run_source, ball_x=-0.5)
    elif change == "trace_depth":
        sc.cfg.trace_depth += 1
    elif change == "batch":
        kw["batch"] = 1 << 10
    elif change == "dtype":
        kw["dtype"] = np.float64
    driver.release()
    render(S.small_scene(run_source), tmp_path / "a.pnm")
    if change == "integrator_class":
        monkeypatch.setattr(driver, "Integrator",
                            type("Other", (Integrator,), {}))
    got = render(sc, tmp_path / "b.pnm", **kw)
    assert kept(got) == 0
    assert type(driver._kept[2]) is driver.Integrator
    driver.release()
    assert_same(got, render(sc, tmp_path / "c.pnm", **kw))


@pytest.mark.parametrize("how", ["release", "raise"])
def test_nothing_kept_after_release_or_a_raise(how, tmp_path):
    sc = S.small_scene(run_source)
    render(sc, tmp_path / "a.pnm")
    assert driver._kept is not None
    if how == "release":
        driver.release()
    else:
        # the output exists and force is off: the call raises after it
        # took the kept renderer
        with pytest.raises(FileExistsError):
            driver.render_scene(sc.clone(), str(tmp_path / "a.pnm"),
                                verbose=False, device="cpu")
    assert driver._kept is None
    assert kept(render(sc, tmp_path / "b.pnm")) == 0
