"""The port's render driver: an inline .acn scene through both packages'
drivers, checkpoint resume within the port, the CLI, and the default
device.

Both drivers render at a tests/golden_gen.py tiny config (24x18,
direct=4, path=0, depth=12) in f64 with the drivers' own position
seeding; the image means agree within 2 %.  The port's adaptive passes
are covered by the resume test."""

import inspect
import os

import numpy as np
import pytest
import torch

from actinon_tpu.acn.interp import run_source as jrun_source
from actinon_tpu.render.driver import render_scene as jrender
from actinon_tpu_torch.__main__ import main as tmain
from actinon_tpu_torch.acn.interp import run_source as trun_source
from actinon_tpu_torch.render import image as aimg
from actinon_tpu_torch.render.driver import render_scene as trender
from _torch_threads import one_torch_thread  # noqa: F401

SRC = """
def scene = scene_s;
scene.image_width = 24; scene.image_height = 18;
scene.trace_depth = 12; scene.direct_samples = 4; scene.path_samples = 0;
scene.gradient_cycles = {cycles}; scene.gradient_samples = 2;
scene.gradient_threshold = 0.05;
scene.camera_position = vec(0,-7,3);
scene.camera_view_direction = vec(0,7,-1.6);
scene.camera_top_direction = vec(0,0,1);
scene.background_color = color(0.1,0.12,0.2);
def lamp = create_sphere(0.5) + vec(2,-1,6);
lamp.set_radiance( 25 );
scene.push( lamp );
def bar = create_ellipsoid(1.0, 0.35, 0.35);
bar.set_envelope( create_sphere(1.1) );
bar = bar + vec(-3,1.5,5);
bar.set_radiance( 10 );
scene.push( bar );
def floor = create_plane();
floor.set_texture_field( beth_object("txm_chess_s") );
scene.push( floor );
def ball = create_sphere(1.0) + vec(-0.8,0,1.2);
ball.set_material( "glass" );
scene.push( ball );
def shell = ( create_sphere(0.8) & !create_sphere(0.65) ) + vec(1.3,0.8,1.0);
shell.set_material( "glass" );
shell.set_auto_envelope();
scene.push( shell );
scene.create_image( "{out}" );
"""


def _scene(run_source, out, cycles=1):
    cap = []
    run_source(SRC.format(out=out, cycles=cycles),
               render_fn=lambda sc, fn: cap.append(sc.clone()))
    return cap[0]


def test_render_means_match_jax(tmp_path):
    """Pass 0 only: each adaptive pass would compile another JAX drain."""
    out_j, out_t = str(tmp_path / "j.pnm"), str(tmp_path / "t.pnm")
    img_j = jrender(_scene(jrun_source, out_j, cycles=0), out_j, force=True,
                    dtype=np.float64, verbose=False)
    img_t = trender(_scene(trun_source, out_t, cycles=0), out_t, force=True,
                    dtype=np.float64, verbose=False, device="cpu")
    assert img_t.shape == img_j.shape == (18, 24, 3)
    assert np.isfinite(img_t).all()
    m_j, m_t = img_j.mean(), img_t.mean()
    assert m_j > 0.05
    assert abs(m_t - m_j) <= 0.02 * m_j, (m_t, m_j)
    back = aimg.read_pnm(out_t)
    assert np.abs(back - np.clip(img_t, 0, 1)).max() < 1.0 / 255


def test_render_deterministic_and_stats(tmp_path):
    stats = [{}, {}]
    imgs = [trender(_scene(trun_source, "x"), str(tmp_path / f"{k}.pnm"),
                    force=True, dtype=np.float32, verbose=False,
                    device="cpu", stats=stats[k]) for k in range(2)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert stats[0]["hash"] == stats[1]["hash"] == aimg.image_hash(
        aimg.pack_cps(imgs[0]))
    assert stats[0]["rays_traced"] > stats[0]["samples"] >= 24 * 18


def test_resume_exactness(tmp_path):
    """A checkpoint written after pass 0 resumes to the same image as an
    uninterrupted render (tests/test_driver.py:73-93, in the port)."""
    out_full = str(tmp_path / "full.pnm")
    full = trender(_scene(trun_source, "x", cycles=2), out_full, force=True,
                   dtype=np.float64, verbose=False, device="cpu")
    out_part = str(tmp_path / "part.pnm")
    part0 = trender(_scene(trun_source, "x", cycles=2), out_part,
                    force=True, dtype=np.float64, verbose=False,
                    max_cycles=0, device="cpu")
    li = aimg.LumImage(24, 18)
    li.clr = part0.copy()
    li.weight = np.ones((18, 24))
    li.gradient_cycle = 1
    li.rval = np.uint64(21943294)
    li.save(out_part + ".tmp.lum_image.npz")
    resumed = trender(_scene(trun_source, "x", cycles=2), out_part,
                      force=True, recover=True, dtype=np.float64,
                      verbose=False, device="cpu")
    np.testing.assert_allclose(resumed, full, atol=1e-12)


def test_cli_renders_on_cpu(tmp_path):
    out = tmp_path / "cli.pnm"
    script = tmp_path / "cli.acn"
    script.write_text(SRC.format(out=str(out), cycles=0))
    assert tmain([str(script), "-f", "--device", "cpu", "--dtype", "f64",
                  "--batch", "256"]) == 0
    img = aimg.read_pnm(str(out))
    assert img.shape == (18, 24, 3) and img.max() > 0.05


def test_default_device_is_cuda(tmp_path):
    assert inspect.signature(trender).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender(_scene(trun_source, "x"), str(tmp_path / "d.pnm"),
                force=True, verbose=False)
    assert not os.path.exists(tmp_path / "d.pnm")
