"""The PyTorch port's integrator against the JAX integrator, on the CPU.

Both run in f64 with seed_mode="counter" (RNG streams from sample id and
depth, so a last-ulp difference in a hit point cannot reseed later
samples), and are held to the contract of tests/test_integrator.py:92,
rtol 1e-6 and atol 1e-9: one wavefront step's contributions and
children, the whole device drain of camera samples (normal and mixed
path drains), and the same after geometry and material parameters are
perturbed on the JAX side and carried across with load_jax_params."""

import numpy as np
import pytest
import torch

from actinon_tpu.render.driver import camera_rays
from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.params import load_jax_params
from actinon_tpu_torch.render.integrator import Integrator as TIntegrator
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho
from _torch_threads import one_torch_thread  # noqa: F401


def make_scene(ho, path_samples=0, direct_samples=4, depth=8):
    """Glass ball, glass CSG shell, mirror, Oren-Nayar chess floor, a
    sphere lamp and an enveloped ellipsoid lamp."""
    sc = ho.Scene()
    cfg = sc.cfg
    cfg.image_width, cfg.image_height = 8, 6
    cfg.trace_depth = depth
    cfg.direct_samples = direct_samples
    cfg.path_samples = path_samples
    cfg.camera_position = (0.0, -8.0, 3.0)
    cfg.camera_view_direction = (0.0, 8.0, -2.0)
    cfg.camera_top_direction = (0.0, 0.0, 1.0)
    cfg.camera_focal_length = 1.2
    cfg.background_color = (0.1, 0.12, 0.2)

    lamp = ho.Sphere(0.5)
    lamp.prp.radiance = 25.0
    lamp.move(ho.v3(2, -1, 5))
    sc.push(lamp)
    bar = ho.Squaroid.ellipsoid(1.0, 0.35, 0.35)
    bar.set_envelope(ho.Envelope((0, 0, 0), 1.1))
    bar.prp.radiance = 10.0
    bar.move(ho.v3(-3, 1, 5))
    sc.push(bar)

    floor = ho.Plane()
    floor.prp.sigma = 0.29
    floor.prp.texture = ho.TxmChess((0.1, 0.1, 0.1), (0.9, 0.9, 0.8), 1.0)
    sc.push(floor)
    ball = ho.Sphere(1.0)
    ho.apply_material(ball, "glass")
    ball.move(ho.v3(-0.8, 0, 1.2))
    sc.push(ball)
    shell = ho.PairInside(ho.Sphere(0.8), ho.Neg(ho.Sphere(0.65)))
    ho.apply_material(shell, "glass")
    shell.move(ho.v3(1.2, 0.8, 1.0))
    shell.set_auto_envelope()
    sc.push(shell)
    m = ho.Sphere(0.7)
    ho.apply_material(m, "mirror")
    m.move(ho.v3(1.5, 2.5, 0.8))
    sc.push(m)
    return sc


def pair(**kw):
    jt = JTracer(jsir.compile_scene(make_scene(jho, **kw)),
                 dtype=np.float64)
    tt = TTracer(tsir.compile_scene(make_scene(tho, **kw)),
                 dtype=np.float64, device="cpu")
    ji, ti = JIntegrator(jt, batch=64), TIntegrator(tt, batch=64)
    ji.seed_mode = ti.seed_mode = "counter"
    return ji, ti


def sample_pos(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, cfg.image_width, n),
                     rng.uniform(0, cfg.image_height, n)], -1)


def primary_queue(ir, pos):
    p, d = camera_rays(ir, pos, np.float64)
    n = len(p)
    return dict(p=p, d=d, intensity=np.ones(n), tint=np.ones((n, 3)),
                depth=np.full(n, ir.cfg.trace_depth, np.int32),
                sample_id=np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("path_ray", [False, True])
def test_step_matches_jax(path_ray):
    """One step over camera rays, as normal rays and as path rays (matter
    only): contributions and every child block."""
    ji, ti = pair()
    q = primary_queue(ji.ir, sample_pos(ji.cfg, 48))
    sid_j, contrib_j, ch_j, _ = ji._step(q, path_ray=path_ray)
    qt = {k: torch.as_tensor(np.asarray(v)).to(
        torch.int64 if np.asarray(v).dtype.kind == "i" else torch.float64)
        for k, v in q.items()}
    sid_t, contrib_t, ch_t, _ = ti._step(qt, path_ray=path_ray)
    np.testing.assert_array_equal(sid_t.numpy(), np.asarray(sid_j))
    np.testing.assert_allclose(contrib_t.numpy(), np.asarray(contrib_j),
                               rtol=1e-6, atol=1e-9)
    assert np.asarray(contrib_j).max() > 0
    assert set(ch_t) == set(ch_j)
    for name in ch_j:
        m = np.asarray(ch_j[name]["mask"])
        np.testing.assert_array_equal(ch_t[name]["mask"].numpy(), m)
        for f in ("p", "d", "intensity", "tint", "depth", "sample_id"):
            np.testing.assert_allclose(
                ch_t[name][f].numpy()[m], np.asarray(ch_j[name][f])[m],
                rtol=1e-6, atol=1e-9, err_msg=f"{name}.{f}")


@pytest.mark.parametrize("kw", [dict(), dict(path_samples=3, depth=12)],
                         ids=["normal", "path"])
def test_run_samples_matches_run_device(kw):
    """The whole drain of camera samples (the path config runs the mixed
    drain with parent expansion)."""
    ji, ti = pair(**kw)
    pos = sample_pos(ji.cfg, 24)
    want = ji.run_device(None, len(pos), pos_xy=pos)
    got = ti.run_samples(pos)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert ti.rays_traced == ji.rays_traced


def test_load_jax_params_perturbed():
    """Perturb a sphere radius and a material colour on the JAX side;
    carried across, the two packages still agree, and the render moved."""
    ji, ti = pair()
    pos = sample_pos(ji.cfg, 48, seed=5)
    before = ti.run_samples(pos)

    geom = {k: np.array(v) for k, v in ji.tr.geom_params().items()}
    mat = {k: np.array(v) for k, v in ji.mat_params().items()}
    ball_oid = 3
    row = int(np.flatnonzero(ji.tr.tab.oid == ball_oid)[0])
    k = int(np.flatnonzero(ji.tr.tab.sph_rows == row)[0])
    geom["sph_r"][k] *= 1.15
    mat["m_color"][5] = (0.9, 0.3, 0.2)         # the mirror
    ji.tr.ovr = {k2: np.asarray(v) for k2, v in geom.items()}
    ji.ovr = dict(mat)
    want = ji.run_device(None, len(pos), pos_xy=pos)

    load_jax_params(ti.tr, ti, geom, mat)
    got = ti.run_samples(pos)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert not np.allclose(got, before, rtol=1e-3)
    np.testing.assert_allclose(ti.tr.geom_params()["sph_r"],
                               geom["sph_r"])


def test_camera_rays_match():
    """The driver's host camera rays and the drain's device camera rays
    equal the JAX driver's."""
    from actinon_tpu_torch.render.driver import camera_rays as tcamera
    ji, ti = pair()
    pos = sample_pos(ji.cfg, 32)
    pj, dj = camera_rays(ji.ir, pos, np.float64)
    pt, dt = tcamera(ti.ir, pos, np.float64)
    np.testing.assert_allclose(pt, pj, rtol=1e-15)
    np.testing.assert_allclose(dt, dj, rtol=1e-12, atol=1e-15)
    pd, dd = ti._camera_rays_dev(torch.as_tensor(pos))
    np.testing.assert_allclose(dd.numpy(), dj, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(pd.numpy(), pj, rtol=1e-15)
