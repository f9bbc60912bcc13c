"""The port's wavefront drain against the port's recursive oracle
(actinon_tpu_torch/render/reference_oracle.py), on the seven scene kinds
of tests/test_integrator.py, f64, rtol 1e-6 and atol 1e-9; the port's
oracle against the JAX package's on the same rays; and
Tracer.shadow_nearest_t against the JAX method.

The oracle gets the rays that run_device builds itself
(`_camera_rays_dev` over the same padded positions): a host-built f64
ray can differ by ulps, which reseeds the position-seeded RNG."""

import numpy as np
import pytest
import torch

from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.reference_oracle import RecursiveOracle as JOracle
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.render.integrator import Integrator
from actinon_tpu_torch.render.reference_oracle import RecursiveOracle
from actinon_tpu_torch.render.tracer import Tracer
from actinon_tpu_torch.scene import ir as sir
from actinon_tpu_torch.scene import objects as tho

KINDS = {
    "diffuse_only": dict(glass=False),
    "glass": dict(glass=True),
    "mirror": dict(glass=False, mirror=True),
    "glass_mirror_chess": dict(glass=True, mirror=True, chess=True),
    "oren_nayar": dict(glass=False, sigma=0.29),
    "path_traced": dict(glass=False, path_samples=4, depth=12),
    "glass_path": dict(glass=True, path_samples=3, depth=12),
}


def make_scene(ho, glass=True, mirror=False, chess=False, path_samples=0,
               direct_samples=6, depth=8, sigma=0.0):
    """tests/test_integrator.py:make_scene over either package's objects
    module `ho`."""
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

    floor = ho.Plane()
    floor.prp.sigma = sigma
    if chess:
        floor.prp.texture = ho.TxmChess((0.1, 0.1, 0.1), (0.9, 0.9, 0.8),
                                        1.0)
    sc.push(floor)

    if glass:
        ball = ho.Sphere(1.0)
        ho.apply_material(ball, "glass")
        ball.move(ho.v3(-0.8, 0, 1.2))
        sc.push(ball)
    if mirror:
        m = ho.Sphere(1.0)
        ho.apply_material(m, "mirror")
        m.move(ho.v3(1.5, 1.5, 1.0))
        sc.push(m)
    return sc


def port_rays(kind, n=12, seed=3):
    """(integrator, run_device's per-sample radiance, its primary rays as
    f64 numpy) for scene kind `kind`."""
    sc = make_scene(tho, **KINDS[kind])
    integ = Integrator(Tracer(sir.compile_scene(sc), dtype=np.float64,
                              device="cpu"), batch=64)
    cfg = sc.cfg
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, cfg.image_width, n),
                    rng.uniform(0, cfg.image_height, n)], -1)
    got = integ.run_device(None, len(pos), pos_xy=pos)
    # run_device's own rays: the same padded position block
    Np = 1 << int(np.ceil(np.log2(max(n, 64))))
    pad = torch.zeros((Np, 2), dtype=torch.float64)
    pad[:n] = torch.as_tensor(pos)
    p, d = integ._camera_rays_dev(pad)
    return integ, got, p[:n].numpy(), d[:n].numpy()


@pytest.mark.parametrize("kind", list(KINDS))
def test_wavefront_matches_recursion(kind):
    integ, got, p, d = port_rays(kind)
    oracle = RecursiveOracle(integ)
    want = np.stack([oracle.sample(p[i], d[i]) for i in range(len(p))])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9,
                               err_msg=kind)
    assert want.max() > 0


@pytest.mark.parametrize("kind", ["glass_mirror_chess", "glass_path"])
def test_oracle_matches_jax_oracle(kind):
    """The port's oracle and the JAX package's, each over its own tracer,
    on the same f64 rays."""
    integ, _, p, d = port_rays(kind, n=6)
    ji = JIntegrator(JTracer(jsir.compile_scene(make_scene(jho,
                                                          **KINDS[kind])),
                             dtype=np.float64), batch=64)
    ours, theirs = RecursiveOracle(integ), JOracle(ji)
    for i in range(len(p)):
        np.testing.assert_allclose(ours.sample(p[i], d[i]),
                                   theirs.sample(p[i], d[i]),
                                   rtol=1e-6, atol=1e-9, err_msg=f"ray {i}")


def test_shadow_nearest_t_matches_jax():
    sc_t = make_scene(tho, glass=True, mirror=True, chess=True)
    sc_j = make_scene(jho, glass=True, mirror=True, chess=True)
    tt = Tracer(sir.compile_scene(sc_t), dtype=np.float64, device="cpu")
    jt = JTracer(jsir.compile_scene(sc_j), dtype=np.float64)
    rng = np.random.default_rng(7)
    n = 256
    p = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                  rng.uniform(0.1, 4, n)], -1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = tt.shadow_nearest_t(torch.as_tensor(p), torch.as_tensor(d))
    want = np.asarray(jt.shadow_nearest_t(p, d))
    assert np.isfinite(want).any() and (~np.isfinite(want)).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert torch.equal(tt.shadow_t(torch.as_tensor(p), torch.as_tensor(d)),
                       got)
