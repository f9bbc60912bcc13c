"""Scenes with distance objects for the port's tests, built in Python from
either package's objects module (`ho`), so that each package compiles the
same scene with its own front end.  Imports nothing itself: the card-only
tests use it without JAX."""

import math
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMP_ROW = os.path.join(ROOT, "actinon_tpu_torch", "scenes", "lamp_row.acn")


def mixed_scene(ho):
    """Every shape family of the scene kernels (a copy of
    tests/test_pallas_scene.py:_mixed_scene): singles of all three
    analytic families, a 2-member analytic composite group, a 3-member SDF
    solo cluster, a standalone torus, and two sphere lights."""
    sc = ho.Scene()
    for k, z in ((0, 8.0), (1, -8.0)):
        light = ho.Sphere(0.4)
        light.move(ho.v3(1.0 * k, 0, z))
        light.prp.radiance = 30.0
        sc.push(light)
    floor = ho.Plane()
    floor.move(ho.v3(0, 0, -2.5))
    sc.push(floor)
    ball = ho.Sphere(0.8)
    ball.move(ho.v3(4.5, 1.0, 0))
    sc.push(ball)
    ell = ho.Squaroid.ellipsoid(1.2, 0.7, 0.5)
    ell.rotate(ho.rot_x(0.4))
    ell.move(ho.v3(-4.5, -1.0, 0.5))
    sc.push(ell)
    for k in range(2):
        comp = ho.PairInside(ho.Sphere(1.0), ho.Neg(ho.Sphere(0.6)))
        comp.move(ho.v3(2.5 * k - 1.0, 3.0, 0.2 * k))
        comp.set_auto_envelope()
        sc.push(comp)
    for k in range(3):
        t = ho.make_torus(1.4, 0.4)
        comp = ho.PairInside(ho.PairOutside(t, ho.Sphere(0.7)),
                             ho.Neg(ho.Sphere(0.3)))
        comp.rotate(ho.rot_y(2 * math.pi * k / 9))
        comp.move(ho.v3(3.0 * k - 3.0, -3.5, 0.3 * k))
        comp.set_auto_envelope()
        sc.push(comp)
    t = ho.make_torus(1.1, 0.3)
    t.rotate(ho.rot_x(0.9))
    t.move(ho.v3(0, 0.5, 3.0))
    sc.push(t)
    return sc


def lamp_scene(ho, direct_samples=3, depth=6, path_samples=0):
    """A small render scene with distance objects: a chess floor, a glass
    ball, two SDF lamps (torus ring in CSG with a sphere and a cylinder)
    that or-decompose into a 2-member cluster, a standalone torus, a
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
    floor.prp.texture = ho.TxmChess((0.1, 0.1, 0.1), (0.9, 0.9, 0.8), 1.0)
    sc.push(floor)
    ball = ho.Sphere(0.8)
    ho.apply_material(ball, "glass")
    ball.move(ho.v3(1.2, 0.5, 0.8))
    sc.push(ball)
    for k in range(2):
        ringed = ho.PairInside(
            ho.PairOutside(ho.make_torus(0.7, 0.15), ho.Sphere(0.3)),
            ho.Neg(ho.Squaroid.cylinder(0.1, 0.1)))
        part = ho.PairOutside(ringed, ho.Sphere(0.25))
        part.o2.move(ho.v3(0.0, 0.0, 1.3))
        part.rotate(ho.rot_x(0.5 + 0.3 * k))
        part.move(ho.v3(-1.5 + 3.0 * k, 1.5, 1.2))
        part.set_auto_envelope()
        sc.push(part)
    t = ho.make_torus(0.9, 0.2)
    t.rotate(ho.rot_y(0.6))
    t.move(ho.v3(-0.8, -1.0, 0.4))
    sc.push(t)
    return sc


def many_sphere_scene(ho, n=600, seed=3):
    """A light over n random matter spheres (a copy of
    tests/test_bigscene.py:_many_sphere_scene, returning the scene): more
    than BIG_MIN_ROWS spheres, so the big-scene kernels apply."""
    rng = np.random.default_rng(seed)
    sc = ho.Scene()
    light = ho.Sphere(0.4)
    light.move(ho.v3(0, 0, 15))
    light.prp.radiance = 50.0
    sc.push(light)
    centers = rng.uniform(-8, 8, (n, 3))
    radii = rng.uniform(0.15, 0.5, n)
    for c, r in zip(centers, radii):
        s = ho.Sphere(float(r))
        s.move(ho.v3(*c))
        sc.push(s)
    return sc


def rays(n=512, seed=1, spread=7.0):
    """Seeded rays in float32: origins uniform in a cube, unit directions."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d
