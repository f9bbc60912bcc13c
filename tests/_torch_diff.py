"""Scenes and runners shared by the differentiable-renderer tests of the
port (tests/test_torch_diff*.py).

The scenes are those of tests/test_diff.py, built in Python from either
package's objects module (`ho`), so that each package compiles the same
scene with its own front end.  `SCENES` names each setup: a scene and
its ray batch (camera rays at seeded subpixel positions, or the downward
rays that test_diff.py injects below an occluder).  The JAX package is
imported only inside
`jax_value_and_grad`: the card-only tests use the port's half without
JAX."""

import math
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS_TABLE = os.path.join(ROOT, "actinon_tpu_torch", "scenes",
                           "glass_table.acn")


def make_scene(ho, glass=False, lens=False, path_samples=0,
               direct_samples=4, depth=6, sigma=0.0, diffuse=None):
    """tests/test_diff.py:make_scene: a lamp, a floor, a ball (glass with
    `glass`), a CSG lens with `lens`; `diffuse` sets the floor's diffuse
    weight (its default is 1)."""
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
    if diffuse is not None:
        floor.prp.diffuse_reflectivity = diffuse
    sc.push(floor)
    ball = ho.Sphere(1.0)
    if glass:
        ho.apply_material(ball, "glass")
    ball.move(ho.v3(-0.8, 0, 1.2))
    sc.push(ball)
    if lens:
        a = ho.Sphere(1.4)
        a.move(ho.v3(2.0, 1.0, 0.4))
        b = ho.Sphere(1.4)
        b.move(ho.v3(2.0, 1.0, 1.6))
        sc.push(ho.PairInside(a, b))
    return sc


def torus_scene(ho):
    """make_scene plus a standalone SDF torus clear of the other objects
    (tests/test_diff.py:TestSdfGrads)."""
    sc = make_scene(ho)
    t = ho.make_torus(0.7, 0.2)
    t.rotate(ho.rot_x(1.1))
    t.move(ho.v3(1.4, 0.8, 1.9))
    sc.push(t)
    return sc


def _edge_base(ho):
    sc = ho.Scene()
    cfg = sc.cfg
    cfg.image_width, cfg.image_height = 8, 6
    cfg.trace_depth = 3
    cfg.direct_samples = 64
    cfg.path_samples = 0
    cfg.background_color = (0.0, 0.0, 0.0)
    return sc


def _lamp(ho, sc):
    lamp = ho.Sphere(0.5)
    lamp.prp.radiance = 25.0
    lamp.move(ho.v3(0, 0, 5))
    sc.push(lamp)


def _floor(ho, sc):
    floor = ho.Plane()                      # z = 0, normal +z
    floor.prp.fresnel_reflectivity = 0.0    # pure diffuse
    sc.push(floor)


def edge_sphere(ho):
    """A sphere occluder between the floor and the lamp."""
    sc = _edge_base(ho)
    _lamp(ho, sc)
    _floor(ho, sc)
    occ = ho.Sphere(0.6)
    occ.prp.fresnel_reflectivity = 0.0
    occ.move(ho.v3(0.8, 0.0, 2.0))
    sc.push(occ)
    return sc


def edge_plane(ho):
    """A vertical half-space (solid x > 0.2) whose boundary cuts the
    lamp."""
    sc = _edge_base(ho)
    _lamp(ho, sc)
    _floor(ho, sc)
    occ = ho.Plane()
    occ.prp.fresnel_reflectivity = 0.0
    occ.prp.rax = np.array([[0., 1., 0.], [0., 0., 1.], [-1., 0., 0.]])
    occ.move(ho.v3(0.2, 0, 0))
    sc.push(occ)
    return sc


def edge_csg(ho):
    """A CSG intersection of two spheres as the occluder."""
    sc = _edge_base(ho)
    _lamp(ho, sc)
    _floor(ho, sc)
    a = ho.Sphere(0.6)
    a.move(ho.v3(0.7, 0.0, 2.0))
    b = ho.Sphere(0.6)
    b.move(ho.v3(1.0, 0.0, 2.0))
    lens = ho.PairInside(a, b)
    lens.prp.fresnel_reflectivity = 0.0
    sc.push(lens)
    return sc


def edge_ellipsoid(ho):
    sc = _edge_base(ho)
    _floor(ho, sc)
    _lamp(ho, sc)
    occ = ho.Squaroid.ellipsoid(0.7, 0.4, 0.3)
    occ.prp.fresnel_reflectivity = 0.0
    occ.move(ho.v3(0.8, 0.0, 2.0))
    sc.push(occ)
    return sc


def edge_cylinder(ho):
    """A cylinder along y above the shadow band."""
    sc = _edge_base(ho)
    _floor(ho, sc)
    _lamp(ho, sc)
    occ = ho.Squaroid.cylinder(0.35, 0.35)
    occ.prp.fresnel_reflectivity = 0.0
    occ.rotate(ho.rot_x(math.pi / 2))
    occ.move(ho.v3(0.8, 0.0, 2.0))
    sc.push(occ)
    return sc


def edge_ellipsoid_light(ho):
    """A sphere occluder under an ellipsoid lamp (NEE hits the lamp's
    true geometry)."""
    sc = _edge_base(ho)
    _floor(ho, sc)
    lamp = ho.Squaroid.ellipsoid(0.55, 0.45, 0.35)
    lamp.prp.radiance = 25.0
    lamp.move(ho.v3(0, 0, 5))
    lamp.prp.envelope = ho.estimate_envelope(lamp)
    sc.push(lamp)
    occ = ho.Sphere(0.6)
    occ.prp.fresnel_reflectivity = 0.0
    occ.move(ho.v3(0.8, 0.0, 2.0))
    sc.push(occ)
    return sc


def coverage_scene(ho):
    """make_scene plus a torus and a cone: occluder classes the edge
    terms leave interior-only (tests/test_diff.py:test_edge_coverage_
    warning)."""
    sc = make_scene(ho)
    t = ho.make_torus(1.2, 0.3)
    t.move(ho.v3(4.0, 2.0, 1.0))
    sc.push(t)
    cone = ho.Squaroid.cone(1.0, 1.0, 1.0)
    cone.move(ho.v3(-4.0, 2.0, 1.0))
    sc.push(cone)
    return sc


def glass_table(ho, run_file):
    """The port's smoke scene glass_table.acn through a package's front
    end (`run_file`), cut to 20x15, direct=4, depth=8."""
    cap = []
    run_file(GLASS_TABLE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 20, 15
    sc.cfg.direct_samples = 4
    sc.cfg.trace_depth = 8
    return sc


# name: (builder, keyword arguments, lanes, seed, band (None: camera rays
# over the image; else the x range of the injected downward rays))
SCENES = {
    "plain": (make_scene, {}, 24, 0, None),
    "diffuse07": (make_scene, dict(diffuse=0.7), 24, 0, None),
    "glass": (make_scene, dict(glass=True), 32, 1, None),
    "lens": (make_scene, dict(lens=True), 32, 2, None),
    "path": (make_scene, dict(path_samples=2, depth=14, sigma=0.29), 24, 3,
             None),
    "torus": (torus_scene, {}, 32, 6, None),
    "edge_sphere": (edge_sphere, {}, 512, 11, (-0.3, 0.5)),
    "edge_plane": (edge_plane, {}, 512, 13, (-0.5, 0.1)),
    "edge_csg": (edge_csg, {}, 512, 13, (0.1, 0.9)),
    "edge_ellipsoid": (edge_ellipsoid, {}, 512, 17, (-0.2, 0.6)),
    "edge_cylinder": (edge_cylinder, {}, 512, 17, (-0.2, 0.6)),
    "edge_ellipsoid_light": (edge_ellipsoid_light, {}, 512, 17, (-0.3, 0.5)),
    "glass_table": (glass_table, {}, 32, 3, None),
}


def scene(name, ho, run_file=None):
    build, kw, *_ = SCENES[name]
    return build(ho, run_file) if name == "glass_table" else build(ho, **kw)


def rays(name, cfg):
    """The ray batch of scene `name` as numpy arrays: (q0 fields,
    camera positions or None)."""
    _, _, n, seed, band = SCENES[name]
    rng = np.random.default_rng(seed)
    if band is None:
        pos = np.stack([rng.uniform(0, cfg.image_width, n),
                        rng.uniform(0, cfg.image_height, n)], -1)
        return None, pos
    px = rng.uniform(band[0], band[1], n)
    py = rng.uniform(-0.4, 0.4, n)
    q0 = dict(p=np.stack([px, py, np.full(n, 0.5)], -1),
              d=np.tile(np.array([0.0, 0.0, -1.0]), (n, 1)),
              intensity=np.ones(n), tint=np.ones((n, 3)),
              depth=np.full(n, cfg.trace_depth, np.int32),
              sample_id=np.arange(n, dtype=np.int32),
              is_path=np.zeros(n, bool))
    return q0, None


def port_setup(name, sel_mode="uniform", edge_aware=False, dtype=np.float64,
               device="cpu"):
    """(DiffRenderer, q0) of the port for scene `name`."""
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.diff import DiffRenderer
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    sc = scene(name, ho, run_file)
    n = SCENES[name][2]
    tr = Tracer(sir.compile_scene(sc), dtype=dtype, device=device)
    dr = DiffRenderer(Integrator(tr, batch=n), sel_mode=sel_mode,
                      edge_aware=edge_aware)
    q0, pos = rays(name, sc.cfg)
    return dr, (dr.primary(pos) if q0 is None else dr._lanes(q0))


def jax_value_and_grad(name, sel_mode="uniform", edge_aware=False):
    """(loss, grads as numpy) of the JAX package's DiffRenderer on scene
    `name` in f64: jax.value_and_grad of render_loss at the scene's own
    parameters."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from actinon_tpu.acn.interp import run_file
    from actinon_tpu.render.diff import DiffRenderer
    from actinon_tpu.render.integrator import Integrator
    from actinon_tpu.render.tracer import Tracer
    from actinon_tpu.scene import ir as sir
    from actinon_tpu.scene import objects as ho
    sc = scene(name, ho, run_file)
    n = SCENES[name][2]
    tr = Tracer(sir.compile_scene(sc), dtype=np.float64)
    dr = DiffRenderer(Integrator(tr, batch=n), sel_mode=sel_mode,
                      edge_aware=edge_aware)
    q0, pos = rays(name, sc.cfg)
    q0 = dr.primary(pos) if q0 is None else \
        {k: jnp.asarray(v) for k, v in q0.items()}
    # one program for the whole replay and its backward, as bench.py:177
    # compiles it; LLVM's optimization level 0 compiles it in about half
    # the time (the HLO passes, which decide the rounding the port
    # mirrors, still run)
    f = jax.jit(jax.value_and_grad(lambda ps: dr.render_loss(ps, q0)))
    params = dr.params()
    val, grads = f.lower(params).compile(
        compiler_options={"xla_backend_optimization_level": 0})(params)
    return float(val), {g: {k: np.asarray(v, np.float64)
                            for k, v in grp.items()}
                        for g, grp in grads.items()}


def assert_matches_jax(got, want):
    """The port's (loss, grads) against the JAX package's: loss within
    rtol 1e-8, every gradient entry within rtol 1e-5 plus 1e-8 of its
    table's largest magnitude, the same keys, all finite."""
    loss_t, g_t = float(got[0]), got[1]
    loss_j, g_j = want
    assert np.isfinite(loss_t)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-8)
    assert {g: set(v) for g, v in g_t.items()} == \
        {g: set(v) for g, v in g_j.items()}
    for g, grp in g_j.items():
        for k, want_k in grp.items():
            got_k = g_t[g][k].detach().cpu().numpy()
            assert np.isfinite(got_k).all(), (g, k)
            np.testing.assert_allclose(
                got_k, want_k, rtol=1e-5,
                atol=1e-8 * float(np.abs(want_k).max(initial=0.0)),
                err_msg=f"{g}.{k}")


def fd_pair(dr, q0, group, key, flat_idx, delta):
    """(loss, autograd entry, central finite difference of the same loss)
    for one parameter entry of the port."""
    import torch
    val, grads = dr.value_and_grad(q0)
    params = dr.params()
    g_ad = float(grads[group][key].reshape(-1)[flat_idx])
    leaf = params[group][key]

    def eval_at(eps):
        pert = leaf.clone().reshape(-1)
        pert[flat_idx] += eps
        ps = {g: dict(v) for g, v in params.items()}
        ps[group][key] = pert.reshape(leaf.shape)
        with torch.no_grad():
            return float(dr.render_loss(ps, q0))

    g_fd = (eval_at(delta) - eval_at(-delta)) / (2 * delta)
    return float(val), g_ad, g_fd


def edge_fd(name, key, flat_idx, edge_aware=True, delta=2e-2):
    """(loss, autograd entry, central difference) of a geometry entry on
    an edge scene, uniform selection (tests/test_diff.py's edge cases)."""
    dr, q0 = port_setup(name, "uniform", edge_aware)
    return fd_pair(dr, q0, "geom", key, flat_idx, delta)


def fd_check(dr, q0, group, key, flat_idx, delta, rtol, atol=1e-9):
    """The port's autograd entry against central finite differences
    (tests/test_diff.py:fd_check).  Returns (g_ad, g_fd)."""
    val, g_ad, g_fd = fd_pair(dr, q0, group, key, flat_idx, delta)
    assert np.isfinite(val)
    assert abs(g_ad - g_fd) <= atol + rtol * max(abs(g_ad), abs(g_fd)), \
        (key, flat_idx, g_ad, g_fd)
    return g_ad, g_fd
