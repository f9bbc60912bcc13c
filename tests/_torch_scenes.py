"""Scenes with distance objects for the port's tests, built in Python from
either package's objects module (`ho`), so that each package compiles the
same scene with its own front end.  Imports nothing itself: the card-only
tests use it without JAX."""

import math
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMP_ROW = os.path.join(ROOT, "actinon_tpu_torch", "scenes", "lamp_row.acn")


# a tiny .acn scene (16x16, depth 3, one gradient pass): a sphere lamp, a
# floor and a ball of `material` at x = `ball_x`
SMALL = """
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
def ball = create_sphere(1.0) + vec({ball_x},0,1.2);
ball.set_material( "{material}" );
scene.push( ball );
scene.create_image( "x" );
"""


def small_scene(run_source, material="glass", ball_x=-0.8):
    """SMALL through a front end's run_source (either package's)."""
    cap = []
    run_source(SMALL.format(material=material, ball_x=ball_x),
               render_fn=lambda sc, fn: cap.append(sc.clone()))
    return cap[0]


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


def fractal_spheres(levels=5):
    """Centres [8**levels, 3] and radii of spheres shaped like
    sphere_fractal.acn's: nested levels of 8 (each child a third of its
    parent's size, at its parent's cube corners); at 5 levels 32,768
    spheres, 256 Morton blocks."""
    c = np.zeros((1, 3))
    corners = np.stack(np.meshgrid(*[[-1.0, 1.0]] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    for k in range(levels):
        c = (c[:, None, :] + corners[None] * 4.0 / 3.0 ** k).reshape(-1, 3)
    return c, np.full(len(c), 0.04)


# Scenes and rays built for exact ties: centres on the integer lattice,
# radii 0.25 and 0.375, unit axis directions and integer or half-integer
# origins.  Every product, sum, square root and quotient of a sphere's
# roots is then exact in f32, so a kernel and its plain version agree bit
# for bit whatever their contraction to FMA, and copies of one sphere tie
# exactly.

TIE_SHAPE = (5, 6, 5)      # the lattice of tie_scene (K4)
TIE_BIG_SHAPE = (24, 24, 16)   # the lattice of tie_blocks (K6)


def lattice_sites(shape):
    """[prod(shape), 3] integer lattice sites (float64), x slowest."""
    g = np.meshgrid(*(np.arange(k, dtype=np.float64) for k in shape),
                    indexing="ij")
    return np.stack(g, -1).reshape(-1, 3)


def tie_centres(shape, seed=5):
    """Sphere centres on the lattice of `shape`: one to three copies of
    each site, the copies in a row (so that they stay neighbours in Morton
    order), one more sphere where the count would fill its last block of
    128 exactly."""
    sites = lattice_sites(shape)
    copies = np.random.default_rng(seed).integers(1, 4, len(sites))
    c = np.repeat(sites, copies, axis=0)
    return c if len(c) % 128 else np.concatenate([c, sites[:1]])


def tie_scene(ho):
    """Two copies of a matter sphere of radius 0.25 at each site of the
    TIE_SHAPE lattice and a sphere light of radius 0.25 on the column
    x = y = 2 above it (301 members of one singles shape: three blocks,
    the last partial; more than 192 members, so the scene kernels, and
    fewer than 512 spheres, so not the big-scene ones), and four pairs of
    identical composites (a sphere of radius 0.375 less one of 0.125) at
    x = 6 beside the lattice."""
    sc = ho.Scene()
    light = ho.Sphere(0.25)
    light.move(ho.v3(2.0, 2.0, TIE_SHAPE[2] + 1.0))
    light.prp.radiance = 20.0
    sc.push(light)
    for c in np.repeat(lattice_sites(TIE_SHAPE), 2, axis=0):
        s = ho.Sphere(0.25)
        s.move(ho.v3(*c))
        sc.push(s)
    for y, z in ((0, 0), (1, 3), (4, 2), (5, 4)):
        for _ in range(2):
            comp = ho.PairInside(ho.Sphere(0.375), ho.Neg(ho.Sphere(0.125)))
            comp.move(ho.v3(6.0, float(y), float(z)))
            sc.push(comp)
    return sc


def tie_singles(ho, shape):
    """A sphere light of radius 0.25 above the lattice of `shape` and a
    matter sphere of radius 0.25 at each of tie_centres(shape): one
    singles shape of many blocks (at TIE_BIG_SHAPE about 18,000 members,
    more than one shared-memory stage of block bounds in the scene
    kernels, where a test keeps the spheres in the scene table)."""
    sc = ho.Scene()
    light = ho.Sphere(0.25)
    light.move(ho.v3(2.0, 2.0, shape[2] + 1.0))
    light.prp.radiance = 20.0
    sc.push(light)
    for c in tie_centres(shape):
        s = ho.Sphere(0.25)
        s.move(ho.v3(*c))
        sc.push(s)
    return sc


def face_tie_scene(ho):
    """Composites whose leaves share a face, so that their crossings tie
    exactly: a dome (a sphere of radius 1 and two coincident half-spaces
    z <= 0.25 under &), a lens of two coincident spheres under &, and an
    empty shell (a sphere less its own copy), beside a floor at z = -2 and
    a sphere light above.  Every composite crosses the same surface twice
    at one t, so a walk that toggled the two crossings apart would see a
    flip inside the tie (the shell) or miss the joint one."""
    sc = ho.Scene()
    light = ho.Sphere(0.5)
    light.move(ho.v3(0.0, 0.0, 8.0))
    light.prp.radiance = 20.0
    sc.push(light)
    floor = ho.Plane()
    floor.move(ho.v3(0.0, 0.0, -2.0))
    sc.push(floor)
    cut = ho.Plane()
    cut.move(ho.v3(0.0, 0.0, 0.25))
    parts = (ho.PairInside(ho.Sphere(1.0), ho.PairInside(cut, cut)),
             ho.PairInside(ho.Sphere(0.75), ho.Sphere(0.75)),
             ho.PairInside(ho.Sphere(0.5), ho.Neg(ho.Sphere(0.5))))
    for x, comp in zip((-2.5, 0.0, 2.5), parts):
        comp.move(ho.v3(x, 0.0, 0.0))
        sc.push(comp)
    return sc


def wide_comp_scene(ho):
    """A composite of 21 leaves, 42 crossing columns (past one warp's 32,
    and past the walks' 16 in registers): a row of 20 overlapping spheres
    of radius 0.3, 0.4 apart along x, under |, less a sphere of radius 0.5
    at the row's middle; beside a floor and a sphere light."""
    sc = ho.Scene()
    light = ho.Sphere(0.5)
    light.move(ho.v3(0.0, 0.0, 8.0))
    light.prp.radiance = 20.0
    sc.push(light)
    floor = ho.Plane()
    floor.move(ho.v3(0.0, 0.0, -2.0))
    sc.push(floor)
    row = ho.Sphere(0.3)
    row.move(ho.v3(-3.8, 0.0, 0.0))
    for k in range(1, 20):
        s = ho.Sphere(0.3)
        s.move(ho.v3(0.4 * k - 3.8, 0.0, 0.0))
        row = ho.PairOutside(row, s)
    hole = ho.Sphere(0.5)
    hole.move(ho.v3(0.0, 0.0, 0.0))
    sc.push(ho.PairInside(row, ho.Neg(hole)))
    return sc


def axis_rays(n, shape, seed):
    """n unit rays along the lattice axes, down the columns of sites of
    `shape` (a tenth of them half a cell off, between the columns), from
    2.5 outside the lattice (or 1.5 past x = 6 on x) or from half-way
    between two sites, in float32."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(shape, np.float32) - 1
    rows = np.arange(n)
    axis = rng.integers(0, 3, n)
    sign = rng.choice(np.float32([-1.0, 1.0]), n)
    p = np.floor(rng.uniform(size=(n, 3)) * (hi + 1)).astype(np.float32)
    off = rng.uniform(size=n) < 0.1
    p[rows[off], (axis[off] + 1) % 3] += 0.5
    far = np.where(axis == 0, 7.5, hi[axis] + 2.5).astype(np.float32)
    outside = np.where(sign > 0, np.float32(-2.5), far)
    p[rows, axis] = np.where(rng.uniform(size=n) < 0.7, outside,
                             p[rows, axis] + 0.5)
    d = np.zeros((n, 3), np.float32)
    d[rows, axis] = sign
    return p, d


def rays(n=512, seed=1, spread=7.0):
    """Seeded rays in float32: origins uniform in a cube, unit directions."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d
