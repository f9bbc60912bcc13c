"""Scene IR: the host object graph compiled to flat arrays + static CSG
programs — the form the device tracer consumes.

Design (tpu-first, SURVEY.md section 7): instead of the reference's
pointer-chasing object vtables (reference src/objects.c:202-241) and
per-pair recursive marching (reference src/objects.c:1052-1094), every
top-level scene object is flattened into

  * a set of *leaf surfaces* drawn from four analytic families —
    half-space PLANE ``n.x + k <= 0``, SPHERE ``|x-c|^2 <= r^2``,
    QUADRIC ``sum_i coef_i (M x + m0)_i^2 + r <= 0`` and marched SDF —
    with every rigid/anisotropic transform (obj_scale_s, reference
    src/objects.c:1350-1459) folded into the leaf parameters at compile
    time, and
  * a static CSG *tree program* (nested ("and"|"or"|"not"|"leaf", ...)
    tuples) evaluated by unrolling at JAX trace time, so each scene
    becomes straight-line XLA code with no data-dependent dispatch.

The leaf tables are struct-of-arrays so the tracer evaluates all leaves of
one family in a single vectorized expression (quadric setup is einsum ->
MXU work).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from actinon_tpu_torch.scene import objects as ho  # host objects

INF = float("inf")

# leaf family tags
PLANE, SPHERE, QUADRIC, SDF = 0, 1, 2, 3
# SDF kinds
SDF_SPHERE, SDF_TORUS = 0, 1
# texture kinds
TEX_NONE, TEX_PLAIN, TEX_CHESS = 0, 1, 2
# projection kinds (for chess textures)
PROJ_NONE, PROJ_PLANE, PROJ_SPHERE = 0, 1, 2


@dataclasses.dataclass
class Leaf:
    """One analytic surface in world space."""

    family: int
    # PLANE: n[3], k             side = n.x + k
    # SPHERE: c[3], r
    # QUADRIC: m[3,3], m0[3], coef[3], r
    # SDF: m[3,3], m0[3], kind, param, cycles, env_c[3], env_r (entry clip)
    n: Optional[np.ndarray] = None
    k: float = 0.0
    c: Optional[np.ndarray] = None
    r: float = 0.0
    m: Optional[np.ndarray] = None
    m0: Optional[np.ndarray] = None
    coef: Optional[np.ndarray] = None
    sdf_kind: int = 0
    sdf_param: float = 0.0
    cycles: int = 200
    env_c: Optional[np.ndarray] = None
    env_r: float = -1.0
    neg: bool = False   # parity of Neg ancestors (flips the reported normal)


@dataclasses.dataclass
class ObjIR:
    """One top-level scene object: CSG tree over leaves + material."""

    leaves: List[Leaf]
    tree: tuple                     # ("leaf", i) | ("and"|"or", l, r) | ("not", t)
    # material record (properties_s, reference src/objects.h:51-78)
    color: np.ndarray = None
    radiance: float = 0.0
    refractive_index: float = 1.0
    fresnel: float = 1.0
    chromatic: float = 0.0
    diffuse: float = 1.0
    sigma: float = 0.0
    roughness: float = 0.0
    transparency: np.ndarray = None
    pos: np.ndarray = None          # prp.pos (radiance falloff center)
    # texture
    tex_kind: int = TEX_NONE
    tex_c1: np.ndarray = None
    tex_c2: np.ndarray = None
    tex_scale: float = 1.0
    proj_kind: int = PROJ_NONE
    proj_pos: np.ndarray = None
    proj_rax: np.ndarray = None
    # envelope (object-level culling + light fov fallback)
    env_c: Optional[np.ndarray] = None
    env_r: float = -1.0
    is_light: bool = False
    # light sampling geometry (sphere lights: exact fov cone,
    # reference src/objects.c:619-637)
    light_radius: float = 0.0
    # fov cone kind: "sphere" (exact sphere / envelope cone) or "plane"
    # (obj_plane_s_fov, reference src/objects.c:520-526)
    light_fov: str = "sphere"
    light_plane_n: Optional[np.ndarray] = None   # plane light normal (rax.z)
    # cone center: the object pos for sphere lights, the ENVELOPE center
    # for enveloped non-sphere lights (envelope_s_fov, reference
    # src/objects.c:70-88); radiance falloff always uses prp.pos
    # (reference src/scene.c:573)
    light_cone_pos: Optional[np.ndarray] = None

    @property
    def single_leaf(self) -> bool:
        return len(self.leaves) == 1 and self.tree == ("leaf", 0)


@dataclasses.dataclass
class SceneIR:
    objects: List[ObjIR]
    lights: List[int]               # indices into objects with radiance > 0
    cfg: "RenderConfig"

    # derived camera fields (filled by compile_scene)
    cam_pos: np.ndarray = None
    cam_rot: np.ndarray = None      # applied as cam_rot @ d_local
    background: np.ndarray = None


# ---------------------------------------------------------------------------
# affine context: current = A @ x + b maps world points into the space the
# current subtree's parameters live in


class _Affine:
    __slots__ = ("A", "b")

    def __init__(self, A=None, b=None):
        self.A = np.eye(3) if A is None else A
        self.b = np.zeros(3) if b is None else b

    def enter_scale_wrap(self, w: "ho.ScaleWrap") -> "_Affine":
        """Child coordinates of obj_scale_s: diag(inv)*rax*(y - pos)
        (reference src/objects.c:1418-1424), where y is a point in the
        current space."""
        D = np.diag(w.inv_scale)
        R = w.prp.rax
        M = D @ R
        return _Affine(M @ self.A, M @ (self.b - w.prp.pos))

    @property
    def is_identity(self):
        return np.allclose(self.A, np.eye(3)) and np.allclose(self.b, 0.0)

    def isotropic_scale(self) -> Optional[float]:
        """If A = s * R (similarity), return s, else None."""
        g = self.A @ self.A.T
        s2 = g[0, 0]
        if np.allclose(g, np.eye(3) * s2, atol=1e-12 * max(s2, 1.0)):
            return float(np.sqrt(s2))
        return None


def _transform_envelope(env: ho.Envelope, ctx: _Affine) -> Tuple[np.ndarray, float]:
    """Conservative world-space image of an envelope given in ctx space:
    center = A^-1(c - b), radius = r * max singular value of A^-1."""
    Ainv = np.linalg.inv(ctx.A)
    c = Ainv @ (env.pos - ctx.b)
    r = env.radius * float(np.linalg.svd(Ainv, compute_uv=False)[0])
    return c, r


# ---------------------------------------------------------------------------


def _flatten(obj: ho.Obj, ctx: _Affine, neg: bool, leaves: List[Leaf]):
    """Recursive CSG flatten; returns the tree node."""
    if isinstance(obj, ho.PairInside) and not isinstance(obj, ho.PairOutside):
        l = _flatten(obj.o1, ctx, neg, leaves)
        r = _flatten(obj.o2, ctx, neg, leaves)
        return ("and", l, r)
    if isinstance(obj, ho.PairOutside):
        l = _flatten(obj.o1, ctx, neg, leaves)
        r = _flatten(obj.o2, ctx, neg, leaves)
        return ("or", l, r)
    if isinstance(obj, ho.Neg):
        return ("not", _flatten(obj.o1, ctx, not neg, leaves))
    if isinstance(obj, ho.ScaleWrap):
        return _flatten(obj.o1, ctx.enter_scale_wrap(obj), neg, leaves)

    idx = len(leaves)
    leaves.append(_leaf_of(obj, ctx, neg))
    return ("leaf", idx)


def _leaf_of(obj: ho.Obj, ctx: _Affine, neg: bool) -> Leaf:
    if isinstance(obj, ho.Plane):
        # side(x) = (A x + b - pos) . nor  ->  n = A^T nor, k = (b - pos) . nor
        nor = obj.prp.rax[2]
        n = ctx.A.T @ nor
        k = float((ctx.b - obj.prp.pos) @ nor)
        ln = np.linalg.norm(n)
        return Leaf(family=PLANE, n=n / ln, k=k / ln, neg=neg)

    if isinstance(obj, ho.Sphere):
        s = ctx.isotropic_scale()
        if s is not None:
            Ainv = np.linalg.inv(ctx.A)
            c = Ainv @ (obj.prp.pos - ctx.b)
            return Leaf(family=SPHERE, c=c, r=obj.radius / s, neg=neg)
        # anisotropic: |A x + b - pos|^2 - r^2 = 0  -> quadric
        return Leaf(family=QUADRIC, m=ctx.A.copy(), m0=ctx.b - obj.prp.pos,
                    coef=np.ones(3), r=-obj.radius ** 2, neg=neg)

    if isinstance(obj, ho.Squaroid):
        # side(x) = sum coef_i (rax (A x + b - pos))_i^2 + r
        M = obj.prp.rax @ ctx.A
        m0 = obj.prp.rax @ (ctx.b - obj.prp.pos)
        if ctx.is_identity and np.allclose([obj.a, obj.b, obj.c], 1.0) \
                and obj.r < 0:
            # pure sphere in disguise
            return Leaf(family=SPHERE, c=obj.prp.pos.copy(),
                        r=float(np.sqrt(-obj.r)), neg=neg)
        return Leaf(family=QUADRIC, m=M, m0=m0,
                    coef=np.array([obj.a, obj.b, obj.c]), r=obj.r, neg=neg)

    if isinstance(obj, ho.DistanceObj):
        # local = (rax (A x + b - pos)) * inv_scale; inv_scale is scalar
        # (reference src/objects.c:917)
        M = obj.inv_scale * (obj.prp.rax @ ctx.A)
        m0 = obj.inv_scale * (obj.prp.rax @ (ctx.b - obj.prp.pos))
        if isinstance(obj.distance, ho.DistanceTorus):
            kind, param = SDF_TORUS, obj.distance.ex_radius
        elif isinstance(obj.distance, ho.DistanceSphere):
            kind, param = SDF_SPHERE, 0.0
        else:
            raise NotImplementedError(
                f"SDF type {type(obj.distance).__name__}")
        env_c, env_r = None, -1.0
        if obj.prp.envelope is not None:
            env_c, env_r = _transform_envelope(obj.prp.envelope, ctx)
        return Leaf(family=SDF, m=M, m0=m0, sdf_kind=kind, sdf_param=param,
                    cycles=obj.cycles, env_c=env_c, env_r=env_r, neg=neg)

    raise NotImplementedError(f"cannot compile {type(obj).__name__}")


def compile_object(obj: ho.Obj, is_light: bool) -> ObjIR:
    leaves: List[Leaf] = []
    tree = _flatten(obj, _Affine(), False, leaves)
    p = obj.prp

    o = ObjIR(leaves=leaves, tree=tree)
    o.color = p.color.copy()
    o.radiance = p.radiance
    o.refractive_index = p.refractive_index
    o.fresnel = p.fresnel_reflectivity
    o.chromatic = p.chromatic_reflectivity
    o.diffuse = p.diffuse_reflectivity
    o.sigma = p.sigma
    o.roughness = p.surface_roughness
    o.transparency = p.transparency.copy()
    o.pos = p.pos.copy()
    o.is_light = is_light

    # texture / projection (obj_color dispatch, reference src/objects.c:411-422;
    # chess projection reference src/textures.c:142-148)
    t = p.texture
    if isinstance(t, ho.TxmPlain):
        o.tex_kind = TEX_PLAIN
        o.tex_c1 = t.color.copy()
    elif isinstance(t, ho.TxmChess):
        o.tex_kind = TEX_CHESS
        o.tex_c1 = t.color1.copy()
        o.tex_c2 = t.color2.copy()
        o.tex_scale = t.scale
        if isinstance(obj, ho.Plane):
            o.proj_kind = PROJ_PLANE
        elif isinstance(obj, ho.Sphere):
            o.proj_kind = PROJ_SPHERE
        else:
            raise NotImplementedError(
                f"chess texture on {type(obj).__name__} (no projection)")
        o.proj_pos = p.pos.copy()
        o.proj_rax = p.rax.copy()

    if p.envelope is not None:
        o.env_c = p.envelope.pos.copy()
        o.env_r = p.envelope.radius

    if is_light:
        # light-source sampling cone (obj_fov): exact for spheres
        # (reference src/objects.c:619-637), half-space cone for planes
        # (reference src/objects.c:520-526), envelope cone otherwise
        # (reference src/objects.c:70-88, used by pair fov at
        # src/objects.c:1037).  The reference ERRORS for any other light
        # (obj_fov, src/objects.c:254-258) — so do we.
        o.light_cone_pos = o.pos.copy()
        if isinstance(obj, ho.Sphere):
            o.light_radius = obj.radius
        elif isinstance(obj, ho.Plane):
            o.light_fov = "plane"
            o.light_plane_n = np.asarray(p.rax[2], float).copy()
        elif p.envelope is not None:
            o.light_radius = p.envelope.radius
            o.light_cone_pos = p.envelope.pos.copy()
        else:
            raise NotImplementedError(
                f"light source {type(obj).__name__} without envelope "
                f"(the reference obj_fov errors here too, "
                f"src/objects.c:254-258)")
    return o


def _collect(compound: ho.Compound, out: List[ho.Obj]):
    for el in compound.elements:
        if isinstance(el, ho.Compound):
            _collect(el, out)
        else:
            out.append(el)


def compile_scene(scene: ho.Scene) -> SceneIR:
    """Host scene -> IR.  Camera math mirrors lum_machine_s_func
    (reference src/scene.c:962-974)."""
    objs: List[ObjIR] = []
    lights: List[int] = []

    light_objs: List[ho.Obj] = []
    matter_objs: List[ho.Obj] = []
    _collect(scene.light, light_objs)
    _collect(scene.matter, matter_objs)

    for hobj in light_objs:
        lights.append(len(objs))
        objs.append(compile_object(hobj, is_light=True))
    for hobj in matter_objs:
        objs.append(compile_object(hobj, is_light=False))

    ir = SceneIR(objects=objs, lights=lights, cfg=scene.cfg)

    cfg = scene.cfg
    ry = _norm(np.asarray(cfg.camera_view_direction, float))
    rz = np.asarray(cfg.camera_top_direction, float)
    rz = _von(ry, rz)
    rx = np.cross(ry, rz)
    ir.cam_rot = np.stack([rx, ry, rz]).T  # transposed([rx;ry;rz])
    ir.cam_pos = np.asarray(cfg.camera_position, float)
    ir.background = np.asarray(cfg.background_color, float)
    return ir


def _norm(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _von(o, v):
    v = v - o * float(o @ v)
    return _norm(v)
