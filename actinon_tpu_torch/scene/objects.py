"""Host-side (build-time) scene object model.

This is the object algebra that `.acn` scripts manipulate: primitives, CSG
combinators, transforms, materials, envelopes and containers — the analog of
the reference's objects.c / compound.c / container.c layer, re-expressed as
plain Python + numpy (f64).  It exists purely at scene-build time; rendering
never touches these classes (scenes compile to flat arrays, see ir.py).

Every object also carries a *scalar reference implementation* of its ray-hit
and side test (`ray_hit(p, d)`, `side(pos)`), a direct re-derivation of the
reference algorithms.  These serve two roles:
  1. the Monte-Carlo auto-envelope estimator runs on them at build time
     (obj_estimate_envelope, reference src/objects.c:312-363), and
  2. they are the oracle for unit tests of the vectorized device kernels.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional

import numpy as np

INF = float("inf")
EPS = 1e-6          # f3_eps (reference src/vectors.h:33) — build phase is f64
MAG = 1e30          # f3_mag (reference src/vectors.h:32)


def v3(x=0.0, y=0.0, z=0.0) -> np.ndarray:
    return np.array([float(x), float(y), float(z)], dtype=np.float64)


def normalize(v: np.ndarray, a: float = 1.0) -> np.ndarray:
    """v3d_s_of_length semantics (reference src/vectors.h:148-154)."""
    r2 = float(v @ v)
    if abs(r2 - 1.0) < 1e-8:
        return v.copy()
    return v * (a / math.sqrt(r2)) if r2 > 0 else v * 0.0


def rot_x(deg_rad: float) -> np.ndarray:
    sa, ca = math.sin(deg_rad), math.cos(deg_rad)
    return np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]], dtype=np.float64)


def rot_y(a: float) -> np.ndarray:
    sa, ca = math.sin(a), math.cos(a)
    return np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], dtype=np.float64)


def rot_z(a: float) -> np.ndarray:
    sa, ca = math.sin(a), math.cos(a)
    return np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], dtype=np.float64)


# ---------------------------------------------------------------------------
# analytic hit/side helpers (reference src/gmath.h)


def plane_ray_hit(pos, nor, p, d):
    """reference src/gmath.h:38-45."""
    div = float(nor @ d)
    if div == 0.0:
        return INF
    offs = float((pos - p) @ nor) / div
    return offs - EPS if offs > 0 else INF


def sphere_ray_hit(pos, r, p, d):
    """reference src/gmath.h:64-85 (entry or exit root, eps-backed)."""
    pp = p - pos
    s = float(pp @ d)
    q = float(pp @ pp) - r * r
    s2 = s * s
    if s2 < q:
        return INF
    if s < 0 and q > 0:
        return -s - math.sqrt(s2 - q) - EPS
    elif s < 0 or q < 0:
        return -s + math.sqrt(s2 - q) - EPS
    return INF


def sphere_is_in_fov(pos, r, fov_p, fov_d, fov_cos_rs):
    """reference src/gmath.h:107-121."""
    diff = pos - fov_p
    diff_sqr = float(diff @ diff)
    cos_ang0 = float(normalize(diff) @ fov_d)
    if cos_ang0 > fov_cos_rs:
        return True
    r2 = r * r
    if diff_sqr <= r2:
        return True
    cos_ang1 = math.sqrt(1.0 - (r2 / diff_sqr)) if diff_sqr > r2 else 0.0
    return math.acos(min(max(cos_ang0, -1), 1)) - math.acos(min(max(cos_ang1, -1), 1)) \
        < math.acos(min(max(fov_cos_rs, -1), 1))


def sphere_intersects_half_sphere(pos, r, ray_p, ray_d, ray_radius):
    """reference src/gmath.h:124-136."""
    dd = pos - ray_p
    d2 = float(dd @ dd)
    if d2 > (r + ray_radius) ** 2:
        return False
    dp = float(dd @ ray_d)
    if dp > 0:
        return True
    dn = normalize(dd - ray_d * dp, ray_radius)
    r2 = r * r
    if float((dd - dn) @ (dd - dn)) < r2:
        return True
    if float((dd + dn) @ (dd + dn)) < r2:
        return True
    return False


# ---------------------------------------------------------------------------


class Envelope:
    """Bounding sphere (envelope_s, reference src/objects.c:34-136)."""

    __slots__ = ("pos", "radius")

    def __init__(self, pos=None, radius=0.0):
        self.pos = v3() if pos is None else np.asarray(pos, np.float64).copy()
        self.radius = float(radius)

    def clone(self):
        return Envelope(self.pos, self.radius)

    def move(self, vec):
        self.pos = self.pos + vec

    def rotate(self, mat):
        self.pos = mat @ self.pos

    def scale(self, fac):
        self.pos = self.pos * fac
        self.radius *= fac

    def ray_hit(self, p, d):
        return sphere_ray_hit(self.pos, self.radius, p, d)

    def ray_hits(self, p, d):
        return self.ray_hit(p, d) < INF

    def side(self, pos):
        diff = pos - self.pos
        return 1 if float(diff @ diff) > self.radius ** 2 else -1

    def fov(self, pos):
        """Cone from pos covering the envelope (reference src/objects.c:70-88).
        Returns (dir, cos_rs)."""
        diff = self.pos - pos
        d = normalize(diff)
        diff_sqr = float(diff @ diff)
        r2 = self.radius ** 2
        cos_rs = math.sqrt(1.0 - r2 / diff_sqr) if diff_sqr > r2 else -1.0
        return d, cos_rs

    def is_in_fov(self, fov_p, fov_d, fov_cos):
        return sphere_is_in_fov(self.pos, self.radius, fov_p, fov_d, fov_cos)

    def is_reachable(self, ray_p, ray_d, length):
        return sphere_intersects_half_sphere(self.pos, self.radius, ray_p, ray_d, length)


def envelope_of_pair(e1: Envelope, e2: Envelope) -> Envelope:
    """Merged bounding sphere (reference src/objects.c:113-136)."""
    diff = e1.pos - e2.pos
    d = math.sqrt(float(diff @ diff))
    r1, r2 = e1.radius, e2.radius
    if min(r1, r2) + d <= max(r1, r2):
        return (e1 if r1 > r2 else e2).clone()
    p1 = e1.pos + normalize(diff, r1)
    p2 = e2.pos - normalize(diff, r2)
    return Envelope((p1 + p2) * 0.5, (r1 + r2 + d) * 0.5)


# ---------------------------------------------------------------------------
# textures (reference src/textures.c)


class TxmPlain:
    """Constant-color texture (txm_plain_s, reference src/textures.c:75-116)."""

    def __init__(self, color=(0.7, 0.7, 0.7)):
        self.color = v3(*color)

    def clone(self):
        return TxmPlain(self.color)


class TxmChess:
    """Checkerboard over the object's own 2-D surface projection
    (txm_chess_s, reference src/textures.c:121-155)."""

    def __init__(self, color1=(0, 0, 0), color2=(1, 1, 1), scale=1.0):
        self.color1 = v3(*color1)
        self.color2 = v3(*color2)
        self.scale = float(scale)

    def clone(self):
        return TxmChess(self.color1, self.color2, self.scale)


# ---------------------------------------------------------------------------


class Properties:
    """Per-object material/placement record (properties_s, reference
    src/objects.c:141-196).  Defaults match properties_s_init_a."""

    __slots__ = ("pos", "rax", "texture", "color", "radiance",
                 "refractive_index", "fresnel_reflectivity",
                 "chromatic_reflectivity", "diffuse_reflectivity",
                 "sigma", "surface_roughness", "transparency", "envelope")

    def __init__(self):
        self.pos = v3()
        self.rax = np.eye(3, dtype=np.float64)
        self.texture = None
        self.color = v3(0.7, 0.7, 0.7)
        self.radiance = 0.0
        self.refractive_index = 1.0
        self.fresnel_reflectivity = 1.0
        self.chromatic_reflectivity = 0.0
        self.diffuse_reflectivity = 1.0
        self.sigma = 0.0
        self.surface_roughness = 0.0
        self.transparency = v3(0, 0, 0)
        self.envelope: Optional[Envelope] = None

    def copy_from(self, other: "Properties"):
        self.pos = other.pos.copy()
        self.rax = other.rax.copy()
        self.texture = other.texture.clone() if other.texture else None
        self.color = other.color.copy()
        self.radiance = other.radiance
        self.refractive_index = other.refractive_index
        self.fresnel_reflectivity = other.fresnel_reflectivity
        self.chromatic_reflectivity = other.chromatic_reflectivity
        self.diffuse_reflectivity = other.diffuse_reflectivity
        self.sigma = other.sigma
        self.surface_roughness = other.surface_roughness
        self.transparency = other.transparency.copy()
        self.envelope = other.envelope.clone() if other.envelope else None

    def move(self, vec):
        self.pos = self.pos + vec
        if self.envelope:
            self.envelope.move(vec)

    def rotate(self, mat):
        # rax rows are frame axes; each rotates by mat
        # (properties_s_rotate, reference src/objects.c:185-190)
        self.rax = (mat @ self.rax.T).T
        self.pos = mat @ self.pos
        if self.envelope:
            self.envelope.rotate(mat)

    def scale(self, fac):
        self.pos = self.pos * fac
        if self.envelope:
            self.envelope.scale(fac)


# ---------------------------------------------------------------------------


class Obj:
    """Base object: generic dispatch incl. envelope early-outs mirrors
    obj_ray_hit / obj_side (reference src/objects.c:245-370).
    Host hits skip the surface-roughness normal perturbation (render-time
    only, applied in the device integrator)."""

    def __init__(self):
        self.prp = Properties()

    # --- structural ---

    def clone(self):
        return copy.deepcopy(self)

    def children(self) -> List["Obj"]:
        return []

    # --- transforms (subclasses extend) ---

    def move(self, vec):
        self.prp.move(np.asarray(vec, np.float64))
        for c in self.children():
            c.move(vec)

    def rotate(self, mat):
        self.prp.rotate(np.asarray(mat, np.float64))
        for c in self.children():
            c.rotate(mat)

    def scale(self, fac):
        self.prp.scale(float(fac))
        for c in self.children():
            c.scale(fac)

    # --- geometry interface ---

    def _raw_ray_hit(self, p, d):
        """(offs, normal) without envelope gate."""
        raise NotImplementedError

    def _raw_side(self, pos) -> int:
        raise NotImplementedError

    def ray_hit(self, p, d):
        """obj_ray_hit dispatch (reference src/objects.c:261-284), sans
        roughness perturbation."""
        if self.prp.envelope is not None and not self.prp.envelope.ray_hits(p, d):
            return INF, None
        return self._raw_ray_hit(p, d)

    def side(self, pos) -> int:
        """obj_side (reference src/objects.c:365-370)."""
        if self.prp.envelope is not None and self.prp.envelope.side(pos) == 1:
            return 1
        return self._raw_side(pos)

    def ray_exit(self, p, d):
        """March through repeated hits to find where the ray leaves the object
        (obj_ray_exit, reference src/objects.c:286-310)."""
        a, nor = self.ray_hit(p, d)
        if a >= INF:
            return INF
        pl = np.asarray(p, np.float64).copy()
        total = 0.0
        while a < INF:
            a += EPS * 2
            total += a
            pl = pl + d * a
            a, nor2 = self.ray_hit(pl, d)
            if a < INF:
                nor = nor2
        if nor is not None and float(nor @ d) > 0:
            return total
        return INF

    def fov(self, pos):
        """Cone from pos covering this object; default variant used by the
        pair combinators (reference src/objects.c:1035-1044): direction toward
        prp.pos with cos_rs=0 (half-space), envelope override if present."""
        if self.prp.envelope is not None:
            return self.prp.envelope.fov(pos)
        return normalize(self.prp.pos - pos), 0.0

    def is_in_fov(self, fov_p, fov_d, fov_cos) -> bool:
        if self.prp.envelope is not None and not self.prp.envelope.is_in_fov(fov_p, fov_d, fov_cos):
            return False
        return True

    def projection(self, pos):
        raise RuntimeError(f"{type(self).__name__} has no projection")

    # --- materials ---

    def get_color(self, pos):
        """obj_color (reference src/objects.c:411-422)."""
        t = self.prp.texture
        if t is None:
            return self.prp.color
        if isinstance(t, TxmPlain):
            return t.color
        if isinstance(t, TxmChess):
            u, v = self.projection(pos)
            x = int(round(u * t.scale))
            y = int(round(v * t.scale))
            return t.color1 if (x ^ y) & 1 else t.color2
        raise TypeError(t)

    def set_refractive_index(self, rix):
        """reference src/objects.c:436-448 — rix 1.0 disables fresnel."""
        self.prp.refractive_index = float(rix)
        self.prp.fresnel_reflectivity = 0.0 if rix == 1.0 else 1.0

    def set_envelope(self, env: Envelope):
        self.prp.envelope = env.clone()

    def set_auto_envelope(self, samples=1000, rseed=123, radius_factor=1.1):
        self.prp.envelope = estimate_envelope(self, samples, rseed, radius_factor)


# ---------------------------------------------------------------------------
# primitives


class Plane(Obj):
    """Half-space below prp.rax.z (obj_plane_s, reference src/objects.c:479-551)."""

    def _raw_ray_hit(self, p, d):
        nor = self.prp.rax[2]
        a = plane_ray_hit(self.prp.pos, nor, p, d)
        return a, (nor.copy() if a < INF else None)

    def _raw_side(self, pos):
        return 1 if float((pos - self.prp.pos) @ self.prp.rax[2]) > 0 else -1

    def projection(self, pos):
        """reference src/objects.c:514-518."""
        p = pos - self.prp.pos
        return float(p @ self.prp.rax[0]), float(p @ self.prp.rax[1])

    def fov(self, pos):
        """reference src/objects.c:520-527."""
        d = -self.prp.rax[2]
        cos_rs = 0.0 if float((self.prp.pos - pos) @ d) > 0 else 1.0
        return d, cos_rs

    def is_in_fov(self, fov_p, fov_d, fov_cos):
        """reference src/objects.c:539-547."""
        if self.prp.envelope is not None:
            return self.prp.envelope.is_in_fov(fov_p, fov_d, fov_cos)
        if self._raw_ray_hit(fov_p, fov_d)[0] < INF:
            return True
        sin_a = min(float(self.prp.rax[2] @ fov_d), 1.0)
        return math.sqrt(1.0 - sin_a * sin_a) > fov_cos


class Sphere(Obj):
    """obj_sphere_s (reference src/objects.c:553-661)."""

    def __init__(self, radius=1.0):
        super().__init__()
        self.radius = float(radius)

    def scale(self, fac):
        super().scale(fac)
        self.radius *= float(fac)

    def _raw_ray_hit(self, p, d):
        a = sphere_ray_hit(self.prp.pos, self.radius, p, d)
        if a >= INF:
            return INF, None
        return a, normalize(p + d * a - self.prp.pos)

    def _raw_side(self, pos):
        diff = pos - self.prp.pos
        return 1 if float(diff @ diff) > self.radius ** 2 else -1

    def projection(self, pos):
        """Azimuth/elevation (reference src/objects.c:602-617)."""
        r = normalize(pos - self.prp.pos)
        x = float(r @ self.prp.rax[0])
        y = float(r @ np.cross(self.prp.rax[2], self.prp.rax[0]))
        z = min(max(float(r @ self.prp.rax[2]), -1.0), 1.0)
        return math.atan2(x, y), math.asin(z)

    def fov(self, pos):
        """Exact cone (reference src/objects.c:619-637)."""
        diff = self.prp.pos - pos
        d = normalize(diff)
        diff_sqr = float(diff @ diff)
        r2 = self.radius ** 2
        cos_rs = math.sqrt(1.0 - r2 / diff_sqr) if diff_sqr > r2 else -1.0
        return d, cos_rs

    def is_in_fov(self, fov_p, fov_d, fov_cos):
        return sphere_is_in_fov(self.prp.pos, self.radius, fov_p, fov_d, fov_cos)

    def is_reachable(self, ray_p, ray_d, length):
        return sphere_intersects_half_sphere(self.prp.pos, self.radius, ray_p, ray_d, length)


class Squaroid(Obj):
    """Quadric a x^2 + b y^2 + c z^2 + r = 0 in the object frame
    (obj_squaroid_s, reference src/objects.c:663-831)."""

    def __init__(self, a=1.0, b=1.0, c=1.0, r=-1.0):
        super().__init__()
        self.a, self.b, self.c, self.r = float(a), float(b), float(c), float(r)

    @staticmethod
    def ellipsoid(rx, ry, rz):
        return Squaroid(
            1.0 / rx ** 2 if rx != 0 else 1.0,
            1.0 / ry ** 2 if ry != 0 else 1.0,
            1.0 / rz ** 2 if rz != 0 else 1.0, -1.0)

    @staticmethod
    def hyperboloid1(rx, ry, rz):
        return Squaroid(
            1.0 / rx ** 2 if rx != 0 else 1.0,
            1.0 / ry ** 2 if ry != 0 else 1.0,
            -(1.0 / rz ** 2 if rz != 0 else 1.0), -1.0)

    @staticmethod
    def hyperboloid2(rx, ry, rz):
        return Squaroid(
            1.0 / rx ** 2 if rx != 0 else 1.0,
            1.0 / ry ** 2 if ry != 0 else 1.0,
            -(1.0 / rz ** 2 if rz != 0 else 1.0), 1.0)

    @staticmethod
    def cone(rx, ry, rz):
        return Squaroid(
            1.0 / rx ** 2 if rx != 0 else 1.0,
            1.0 / ry ** 2 if ry != 0 else 1.0,
            -(1.0 / rz ** 2 if rz != 0 else 1.0), 0.0)

    @staticmethod
    def cylinder(rx, ry):
        return Squaroid(
            1.0 / rx ** 2 if rx != 0 else 1.0,
            1.0 / ry ** 2 if ry != 0 else 1.0, 0.0, -1.0)

    def scale(self, fac):
        super().scale(fac)
        self.r *= float(fac) ** 2

    def _raw_ray_hit(self, p, d):
        """reference src/objects.c:778-821.  Deviation: the degenerate linear
        case (f == 0) solves t = -fq / (2 fs), the mathematically correct
        root (the reference swaps fs/fq there, src/objects.c:802)."""
        rax = self.prp.rax
        pl = rax @ (p - self.prp.pos)
        dl = rax @ d
        a_, b_, c_ = self.a, self.b, self.c
        f = a_ * dl[0] ** 2 + b_ * dl[1] ** 2 + c_ * dl[2] ** 2
        fs = a_ * dl[0] * pl[0] + b_ * dl[1] * pl[1] + c_ * dl[2] * pl[2]
        fq = a_ * pl[0] ** 2 + b_ * pl[1] ** 2 + c_ * pl[2] ** 2 + self.r
        if f != 0:
            f_inv = 1.0 / f
            s = fs * f_inv
            q = fq * f_inv
            r = s * s - q
            if r < 0:
                return INF, None
            r = math.sqrt(r)
            a = -s - r
            if a < 0:
                a = -s + r
            if a < 0:
                return INF, None
        else:
            a = -fq / (2 * fs) if fs != 0 else INF
            if a < 0 or a == INF:
                return INF, None
        x = pl + a * dl
        n1 = np.array([x[0] * a_, x[1] * b_, x[2] * c_])
        nor = normalize(rax.T @ n1)
        return a - EPS, nor

    def _raw_side(self, pos):
        p = self.prp.rax @ (pos - self.prp.pos)
        val = self.a * p[0] ** 2 + self.b * p[1] ** 2 + self.c * p[2] ** 2 + self.r
        return 1 if val > 0 else -1


# ---------------------------------------------------------------------------
# SDF objects (reference src/distance.c, src/objects.c:833-970)


class DistanceSphere:
    """Unit sphere SDF (distance_sphere_s, reference src/distance.c:23-56)."""

    def __call__(self, pos):
        return math.sqrt(float(pos @ pos)) - 1.0

    def clone(self):
        return DistanceSphere()


class DistanceTorus:
    """Torus SDF: major radius 1 in the xy-plane, minor radius ex_radius
    (distance_torus_s, reference src/distance.c:60-106)."""

    def __init__(self, ex_radius=0.5):
        self.ex_radius = float(ex_radius)

    def __call__(self, pos):
        x, y = float(pos[0]), float(pos[1])
        f = math.hypot(x, y)
        f_inv = 1.0 / f if f > 0 else 1.0
        xu, yu = x * f_inv, y * f_inv
        return math.sqrt((xu - x) ** 2 + (yu - y) ** 2 + float(pos[2]) ** 2) - self.ex_radius

    def clone(self):
        return DistanceTorus(self.ex_radius)


class DistanceObj(Obj):
    """Sphere-marched SDF object (obj_distance_s, reference
    src/objects.c:833-970)."""

    def __init__(self, distance=None, cycles=200):
        super().__init__()
        self.distance = distance
        self.inv_scale = 1.0
        self.cycles = int(cycles)

    def scale(self, fac):
        super().scale(fac)
        self.inv_scale *= 1.0 / float(fac)

    def projection(self, pos):
        return 0.0, 0.0

    def _raw_ray_hit(self, p, d):
        """reference src/objects.c:903-959 (bidirectional sphere march with
        envelope-clipped entry)."""
        offs0 = 0.0
        p = np.asarray(p, np.float64)
        env = self.prp.envelope
        if env is not None and env.side(p) == 1:
            offs0 = env.ray_hit(p, d)
            if offs0 >= INF:
                return INF, None
            p = p + d * offs0
        rax = self.prp.rax
        pl = (rax @ (p - self.prp.pos)) * self.inv_scale
        dl = rax @ d

        D = self.distance
        offs1 = 0.0
        dist = D(pl)
        if dist > 0:
            for _ in range(self.cycles):
                offs1 += dist + EPS
                dist = D(pl + dl * offs1)
                if dist < 0 or dist > MAG:
                    break
        else:
            for _ in range(self.cycles):
                offs1 -= dist - EPS
                dist = D(pl + dl * offs1)
                if dist > 0 or dist < -MAG:
                    break

        if abs(dist) <= EPS:
            q = pl + dl * offs1
            d0 = D(q)
            n = np.array([
                (D(q + v3(EPS, 0, 0)) - d0) / EPS,
                (D(q + v3(0, EPS, 0)) - d0) / EPS,
                (D(q + v3(0, 0, EPS)) - d0) / EPS,
            ])
            nor = normalize(rax.T @ n)
            return offs0 + (offs1 / self.inv_scale) - EPS, nor
        return INF, None

    def _raw_side(self, pos):
        p = (self.prp.rax @ (pos - self.prp.pos)) * self.inv_scale
        return 1 if self.distance(p) > 0 else -1

    def is_in_fov(self, fov_p, fov_d, fov_cos):
        if self.prp.envelope is not None:
            return self.prp.envelope.is_in_fov(fov_p, fov_d, fov_cos)
        return True


def make_torus(radius1, radius2):
    """create_torus builtin composition (reference src/closures.c:568-593)."""
    o = DistanceObj(DistanceTorus(radius2 / radius1))
    o.scale(radius1)
    env = Envelope(v3(), (radius1 + radius2) * 1.01)
    o.prp.envelope = env
    return o


# ---------------------------------------------------------------------------
# CSG combinators


class PairInside(Obj):
    """CSG intersection by mutual-inside validity (obj_pair_inside_s,
    reference src/objects.c:972-1120).  Properties copy from the first child."""

    def __init__(self, o1: Obj, o2: Obj):
        super().__init__()
        self.prp.copy_from(o1.prp)
        self.o1 = o1.clone()
        self.o2 = o2.clone()

    def children(self):
        return [self.o1, self.o2]

    def move(self, vec):
        self.prp.move(np.asarray(vec, np.float64))
        self.o1.move(vec)
        self.o2.move(vec)

    def rotate(self, mat):
        self.prp.rotate(np.asarray(mat, np.float64))
        self.o1.rotate(mat)
        self.o2.rotate(mat)

    def scale(self, fac):
        self.prp.scale(float(fac))
        self.o1.scale(fac)
        self.o2.scale(fac)

    _want = -1  # side the *other* child must report for a hit to be valid

    def _raw_ray_hit(self, p, d):
        """Alternating march (reference src/objects.c:1052-1094)."""
        want = self._want
        a1, n1 = self.o1.ray_hit(p, d)
        a2, n2 = self.o2.ray_hit(p, d)
        if a1 < a2 and self.o2.side(p + d * a1) == want:
            return a1, n1
        if a2 >= INF:
            return INF, None
        if self.o1.side(p + d * a2) == want:
            return a2, n2
        offs = a2
        pl = p + d * offs
        obj1, obj2 = self.o1, self.o2
        while offs < INF:
            a, n = obj1.ray_hit(pl, d)
            if a >= INF:
                return INF, None
            if obj2.side(pl + d * a) == want:
                return offs + a, n
            offs += a + 2 * EPS
            pl = p + d * offs
            obj1, obj2 = obj2, obj1
        return INF, None

    def _raw_side(self, pos):
        """reference src/objects.c:1096-1099."""
        return -1 if self.o1.side(pos) + self.o2.side(pos) == -2 else 1

    def fov(self, pos):
        if self.prp.envelope is not None:
            return self.prp.envelope.fov(pos)
        return normalize(self.prp.pos - pos), 0.0

    def is_in_fov(self, fov_p, fov_d, fov_cos):
        return self.o1.is_in_fov(fov_p, fov_d, fov_cos) or self.o2.is_in_fov(fov_p, fov_d, fov_cos)


class PairOutside(PairInside):
    """CSG union by mutual-outside validity (obj_pair_outside_s, reference
    src/objects.c:1122-1277).  Inherited envelope is discarded (the union is
    bigger than either part, src/objects.c:1169-1174)."""

    _want = 1

    def __init__(self, o1: Obj, o2: Obj):
        super().__init__(o1, o2)
        self.prp.envelope = None

    def _raw_side(self, pos):
        """reference src/objects.c:1253-1256."""
        return 1 if self.o1.side(pos) + self.o2.side(pos) == 2 else -1


class Neg(Obj):
    """Complement: flips side and normal (obj_neg_s, reference
    src/objects.c:1279-1348)."""

    def __init__(self, o1: Obj):
        super().__init__()
        self.prp.copy_from(o1.prp)
        self.o1 = o1.clone()

    def children(self):
        return [self.o1]

    def move(self, vec):
        self.prp.move(np.asarray(vec, np.float64))
        self.o1.move(vec)

    def rotate(self, mat):
        self.prp.rotate(np.asarray(mat, np.float64))
        self.o1.rotate(mat)

    def scale(self, fac):
        self.prp.scale(float(fac))
        self.o1.scale(fac)

    def _raw_ray_hit(self, p, d):
        a, n = self.o1.ray_hit(p, d)
        if a < INF:
            return a, -n
        return INF, None

    def _raw_side(self, pos):
        return -self.o1.side(pos)

    def is_in_fov(self, fov_p, fov_d, fov_cos):
        if self.prp.envelope is not None:
            return self.prp.envelope.is_in_fov(fov_p, fov_d, fov_cos)
        return self.o1.is_in_fov(fov_p, fov_d, fov_cos)


class ScaleWrap(Obj):
    """Anisotropic scaling wrapper: traces in the scaled frame and maps the
    hit back (obj_scale_s, reference src/objects.c:1350-1459)."""

    def __init__(self, o1: Obj, scale_vec):
        super().__init__()
        self.prp.copy_from(o1.prp)
        self.prp.pos = v3()
        self.prp.rax = np.eye(3)
        sv = np.asarray(scale_vec, np.float64)
        if self.prp.envelope is not None:
            self.prp.envelope.pos = self.prp.envelope.pos * sv
            self.prp.envelope.radius *= float(np.max(sv))
        self.o1 = o1.clone()
        self.inv_scale = np.where(sv != 0, 1.0 / np.where(sv != 0, sv, 1.0), 1.0)

    def children(self):
        return [self.o1]

    def move(self, vec):
        self.prp.move(np.asarray(vec, np.float64))

    def rotate(self, mat):
        self.prp.rotate(np.asarray(mat, np.float64))

    def scale(self, fac):
        self.prp.scale(float(fac))
        self.inv_scale = self.inv_scale * (1.0 / fac if fac != 0 else 1.0)

    def _raw_ray_hit(self, p, d):
        """reference src/objects.c:1418-1437."""
        rax = self.prp.rax
        pl = (rax @ (p - self.prp.pos)) * self.inv_scale
        dl = (rax @ d) * self.inv_scale
        d_len = math.sqrt(float(dl @ dl))
        d_fac = 1.0 / d_len if d_len > 0 else 0.0
        dl = dl * d_fac
        a1, n1 = self.o1.ray_hit(pl, dl)
        if a1 is not None and a1 < INF:
            a1 = a1 + EPS
            n1 = n1 * self.inv_scale
            nor = normalize(rax.T @ n1)
            return a1 * d_fac - EPS, nor
        return INF, None

    def _raw_side(self, pos):
        p = self.prp.rax @ (pos - self.prp.pos)
        return self.o1.side(p * self.inv_scale)


# ---------------------------------------------------------------------------
# batched (numpy) hit/side — vectorized counterparts of the scalar oracle
# methods above.  Used by the Monte-Carlo envelope estimator (thousands of
# rays per object) and as the intermediate reference for the device kernels.


def _sphere_ray_hit_b(pos, r, p, d):
    """Batched sphere_ray_hit (reference src/gmath.h:64-85). p,d: [N,3]."""
    pp = p - pos
    s = (pp * d).sum(-1)
    q = (pp * pp).sum(-1) - r * r
    s2 = s * s
    disc = s2 - q
    root = np.sqrt(np.maximum(disc, 0.0))
    entry = (s < 0) & (q > 0)
    exit_ = ((s < 0) | (q < 0))
    a = np.where(entry, -s - root - EPS,
                 np.where(exit_, -s + root - EPS, INF))
    return np.where(disc >= 0, a, INF)


def _env_ray_hits_b(env: Optional[Envelope], p, d):
    if env is None:
        return np.ones(len(p), bool)
    return _sphere_ray_hit_b(env.pos, env.radius, p, d) < INF


def _env_outside_b(env: Optional[Envelope], pos):
    if env is None:
        return np.zeros(len(pos), bool)
    diff = pos - env.pos
    return (diff * diff).sum(-1) > env.radius ** 2


def _obj_ray_hit_b(obj: "Obj", p, d):
    """obj_ray_hit dispatch with envelope early-out, batched."""
    n = len(p)
    mask = _env_ray_hits_b(obj.prp.envelope, p, d)
    a = np.full(n, INF)
    nor = np.zeros((n, 3))
    if mask.any():
        ai, ni = obj._raw_ray_hit_b(p[mask], d[mask])
        a[mask] = ai
        nor[mask] = ni
    return a, nor


def _obj_side_b(obj: "Obj", pos):
    out = np.ones(len(pos), np.int64)
    inside_env = ~_env_outside_b(obj.prp.envelope, pos)
    if inside_env.any():
        out[inside_env] = obj._raw_side_b(pos[inside_env])
    return out


def _raw_ray_hit_b_default(self, p, d):
    """Fallback: loop the scalar oracle (only for classes without a
    vectorized override)."""
    n = len(p)
    a = np.full(n, INF)
    nor = np.zeros((n, 3))
    for i in range(n):
        ai, ni = self._raw_ray_hit(p[i], d[i])
        a[i] = ai
        if ni is not None:
            nor[i] = ni
    return a, nor


def _raw_side_b_default(self, pos):
    return np.array([self._raw_side(q) for q in pos], np.int64)


Obj._raw_ray_hit_b = _raw_ray_hit_b_default
Obj._raw_side_b = _raw_side_b_default
Obj.ray_hit_b = _obj_ray_hit_b
Obj.side_b = _obj_side_b


def _plane_raw_ray_hit_b(self, p, d):
    nor = self.prp.rax[2]
    div = d @ nor
    offs = ((self.prp.pos - p) @ nor) / np.where(div != 0, div, 1.0)
    a = np.where((div != 0) & (offs > 0), offs - EPS, INF)
    return a, np.broadcast_to(nor, p.shape).copy()


def _plane_raw_side_b(self, pos):
    return np.where((pos - self.prp.pos) @ self.prp.rax[2] > 0, 1, -1)


Plane._raw_ray_hit_b = _plane_raw_ray_hit_b
Plane._raw_side_b = _plane_raw_side_b


def _sphere_raw_ray_hit_b(self, p, d):
    a = _sphere_ray_hit_b(self.prp.pos, self.radius, p, d)
    a_safe = np.where(np.isfinite(a), a, 0.0)
    nor = p + d * a_safe[:, None] - self.prp.pos
    ln = np.sqrt((nor * nor).sum(-1, keepdims=True))
    nor = nor / np.where(ln > 0, ln, 1.0)
    return a, np.where(np.isfinite(a[:, None]), nor, 0.0)


def _sphere_raw_side_b(self, pos):
    diff = pos - self.prp.pos
    return np.where((diff * diff).sum(-1) > self.radius ** 2, 1, -1)


Sphere._raw_ray_hit_b = _sphere_raw_ray_hit_b
Sphere._raw_side_b = _sphere_raw_side_b


def _squaroid_raw_ray_hit_b(self, p, d):
    rax = self.prp.rax
    pl = (p - self.prp.pos) @ rax.T
    dl = d @ rax.T
    coef = np.array([self.a, self.b, self.c])
    f = (coef * dl * dl).sum(-1)
    fs = (coef * dl * pl).sum(-1)
    fq = (coef * pl * pl).sum(-1) + self.r
    safe_f = np.where(f != 0, f, 1.0)
    s = fs / safe_f
    q = fq / safe_f
    disc = s * s - q
    root = np.sqrt(np.maximum(disc, 0.0))
    a_quad = np.where(-s - root >= 0, -s - root,
                      np.where(-s + root >= 0, -s + root, INF))
    a_quad = np.where(disc >= 0, a_quad, INF)
    safe_fs = np.where(fs != 0, fs, 1.0)
    a_lin = np.where(fs != 0, -fq / (2 * safe_fs), INF)
    a_lin = np.where(a_lin >= 0, a_lin, INF)
    a = np.where(f != 0, a_quad, a_lin)
    a_safe = np.where(np.isfinite(a), a, 0.0)[:, None]
    n1 = np.where(np.isfinite(a[:, None]), (pl + a_safe * dl) * coef, 0.0)
    nw = n1 @ rax
    ln = np.sqrt((nw * nw).sum(-1, keepdims=True))
    nor = nw / np.where(ln > 0, ln, 1.0)
    return np.where(a < INF, a - EPS, INF), nor


def _squaroid_raw_side_b(self, pos):
    pl = (pos - self.prp.pos) @ self.prp.rax.T
    coef = np.array([self.a, self.b, self.c])
    val = (coef * pl * pl).sum(-1) + self.r
    return np.where(val > 0, 1, -1)


Squaroid._raw_ray_hit_b = _squaroid_raw_ray_hit_b
Squaroid._raw_side_b = _squaroid_raw_side_b


def _distance_batch_eval(dist, pos):
    """Vectorized SDF evaluation for the known SDF types; pos [N,3]."""
    if isinstance(dist, DistanceSphere):
        return np.sqrt((pos * pos).sum(-1)) - 1.0
    if isinstance(dist, DistanceTorus):
        x, y = pos[:, 0], pos[:, 1]
        f = np.sqrt(x * x + y * y)
        f_inv = np.where(f > 0, 1.0 / np.where(f > 0, f, 1.0), 1.0)
        xu, yu = x * f_inv, y * f_inv
        return np.sqrt((xu - x) ** 2 + (yu - y) ** 2 + pos[:, 2] ** 2) \
            - dist.ex_radius
    return np.array([dist(q) for q in pos])


def _distance_raw_ray_hit_b(self, p, d):
    """Batched bidirectional sphere march (reference src/objects.c:903-959)."""
    n = len(p)
    offs0 = np.zeros(n)
    env = self.prp.envelope
    p = p.copy()
    if env is not None:
        outside = _env_outside_b(env, p)
        if outside.any():
            a_env = _sphere_ray_hit_b(env.pos, env.radius, p[outside],
                                      d[outside])
            offs0[outside] = a_env
            dead = np.zeros(n, bool)
            dead[outside] = ~np.isfinite(a_env)
            offs0[~np.isfinite(offs0)] = 0.0
            p[outside] += d[outside] * np.where(
                np.isfinite(a_env), a_env, 0.0)[:, None]
        else:
            dead = np.zeros(n, bool)
    else:
        dead = np.zeros(n, bool)

    rax = self.prp.rax
    pl = ((p - self.prp.pos) @ rax.T) * self.inv_scale
    dl = d @ rax.T

    D = self.distance
    offs1 = np.zeros(n)
    dist = _distance_batch_eval(D, pl)
    forward = dist > 0
    active = ~dead
    for _ in range(self.cycles):
        if not active.any():
            break
        offs1 = np.where(active, offs1 + np.where(forward, dist + EPS,
                                                  -(dist - EPS)), offs1)
        dist_new = _distance_batch_eval(D, pl + dl * offs1[:, None])
        dist = np.where(active, dist_new, dist)
        crossed = np.where(forward, (dist < 0) | (dist > MAG),
                           (dist > 0) | (dist < -MAG))
        active = active & ~crossed
    hit = (~dead) & (np.abs(dist) <= EPS)

    a = np.full(n, INF)
    nor = np.zeros((n, 3))
    if hit.any():
        q = pl[hit] + dl[hit] * offs1[hit, None]
        d0 = _distance_batch_eval(D, q)
        grad = np.stack([
            (_distance_batch_eval(D, q + np.array([EPS, 0, 0])) - d0) / EPS,
            (_distance_batch_eval(D, q + np.array([0, EPS, 0])) - d0) / EPS,
            (_distance_batch_eval(D, q + np.array([0, 0, EPS])) - d0) / EPS,
        ], axis=-1)
        nw = grad @ rax
        ln = np.sqrt((nw * nw).sum(-1, keepdims=True))
        nor[hit] = nw / np.where(ln > 0, ln, 1.0)
        a[hit] = offs0[hit] + offs1[hit] / self.inv_scale - EPS
    return a, nor


def _distance_raw_side_b(self, pos):
    pl = ((pos - self.prp.pos) @ self.prp.rax.T) * self.inv_scale
    return np.where(_distance_batch_eval(self.distance, pl) > 0, 1, -1)


DistanceObj._raw_ray_hit_b = _distance_raw_ray_hit_b
DistanceObj._raw_side_b = _distance_raw_side_b


def _pair_raw_ray_hit_b(self, p, d, max_iters=64):
    """Batched alternating CSG march (reference src/objects.c:1052-1094)."""
    want = self._want
    n = len(p)
    a1, n1 = self.o1.ray_hit_b(p, d)
    a2, n2 = self.o2.ray_hit_b(p, d)

    a = np.full(n, INF)
    nor = np.zeros((n, 3))

    # case 1: nearest is o1's hit and it is valid w.r.t. o2
    c1 = (a1 < a2) & (self.o2.side_b(p + d * np.where(np.isfinite(a1), a1,
                                                      0.0)[:, None]) == want)
    c1 &= np.isfinite(a1)
    a[c1] = a1[c1]
    nor[c1] = n1[c1]
    # case 2: o2 missed entirely -> INF
    done = c1 | ~np.isfinite(a2)
    # case 3: o2's hit is valid w.r.t. o1
    c3 = ~done & (self.o1.side_b(p + d * np.where(np.isfinite(a2), a2,
                                                  0.0)[:, None]) == want)
    a[c3] = a2[c3]
    nor[c3] = n2[c3]
    done |= c3

    # marching loop from offs = a2, starting with o1
    active = ~done
    offs = np.where(active, a2, 0.0)
    use1 = np.ones(n, bool)
    for _ in range(max_iters):
        if not active.any():
            break
        pl = p + d * offs[:, None]
        ha1, hn1 = self.o1.ray_hit_b(pl[active], d[active])
        ha2, hn2 = self.o2.ray_hit_b(pl[active], d[active])
        u = use1[active]
        ha = np.where(u, ha1, ha2)
        hn = np.where(u[:, None], hn1, hn2)
        # dead: current child missed
        miss = ~np.isfinite(ha)
        # side test of the *other* child at the new hit
        hp = pl[active] + d[active] * np.where(np.isfinite(ha), ha,
                                               0.0)[:, None]
        so1 = self.o1.side_b(hp)
        so2 = self.o2.side_b(hp)
        sother = np.where(u, so2, so1)
        valid = ~miss & (sother == want)

        idx = np.flatnonzero(active)
        vidx = idx[valid]
        a[vidx] = offs[vidx] + ha[valid]
        nor[vidx] = hn[valid]
        midx = idx[miss]
        cont = ~miss & ~valid
        cidx = idx[cont]
        offs[cidx] += ha[cont] + 2 * EPS
        use1[cidx] = ~use1[cidx]
        active[vidx] = False
        active[midx] = False
    return a, nor


def _pair_inside_raw_side_b(self, pos):
    return np.where(self.o1.side_b(pos) + self.o2.side_b(pos) == -2, -1, 1)


def _pair_outside_raw_side_b(self, pos):
    return np.where(self.o1.side_b(pos) + self.o2.side_b(pos) == 2, 1, -1)


PairInside._raw_ray_hit_b = _pair_raw_ray_hit_b
PairInside._raw_side_b = _pair_inside_raw_side_b
PairOutside._raw_side_b = _pair_outside_raw_side_b


def _neg_raw_ray_hit_b(self, p, d):
    a, nr = self.o1.ray_hit_b(p, d)
    return a, -nr


def _neg_raw_side_b(self, pos):
    return -self.o1.side_b(pos)


Neg._raw_ray_hit_b = _neg_raw_ray_hit_b
Neg._raw_side_b = _neg_raw_side_b


def _scale_raw_ray_hit_b(self, p, d):
    rax = self.prp.rax
    pl = ((p - self.prp.pos) @ rax.T) * self.inv_scale
    dl = (d @ rax.T) * self.inv_scale
    d_len = np.sqrt((dl * dl).sum(-1))
    d_fac = np.where(d_len > 0, 1.0 / np.where(d_len > 0, d_len, 1.0), 0.0)
    dl = dl * d_fac[:, None]
    a1, nr = self.o1.ray_hit_b(pl, dl)
    hit = np.isfinite(a1)
    nw = (nr * self.inv_scale) @ rax
    ln = np.sqrt((nw * nw).sum(-1, keepdims=True))
    nor = np.where(hit[:, None], nw / np.where(ln > 0, ln, 1.0), 0.0)
    a = np.where(hit, (a1 + EPS) * d_fac - EPS, INF)
    return a, nor


def _scale_raw_side_b(self, pos):
    pl = ((pos - self.prp.pos) @ self.prp.rax.T) * self.inv_scale
    return self.o1.side_b(pl)


ScaleWrap._raw_ray_hit_b = _scale_raw_ray_hit_b
ScaleWrap._raw_side_b = _scale_raw_side_b


def ray_exit_b(obj: Obj, p, d, max_iters=32):
    """Batched obj_ray_exit (reference src/objects.c:286-310)."""
    n = len(p)
    a, nor = obj.ray_hit_b(p, d)
    total = np.zeros(n)
    last_nor = nor.copy()
    active = np.isfinite(a)
    ever_hit = active.copy()
    pl = p.copy()
    for _ in range(max_iters):
        if not active.any():
            break
        step = a + EPS * 2
        total = np.where(active, total + step, total)
        pl = np.where(active[:, None], pl + d * step[:, None], pl)
        a_new, nor_new = obj.ray_hit_b(pl[active], d[active])
        idx = np.flatnonzero(active)
        hit_again = np.isfinite(a_new)
        last_nor[idx[hit_again]] = nor_new[hit_again]
        a = np.full(n, INF)
        a[idx[hit_again]] = a_new[hit_again]
        active = np.isfinite(a)
    leaving = (last_nor * d).sum(-1) > 0
    return np.where(ever_hit & leaving, total, INF)


# ---------------------------------------------------------------------------
# auto-envelope estimation


def estimate_envelope(obj: Obj, samples=1000, rseed=123, radius_factor=1.1) -> Envelope:
    """Monte-Carlo bounding sphere (obj_estimate_envelope, reference
    src/objects.c:312-363), restructured into two vectorizable phases:
    (1) cast rays from prp.pos, collect exit points; (2) re-center at their
    centroid and take radius = max distance x factor.  The reference instead
    updates the start point per sample (a running centroid); the two produce
    equivalent enclosing spheres.  Known primitives short-circuit to exact
    envelopes."""
    from actinon_tpu_torch.rng import HostLcg

    if isinstance(obj, Sphere):
        return Envelope(obj.prp.pos, obj.radius * radius_factor)

    lcg = HostLcg(rseed)
    dirs = np.stack([lcg.sphere_belt(1.0) for _ in range(samples)])
    p0 = np.broadcast_to(obj.prp.pos, dirs.shape)
    a = ray_exit_b(obj, np.ascontiguousarray(p0), dirs)
    hit = np.isfinite(a)
    if not hit.any():
        return Envelope(obj.prp.pos, MAG)
    pts = p0[hit] + dirs[hit] * a[hit, None]
    center = pts.mean(axis=0)
    # second phase: re-cast from the centroid for a better-centered bound
    dirs2 = np.stack([lcg.sphere_belt(1.0) for _ in range(samples)])
    starts = center + (np.random.default_rng(rseed).uniform(
        -1, 1, dirs2.shape) * EPS)
    a2 = ray_exit_b(obj, starts, dirs2)
    hit2 = np.isfinite(a2)
    if hit2.any():
        pts = np.concatenate([pts, starts[hit2] + dirs2[hit2] * a2[hit2, None]])
    radius = float(np.sqrt(((pts - center) ** 2).sum(axis=1).max())) * radius_factor
    return Envelope(center, radius)


# ---------------------------------------------------------------------------
# containers (reference src/compound.c, src/container.c)


class Compound:
    """Render-time flat object list with optional envelope (compound_s,
    reference src/compound.c:36-299).  Push flattens maps/arrays and
    unenveloped compounds and maintains a merged envelope."""

    def __init__(self):
        self.envelope: Optional[Envelope] = None
        self.elements: List = []  # Obj or Compound

    def clone(self):
        return copy.deepcopy(self)

    def size(self):
        return len(self.elements)

    def set_envelope(self, env: Envelope):
        self.envelope = env.clone()

    def set_auto_envelope(self):
        """reference src/compound.c:73-107."""
        self.envelope = None
        for el in self.elements:
            if isinstance(el, Compound):
                if el.envelope is None:
                    el.set_auto_envelope()
                env = el.envelope
            else:
                if el.prp.envelope is None:
                    el.set_auto_envelope()
                env = el.prp.envelope
            self.envelope = env.clone() if self.envelope is None \
                else envelope_of_pair(self.envelope, env)

    def push(self, obj):
        """compound_s_push_q semantics (reference src/compound.c:140-207)."""
        if isinstance(obj, Obj):
            el = obj.clone()
            self.elements.append(el)
            if self.envelope is not None:
                if el.prp.envelope is not None:
                    self.envelope = envelope_of_pair(self.envelope, el.prp.envelope)
                else:
                    self.envelope = None
            elif len(self.elements) == 1:
                self.envelope = el.prp.envelope.clone() if el.prp.envelope else None
        elif isinstance(obj, Compound):
            if obj.envelope is not None:
                self.elements.append(obj.clone())
            else:
                for el in obj.elements:
                    self.push(el)
        elif isinstance(obj, MapS):
            for v in obj.data.values():
                self.push(v)
        elif isinstance(obj, ArrS):
            for v in obj.data:
                self.push(v)
        else:
            raise TypeError(f"Cannot push {type(obj).__name__} to compound")

    def move(self, vec):
        if self.envelope:
            self.envelope.move(vec)
        for el in self.elements:
            el.move(vec)

    def rotate(self, mat):
        if self.envelope:
            self.envelope.rotate(mat)
        for el in self.elements:
            el.rotate(mat)

    def scale(self, fac):
        if self.envelope:
            self.envelope.scale(fac)
        for el in self.elements:
            el.scale(fac)

    def leaf_objects(self):
        """All Obj elements, recursing through nested compounds (the flat
        element list the device tracer sees)."""
        out = []
        for el in self.elements:
            if isinstance(el, Compound):
                out.extend(el.leaf_objects())
            else:
                out.append(el)
        return out

    def ray_hit(self, p, d):
        """Linear scan with envelope early-out (compound_s_ray_hit, reference
        src/compound.c:215-244).  Returns (offs, normal, hit_obj)."""
        if self.envelope is not None and not self.envelope.ray_hits(p, d):
            return INF, None, None
        best = (INF, None, None)
        for el in self.elements:
            if isinstance(el, Compound):
                a, n, h = el.ray_hit(p, d)
            else:
                a, n = el.ray_hit(p, d)
                h = el
            if a < best[0]:
                best = (a, n, h)
        return best


class ArrS:
    """Script-level dynamic array (arr_s, reference src/container.c:236-518)."""

    def __init__(self, data=None):
        self.data = list(data) if data else []

    def clone(self):
        return ArrS([_clone_value(v) for v in self.data])

    def push(self, v):
        self.data.append(_clone_value(v))

    def cat(self, other: "ArrS"):
        for v in other.data:
            self.push(v)

    def move(self, vec):
        for v in self.data:
            _transform_value(v, "move", vec)

    def rotate(self, mat):
        for v in self.data:
            _transform_value(v, "rotate", mat)

    def scale(self, fac):
        for v in self.data:
            _transform_value(v, "scale", fac)

    def create_inside_composite(self, start=0, size=None):
        """Balanced binary tree of PairInside (reference
        src/container.c:376-392)."""
        size = len(self.data) if size is None else size
        if size == 1:
            return self.data[start]
        half = size >> 1
        return PairInside(self.create_inside_composite(start, half),
                          self.create_inside_composite(start + half, size - half))

    def create_outside_composite(self, start=0, size=None):
        size = len(self.data) if size is None else size
        if size == 1:
            return self.data[start]
        half = size >> 1
        return PairOutside(self.create_outside_composite(start, half),
                           self.create_outside_composite(start + half, size - half))

    def create_compound(self):
        """reference src/container.c:412-421."""
        c = Compound()
        for v in self.data:
            c.push(v)
        return c


class MapS:
    """Script-level hashmap, also the module system (map_s, reference
    src/container.c:39-231)."""

    def __init__(self):
        self.data = {}

    def clone(self):
        m = MapS()
        m.data = {k: _clone_value(v) for k, v in self.data.items()}
        return m

    def move(self, vec):
        for v in self.data.values():
            _transform_value(v, "move", vec)

    def rotate(self, mat):
        for v in self.data.values():
            _transform_value(v, "rotate", mat)

    def scale(self, fac):
        for v in self.data.values():
            _transform_value(v, "scale", fac)


def _clone_value(v):
    if isinstance(v, (Obj, Compound, ArrS, MapS)):
        return v.clone()
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def _transform_value(v, op, arg):
    """Recursive container transform dispatch (reference
    src/container.c:69-154, 289-374): containers and objects transform,
    everything else is left untouched."""
    if isinstance(v, (Obj, Compound, ArrS, MapS)):
        getattr(v, op)(arg)


# ---------------------------------------------------------------------------
# materials (reference src/objects.c:1582-1690)

MATERIALS = {
    "transparent":     dict(refractive_index=1.0, transparency=(1, 1, 1),
                            fresnel_reflectivity=1.0, chromatic_reflectivity=0.0,
                            diffuse_reflectivity=0.0),
    "glass":           dict(refractive_index=1.46, transparency=(0.8, 0.9, 0.9),
                            fresnel_reflectivity=1.0, chromatic_reflectivity=0.0,
                            diffuse_reflectivity=0.0),
    "water":           dict(refractive_index=1.32, transparency=(0.5, 0.9, 0.99),
                            fresnel_reflectivity=1.0, chromatic_reflectivity=0.0,
                            diffuse_reflectivity=0.0),
    "sapphire":        dict(refractive_index=1.76, transparency=(0.7, 0.7, 0.7),
                            fresnel_reflectivity=1.0, chromatic_reflectivity=0.0,
                            diffuse_reflectivity=0.0),
    "diamond":         dict(refractive_index=2.42, transparency=(0.8, 0.8, 0.8),
                            fresnel_reflectivity=1.0, chromatic_reflectivity=0.0,
                            diffuse_reflectivity=0.0),
    "diffuse":         dict(refractive_index=1.0, transparency=(0, 0, 0),
                            fresnel_reflectivity=0.0, chromatic_reflectivity=0.0,
                            diffuse_reflectivity=1.0, sigma=0.29),
    "diffuse_polished": dict(refractive_index=1.5, transparency=(0, 0, 0),
                             fresnel_reflectivity=1.0, chromatic_reflectivity=0.0,
                             diffuse_reflectivity=1.0, sigma=0.29),
    "perfect_mirror":  dict(refractive_index=1.0, transparency=(0, 0, 0),
                            color=(1, 1, 1), fresnel_reflectivity=0.0,
                            chromatic_reflectivity=1.0, diffuse_reflectivity=0.0),
    "mirror":          dict(refractive_index=1.0, transparency=(0, 0, 0),
                            color=(0.92, 0.94, 0.87), fresnel_reflectivity=0.0,
                            chromatic_reflectivity=1.0, diffuse_reflectivity=0.0),
    "gold":            dict(refractive_index=1.0, transparency=(0, 0, 0),
                            color=(0.83, 0.69, 0.22), fresnel_reflectivity=0.0,
                            chromatic_reflectivity=1.0, diffuse_reflectivity=0.0),
    "silver":          dict(refractive_index=1.0, transparency=(0, 0, 0),
                            color=(0.8, 0.8, 0.8), fresnel_reflectivity=0.0,
                            chromatic_reflectivity=1.0, diffuse_reflectivity=0.0),
}


def apply_material(obj: Obj, name: str):
    if name not in MATERIALS:
        raise KeyError(f"Unknown material specification '{name}'")
    m = MATERIALS[name]
    p = obj.prp
    p.refractive_index = m["refractive_index"]
    p.transparency = v3(*m["transparency"])
    p.fresnel_reflectivity = m["fresnel_reflectivity"]
    p.chromatic_reflectivity = m["chromatic_reflectivity"]
    p.diffuse_reflectivity = m["diffuse_reflectivity"]
    if "sigma" in m:
        p.sigma = m["sigma"]
    if "color" in m:
        p.color = v3(*m["color"])


# ---------------------------------------------------------------------------


class Scene:
    """Top-level scene: render config + light/matter compounds
    (scene_s, reference src/scene.c:153-331)."""

    def __init__(self, cfg=None):
        from actinon_tpu_torch.config import RenderConfig
        self.cfg = cfg if cfg is not None else RenderConfig()
        self.light = Compound()
        self.matter = Compound()

    def clone(self):
        return copy.deepcopy(self)

    def clear(self):
        self.light = Compound()
        self.matter = Compound()

    def object_count(self):
        return self.light.size() + self.matter.size()

    def push(self, obj):
        """Routing: radiance > 0 goes to the light compound
        (scene_s_push, reference src/scene.c:238-279)."""
        if isinstance(obj, Obj):
            if obj.prp.radiance > 0:
                self.light.push(obj)
            else:
                self.matter.push(obj)
        elif isinstance(obj, Compound):
            self.matter.push(obj)
        elif isinstance(obj, MapS):
            for v in obj.data.values():
                self.push(v)
        elif isinstance(obj, ArrS):
            for v in obj.data:
                self.push(v)
        else:
            raise TypeError(f"Cannot push {type(obj).__name__} to scene")
