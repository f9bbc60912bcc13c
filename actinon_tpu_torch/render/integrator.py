"""Wavefront light-transport integrator.

PyTorch counterpart of the JAX package's `render/integrator.py`.  The
reference integrator scene_s_lum (reference src/scene.c:420-667) is a
recursion; here it is flattened into a wavefront: rays are queue entries
carrying (p, d, intensity, tint_rgb, depth, sample_id), and one *step*
processes a batch — trace, classify, accumulate local contributions
(emitter / background / NEE direct light), emit child rays for the
specular branches and path samples.  Two drains, as in the JAX package:
the device drain (`run_device`) is a cascade of loops over trips whose
queue, child compaction and accumulator stay on the device, each stage's
loop on the card the replay of a CUDA graph whose WHILE node runs the
trips (render/graphs.py, render/cond.py) and the host reading one count a
stage (path configs run the mixed drain: path-spawn parents live in the
same queue and expand in place); the host drain (`run`, path configs or
`device_drain = False`) keeps a normal and a path queue of `RayQueue`s on
the host, copies each step's results back in one transfer and
accumulates in f64.  It is the mixed drain's oracle: the same RNG
counters and estimator factors.

All reference semantics are those of the JAX package: the depth budget
(specular and refraction cost 1, path costs 10 and is gated on depth >
10), intensity-scaled sample counts, the 2*cap_height/n and 2/n
estimators, the exit-transition override, Beer-Lambert absorption,
Oren-Nayar weighting, and position-seeded counter RNG streams.

On a CUDA device in f32 the NEE of a position-seeded render runs as the
hand-written NEE kernel (`render/kernels.py`) where the scene lies inside
its coverage; SDF scenes take the plain NEE, whose shadow and light-hit
queries go through the tracer's kernels (K5, K3).

The differentiable renderer (`render/diff.py`) sets `ovr`, a dict of
tensors keyed as `mat_params()`, whose values replace the material and
light tables (autograd reaches them), and `edge_aware`, which adds the
silhouette boundary term of the NEE visibility integral
(`_nee_edge_terms`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from actinon_tpu_torch import math3d as m3
from actinon_tpu_torch import rng as argn
from actinon_tpu_torch.render import cond, kernels, spans
from actinon_tpu_torch.render.tracer import (CHUNK, INF, Tracer, _dot,
                                             _dot_fma32, _norm3, _rows,
                                             _sphere_first_hit,
                                             as_table, safe_acos, safe_sqrt,
                                             same_ovr)
from actinon_tpu_torch.scene import ir as sir

F3_MAG = 1e30
# runaway-wavefront backstop: a pathological scene that keeps spawning
# children exits the drain loop here — run_device warns when it fires
DRAIN_TRIP_CAP = 100000
# path children emitted per parent lane per drain trip: a parent
# descriptor with ns samples re-enqueues itself ns/PATH_EXPAND times
PATH_EXPAND = 16

_MAT_NAMES = ["m_color", "m_radiance", "m_rix", "m_fresnel", "m_chromatic",
              "m_diffuse", "m_sigma", "m_transp", "m_pos", "m_tex1",
              "m_tex2", "l_pos", "l_rad", "l_radius", "l_color",
              "background"]


def _frame_apply(frame, vecs):
    """frame [..., 3, 3] applied to vecs [..., K, 3]:
    out[..., k, i] = sum_j frame[..., i, j] * vecs[..., k, j]."""
    f = frame[..., None, :, :]        # [..., 1, 3, 3]
    return torch.stack(
        [f[..., i, 0] * vecs[..., 0] + f[..., i, 1] * vecs[..., 1]
         + f[..., i, 2] * vecs[..., 2] for i in range(3)], dim=-1)


def _dotk(vecs, v):
    """vecs [..., K, 3] . v [..., 3] -> [..., K] (v broadcast over K)."""
    return (vecs * v[..., None, :]).sum(-1)


def _scatter_add(acc, idx, val):
    """acc[idx] += val with a fixed summation order.  On CUDA,
    `index_put_(accumulate=True)` sorts the indices and sums each run of
    duplicates serially (deterministic, unlike the float atomics of
    `index_add_`); on the CPU `index_add_` walks the indices in order."""
    if acc.device.type == "cuda":
        acc.index_put_((idx,), val, accumulate=True)
    else:
        acc.index_add_(0, idx, val)


def compact_rows(mask, room):
    """Stream compaction of the rows where `mask` [n] holds, in their
    order, by a cumsum scatter (the JAX drain body's; no host read): each
    kept row's slot is its rank among them, and every other row sends its
    index to a dump slot.  `room` (a 0-d tensor) is how many rows fit.
    Returns (src [n]: the row that fills each slot, 0 past the kept ones;
    live [n]: the slot holds a kept row that fits; nv kept rows; nv_fit
    = min(nv, room) of them that fit)."""
    n = mask.shape[0]
    rn = torch.arange(n, device=mask.device)
    slot = torch.cumsum(mask.to(torch.int64), 0) - 1
    nv = slot[-1] + 1
    nv_fit = torch.minimum(nv, room)
    src = torch.zeros((n + 1,), dtype=torch.int64, device=mask.device)
    src.scatter_(0, torch.where(mask, slot, n), rn)
    return src[:n], rn < nv_fit, nv, nv_fit


@dataclasses.dataclass
class RayQueue:
    """Host-side struct-of-arrays ray queue."""

    p: np.ndarray
    d: np.ndarray
    intensity: np.ndarray
    tint: np.ndarray
    depth: np.ndarray
    sample_id: np.ndarray

    @staticmethod
    def empty(dtype):
        return RayQueue(np.zeros((0, 3), dtype), np.zeros((0, 3), dtype),
                        np.zeros((0,), dtype), np.zeros((0, 3), dtype),
                        np.zeros((0,), np.int32), np.zeros((0,), np.int32))

    def __len__(self):
        return len(self.intensity)

    def append(self, other: "RayQueue"):
        for f in dataclasses.fields(self):
            k = f.name
            setattr(self, k, np.concatenate([getattr(self, k),
                                             getattr(other, k)]))

    def pop(self, n: int) -> "RayQueue":
        out = RayQueue(*[getattr(self, f.name)[:n]
                         for f in dataclasses.fields(self)])
        for f in dataclasses.fields(self):
            k = f.name
            setattr(self, k, getattr(self, k)[n:])
        return out

    def padded(self, n: int, dtype) -> "RayQueue":
        """Pad to length n with dead rays (intensity 0, depth 0)."""
        m = len(self)
        if m == n:
            return self
        pad = n - m
        return RayQueue(
            np.concatenate([self.p, np.zeros((pad, 3), dtype)]),
            np.concatenate([self.d, np.tile(np.array([[0, 0, 1]], dtype),
                                            (pad, 1))]),
            np.concatenate([self.intensity, np.zeros(pad, dtype)]),
            np.concatenate([self.tint, np.zeros((pad, 3), dtype)]),
            np.concatenate([self.depth, np.zeros(pad, np.int32)]),
            np.concatenate([self.sample_id, np.zeros(pad, np.int32)]))


class Integrator:
    def __init__(self, tracer: Tracer, batch: int = 1 << 14):
        self.tr = tracer
        self.ir = tracer.ir
        self.cfg = tracer.ir.cfg
        self.dtype = tracer.dtype
        self.tdtype = tracer.tdtype
        self.device = tracer.device
        self.batch = batch
        # "position": RNG streams from the hit position (reference
        # src/scene.c:537); "counter": from (sample_id, depth), frozen
        # randomness whose samples do not move with the scene
        self.seed_mode = "position"
        # False: run() and run_samples() take the host drain for every
        # config (path configs always do)
        self.device_drain = True
        # True (on a CUDA device): each stage of the device drain is the
        # replay of its CUDA graph, a WHILE node over its trips
        # (render/graphs.py); False runs the same trips eagerly
        self.drain_graphs = self.device.type == "cuda"
        self._graphs = None
        # the caller's record of spans and counters (render/spans.py)
        self.record = None
        # differentiable-path hooks (render/diff.py): `ovr` maps
        # mat_params keys to tensors that replace the tables (autograd
        # reaches them); `edge_aware` adds the NEE silhouette terms
        self.ovr = {}
        self.edge_aware = False
        self._ovr_mats = None
        self._kernel_cache = {}

        ir = self.ir
        dt = self.dtype
        g = lambda f: np.array([getattr(o, f) for o in ir.objects], dt)
        g3 = lambda f: np.stack([np.asarray(getattr(o, f), dt)
                                 for o in ir.objects])
        self.m_color = g3("color")
        self.m_radiance = g("radiance")
        self.m_rix = g("refractive_index")
        self.m_fresnel = g("fresnel")
        self.m_chromatic = g("chromatic")
        self.m_diffuse = g("diffuse")
        self.m_sigma = g("sigma")
        self.m_transp = g3("transparency")
        self.m_pos = g3("pos")
        self.m_texk = np.array([o.tex_kind for o in ir.objects], np.int32)
        self.m_tex1 = np.stack([
            np.asarray(o.tex_c1, dt) if o.tex_c1 is not None
            else np.zeros(3, dt) for o in ir.objects])
        self.m_tex2 = np.stack([
            np.asarray(o.tex_c2, dt) if o.tex_c2 is not None
            else np.zeros(3, dt) for o in ir.objects])
        self.m_texs = g("tex_scale")
        self.m_projk = np.array([o.proj_kind for o in ir.objects], np.int32)
        self.m_projp = np.stack([
            np.asarray(o.proj_pos, dt) if o.proj_pos is not None
            else np.zeros(3, dt) for o in ir.objects])
        self.m_projr = np.stack([
            np.asarray(o.proj_rax, dt) if o.proj_rax is not None
            else np.eye(3, dtype=dt) for o in ir.objects])

        # light tables [L]
        L = len(ir.lights)
        self.n_lights = L
        lo = [ir.objects[i] for i in ir.lights]
        self.l_pos = np.stack([np.asarray(o.pos, dt) for o in lo]) \
            if L else np.zeros((0, 3), dt)
        self.l_rad = np.array([o.radiance for o in lo], dt)
        self.l_radius = np.array([o.light_radius for o in lo], dt)
        # light color at its own center (obj_color(light, prp.pos),
        # reference src/scene.c:552)
        self.l_color = np.stack([
            np.asarray(o.tex_c1 if o.tex_kind == sir.TEX_PLAIN else o.color,
                       dt) for o in lo]) if L else np.zeros((0, 3), dt)
        # per-light fov cone kind (obj_fov, reference src/objects.c:520,
        # 619,1037) and whether the NEE intersection is the exact sphere
        # formula or a hit of the true object geometry (obj_ray_hit(
        # light_src), reference src/scene.c:564)
        self.l_fov = [o.light_fov for o in lo]
        self.l_plane_n = [None if o.light_plane_n is None
                          else np.asarray(o.light_plane_n, dt) for o in lo]
        self.l_cone_pos = np.stack([
            np.asarray(o.light_cone_pos if o.light_cone_pos is not None
                       else o.pos, dt) for o in lo]) \
            if L else np.zeros((0, 3), dt)
        self.l_sphere_exact = [
            o.single_leaf and o.leaves[0].family == sir.SPHERE for o in lo]
        self.l_oid = list(ir.lights)

        self.rays_traced = 0
        self.direct_cap = max(int(self.cfg.direct_samples), 1)
        # THE query accounting definition of the JAX package, shared with
        # its bench: one live non-parent lane costs 1 transition trace + 1
        # coincident-surface pass + n_lights*direct_cap NEE traversals
        self.per_lane_queries = 2 + len(ir.lights) * self.direct_cap
        self.path_cap = max(int(self.cfg.path_samples), 0)
        self.tmi = float(dt.type(self.cfg.trace_min_intensity))
        self.background = np.asarray(ir.background, dt)
        self.max_path_length = float(dt.type(self.cfg.max_path_length))
        self._generation = 0
        self._upload()

    # ------------------------------------------------------------------

    def _upload(self):
        """Material and light tables to the device (after construction
        and after set_mat)."""
        dev, dt = self.device, self.tdtype
        self._dev = {n: torch.as_tensor(np.asarray(getattr(self, n)),
                                        dtype=dt, device=dev)
                     for n in _MAT_NAMES}
        self._P = self._pack(self._dev)
        self._kernel_cache.clear()
        self._generation += 1     # drops the drain's graphs

    def _pack(self, t):
        """The packed [O, 36] material table from the tables `t`
        (torch.cat: autograd reaches the override tensors; the static
        columns are the tracer's cached device constants)."""
        O = len(self.ir.objects)
        f = lambda a: self.tr._const(a, self.tdtype)
        return torch.cat([
            t["m_color"],                              # 0:3
            t["m_radiance"][:, None],                  # 3
            t["m_rix"][:, None],                       # 4
            t["m_fresnel"][:, None],                   # 5
            t["m_chromatic"][:, None],                 # 6
            t["m_diffuse"][:, None],                   # 7
            t["m_sigma"][:, None],                     # 8
            t["m_transp"],                             # 9:12
            t["m_pos"],                                # 12:15
            t["m_tex1"],                               # 15:18
            t["m_tex2"],                               # 18:21
            f(self.m_texs)[:, None],                   # 21
            f(self.m_texk)[:, None],                   # 22
            f(self.m_projk)[:, None],                  # 23
            f(self.m_projp),                           # 24:27
            f(self.m_projr).reshape(O, 9),             # 27:36
        ], dim=1)

    def _mats(self):
        """(tables by name, packed table): the device tables, or under
        `ovr` the override tensors in their place, built once per `ovr`
        (the same dict holding the same tensors; the differentiable
        renderer drops them when its call ends)."""
        if not self.ovr:
            return self._dev, self._P
        if self._ovr_mats is None or not same_ovr(self._ovr_mats[0],
                                                  self.ovr):
            t = dict(self._dev)
            for k, v in self.ovr.items():
                if k not in _MAT_NAMES:
                    raise KeyError(k)
                t[k] = as_table(v, self.tdtype, self.device)
            self._ovr_mats = (dict(self.ovr), (t, self._pack(t)))
        return self._ovr_mats[1]

    def _mt(self, name):
        """Material or light table `name`, with its override from `ovr`."""
        return self._mats()[0][name]

    def mat_params(self):
        """The material and light tables as a dict of numpy arrays, with
        the keys of the JAX integrator's `mat_params`."""
        return {n: np.asarray(getattr(self, n)) for n in _MAT_NAMES
                if getattr(self, n) is not None
                and np.size(getattr(self, n)) > 0}

    def set_mat(self, params: Dict[str, np.ndarray]):
        """Take material and light tables (keys of mat_params) in place of
        the scene's own."""
        for k, v in params.items():
            if k not in _MAT_NAMES:
                raise KeyError(k)
            setattr(self, k, np.asarray(v, self.dtype))
        self._upload()

    def _as(self, x):
        return torch.as_tensor(x, dtype=self.tdtype, device=self.device)

    def _mat_lookup(self, oid_s):
        """ALL per-object material fields for a lane batch: one row read
        from the packed [O, 36] table (tracer._rows)."""
        Pw, = _rows(oid_s, self._mats()[1])
        return dict(
            color=Pw[:, 0:3], radiance=Pw[:, 3], rix=Pw[:, 4],
            fresnel=Pw[:, 5], chromatic=Pw[:, 6], diffuse=Pw[:, 7],
            sigma=Pw[:, 8], transp=Pw[:, 9:12], pos=Pw[:, 12:15],
            tex1=Pw[:, 15:18], tex2=Pw[:, 18:21], texs=Pw[:, 21],
            texk=torch.round(Pw[:, 22]).to(torch.int64),
            projk=torch.round(Pw[:, 23]).to(torch.int64),
            projp=Pw[:, 24:27],
            projr=Pw[:, 27:36].reshape(-1, 3, 3))

    def _albedo(self, oid, pos, mat=None):
        """obj_color with texture dispatch (reference
        src/objects.c:411-422, src/textures.c)."""
        if mat is None:
            mat = self._mat_lookup(torch.clamp(oid, min=0))
        base, texk = mat["color"], mat["texk"]
        tex1, tex2, texs = mat["tex1"], mat["tex2"], mat["texs"]
        projk, projp, projr = mat["projk"], mat["projp"], mat["projr"]

        # plane projection (reference src/objects.c:514-518)
        rel = pos - projp
        u_pl = _dot(rel, projr[:, 0, :])
        v_pl = _dot(rel, projr[:, 1, :])
        # sphere projection (azimuth/elevation, reference
        # src/objects.c:602-617)
        r = _norm3(rel)
        sx = _dot(r, projr[:, 0, :])
        sy = _dot(r, m3.cross(projr[:, 2, :], projr[:, 0, :]))
        sz = _dot(r, projr[:, 2, :])
        u_sp = torch.atan2(sx, sy)
        v_sp = safe_acos(sz) * (-1.0) + math.pi / 2

        u = torch.where(projk == sir.PROJ_SPHERE, u_sp, u_pl)
        v = torch.where(projk == sir.PROJ_SPHERE, v_sp, v_pl)
        xi = torch.round(u * texs).to(torch.int64)
        yi = torch.round(v * texs).to(torch.int64)
        chess = torch.where((((xi ^ yi) & 1) == 1)[:, None], tex1, tex2)

        out = torch.where((texk == sir.TEX_PLAIN)[:, None], tex1, base)
        out = torch.where((texk == sir.TEX_CHESS)[:, None], chess, out)
        return out

    def _fresnel_reflectance(self, d, exit_nor, trix):
        """fresnel_reflection (reference src/gmath.c:68-91).  exit_nor
        points along the ray (into the surface)."""
        c = _dot(d, exit_nor)
        f = torch.where(c < 0, trix,
                        1.0 / torch.where(trix != 0, trix, 1.0))
        cos_ai = torch.clamp(torch.abs(c), max=1.0)
        sin_ai = safe_sqrt(1.0 - cos_ai * cos_ai)
        sin_at = sin_ai * f
        total = sin_at >= 1.0
        cos_at = safe_sqrt(1.0 - sin_at * sin_at)
        den_s = f * cos_ai + cos_at
        den_p = f * cos_at + cos_ai
        rs = ((f * cos_ai - cos_at)
              / torch.where(den_s != 0, den_s, 1.0)) ** 2
        rp = ((f * cos_at - cos_ai)
              / torch.where(den_p != 0, den_p, 1.0)) ** 2
        return torch.where(total, 1.0, (rs + rp) * 0.5)

    def _refract_dir(self, d, exit_nor, trix):
        """fresnel_refraction (reference src/gmath.c:94-113)."""
        c = _dot(d, exit_nor)
        f = torch.where(c < 0, trix,
                        1.0 / torch.where(trix != 0, trix, 1.0))
        q = f * f * (1.0 - c * c)
        sq = safe_sqrt(1.0 - q)
        b = -f * c + torch.where(c > 0, sq, -sq)
        out = d * f[:, None] + exit_nor * b[:, None]
        return torch.where((q < 1.0)[:, None], out, d)

    # ------------------------------------------------------------------

    def _step(self, q: Dict, path_ray: bool = False, mixed: bool = False):
        """One wavefront step over a padded batch.  Returns
        (sample_id, contrib [B,3], children dict, path_parent).  The NEE
        block runs only where a lane of the batch shades diffusely
        (`_nee_gated`, the JAX step's lax.cond): decided on the device
        under a CUDA-graph capture, on the host elsewhere.

        mixed=True: q carries a per-lane `kind` (0 normal ray, 1 path ray,
        2 path-parent descriptor) plus the parent aux fields; the trace is
        ONE traversal with per-lane light masking, and the path spawn is
        returned as a queue-resident parent block (reference
        src/scene.c:584-621)."""
        dt, dev = self.tdtype, self.device
        p, d = q["p"], q["d"]
        intensity, tint = q["intensity"], q["tint"]
        depth, sid = q["depth"], q["sample_id"]
        B = p.shape[0]
        alive = intensity > 0
        bg = self._mt("background")

        if mixed:
            is_path = q["kind"] == 1
            is_parent = q["kind"] == 2
            alive = alive & ~is_parent
            t, exit_nor, enter, exit_ = self.tr.trans_hit_mixed(p, d, is_path)
            hit_ok = torch.isfinite(t) & (~is_path
                                          | (t < self.max_path_length))
        elif path_ray:
            t, exit_nor, enter, exit_ = self.tr.trans_hit_matter(p, d)
            # miss OR beyond max_path_length -> background
            # (reference src/scene.c:608-616)
            hit_ok = torch.isfinite(t) & (t < self.max_path_length)
        else:
            t, exit_nor, enter, exit_ = self.tr.trans_hit(p, d)
            hit_ok = torch.isfinite(t)

        contrib = torch.zeros((B, 3), dtype=dt, device=dev)
        miss = alive & ~hit_ok
        contrib = contrib + torch.where(
            miss[:, None], bg[None, :] * intensity[:, None] * tint, 0.0)

        # shading gate: reference returns black at depth==0 or
        # intensity < tmi (reference src/scene.c:428)
        shade = alive & hit_ok & (depth > 0) & (intensity >= self.tmi)

        t_safe = torch.where(torch.isfinite(t), t, 0.0)
        pos = p + d * t_safe[:, None]

        enter_s = torch.clamp(enter, min=0)
        exit_s = torch.clamp(exit_, min=0)
        has_enter = enter >= 0
        has_exit = exit_ >= 0

        mat_in = self._mat_lookup(enter_s)
        mat_out = self._mat_lookup(exit_s)

        # emitter hit (reference src/scene.c:432-437)
        e_rad = mat_in["radiance"] * has_enter
        is_emit = shade & (e_rad > 0)
        e_pos = mat_in["pos"]
        diff_sqr = _dot(pos - e_pos, pos - e_pos)
        e_int = torch.where(diff_sqr > 0,
                            e_rad / torch.where(diff_sqr > 0, diff_sqr, 1.0),
                            F3_MAG)
        e_col = self._albedo(enter_s, pos, mat=mat_in)
        contrib = contrib + torch.where(
            is_emit[:, None], e_col * (e_int * intensity)[:, None] * tint,
            0.0)

        shade = shade & ~is_emit

        # surface parameters with exit-transition override
        # (reference src/scene.c:441-470)
        zero = torch.zeros_like(intensity)
        trix = torch.where(has_enter, mat_in["rix"], 1.0)
        # C && semantics: fresnel collapses to 0/1 (reference
        # src/scene.c:459)
        fresnel = torch.where(has_enter,
                              ((mat_in["fresnel"] != 0)
                               & (mat_in["rix"] != 1.0)).to(dt), zero)
        chromatic = torch.where(has_enter, mat_in["chromatic"], zero)
        diffuse = torch.where(has_enter, mat_in["diffuse"], zero)
        transparent = has_enter & (_dot(mat_in["transp"],
                                        mat_in["transp"]) > 0)
        sigma = torch.where(has_enter, mat_in["sigma"], zero)
        sig2 = sigma * sigma
        on_a = torch.where(sigma > 0, 1.0 - 0.5 * sig2 / (sig2 + 0.33), 1.0)
        on_b = torch.where(sigma > 0, 0.45 * sig2 / (sig2 + 0.09), 0.0)

        exit_rix = mat_out["rix"]
        trix = torch.where(has_exit,
                           trix / torch.where(exit_rix != 0, exit_rix, 1.0),
                           trix)
        fresnel = torch.where(has_exit, 1.0, fresnel)
        chromatic = torch.where(has_exit, 0.0, chromatic)
        diffuse = torch.where(has_exit, 0.0, diffuse)
        transparent = has_exit | transparent

        # Beer-Lambert absorption of this segment
        # (reference src/scene.c:656-664)
        transp = mat_out["transp"]
        tpos = transp > 0
        powed = torch.where(tpos, torch.pow(torch.where(tpos, transp, 1.0),
                                            t_safe[:, None]), 0.0)
        absorb = torch.where((has_exit & (t_safe > 0))[:, None], powed, 1.0)
        tint_l = tint * absorb

        albedo = e_col
        children = {}

        # --- fresnel branch (reference src/scene.c:473-495)
        fr_gate = shade & (fresnel > 0) & (intensity >= self.tmi)
        R = self._fresnel_reflectance(d, exit_nor, trix) * fresnel
        refl_d = m3.reflect(d, exit_nor)
        children["fresnel"] = dict(
            mask=fr_gate, p=pos, d=refl_d, intensity=R * intensity,
            tint=tint_l, depth=depth - 1, sample_id=sid)
        intensity = torch.where(fr_gate, intensity * (1.0 - R), intensity)

        # --- chromatic branch (reference src/scene.c:498-523)
        ch_gate = shade & (chromatic > 0) & (intensity >= self.tmi)
        children["chromatic"] = dict(
            mask=ch_gate, p=pos, d=refl_d,
            intensity=chromatic * intensity,
            tint=tint_l * albedo, depth=depth - 1, sample_id=sid)
        intensity = torch.where(ch_gate, intensity * (1.0 - chromatic),
                                intensity)

        # --- diffuse: NEE direct lighting (reference src/scene.c:526-581)
        di = intensity * diffuse
        di_gate = shade & (di >= self.tmi) & (diffuse > 0)
        surf_d = -exit_nor   # outward shading normal
        theta_i = safe_acos(-_dot(d, surf_d))
        ray_prj = _norm3(d - surf_d * _dot(d, surf_d)[:, None])
        if self.seed_mode == "counter":
            rv = argn.fold(argn.mix(sid, 2654435769), depth)
        else:
            rv = argn.fold(argn.seed_from_v3(pos, 3294479285),
                           argn.seed_from_v3(surf_d, 3247146734))

        if self.n_lights:
            lum_nee = self._nee_gated(pos, surf_d, di, di_gate, theta_i,
                                      on_a, on_b, ray_prj, rv)
        else:
            lum_nee = torch.zeros((B, 3), dtype=dt, device=dev)
        path_parent = None
        if self.path_cap > 0:
            ns_p = torch.clamp(torch.floor(self.path_cap * di).to(
                torch.int64), min=1)
            path_gate = di_gate & (depth > 10)
            path_parent = dict(
                mask=path_gate, pos=pos, surf_d=surf_d, di=di,
                ns=ns_p, theta_i=theta_i, on_a=on_a, on_b=on_b,
                ray_prj=ray_prj, rv=rv,
                tint=tint_l * albedo, depth=depth - 10, sample_id=sid)

        contrib = contrib + torch.where(di_gate[:, None],
                                        lum_nee * albedo * tint_l, 0.0)
        intensity = torch.where(di_gate, intensity * (1.0 - diffuse),
                                intensity)

        # --- refraction branch (reference src/scene.c:633-653)
        re_gate = shade & transparent & (intensity >= self.tmi)
        refr_d = self._refract_dir(d, exit_nor, trix)
        refr_p = p + d * (t_safe + 2 * self.tr.eps)[:, None]
        children["refract"] = dict(
            mask=re_gate, p=refr_p, d=refr_d, intensity=intensity,
            tint=tint_l, depth=depth - 1, sample_id=sid)

        if mixed:
            # widen the specular blocks to the mixed field set and turn
            # the path-spawn descriptor into a queue-resident parent block
            # (parent-lane expansion happens in the drain, which knows the
            # queue headroom)
            zero3 = torch.zeros((B, 3), dtype=dt, device=dev)
            zi = torch.zeros((B,), dtype=torch.int64, device=dev)
            for name in ("fresnel", "chromatic", "refract"):
                children[name].update(
                    kind=zi, aux_prj=zero3, aux_t=zero, aux_a=zero,
                    aux_b=zero, rv=zi, j0=zi, ns=zi)
            if path_parent is not None:
                pp = path_parent
                children["parent"] = dict(
                    mask=pp["mask"], p=pp["pos"], d=pp["surf_d"],
                    intensity=pp["di"], tint=pp["tint"],
                    depth=pp["depth"], sample_id=pp["sample_id"],
                    kind=torch.full((B,), 2, dtype=torch.int64, device=dev),
                    aux_prj=pp["ray_prj"], aux_t=pp["theta_i"],
                    aux_a=pp["on_a"], aux_b=pp["on_b"], rv=pp["rv"],
                    j0=zi, ns=pp["ns"])
                path_parent = None

        return sid, contrib, children, path_parent

    # ------------------------------------------------------------------

    def _nee_kernel_ok(self):
        """The fused NEE kernel applies: the tracer's kernel rules, no
        material overrides, a position-seeded render, and a scene within
        the kernel's coverage."""
        return (self.tr._kernels_ok() and not self.ovr
                and self.seed_mode == "position"
                and kernels.nee_supported(self))

    def _nee_gated(self, pos, surf_d, di, gate, theta_i, on_a, on_b,
                   ray_prj, rv):
        """`_nee` where a lane of the batch shades diffusely (`gate`), zeros
        elsewhere: the JAX step's `lax.cond(any(di_gate), _nee, zeros)`
        (pure-specular wavefront generations skip it).  Under autograd
        (the diff replay) the backward is gated as well
        (`cond.cond_grad`): the NEE reads the parameters through `ovr`,
        `tr.ovr` and the tables built from them, so those go in as inputs
        and the NEE runs on their detached copies."""
        args = (pos, surf_d, di, gate, theta_i, on_a, on_b, ray_prj, rv)
        pred = gate.any()
        tr = self.tr
        state = (self.ovr, tr.ovr, self._mats() if self.ovr else None,
                 tr._tables() if tr.ovr else None)
        flat, spec = tree_flatten((args, state))
        if not (torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in flat)):
            lum = torch.zeros_like(pos)
            with cond.if_node(pred) as run:
                if run:
                    lum.copy_(self._nee(*args))
            return lum

        def nee(*inner):
            a, (m, g, mats, tabs) = tree_unflatten(list(inner), spec)
            saved = (self.ovr, tr.ovr, self._ovr_mats, tr._ovr_tabs)
            self.ovr, tr.ovr = m, g
            self._ovr_mats = (dict(m), mats) if m else None
            tr._ovr_tabs = (dict(g), tabs) if g else None
            try:
                return self._nee(*a)
            finally:
                (self.ovr, tr.ovr, self._ovr_mats, tr._ovr_tabs) = saved

        return cond.cond_grad(pred, nee, pos, *flat)

    def _nee(self, pos, surf_d, di, gate, theta_i, on_a, on_b, ray_prj, rv):
        """Per-light cone-restricted direct light sampling with the
        2*cap_height/n estimator (reference src/scene.c:542-578)."""
        ns = torch.floor(self.cfg.direct_samples * di).to(torch.int64)
        ns = torch.clamp(ns, min=1, max=self.direct_cap)
        if self._nee_kernel_ok():
            return kernels.nee(
                self, pos.contiguous(), surf_d.contiguous(),
                torch.where(gate, di, 0.0).contiguous(),
                torch.cos(theta_i).contiguous(), on_a.contiguous(),
                on_b.contiguous(), ray_prj.contiguous(),
                argn.to_uint32(rv), ns.to(torch.int32))
        lum = self._nee_plain(pos, surf_d, di, gate, theta_i, on_a, on_b,
                              ray_prj, rv, ns, self.tr.shadow_blocked,
                              self.tr.object_hit_t)
        if self.edge_aware:
            lum = lum + self._nee_edge_terms(pos, surf_d, di, gate, theta_i,
                                             on_a, on_b, ray_prj)
        return lum

    def _nee_plain(self, pos, surf_d, di, gate, theta_i, on_a, on_b, ray_prj,
                   rv, ns, shadow, obj_hit):
        """The NEE without the fused kernel: single-sphere lights as one
        vectorized batch, other lights one by one.  `shadow(p, d, limit)`
        and `obj_hit(oid, p, d)` answer the shadow and light-hit queries
        (the plain version of the NEE kernel passes the plain ones)."""
        dt = self.tdtype
        B = pos.shape[0]
        rv = argn.as_u32(rv)
        ns = ns.to(torch.int64)
        lum = torch.zeros((B, 3), dtype=dt, device=self.device)
        exact = [li for li in range(self.n_lights)
                 if self.l_sphere_exact[li]]
        legacy = [li for li in range(self.n_lights)
                  if not self.l_sphere_exact[li]]
        if exact:
            lum = lum + self._nee_exact_batch(
                exact, pos, surf_d, di, gate, theta_i, on_a, on_b, ray_prj,
                rv, ns, shadow)
        budget = self._flat_ray_budget()
        for li in legacy:
            lpos = self._mt("l_pos")[li]
            lrad = self._mt("l_rad")[li]
            lr = self._mt("l_radius")[li]
            lcol = self._mt("l_color")[li]
            if self.l_fov[li] == "plane":
                # half-space cone (obj_plane_s_fov, reference
                # src/objects.c:520-526): toward -normal; degenerate when
                # the surface is behind
                nrm = self.tr._const(self.l_plane_n[li], self.tdtype)
                fov_d = (-nrm).expand(pos.shape)
                cos_rs = torch.where(_dot(lpos - pos, fov_d) > 0, 0.0, 1.0)
                cos_rs = cos_rs.to(dt)
            else:
                # sphere / envelope cone toward the light (reference
                # src/objects.c:619-637, 70-88)
                cpos = self.tr._const(self.l_cone_pos[li], self.tdtype)
                diff = cpos - pos
                dist2 = _dot(diff, diff)
                fov_d = _norm3(diff)
                r2 = lr * lr
                cos_rs = torch.where(
                    dist2 > r2,
                    safe_sqrt(1.0 - r2 / torch.where(dist2 > 0, dist2, 1.0)),
                    -1.0)
            cyl_hgt = 1.0 - cos_rs
            frame = self._conz_t(fov_d)
            s_chunk = max(1, min(self.direct_cap, budget // max(B, 1)))
            cl_sum = torch.zeros((B, 3), dtype=dt, device=self.device)
            for j0 in range(0, self.direct_cap, s_chunk):
                js = torch.arange(j0, min(j0 + s_chunk, self.direct_cap),
                                  device=self.device)
                S = js.shape[0]
                ctr = 4 * (li * self.direct_cap + js)[None, :]
                u1 = argn.uniform(rv[:, None], ctr, dt)
                u2 = argn.uniform(rv[:, None], ctr + 1, dt)
                local = m3.sphere_cap_sample(u1, u2, cyl_hgt[:, None])
                out_d = _frame_apply(frame, local)           # [B,S,3]
                w = _dotk(out_d, surf_d)
                ok = (js[None, :] < ns[:, None]) & gate[:, None] & (w > 0)
                flat_p = pos[:, None, :].expand(B, S, 3).reshape(B * S, 3)
                flat_d = out_d.reshape(B * S, 3)
                a = obj_hit(self.l_oid[li], flat_p, flat_d).reshape(B, S)
                ok = ok & torch.isfinite(a)
                w = torch.where((on_b > 0)[:, None],
                                self._oren_nayar_b(w, theta_i, on_a, on_b,
                                                   out_d, surf_d, ray_prj),
                                w)
                # shadow: no matter hit at or before the light (reference
                # src/scene.c:571 `compound_s_ray_hit(matter) > a`)
                a_lim = torch.where(torch.isfinite(a), a, 0.0).reshape(B * S)
                blocked = shadow(flat_p, flat_d, a_lim).reshape(B, S)
                ok = ok & ~blocked
                a_safe = torch.where(torch.isfinite(a), a, 0.0)
                hit_pos = pos[:, None, :] + out_d * a_safe[..., None]
                dsq = torch.sum((hit_pos - lpos) ** 2, -1)
                loc = torch.where(dsq > 0,
                                  lrad / torch.where(dsq > 0, dsq, 1.0),
                                  F3_MAG)
                contrib = lcol[None, None, :] * (loc * w)[..., None] \
                    * di[:, None, None]
                cl_sum = cl_sum + torch.sum(
                    torch.where(ok[..., None], contrib, 0.0), dim=1)
            lum = lum + cl_sum * (2.0 * cyl_hgt / ns.to(dt))[:, None]
        return lum

    def _nee_exact_batch(self, idx, pos, surf_d, di, gate, theta_i, on_a,
                         on_b, ray_prj, rv, ns, shadow):
        """Vectorized NEE over all single-sphere lights at once: the
        cone / frame / cap-sample / light-hit math batches on a light
        axis, and each sample chunk issues ONE flattened shadow query for
        ALL lights.  RNG counters are ctr = 4*(li*direct_cap + j)."""
        dt, dev = self.tdtype, self.device
        B = pos.shape[0]
        Le = len(idx)
        li = self.tr._const(idx, torch.int64)
        lp = self._mt("l_pos")[li]                      # [Le,3]
        lrad = self._mt("l_rad")[li]
        lr = self._mt("l_radius")[li]
        lcol = self._mt("l_color")[li]

        diff = lp[None] - pos[:, None]                 # [B,Le,3]
        dist2 = _dot(diff, diff)
        fov_d = _norm3(diff)
        r2 = (lr * lr)[None]
        cos_rs = torch.where(
            dist2 > r2,
            safe_sqrt(1.0 - r2 / torch.where(dist2 > 0, dist2, 1.0)), -1.0)
        cyl = 1.0 - cos_rs                             # [B,Le]
        frame = m3.transposed(m3.con_z(fov_d))         # [B,Le,3,3]

        budget = self._flat_ray_budget()
        s_chunk = max(1, min(self.direct_cap, budget // max(B * Le, 1)))
        cl = torch.zeros((B, Le, 3), dtype=dt, device=dev)
        for j0 in range(0, self.direct_cap, s_chunk):
            js = j0 + torch.arange(s_chunk, device=dev)    # [S]
            S = s_chunk
            ctr = 4 * (li[:, None] * self.direct_cap + js[None, :])
            u1 = argn.uniform(rv[:, None, None], ctr[None], dt)
            u2 = argn.uniform(rv[:, None, None], ctr[None] + 1, dt)
            local = m3.sphere_cap_sample(u1, u2, cyl[..., None])
            out_d = _frame_apply(frame, local)         # [B,Le,S,3]
            w = _dotk(out_d, surf_d[:, None, :])
            ok = (js[None, None] < ns[:, None, None]) \
                & gate[:, None, None] & (w > 0)
            a = _sphere_first_hit(lp[None, :, None], lr[None, :, None],
                                  pos[:, None, None], out_d, self.tr.eps)
            ok = ok & torch.isfinite(a)
            won = torch.where(
                (on_b > 0)[:, None, None],
                self._oren_nayar_b(
                    w.reshape(B, Le * S), theta_i, on_a, on_b,
                    out_d.reshape(B, Le * S, 3), surf_d,
                    ray_prj).reshape(B, Le, S), w)
            flat_p = pos[:, None, None, :].expand(B, Le, S, 3).reshape(-1, 3)
            a_lim = torch.where(torch.isfinite(a), a, 0.0).reshape(-1)
            blocked = shadow(flat_p, out_d.reshape(-1, 3).contiguous(),
                             a_lim).reshape(B, Le, S)
            ok = ok & ~blocked
            a_safe = torch.where(torch.isfinite(a), a, 0.0)
            hitp = pos[:, None, None, :] + out_d * a_safe[..., None]
            dsq = torch.sum((hitp - lp[None, :, None]) ** 2, -1)
            loc = torch.where(dsq > 0,
                              lrad[None, :, None]
                              / torch.where(dsq > 0, dsq, 1.0), F3_MAG)
            contrib = lcol[None, :, None, :] \
                * (loc * won)[..., None] * di[:, None, None, None]
            cl = cl + torch.sum(torch.where(ok[..., None], contrib, 0.0),
                                dim=2)                 # [B,Le,3]
        fac = (2.0 * cyl / ns.to(dt)[:, None])[..., None]
        return torch.sum(cl * fac, dim=1)

    def _flat_ray_budget(self):
        """Shadow rays per flattened NEE query: B*S x leaves temporaries
        of the plain shadow traversal stay bounded; the scene kernel's
        shadow (K5) has no such temporaries, so its budget bounds only the
        kernel's I/O (JAX integrator.py:663-666)."""
        W = max(1, min(len(self.tr.tab), CHUNK))
        if self.tr._scene_route_ok() and self.tr._prefer_scene_shadow():
            W = 64
        return min(1 << 20, (1 << 26) // W)

    def _nee_edge_terms(self, pos, surf_d, di, gate, theta_i, on_a, on_b,
                        ray_prj, K=32):
        """Silhouette boundary term of the NEE visibility integral
        (edge-aware gradients; the JAX integrator's `_nee_edge_terms`).

        The NEE estimate of I = (1/pi) int_cap V(w) g(w) dw moves with the
        occluders: V's discontinuity, the silhouette of each occluder as
        seen from the shading point, carries the boundary term
        -(1/pi) oint_C g(w) (nhat . dw/dtheta) sin(alpha) dphi.  Each of
        K quadrature nodes on the silhouette contributes
        g.detach() * speed.detach() * (nhat.detach() . w), whose value is
        zero (nhat is tangent to the direction sphere at w) while its
        gradient is the boundary integrand; the term adds to the radiance
        as x - x.detach().

        Occluders: single-leaf spheres (their silhouette circle), single-
        leaf planes against sphere lights (the plane's rim circle on the
        light), sphere and quadric leaves of CSG composites (nodes masked
        to where the composite's blocking jumps), and ellipsoid and
        cylinder quadrics (`_quadric_sil_nodes`).  Cones, hyperboloids and
        SDF occluders stay interior-only (diff.edge_coverage_gaps)."""
        dt, dev = self.tdtype, self.device
        tr = self.tr
        tab = tr.tab
        B = pos.shape[0]
        out = torch.zeros((B, 3), dtype=dt, device=dev)

        # occluder inventory: (kind, a, b, composite or None) with the
        # geometry read through the tracer's overrides
        occs = []
        if len(tab.sph_rows):
            sph_c = tr._t("sph_c", tab.sph_c)
            sph_r = tr._t("sph_r", tab.sph_r)
        for i, row in enumerate(tab.sph_rows):
            if tab.single[row] and not tab.is_light[row]:
                occs.append(("sphere", sph_c[i], sph_r[i], None))
        for row, key, fam in tab.comp_keys:
            if fam != sir.SPHERE or tab.is_light[row]:
                continue
            occs.append(("sphere", tr._t(key + "c", -tab.m0[row]),
                         tr._t(key + "r", np.sqrt(-tab.rr[row])),
                         self._composite_of(row)))
        if len(tab.pla_rows):
            pla_n = tr._t("pla_n", tab.pla_n)
            pla_k = tr._t("pla_k", tab.pla_k)
        for i, row in enumerate(tab.pla_rows):
            if tab.single[row] and not tab.is_light[row]:
                occs.append(("plane", pla_n[i], pla_k[i], None))

        def quad_sig(c2s, rrs):
            c2s = np.asarray(c2s, float)
            if (c2s > 0).all() and rrs < 0:
                return ("ellipsoid", -1)
            z = np.isclose(c2s, 0.0)
            if z.sum() == 1 and (c2s[~z] > 0).all() and rrs < 0:
                return ("cylinder", int(np.flatnonzero(z)[0]))
            return (None, -1)

        if len(tab.qua_rows):
            qua = {k: tr._t(k, getattr(tab, k))
                   for k in ("qua_m", "qua_m0", "qua_coef", "qua_r")}
        for i, row in enumerate(tab.qua_rows):
            if not tab.single[row] or tab.is_light[row]:
                continue
            sig, free = quad_sig(tab.c2[row], tab.rr[row])
            if sig is not None:
                occs.append(("quadric", dict(
                    M=qua["qua_m"][i], m0=qua["qua_m0"][i],
                    c2=qua["qua_coef"][i], rr=qua["qua_r"][i], sig=sig,
                    free=free), None, None))
        for row, key, fam in tab.comp_keys:
            if fam != sir.QUADRIC or tab.is_light[row]:
                continue
            sig, free = quad_sig(tab.c2[row], tab.rr[row])
            if sig is not None:
                occs.append(("quadric", dict(
                    M=tr._t(key + "m", tab.M[row]),
                    m0=tr._t(key + "m0", tab.m0[row]),
                    c2=tr._t(key + "coef", tab.c2[row]),
                    rr=tr._t(key + "r", tab.rr[row]), sig=sig, free=free),
                    None, self._composite_of(row)))
        if not occs:
            return out

        phis = (np.arange(K) + 0.5) * (2.0 * np.pi / K)
        cphi = tr._const(np.cos(phis))
        sphi = tr._const(np.sin(phis))
        s_sd, s_ti, s_pos = surf_d.detach(), theta_i.detach(), pos.detach()
        fp = s_pos[:, None, :].expand(B, K, 3).reshape(B * K, 3)
        tilt = 1e-3    # predicate probe angle off the curve

        def detached(fn, *args):
            """A plain forward tracer query: overrides and AD off."""
            saved = tr.ovr, tr.diff
            tr.ovr, tr.diff = {}, False
            try:
                return fn(*args)
            finally:
                tr.ovr, tr.diff = saved

        for li in range(self.n_lights):
            exact = self.l_sphere_exact[li]
            lpos = self._mt("l_pos")[li]
            lrad = self._mt("l_rad")[li]
            lr = self._mt("l_radius")[li]
            lcol = self._mt("l_color")[li]
            s_lpos, s_lr = lpos.detach(), lr.detach()
            if self.l_fov[li] == "plane":
                fov_d = (-tr._const(self.l_plane_n[li])).expand(s_pos.shape)
                cos_rs = torch.where(_dot(s_lpos - s_pos, fov_d) > 0,
                                     0.0, 1.0).to(dt)
            else:
                cpos = s_lpos if exact else tr._const(self.l_cone_pos[li])
                ldiff = cpos - s_pos
                ldist2 = _dot(ldiff, ldiff)
                fov_d = _norm3(ldiff)
                r2 = s_lr * s_lr
                cos_rs = torch.where(
                    ldist2 > r2,
                    safe_sqrt(1.0 - r2 / torch.where(ldist2 > 0, ldist2,
                                                     1.0)), -1.0)

            def light_a(wd, exact=exact, s_lpos=s_lpos, s_lr=s_lr,
                        oid=self.l_oid[li]):
                """Light first hit along detached directions [B,K,3]."""
                if exact:
                    return self._sphere_hit(s_lpos, s_lr, s_pos[:, None, :],
                                            wd)
                return detached(tr.object_hit_t, oid, fp,
                                wd.reshape(B * K, 3)).reshape(B, K)

            for okind, oa, ob, comp in occs:
                if okind == "sphere":
                    c, r = oa, ob
                    rel = c - pos
                    dist = safe_sqrt(_dot(rel, rel))
                    ok0 = (dist > r) & (r > 0) & gate
                    sin_a = torch.clamp(
                        r / torch.where(dist > 0, dist, 1.0), 0.0, 1.0)
                    cos_a = safe_sqrt(1.0 - sin_a * sin_a)
                    u = _norm3(rel)
                    fr = self._conz_t(u)                # cols e1, e2, u
                    circ = (cphi[None, :, None] * fr[:, None, :, 0]
                            + sphi[None, :, None] * fr[:, None, :, 1])
                    w_dir = (cos_a[:, None, None] * u[:, None, :]
                             + sin_a[:, None, None] * circ)
                elif okind == "quadric":
                    w_dir, ok0 = self._quadric_sil_nodes(oa, pos, gate,
                                                         cphi, sphi)
                else:
                    if not exact:
                        # the half-space's discontinuity curve is its rim
                        # on the light sphere: sphere lights only
                        continue
                    nvec, koff = oa, ob
                    nn = safe_sqrt(_dot(nvec, nvec))
                    nn_s = torch.where(nn > 0, nn, 1.0)
                    nh = nvec / nn_s
                    s_l = torch.sum(nh * lpos) + koff / nn_s
                    rc2 = lr * lr - s_l * s_l
                    ok0 = (rc2 > 0) & gate              # plane cuts light
                    rc = safe_sqrt(torch.clamp(rc2, min=0.0))
                    q0 = lpos - s_l * nh                # rim centre
                    frp = self._conz_t(nh[None, :])[0]  # cols e1, e2, nh
                    xk = q0[None, :] + rc * (cphi[:, None] * frp[None, :, 0]
                                             + sphi[:, None] * frp[None, :, 1])
                    w_dir = _norm3(xk[None, :, :] - pos[:, None, :])

                wd = w_dir.detach()                     # [B,K,3]
                # the curve's tangent, speed and in-sphere normal from the
                # node ring (central differences)
                dwd = 0.5 * (torch.roll(wd, -1, dims=1)
                             - torch.roll(wd, 1, dims=1))
                speed = torch.sqrt(torch.sum(dwd * dwd, -1)) \
                    * (K / (2.0 * np.pi))
                mh = _norm3(m3.cross(wd, _norm3(dwd)))

                def blocked(w, okind=okind, oa=oa, ob=ob, comp=comp):
                    """This occluder alone blocks the light along detached
                    directions w [B,K,3]."""
                    a = light_a(w)
                    a_inf = torch.where(torch.isfinite(a), a, INF)
                    if okind == "plane":
                        nv, kv = oa.detach(), ob.detach()
                        sp = (torch.sum(nv[None, :] * s_pos, -1) + kv)
                        den = torch.sum(w * nv, -1)
                        t_pl = -sp[:, None] / torch.where(den != 0, den, 1.0)
                        return (den != 0) & (t_pl > 0) & (t_pl < a_inf)
                    if okind == "quadric" and comp is None:
                        t_oc = self._quadric_first_hit(oa, s_pos, w)
                        return torch.isfinite(t_oc) & (t_oc < a_inf)
                    if comp is None:
                        t_oc = self._sphere_hit(oa.detach(), ob.detach(),
                                                s_pos[:, None, :], w)
                        return torch.isfinite(t_oc) & (t_oc < a_inf)
                    # composite: its detached boundary query
                    return detached(tr._shadow_composite, comp, fp,
                                    w.reshape(B * K, 3),
                                    a_inf.reshape(B * K)).reshape(B, K)

                # orient mh toward the unblocked side, and demand a jump
                # across the node (blocked inside, clear outside)
                b_hi = blocked(_norm3(wd + tilt * mh))
                b_lo = blocked(_norm3(wd - tilt * mh))
                mh = torch.where((b_hi & ~b_lo)[..., None], -mh, mh)
                jump = b_hi ^ b_lo

                w_cos = _dotk(wd, s_sd)
                g_on = torch.where(
                    (on_b > 0)[:, None],
                    self._oren_nayar_b(w_cos, s_ti, on_a.detach(),
                                       on_b.detach(), wd, s_sd,
                                       ray_prj.detach()), w_cos)
                a = light_a(wd)
                fin = torch.isfinite(a)
                in_cap = _dotk(wd, fov_d.detach()) >= cos_rs.detach()[:, None]
                a_safe = torch.where(fin, a, 0.0)
                hitp = s_pos[:, None, :] + wd * a_safe[..., None]
                dsq = torch.sum((hitp - s_lpos) ** 2, -1)
                loc = torch.where(dsq > 0, lrad.detach()
                                  / torch.where(dsq > 0, dsq, 1.0), F3_MAG)
                g = torch.where(ok0[:, None] & fin & in_cap & jump
                                & (w_cos > 0),
                                loc * g_on * di.detach()[:, None], 0.0)
                x = -(2.0 / K) * torch.sum(
                    g.detach() * speed * torch.sum(mh * w_dir, -1), dim=1)
                xr = lcol.detach()[None, :] * x[:, None]
                out = out + (xr - xr.detach())
        return out

    def _composite_of(self, row):
        """The composite that owns unified leaf row `row`."""
        oid = self.tr.tab.oid[row]
        return next(cp for cp in self.tr.composites if cp.oid == oid)

    def _quadric_sil_nodes(self, qd, pos, gate, cphi, sphi):
        """Silhouette quadrature nodes of a quadric occluder seen from
        `pos` [B,3]: directions w(phi) [B,K,3] (with autograd) and their
        validity.  The silhouette of {y: sum c2_i y_i^2 + rr = 0}, y =
        M x + m0, is closed-form after the map z_i = y_i sqrt(c2_i / -rr)
        that makes the surface a unit one: for an ellipsoid (all c2 > 0)
        the sphere silhouette circle of the mapped viewpoint, mapped back;
        for a cylinder (one c2 = 0) the two tangent generator lines,
        K/2 nodes each at view angles that crowd near the shading point."""
        dt, dev = self.tdtype, self.device
        B = pos.shape[0]
        K = cphi.shape[0]
        M, m0, c2, rr = qd["M"], qd["m0"], qd["c2"], qd["rr"]
        # inv_ex: linalg.inv without its singularity check, which reads
        # the card (the same kernels and backward otherwise)
        Minv = torch.linalg.inv_ex(M).inverse
        yp = pos @ M.T + m0[None, :]                   # [B,3] local
        side = torch.sum(c2[None, :] * yp * yp, -1) + rr
        if qd["sig"] == "ellipsoid":
            scale = safe_sqrt(c2 / torch.clamp(-rr, min=1e-30))
            zp = yp * scale[None, :]
            zl = safe_sqrt(_dot(zp, zp))
            ok0 = (zl > 1.0) & (side > 0) & gate
            zl_s = torch.where(zl > 0, zl, 1.0)
            cos_a = torch.clamp(1.0 / zl_s, 0.0, 1.0)
            sin_a = safe_sqrt(1.0 - cos_a * cos_a)
            u = zp / zl_s[:, None]
            fr = self._conz_t(u)
            circ = (cphi[None, :, None] * fr[:, None, :, 0]
                    + sphi[None, :, None] * fr[:, None, :, 1])
            zphi = (cos_a[:, None, None] * u[:, None, :]
                    + sin_a[:, None, None] * circ)     # [B,K,3]
            yphi = zphi / scale[None, None, :]
            xphi = (yphi - m0[None, None, :]) @ Minv.T
            return _norm3(xphi - pos[:, None, :]), ok0
        free = qd["free"]
        ij = [k for k in range(3) if k != free]
        ij_t = self.tr._const(ij, torch.int64)    # a device index: no upload
        s2 = safe_sqrt(c2[ij_t] / torch.clamp(-rr, min=1e-30))  # [2]
        q2 = yp[:, ij_t] * s2[None, :]                 # [B,2]
        ql = safe_sqrt(_dot(q2, q2))
        ok0 = (ql > 1.0) & (side > 0) & gate
        ql_s = torch.where(ql > 0, ql, 1.0)
        cos_a = torch.clamp(1.0 / ql_s, 0.0, 1.0)
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        qhat = q2 / ql_s[:, None]
        qperp = torch.stack([-qhat[:, 1], qhat[:, 0]], -1)
        Kh = K // 2
        th = (torch.arange(Kh, dtype=dt, device=dev) + 0.5) / Kh * math.pi \
            - math.pi / 2
        tanth = torch.tan(th)                          # [Kh]
        axis_x = _norm3(Minv[:, free])                 # free axis in x
        ws = []
        for sgn in (1.0, -1.0):
            T2 = cos_a[:, None] * qhat + sgn * sin_a[:, None] * qperp
            cols = [None] * 3
            cols[ij[0]] = T2[:, 0] / s2[0]
            cols[ij[1]] = T2[:, 1] / s2[1]
            cols[free] = yp[:, free]
            x0 = (torch.stack(cols, -1) - m0[None, :]) @ Minv.T
            base = x0 - pos
            dist = safe_sqrt(_dot(base, base))
            xk = x0[:, None, :] + (dist[:, None] * tanth[None, :])[..., None] \
                * axis_x[None, None, :]                # [B,Kh,3]
            ws.append(_norm3(xk - pos[:, None, :]))
        return torch.cat(ws, dim=1), ok0

    def _quadric_first_hit(self, qd, p, w):
        """Detached first hit of one quadric along directions w [B,K,3]
        (the quadric family's root policy)."""
        M, m0, c2, rr = (qd[k].detach() for k in ("M", "m0", "c2", "rr"))
        pl = (p @ M.T + m0[None, :])[:, None, :]       # [B,1,3]
        dl = torch.einsum("bki,ji->bkj", w, M)         # [B,K,3]
        # f32: the sums as the JAX package's compiled code rounds them (an
        # FMA chain over (c2 dl) dl), and s s - q rounded twice: XLA does
        # not contract it here
        A = _dot_fma32(c2 * dl, dl)
        Bq = 2.0 * _dot_fma32(c2 * dl, pl)
        Cq = _dot_fma32(c2 * pl, pl) + rr
        is_q = A != 0
        sA = torch.where(is_q, A, 1.0)
        s = (Bq * 0.5) / sA
        q = Cq / sA
        disc = s * s - q
        ok = is_q & (disc >= 0)
        root = safe_sqrt(torch.where(ok, disc, 0.0))
        lin_nz = Bq != 0
        t_lin = torch.where(lin_nz, -Cq / torch.where(lin_nz, Bq, 1.0), INF)
        t0 = torch.where(is_q, torch.where(ok, -s - root, INF), t_lin)
        t1 = torch.where(is_q & ok, -s + root, INF)
        a = torch.where(t0 >= 0, t0, torch.where(t1 >= 0, t1, INF))
        return torch.where(torch.isfinite(a), a - self.tr.eps, INF)

    def _oren_nayar(self, weight, theta_i, on_a, on_b, out_d, nor, ray_prj):
        """Oren-Nayar weighting of one sample per lane (reference
        src/scene.c:394-416)."""
        theta_r = safe_acos(weight)
        proj = _norm3(out_d - nor * _dot(out_d, nor)[:, None])
        cos_phi = -_dot(proj, ray_prj)
        tan_arg = torch.clamp(torch.minimum(theta_i, theta_r),
                              max=math.pi / 2 - 1e-6)
        return weight * (on_a + on_b * torch.clamp(cos_phi, min=0.0)
                         * torch.sin(torch.maximum(theta_i, theta_r))
                         * torch.tan(tan_arg))

    def _sphere_hit(self, c, r, p, d):
        """Exact sphere first hit, eps-backed (the NEE light hit)."""
        return _sphere_first_hit(c, r, p, d, self.tr.eps)

    def _conz_t(self, v):
        """transposed(con_z(v)): columns = orthonormal frame with z // v
        (reference src/vectors.h:315-322)."""
        return m3.transposed(m3.con_z(v))

    def _oren_nayar_b(self, weight, theta_i, on_a, on_b, out_d, nor,
                      ray_prj):
        """Oren-Nayar weighting (reference src/scene.c:394-416), batched
        over a [B, K] sample axis."""
        theta_r = safe_acos(weight)
        proj = out_d - nor[:, None, :] * _dotk(out_d, nor)[..., None]
        proj = _norm3(proj)
        cos_phi = -_dotk(proj, ray_prj)
        ti = theta_i[:, None]
        tan_arg = torch.clamp(torch.minimum(ti, theta_r),
                              max=math.pi / 2 - 1e-6)
        return weight * (on_a[:, None] + on_b[:, None]
                         * torch.clamp(cos_phi, min=0.0)
                         * torch.sin(torch.maximum(ti, theta_r))
                         * torch.tan(tan_arg))

    # ------------------------------------------------------------------

    def _spawn_paths(self, pp: Dict):
        """Expand path-spawn descriptors into child rays [B, path_cap]
        (reference src/scene.c:584-621): hemisphere cap sampling with cos
        weight, Oren-Nayar adjust, child tint with albedo and the 2/ns
        estimator factor.  The host drain's form of _expand_parents: the
        same RNG counters and factors."""
        dt, dev = self.tdtype, self.device
        pos, surf_d = pp["pos"], pp["surf_d"]
        B = pos.shape[0]
        frame = self._conz_t(surf_d)
        ns = pp["ns"]
        cap = self.path_cap
        js = torch.arange(cap, device=dev)
        c0 = 4 * self.direct_cap * max(self.n_lights, 1)
        rv = argn.as_u32(pp["rv"])[:, None]
        u1 = argn.uniform(rv, c0 + 2 * js[None, :], dt)
        u2 = argn.uniform(rv, c0 + 2 * js[None, :] + 1, dt)
        local = m3.sphere_cap_sample(u1, u2, 1.0)       # hemisphere cap
        out_d = _frame_apply(frame, local)               # [B, cap, 3]
        w = _dotk(out_d, surf_d)
        ok = pp["mask"][:, None] & (js[None, :] < ns[:, None]) & (w > 0)
        won = torch.where(
            (pp["on_b"] > 0)[:, None],
            self._oren_nayar_b(w, pp["theta_i"], pp["on_a"], pp["on_b"],
                               out_d, surf_d, pp["ray_prj"]), w)
        fac = (2.0 / ns.to(dt))[:, None, None]
        return dict(
            mask=ok,
            p=pos[:, None, :].expand(B, cap, 3),
            d=out_d,
            intensity=won * pp["di"][:, None],
            tint=(pp["tint"][:, None, :] * fac).expand(B, cap, 3),
            depth=pp["depth"][:, None].expand(B, cap),
            sample_id=pp["sample_id"][:, None].expand(B, cap))

    def _expand_parents(self, q: Dict, allow):
        """Expand parent lanes of a mixed batch into PATH_EXPAND path
        children each plus one continuation (reference
        src/scene.c:584-621).  A parent lane stores p=hit pos, d=outward
        normal, intensity=di, tint=tint*albedo, depth=child depth, plus
        the aux fields (ray_prj/theta_i/on_a/on_b/rv/j0/ns).

        `allow` [B] bool: parents denied by the drain's queue-headroom
        budget emit NO children this trip and re-enqueue unchanged."""
        dt, dev = self.tdtype, self.device
        K = PATH_EXPAND
        is_parent = q["kind"] == 2
        pos, surf_d = q["p"], q["d"]
        di, ns, j0 = q["intensity"], q["ns"], q["j0"]
        B = pos.shape[0]
        frame = self._conz_t(surf_d)
        js = j0[:, None] + torch.arange(K, device=dev)[None, :]
        c0 = 4 * self.direct_cap * max(self.n_lights, 1)
        u1 = argn.uniform(q["rv"][:, None], c0 + 2 * js, dt)
        u2 = argn.uniform(q["rv"][:, None], c0 + 2 * js + 1, dt)
        local = m3.sphere_cap_sample(u1, u2, 1.0)       # hemisphere cap
        out_d = _frame_apply(frame, local)
        w = _dotk(out_d, surf_d)
        ok = (is_parent & allow)[:, None] & (js < ns[:, None]) & (w > 0) \
            & (di > 0)[:, None]
        won = torch.where(
            (q["aux_b"] > 0)[:, None],
            self._oren_nayar_b(w, q["aux_t"], q["aux_a"], q["aux_b"],
                               out_d, surf_d, q["aux_prj"]), w)
        ns_f = torch.clamp(ns.to(dt), min=1.0)
        child_tint = q["tint"] * (2.0 / ns_f)[:, None]
        zero3 = torch.zeros((B, 3), dtype=dt, device=dev)
        z1 = torch.zeros((B,), dtype=dt, device=dev)
        zi = torch.zeros((B,), dtype=torch.int64, device=dev)
        ones = torch.ones((B,), dtype=torch.int64, device=dev)
        blocks = []
        for k in range(K):
            blocks.append(dict(
                mask=ok[:, k], p=pos, d=out_d[:, k, :],
                intensity=won[:, k] * di, tint=child_tint,
                depth=q["depth"], sample_id=q["sample_id"], kind=ones,
                aux_prj=zero3, aux_t=z1, aux_a=z1, aux_b=z1,
                rv=zi, j0=zi, ns=zi))
        cont = is_parent & (di > 0) \
            & torch.where(allow, j0 + K < ns, torch.ones_like(allow))
        blocks.append(dict(
            mask=cont,
            p=pos, d=surf_d, intensity=di, tint=q["tint"],
            depth=q["depth"], sample_id=q["sample_id"],
            kind=torch.full((B,), 2, dtype=torch.int64, device=dev),
            aux_prj=q["aux_prj"], aux_t=q["aux_t"], aux_a=q["aux_a"],
            aux_b=q["aux_b"], rv=q["rv"],
            j0=torch.where(allow, j0 + K, j0), ns=ns))
        return blocks

    # ------------------------------------------------------------------

    def _camera_rays_dev(self, pos_xy):
        """Primary camera rays on the device (lum_machine_s_func,
        reference src/scene.c:958-996) from [N,2] subpixel positions."""
        cfg, ir = self.cfg, self.ir
        unit = float(self.dtype.type(1.0 / (cfg.image_height >> 1)))
        x = unit * (pos_xy[:, 0] - (cfg.image_width >> 1))
        z = unit * ((cfg.image_height >> 1) - pos_xy[:, 1])
        d = torch.stack([x, torch.full_like(x, cfg.camera_focal_length), z],
                        dim=-1)
        d = _norm3(d)
        d = d @ self._as(ir.cam_rot).T
        p = self._as(ir.cam_pos).expand(d.shape)
        return p, d

    def run_samples(self, pos_xy: np.ndarray) -> np.ndarray:
        """Render primary camera samples at subpixel positions [N,2]
        (x, y); returns per-sample radiance [N,3] (f64, un-saturated).
        The device drain builds the rays on the device; with
        device_drain = False the host makes them (driver.camera_rays, in
        f64 rounded to the working type) and run() drains them."""
        n = len(pos_xy)
        if self.device_drain:
            return self.run_device(None, n, pos_xy=pos_xy)
        from actinon_tpu_torch.render.driver import camera_rays
        p, d = camera_rays(self.ir, np.asarray(pos_xy, np.float64),
                           self.dtype)
        primary = RayQueue(
            p, d, np.ones(n, self.dtype), np.ones((n, 3), self.dtype),
            np.full(n, self.cfg.trace_depth, np.int32),
            np.arange(n, dtype=np.int32))
        return self.run(primary, n)

    @property
    def _n_child_blocks(self):
        """Child candidate blocks emitted per drain trip: the 3 specular
        branches, plus (path configs) 1 new-parent block + PATH_EXPAND
        path children + 1 parent continuation."""
        return 3 if self.path_cap == 0 else 5 + PATH_EXPAND

    def _fields(self):
        base = ("p", "d", "intensity", "tint", "depth", "sample_id")
        if self.path_cap:
            return base + ("kind", "aux_prj", "aux_t", "aux_a", "aux_b",
                           "rv", "j0", "ns")
        return base

    def run_device(self, primary: Optional[RayQueue], n_samples: int,
                   pos_xy: Optional[np.ndarray] = None) -> np.ndarray:
        """Device-resident wavefront drain of n_samples samples: the
        queue, child compaction and accumulation stay on the device; the
        host reads the count once a stage (`_drain`).  With pos_xy
        [n_samples, 2] the primary camera rays are built on the device;
        otherwise the RayQueue `primary` (any rays: sample ids below
        n_samples, its first n_samples rows live) is uploaded.  Path
        configs (path_samples > 0) run the mixed-kind drain."""
        N = n_samples
        # bucket the sample count to a power of two (pad lanes are dead:
        # never popped)
        Np = 1 << int(np.ceil(np.log2(max(N, 64))))
        with spans.span(self.record, "drain.fill"):
            if pos_xy is not None:
                pos = torch.zeros((Np, 2), dtype=self.tdtype,
                                  device=self.device)
                pos[:N] = self._as(np.asarray(pos_xy))
                rows = self._pos_rows(pos, N)
            else:
                if not isinstance(primary, RayQueue):
                    raise TypeError("run_device: a RayQueue or pos_xy needed")
                rows = self._queue_rows(primary)
        acc, dropped, queries, trips = self._drain(rows, N, Np, self.batch)
        with spans.span(self.record, "drain.collect"):
            self.rays_traced += int(queries) * self.per_lane_queries
            self.last_trips = trips
            self._drain_warnings(dropped, trips)
            return acc[:N].to(torch.float64).cpu().numpy()

    def _pos_rows(self, pos, count):
        """Queue rows of the camera samples at subpixel positions `pos`
        [Np, 2]: the first `count` live, the rest dead; sample ids are
        the rows."""
        dt, dev = self.tdtype, self.device
        Np = pos.shape[0]
        p, d = self._camera_rays_dev(pos)
        live = (torch.arange(Np, device=dev) < count).to(dt)
        return dict(
            p=p, d=d, intensity=live, tint=live[:, None].expand(Np, 3),
            depth=torch.full((Np,), int(self.cfg.trace_depth),
                             dtype=torch.int64, device=dev),
            sample_id=torch.arange(Np, device=dev))

    def _queue_rows(self, queue: RayQueue):
        """Queue rows of a host RayQueue, uploaded."""
        dev = self.device
        rows = {k: self._as(getattr(queue, k))
                for k in ("p", "d", "intensity", "tint")}
        for k in ("depth", "sample_id"):
            rows[k] = torch.as_tensor(
                np.asarray(getattr(queue, k), np.int64), device=dev)
        return rows

    def _drain(self, rows, count, Np, B):
        """Drain a queue whose first rows are `rows` (a dict of the six
        ray fields, from _pos_rows or _queue_rows; the first `count` rows
        live) into an accumulator of Np samples (a power of two at least
        the count; sample ids below it), with trips of at most B lanes.

        The JAX package's cascade of while loops: stage k runs trips of
        its batch while the count exceeds the next stage's batch
        (`_stage_loop`), as the replay of its CUDA graph with
        `drain_graphs` (render/graphs.py: a WHILE node, the loop on the
        device) or eagerly (the loop on the host, a read a trip).  The
        host reads the count, the trips and dropped once a stage, to
        choose the next stage (`last_host_reads`).  Returns (acc [Np, 3]
        on the device, dropped rays, live lanes traced as a device
        tensor, trips)."""
        rec = self.record
        C, size = self._queue_size(Np, B)
        with spans.span(rec, "drain.fill"):
            if self.drain_graphs:
                if self._graphs is None:
                    from actinon_tpu_torch.render.graphs import DrainGraphs
                    self._graphs = DrainGraphs(self)
                st = self._graphs.state(C, size)
                run = lambda Bk, thresh: self._graphs.run(st, Bk, thresh)
            else:
                st = self._drain_state(C, size)
                run = lambda Bk, thresh: self._stage_loop(st, Bk, thresh)
            self._fill_state(st, rows, count)
        stages = self._stages(B)
        k, trips, dropped, reads = 0, 0, 0, 0
        while count > 0 and trips < DRAIN_TRIP_CAP:
            while k + 1 < len(stages) and count <= stages[k + 1]:
                k += 1
            with spans.span(rec, "drain.stage"):
                run(stages[k], stages[k + 1] if k + 1 < len(stages) else 0)
            # the stage's one host read, with the gated bodies' runs
            with spans.span(rec, "drain.read"):
                got = torch.cat([torch.stack([st["count"], st["it"],
                                              st["dropped"]]),
                                 st["gates"].runs]).cpu().numpy()
            count, trips, dropped = (int(v) for v in got[:3])
            st["gates"].settle(got[3:])
            reads += 1
        self.last_host_reads = reads
        spans.count(rec, "drain.host_reads", reads)
        return st["acc"][:Np].clone(), dropped, st["queries"].clone(), trips

    def _stages(self, B):
        """The drain's cascade of batch sizes [B, B/8, ...]: the wavefront
        decays geometrically, and stage k runs while the queue holds more
        than stage k+1 takes, so its occupancy stays above 1/8."""
        stages = [B]
        if len(self.tr.composites) <= 32:
            while stages[-1] > 1024:
                stages.append(max(stages[-1] // 8, 512))
        elif B > 1024:
            stages.append(max(B // 32, 512))
        return stages

    def _stage_loop(self, st, Bk, thresh):
        """Trips of Bk lanes on the drain state `st` while its count
        exceeds `thresh` (and the trips stay under DRAIN_TRIP_CAP): the
        JAX drain's while loop of one stage, `cond.while_loop` over
        `_trip` (on the device under a capture)."""
        def body():
            self._trip(st, Bk)
            st["it"].add_(1)
        cond.while_loop(
            lambda: (st["count"] > thresh) & (st["it"] < DRAIN_TRIP_CAP),
            body)

    def _queue_size(self, Np, B):
        """(capacity C, rows) of the drain's queue: path configs queue path
        children transiently, so they get double the slack; the rows
        beyond C take a trip's whole child write-back at any start."""
        cap_fac = 4 if self.path_cap == 0 else 8
        C = 1 << int(np.ceil(np.log2(max(cap_fac * Np, 4 * B))))
        return C, C + self._n_child_blocks * B

    def _drain_state(self, C, size):
        """The device state of a drain: the queue's fields [size, ...], an
        accumulator [C, 3] (a row for every sample id that a queue of
        capacity C admits), 0-d int64 tensors count, it (trips), dropped
        and queries, and the counters of the gated bodies' runs (`gates`,
        render/cond.py); C is the queue's capacity (a python int)."""
        dt, dev = self.tdtype, self.device
        q = dict(
            p=torch.empty((size, 3), dtype=dt, device=dev),
            d=torch.empty((size, 3), dtype=dt, device=dev),
            intensity=torch.empty((size,), dtype=dt, device=dev),
            tint=torch.empty((size, 3), dtype=dt, device=dev),
            depth=torch.empty((size,), dtype=torch.int64, device=dev),
            sample_id=torch.empty((size,), dtype=torch.int64, device=dev))
        if self.path_cap:
            for k in ("kind", "rv", "j0", "ns"):
                q[k] = torch.empty((size,), dtype=torch.int64, device=dev)
            q["aux_prj"] = torch.empty((size, 3), dtype=dt, device=dev)
            for k in ("aux_t", "aux_a", "aux_b"):
                q[k] = torch.empty((size,), dtype=dt, device=dev)
        z = lambda: torch.empty((), dtype=torch.int64, device=dev)
        return dict(q=q, acc=torch.empty((C, 3), dtype=dt, device=dev),
                    count=z(), it=z(), dropped=z(), queries=z(), C=C,
                    gates=cond.Gates(dev))

    def _fill_state(self, st, rows, count):
        """Start a drain in the state `st`, in place: an empty queue (dead
        rows, d = +z) whose first rows are `rows`, `count` of them live,
        and zero accumulator, trips, dropped and queries."""
        for v in st["q"].values():
            v.zero_()
        st["q"]["d"][:, 2] = 1.0
        for k, v in rows.items():
            st["q"][k][:v.shape[0]] = v
        st["acc"].zero_()
        st["count"].fill_(int(count))
        st["it"].zero_()
        st["dropped"].zero_()
        st["queries"].zero_()

    @staticmethod
    def _drain_warnings(dropped, trips):
        if dropped:
            print(f"warning: ray queue overflow, {dropped} rays dropped",
                  flush=True)
        if trips >= DRAIN_TRIP_CAP:
            print(f"warning: drain trip cap ({DRAIN_TRIP_CAP}) reached — "
                  f"wavefront terminated early, image under-rendered",
                  flush=True)

    def _trip(self, st, Bk):
        """One drain trip on the drain state `st` (_drain_state), in place:
        pop up to Bk lanes from the queue's tail, step them, accumulate,
        and compact the children back onto the tail.  Every quantity stays
        on the device (the JAX drain body's form): the trip reads nothing
        back to the host, so render/graphs.py can capture it."""
        dev = self.device
        mixed = self.path_cap > 0
        q, C, count = st["q"], st["C"], st["count"]
        ar = torch.arange(Bk, device=dev)
        s = torch.clamp(count - Bk, min=0)
        take = count - s
        # copies of the popped rows, not views: the write-back below may
        # overwrite them
        lanes = {k: v.index_select(0, s + ar) for k, v in q.items()}
        valid = ar < take
        lanes["intensity"] = torch.where(valid, lanes["intensity"], 0.0)

        sid, contrib, children, _ = self._step(lanes, mixed=mixed)
        _scatter_add(st["acc"], sid, torch.where(valid[:, None], contrib,
                                                 0.0))
        # count only LIVE non-parent lanes (the shared accounting
        # definition, per_lane_queries)
        alive = valid & (lanes["intensity"] > 0)
        if mixed:
            alive = alive & (lanes["kind"] != 2)
        st["queries"].add_(alive.sum())

        ch = list(children.values())
        if mixed:
            # parent expansion under a queue-headroom budget: a trip's
            # specular+new-parent children take <= 4*take rows; each
            # allowed parent adds K+1 more, and parents beyond the budget
            # re-enqueue untouched, so path spawn cannot overflow the
            # queue (the >= 1 floor keeps the drain moving)
            K = PATH_EXPAND
            is_par = valid & (lanes["kind"] == 2)
            allow_n = torch.clamp((C - s - 4 * take) // (K + 1), min=1)
            rank = torch.cumsum(is_par.to(torch.int64), 0) - 1
            allow = is_par & (rank < allow_n)
            ch = ch + self._expand_parents(lanes, allow)
        cmask = torch.cat([c["mask"] & valid & (c["intensity"] > 0)
                           for c in ch])
        # all n candidate rows are written at s: the live children in
        # block order, then dead rows (intensity 0), never popped
        src, live, nv, nv_fit = compact_rows(cmask, C - s)
        at = s + torch.arange(cmask.shape[0], device=dev)
        for f in self._fields():
            v = torch.cat([c[f] for c in ch]).index_select(0, src)
            if f == "intensity":
                v = torch.where(live, v, 0.0)
            q[f].index_copy_(0, at, v.to(q[f].dtype))
        st["dropped"].add_(nv - nv_fit)
        count.copy_(s + nv_fit)

    # ------------------------------------------------------------------

    def run(self, primary: RayQueue, n_samples: int,
            progress=None) -> np.ndarray:
        """Drain the wavefront of the rays in `primary` (sample ids below
        n_samples); returns per-sample radiance [n_samples, 3] (f64,
        un-saturated).  Path configs, and every config with
        device_drain = False, take the host drain; the rest run_device.
        progress(steps, normal queue, path queue) is called after each
        host step."""
        if self.path_cap == 0 and self.device_drain:
            return self.run_device(primary, n_samples)
        return self._run_host(primary, n_samples, self.batch, progress)

    def _run_host(self, primary: RayQueue, n_samples: int, batch: int,
                  progress=None) -> np.ndarray:
        """The host drain (the JAX integrator's `run` loop): a normal and
        a path queue on the host, the longer one stepped first (the path
        queue on ties), in power-of-two buckets of at most `batch` lanes;
        each step's outputs come back in one transfer and add into an f64
        accumulator with np.add.at (a fixed order)."""
        dt = self.dtype
        acc = np.zeros((n_samples, 3), np.float64)
        qn = RayQueue.empty(dt)
        qn.append(primary)
        qp = RayQueue.empty(dt)
        # path batches are wide ([B, path_cap] children): keep B modest
        path_parent_batch = max(1, (1 << 22) // max(self.path_cap, 1)) \
            if self.path_cap else 0
        steps = 0
        while len(qn) or len(qp):
            use_path = len(qp) >= len(qn)
            queue = qp if use_path else qn
            B = min(batch, max(len(queue), 1))
            # bucket B to a power of two, as the JAX drain does to limit
            # its recompiles
            B = 1 << max(int(np.ceil(np.log2(B))), 6)
            n_eff = min(B, len(queue))
            # the shared accounting definition (per_lane_queries)
            self.rays_traced += n_eff * self.per_lane_queries
            got = queue.pop(n_eff).padded(B, dt)
            rows = self._queue_rows(got)
            sid, contrib, children, path_parent = self._to_host(
                self._step(rows, path_ray=use_path))
            np.add.at(acc, sid, contrib.astype(np.float64))
            for ch in children.values():
                self._enqueue(qn, ch)
            if path_parent is not None:
                self._enqueue_paths(qp, path_parent, path_parent_batch)
            steps += 1
            if progress:
                progress(steps, len(qn), len(qp))
        return acc

    def _to_host(self, tree):
        """A nest of dicts, tuples and tensors that share a leading batch
        axis, on the host as numpy arrays of the same types: one
        device-to-host copy (every value widened to f64, which holds the
        working type's floats, the sample ids and the u32 seeds exactly)."""
        leaves = []

        def walk(x):
            if isinstance(x, dict):
                return {k: walk(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(walk(v) for v in x)
            if x is None:
                return None
            leaves.append(x)
            return len(leaves) - 1

        shape = walk(tree)
        n = leaves[0].shape[0]
        flat = torch.cat([t.reshape(n, -1).to(torch.float64)
                          for t in leaves], dim=1).cpu().numpy()
        out, at = [], 0
        for t in leaves:
            w = int(np.prod(t.shape[1:], dtype=np.int64))
            a = flat[:, at:at + w].reshape(t.shape)
            at += w
            if t.dtype == torch.bool:
                a = a != 0
            elif t.is_floating_point():
                a = a.astype(self.dtype)
            else:
                a = a.astype(np.int64)
            out.append(a)

        def build(x):
            if isinstance(x, dict):
                return {k: build(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(build(v) for v in x)
            return None if x is None else out[x]

        return build(shape)

    def _enqueue(self, queue: RayQueue, ch: Dict):
        """Append a child block's live rays.  A depth-0 child still
        contributes background on a miss (reference parent-side miss
        handling, src/scene.c:484-493), so only intensity-0 rays are
        dropped."""
        keep = ch["mask"] & (ch["intensity"] > 0)
        if not keep.any():
            return
        queue.append(RayQueue(
            ch["p"][keep], ch["d"][keep], ch["intensity"][keep],
            ch["tint"][keep], ch["depth"][keep].astype(np.int32),
            ch["sample_id"][keep].astype(np.int32)))

    def _enqueue_paths(self, queue: RayQueue, pp: Dict, pb: int):
        """Spawn the path children of the masked descriptors of `pp`
        (host arrays), `pb` descriptors at a time, and append them."""
        idx = np.flatnonzero(pp["mask"])
        for s in range(0, len(idx), pb):
            sel = idx[s:s + pb]
            sub = {k: torch.as_tensor(v[sel], device=self.device)
                   for k, v in pp.items()}
            ch = self._to_host(self._spawn_paths(sub))
            m = ch["mask"].reshape(-1)
            if not m.any():
                continue
            flat = lambda a: a.reshape((-1,) + a.shape[2:])[m]
            queue.append(RayQueue(
                flat(ch["p"]), flat(ch["d"]), flat(ch["intensity"]),
                flat(ch["tint"]), flat(ch["depth"]).astype(np.int32),
                flat(ch["sample_id"]).astype(np.int32)))
