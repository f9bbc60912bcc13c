"""Recursive transport oracle for validating the wavefront integrator.

PyTorch counterpart of the JAX package's `render/reference_oracle.py`: a
direct, scalar transcription of scene_s_lum (reference
src/scene.c:420-667) running over the port's tracer (batch size 1) and
the same position-seeded counter RNG as the wavefront integrator.
Because hits, RNG streams and formulas are identical, the wavefront's
per-sample radiance must match this oracle to float tolerance, which
validates the recursion->wavefront flattening (intensity/tint
bookkeeping, branch gates, estimator factors, depth budget) in isolation.

Test-only code: O(recursion * samples) tracer calls of one ray each; use
tiny images.
"""

from __future__ import annotations

import numpy as np
import torch

from actinon_tpu_torch import rng as argn
from actinon_tpu_torch.render.integrator import F3_MAG, Integrator
from actinon_tpu_torch.render.tracer import _sphere_first_hit


class RecursiveOracle:
    def __init__(self, integ: Integrator):
        self.integ = integ
        self.tr = integ.tr
        self.cfg = integ.cfg
        self.dt = integ.dtype

    # scalar helpers over the [1]-batch tracer

    def _row(self, v):
        """One vector (or scalar) as a [1, ...] tensor of the tracer."""
        return torch.as_tensor(np.asarray([v], self.dt),
                               device=self.integ.device)

    def _trans_hit(self, p, d, matter_only=False):
        f = self.tr.trans_hit_matter if matter_only else self.tr.trans_hit
        t, exit_nor, enter, exit_ = f(self._row(p), self._row(d))
        return (float(t[0]), exit_nor[0].double().cpu().numpy(),
                int(enter[0]), int(exit_[0]))

    def _shadow_t(self, p, d):
        return float(self.tr.shadow_nearest_t(self._row(p), self._row(d))[0])

    def _albedo(self, oid, pos):
        a = self.integ._albedo(
            torch.tensor([oid], device=self.integ.device), self._row(pos))
        return a[0].double().cpu().numpy()

    def _frame(self, v):
        """transposed(con_z(v)) in f64: columns = frame with z // v."""
        return self.integ._conz_t(self._row(v))[0].double().cpu().numpy()

    def _u(self, rv, ctr):
        return float(argn.uniform(torch.tensor(rv), ctr,
                                  self.integ.tdtype))

    def sample(self, p, d, depth=None):
        """One primary sample (lum_machine_s_func inner loop, reference
        src/scene.c:992-1010): background on miss, else lum()."""
        depth = self.cfg.trace_depth if depth is None else depth
        t, exit_nor, enter, exit_ = self._trans_hit(p, d)
        if not np.isfinite(t):
            return np.asarray(self.integ.background, np.float64).copy()
        return self.lum(p, d, t, exit_nor, enter, exit_, depth, 1.0)

    def lum(self, p, d, t, exit_nor, enter, exit_, depth, intensity):
        cfg = self.cfg
        lum = np.zeros(3)
        if depth == 0 or intensity < cfg.trace_min_intensity:
            return lum
        I = self.integ
        pos = p + d * t

        # emitter
        if enter >= 0 and I.m_radiance[enter] > 0:
            dsq = float(((pos - I.m_pos[enter]) ** 2).sum())
            li = I.m_radiance[enter] / dsq if dsq > 0 else F3_MAG
            return self._albedo(enter, pos) * (li * intensity)

        trix = 1.0
        fresnel = chromatic = diffuse = 0.0
        on_a, on_b = 1.0, 0.0
        transparent = False
        if enter >= 0:
            trix = float(I.m_rix[enter])
            # C && semantics (reference src/scene.c:459): 0/1
            fresnel = float(I.m_fresnel[enter] != 0 and I.m_rix[enter] != 1.0)
            chromatic = float(I.m_chromatic[enter])
            diffuse = float(I.m_diffuse[enter])
            transparent = float((I.m_transp[enter] ** 2).sum()) > 0
            sigma = float(I.m_sigma[enter])
            if sigma > 0:
                s2 = sigma * sigma
                on_a = 1.0 - 0.5 * s2 / (s2 + 0.33)
                on_b = 0.45 * s2 / (s2 + 0.09)
        if exit_ >= 0:
            trix = trix / float(I.m_rix[exit_])
            fresnel = 1.0
            diffuse = chromatic = 0.0
            transparent = True

        tmi = cfg.trace_min_intensity

        # fresnel
        if fresnel > 0 and intensity >= tmi:
            R = self._fresnel_reflectance(d, exit_nor, trix) * fresnel
            out_d = self._reflect(d, exit_nor)
            lum += self._branch(pos, out_d, depth - 1, R * intensity)
            intensity *= (1.0 - R)

        # chromatic
        if chromatic > 0 and intensity >= tmi:
            out_d = self._reflect(d, exit_nor)
            l = self._branch(pos, out_d, depth - 1, chromatic * intensity)
            lum += l * self._albedo(enter, pos)
            intensity *= (1.0 - chromatic)

        # diffuse
        di = intensity * diffuse
        if di >= tmi and diffuse > 0:
            surf_d = -exit_nor
            theta_i = float(np.arccos(np.clip(-(d @ surf_d), -1, 1)))
            rp = d - surf_d * (d @ surf_d)
            n = np.linalg.norm(rp)
            ray_prj = rp / n if n > 0 else rp
            rv = int(argn.fold(
                argn.seed_from_v3(torch.as_tensor(pos), 3294479285),
                argn.seed_from_v3(torch.as_tensor(surf_d), 3247146734)))
            lum_l = np.zeros(3)
            for li_i in range(I.n_lights):
                lum_l += self._nee_light(li_i, pos, surf_d, di, theta_i,
                                         on_a, on_b, ray_prj, rv)
            # path tracing
            if cfg.path_samples and depth > 10:
                lum_l += self._path(pos, surf_d, di, theta_i, on_a, on_b,
                                    ray_prj, rv, depth)
            lum += lum_l * self._albedo(enter, pos)
            intensity *= (1.0 - diffuse)

        # refraction
        if transparent and intensity >= tmi:
            out_p = p + d * (t + 2 * self.tr.eps)
            out_d = self._refract(d, exit_nor, trix)
            lum += self._branch(out_p, out_d, depth - 1, intensity)

        # absorption
        if exit_ >= 0 and t > 0:
            lum = lum * np.power(np.maximum(I.m_transp[exit_], 0.0), t)
        return lum

    def _branch(self, out_p, out_d, depth, intensity):
        t, exit_nor, enter, exit_ = self._trans_hit(out_p, out_d)
        if np.isfinite(t):
            return self.lum(out_p, out_d, t, exit_nor, enter, exit_, depth,
                            intensity)
        return np.asarray(self.integ.background, np.float64) * intensity

    def _nee_light(self, li_i, pos, surf_d, di, theta_i, on_a, on_b,
                   ray_prj, rv):
        I = self.integ
        lpos = np.asarray(I.l_pos[li_i], np.float64)
        lrad = float(I.l_rad[li_i])
        lr = float(I.l_radius[li_i])
        lcol = np.asarray(I.l_color[li_i], np.float64)

        if I.l_fov[li_i] == "plane":
            # obj_plane_s_fov (reference src/objects.c:520-526)
            fov_d = -np.asarray(I.l_plane_n[li_i], np.float64)
            cos_rs = 0.0 if float((lpos - pos) @ fov_d) > 0 else 1.0
        else:
            cpos = lpos if I.l_sphere_exact[li_i] \
                else np.asarray(I.l_cone_pos[li_i], np.float64)
            diff = cpos - pos
            dist2 = float(diff @ diff)
            fov_d = diff / np.sqrt(dist2)
            r2 = lr * lr
            cos_rs = np.sqrt(max(1.0 - r2 / dist2, 0.0)) \
                if dist2 > r2 else -1.0
        cyl = 1.0 - cos_rs
        frame = self._frame(fov_d)

        ns = int(self.cfg.direct_samples * di)
        ns = max(min(ns, I.direct_cap), 1)
        cl_sum = np.zeros(3)
        for j in range(ns):
            u1 = self._u(rv, 4 * (li_i * I.direct_cap + j))
            u2 = self._u(rv, 4 * (li_i * I.direct_cap + j) + 1)
            phi = 2.0 * np.pi * u1
            z = 1.0 - u2 * cyl
            sc = np.sqrt(max(1.0 - z * z, 0.0))
            out_d = frame @ np.array([np.sin(phi) * sc, np.cos(phi) * sc, z])
            w = float(out_d @ surf_d)
            if w <= 0:
                continue
            # true light-geometry hit (obj_ray_hit(light_src, ...),
            # reference src/scene.c:564)
            if I.l_sphere_exact[li_i]:
                a = float(_sphere_first_hit(
                    self._row(lpos)[0], float(self.dt.type(lr)),
                    self._row(pos), self._row(out_d), self.tr.eps)[0])
            else:
                a = float(self.tr.object_hit_t(
                    I.l_oid[li_i], self._row(pos), self._row(out_d))[0])
            if not np.isfinite(a):
                continue
            if on_b > 0:
                w = self._oren_nayar(w, theta_i, on_a, on_b, out_d, surf_d,
                                     ray_prj)
            if self._shadow_t(pos, out_d) > a:
                hp = pos + out_d * a
                dsq = float(((hp - lpos) ** 2).sum())
                loc = lrad / dsq if dsq > 0 else F3_MAG
                cl_sum += lcol * (loc * w * di)
        return cl_sum * (2.0 * cyl / ns)

    def _path(self, pos, surf_d, di, theta_i, on_a, on_b, ray_prj, rv,
              depth):
        I = self.integ
        frame = self._frame(surf_d)
        ns = int(self.cfg.path_samples * di)
        ns = max(min(ns, I.path_cap), 1)
        base = 4 * I.direct_cap * max(I.n_lights, 1)
        cl_sum = np.zeros(3)
        for j in range(ns):
            u1 = self._u(rv, base + 2 * j)
            u2 = self._u(rv, base + 2 * j + 1)
            phi = 2.0 * np.pi * u1
            z = 1.0 - u2
            sc = np.sqrt(max(1.0 - z * z, 0.0))
            out_d = frame @ np.array([np.sin(phi) * sc, np.cos(phi) * sc, z])
            w = float(out_d @ surf_d)
            if w <= 0:
                continue
            if on_b > 0:
                w = self._oren_nayar(w, theta_i, on_a, on_b, out_d, surf_d,
                                     ray_prj)
            t, exit_nor, enter, exit_ = self._trans_hit(pos, out_d,
                                                        matter_only=True)
            if np.isfinite(t) and t < self.cfg.max_path_length:
                cl_sum += self.lum(pos, out_d, t, exit_nor, enter, exit_,
                                   depth - 10, w * di)
            else:
                cl_sum += np.asarray(self.integ.background,
                                     np.float64) * (w * di)
        return cl_sum * (2.0 / ns)

    # math (identical formulas to the integrator)

    def _reflect(self, d, n):
        r = d - n * (2.0 * (d @ n))
        ln = np.linalg.norm(r)
        return r / ln if ln > 0 else r

    def _fresnel_reflectance(self, d, exit_nor, trix):
        c = float(d @ exit_nor)
        f = trix if c < 0 else 1.0 / trix
        cos_ai = min(abs(c), 1.0)
        sin_at = np.sqrt(1.0 - cos_ai ** 2) * f
        if sin_at >= 1.0:
            return 1.0
        cos_at = np.sqrt(1.0 - sin_at ** 2)
        rs = ((f * cos_ai - cos_at) / (f * cos_ai + cos_at)) ** 2
        rp = ((f * cos_at - cos_ai) / (f * cos_at + cos_ai)) ** 2
        return (rs + rp) * 0.5

    def _refract(self, d, exit_nor, trix):
        c = float(d @ exit_nor)
        f = trix if c < 0 else 1.0 / trix
        q = f * f * (1.0 - c * c)
        if q < 1.0:
            b = -f * c + (np.sqrt(1.0 - q) if c > 0 else -np.sqrt(1.0 - q))
            return d * f + exit_nor * b
        return d.copy()

    def _oren_nayar(self, w, theta_i, on_a, on_b, out_d, nor, ray_prj):
        theta_r = float(np.arccos(np.clip(w, -1, 1)))
        proj = out_d - nor * (out_d @ nor)
        n = np.linalg.norm(proj)
        proj = proj / n if n > 0 else proj
        cos_phi = -float(proj @ ray_prj)
        return w * (on_a + on_b * max(cos_phi, 0.0)
                    * np.sin(max(theta_i, theta_r))
                    * np.tan(min(theta_i, theta_r)))
