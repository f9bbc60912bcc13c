"""The plain reference: the configuration's scene traced in plain PyTorch
from the numbers of its JSON file, written from the published scene and
the renderer's transport rules, not from the program.  It imports
nothing of the program and takes nothing the program made.

The scene is a set of solids, each the intersection of half-spaces
n . x <= c.  A sample's radiance follows the renderer's rules for opaque
Lambertian surfaces and lights that are solids with a radiance:

  * a camera ray that misses everything sees the background;
  * one that enters a light sees its colour times radiance / dsq, dsq
    the squared distance of the hit to the light's radiance centre;
  * at a surface with intensity i, each light is sampled by
    max(min(floor(direct * i), direct), 1) directions uniform in the cone
    from the hit point around the light's bounding sphere (1 - cos of
    its half-angle = cyl); a direction towards the surface's side whose
    first matter hit lies beyond its first crossing of the light's
    boundary (from inside too) adds the light's
    colour times radiance / dsq times cos times i, and the sum counts
    2 cyl / (number of directions);
  * with path samples, while the depth exceeds 10, max(min(floor(path *
    i), path), 1) directions uniform over the surface's hemisphere each
    carry intensity cos * i and depth - 10 to the first matter hit (lights
    are not seen), or see the background times cos * i; the sum counts
    2 / (number of directions);
  * what a surface gathers is multiplied by its colour.

The random numbers are the reference's own (a torch.Generator seeded by
the caller): the reference's radiance of a sample is another draw of
the same estimator, so the program is judged by statistics over many
samples (kinds.radiance_checks), not sample by sample.

`Bf16` is the control: every floating result of a torch operation
rounded to bfloat16, the precision below the configuration's float32."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# the gradient passes' sub-sample generator: the sequential 64-bit LCG of
# the renderer's driver and its first state
LCG_START = 21943294
_MUL = 6364136223846793005
_ADD = 1442695040888963407
_MASK = (1 << 64) - 1


def lcg_positions(sel_xy, per_px, state=LCG_START):
    """(positions [K*per_px, 2], the LCG's state after them) of a gradient
    pass for the selected pixels sel_xy [K, 2] (x, y) in row order, per_px
    each, (x, y) offsets drawn in turn from the LCG, each its state over
    2**64 - 1."""
    inv = 1.0 / float(_MASK)
    out = np.empty((len(sel_xy) * per_px, 2), np.float64)
    k = 0
    for x, y in sel_xy.tolist():
        for _ in range(per_px):
            state = (state * _MUL + _ADD) & _MASK
            dx = float(state) * inv
            state = (state * _MUL + _ADD) & _MASK
            dy = float(state) * inv
            out[k] = (x + dx, y + dy)
            k += 1
    return out, state


def saturated(lum, gamma):
    """A sample's displayed value: max(lum, 0) ** gamma, clipped to 1."""
    return np.clip(np.power(np.maximum(lum, 0.0), gamma), 0.0, 1.0)


def sqr_grad(avg):
    """Per pixel, the largest squared colour difference [H, W] to one of
    its 8 neighbours inside the image."""
    H, W = avg.shape[:2]
    out = np.zeros((H, W))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                a = avg[max(0, -dy):H + min(0, -dy),
                        max(0, -dx):W + min(0, -dx)]
                b = avg[max(0, dy):H + min(0, dy),
                        max(0, dx):W + min(0, dx)]
                o = out[max(0, -dy):H + min(0, -dy),
                        max(0, -dx):W + min(0, -dx)]
                np.maximum(o, ((a - b) ** 2).sum(-1), out=o)
    return out


class Bf16(TorchFunctionMode):
    """Rounds every floating tensor a torch function returns to bfloat16
    and back: the reference computed in bfloat16 (the control).  An
    in-place op and a view keep their result (the next op rounds it)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name.endswith("_") or name.startswith("__i") \
                or name in ("__setitem__", "detach", "__get__"):
            return out
        return _round(out)


def _round(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point() \
            and x.dtype != torch.bfloat16:
        with torch._C.DisableTorchFunction():
            return x.to(torch.bfloat16).to(x.dtype)
    if isinstance(x, (tuple, list)):
        return type(x)(_round(v) for v in x)
    return x


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def solids(config):
    """The scene's solids from the configuration's published numbers:
    [(name, [(n, c), ...])] with inside n . x <= c, the light's slab last,
    then the light's radiance centre and bounding sphere (centre, radius),
    all in scene units."""
    u = config["unit_mm"]
    room = {k: [v * u for v in r] for k, r in config["room_mm"].items()}
    front = ((0, 0, -1), 0.0)                           # z >= 0
    out = [
        ("floor", [((0, 1, 0), room["y"][0]), front]),
        ("ceiling", [((0, -1, 0), -room["y"][1]), front]),
        ("back", [((0, 0, -1), -room["z"][1])]),
        ("left", [((-1, 0, 0), -room["x"][1]), front]),
        ("right", [((1, 0, 0), room["x"][0]), front]),
    ]
    for b in config["blocks_mm"]:
        xz = np.asarray(b["corners_xz"], np.float64) * u
        mid = xz.mean(0)
        planes = [((0, -1, 0), 0.0), ((0, 1, 0), b["top"] * u)]
        for i in range(len(xz)):
            a, c = xz[i], xz[(i + 1) % len(xz)]
            n = np.array([c[1] - a[1], 0.0, a[0] - c[0]])
            if n[[0, 2]] @ ((a + c) / 2 - mid) < 0:
                n = -n
            n = _unit(n)
            planes.append((tuple(n), float(n[[0, 2]] @ a)))
        out.append((b["name"], planes))
    lt = config["light_mm"]
    x0, x1 = (v * u for v in lt["x"])
    z0, z1 = (v * u for v in lt["z"])
    y0, y1 = (v * u for v in lt["y"])
    out.append(("light", [((0, -1, 0), -y0), ((0, 1, 0), y1),
                          ((-1, 0, 0), -x0), ((1, 0, 0), x1),
                          ((0, 0, -1), -z0), ((0, 0, 1), z1)]))
    centre = np.array([(x0 + x1) / 2, lt["centre_y"] * u, (z0 + z1) / 2])
    sphere = (np.array([(x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2]),
              lt["envelope"] * u)
    return out, centre, sphere


class Scene:
    """The scene on a device in one floating type: K half-spaces a solid
    (unused ones n = 0, c = 1), the light last."""

    def __init__(self, config, device, dtype=torch.float64):
        self.config, self.cfg = config, config["render"]
        self.device, self.dtype = device, dtype
        sol, centre, (env_c, env_r) = solids(config)
        cols = config["colours"]
        K = max(len(p) for _, p in sol)
        n = np.zeros((len(sol), K, 3))
        c = np.ones((len(sol), K))
        for i, (_, planes) in enumerate(sol):
            for k, (nk, ck) in enumerate(planes):
                n[i, k], c[i, k] = nk, ck
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      dtype=dtype, device=device)
        self.n, self.c = t(n), t(c)
        self.colour = t([cols[config["materials"][name]]
                         for name, _ in sol])
        self.light = len(sol) - 1
        self.l_centre, self.l_env_c = t(centre), t(env_c)
        self.l_env_r = float(env_r)
        self.l_rad = float(config["radiance"])
        self.background = t(self.cfg["background_color"])
        self.eps = 1e-6 if dtype == torch.float64 else 1e-4
        cam = config["camera_mm"]
        u = config["unit_mm"]
        self.cam_pos = np.asarray(cam["position"], np.float64) * u
        self.focal = cam["focal_length_mm"] / (cam["film_mm"] / 2)
        fwd = _unit(cam["direction"])
        up = np.asarray(cam["up"], np.float64)
        up = _unit(up - fwd * (fwd @ up))
        self.cam_axes = np.stack([np.cross(fwd, up), fwd, up])

    def with_camera(self, position):
        self.cam_pos = np.asarray(position, np.float64)
        return self

    def in_float32(self):
        """The scene in float32 at the same camera (the control runs it
        under Bf16)."""
        return Scene(self.config, self.device,
                     torch.float32).with_camera(self.cam_pos)

    def camera_rays(self, pos):
        """Rays [N, 3] through sub-pixel positions pos [N, 2] (x right,
        y down): the film spans the image height at distance `focal`
        from the eye, centred on pixel (W // 2, H // 2)."""
        W, H = self.cfg["image_width"], self.cfg["image_height"]
        s = 1.0 / (H // 2)
        a = (pos[:, 0] - W // 2) * s
        b = (H // 2 - pos[:, 1]) * s
        d = np.stack([a, np.full_like(a, self.focal), b], -1) @ self.cam_axes
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = np.broadcast_to(self.cam_pos, d.shape)
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                      dtype=self.dtype, device=self.device)
        return t(p), t(d)

    def enter(self, p, d, which, crossing=False):
        """Per ray, the distance at which it enters each solid of `which`
        [R, O] (inf where it does not, or only behind eps), and the
        index of the half-space it enters through.  With crossing, a ray
        that starts inside takes the distance at which it leaves."""
        n, c = self.n[which], self.c[which]
        nd = torch.einsum("rj,okj->rok", d, n)
        npos = torch.einsum("rj,okj->rok", p, n)
        t = (c - npos) / torch.where(nd == 0, torch.ones_like(nd), nd)
        inf = torch.full_like(t, math.inf)
        t_in, k_in = torch.where(nd < 0, t, -inf).max(-1)
        t_out = torch.where(nd > 0, t, inf).min(-1).values
        never = ((nd == 0) & (npos > c)).any(-1)
        cross = (t_in <= t_out) & ~never
        ok = cross & (t_in > self.eps)
        if crossing:
            # the first crossing of the boundary, the way out from inside
            out = cross & ~ok & (t_out > self.eps)
            t_in = torch.where(out, t_out, t_in)
            ok = ok | out
        return torch.where(ok, t_in, inf[..., 0]), k_in

    def first(self, p, d, matter_only, chunk=1 << 20):
        """(t, solid, outward normal) of each ray's first entry; t = inf
        where it hits nothing."""
        O = self.n.shape[0] - (1 if matter_only else 0)
        which = torch.arange(O, device=self.device)
        ts, os_, ns = [], [], []
        for a in range(0, p.shape[0], chunk):
            t, k = self.enter(p[a:a + chunk], d[a:a + chunk], which)
            tmin, o = t.min(-1)
            kk = k.gather(1, o[:, None])[:, 0]
            ts.append(tmin), os_.append(o), ns.append(self.n[o, kk])
        if not ts:
            e = p.new_zeros((0,))
            return e, e.long(), p.new_zeros((0, 3))
        return torch.cat(ts), torch.cat(os_), torch.cat(ns)


def _frame(z):
    """Two unit vectors [R, 3] that make an orthonormal frame with z."""
    a = torch.where(z[:, :1].abs() < 0.9,
                    torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype,
                                 device=z.device),
                    torch.tensor([0.0, 1.0, 0.0], dtype=z.dtype,
                                 device=z.device))
    x = torch.linalg.cross(a, z)
    x = x / x.norm(dim=-1, keepdim=True)
    return x, torch.linalg.cross(z, x)


def _directions(z, u1, u2, cyl):
    """Directions uniform in the cone around z whose 1 - cos of the
    half-angle is cyl: cos = 1 - u2 cyl, azimuth 2 pi u1."""
    ct = 1.0 - u2 * cyl
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    ph = 2.0 * math.pi * u1
    x, y = _frame(z)
    return x * (torch.cos(ph) * st)[:, None] + \
        y * (torch.sin(ph) * st)[:, None] + z * ct[:, None]


class Render:
    """Per-sample radiance of camera samples, in chunks of rows."""

    def __init__(self, scene, seed, chunk=1 << 18):
        self.s = scene
        self.g = torch.Generator(device=scene.device)
        self.g.manual_seed(seed & ((1 << 63) - 1))
        self.chunk = chunk

    def _rand(self, n):
        return torch.rand(n, generator=self.g, dtype=self.s.dtype,
                          device=self.s.device)

    def radiance(self, pos):
        """Radiance [N, 3] (numpy f64) of the samples at pos [N, 2]."""
        out = [self._camera(pos[i:i + self.chunk])
               for i in range(0, len(pos), self.chunk)]
        return np.concatenate(out) if out else np.zeros((0, 3))

    def _camera(self, pos):
        s = self.s
        p, d = s.camera_rays(pos)
        N = p.shape[0]
        lum = torch.zeros((N, 3), dtype=s.dtype, device=s.device)
        t, o, nrm = s.first(p, d, matter_only=False)
        hit = torch.isfinite(t)
        lum[~hit] = s.background
        x = p + d * torch.where(hit, t, torch.zeros_like(t))[:, None]
        lit = hit & (o == s.light)
        dsq = ((x[lit] - s.l_centre) ** 2).sum(-1)
        lum[lit] = s.colour[s.light] * (s.l_rad / dsq)[:, None]
        m = hit & ~lit
        rows = torch.nonzero(m)[:, 0]
        ones = torch.ones(len(rows), dtype=s.dtype, device=s.device)
        self._surfaces(lum, rows, x[m], nrm[m], o[m], ones[:, None]
                       .expand(-1, 3), ones, int(s.cfg["trace_depth"]))
        return lum.double().cpu().numpy()

    def _surfaces(self, lum, rows, x, nrm, o, T, inten, depth):
        """Adds what surfaces at x (outward normal nrm, solid o) gather,
        carried to their samples `rows` by the weights T [R, 3], at
        intensity inten and depth; then the path level below them."""
        s, cfg = self.s, self.s.cfg
        if depth == 0 or not len(rows):
            return
        keep = inten >= cfg["trace_min_intensity"]
        rows, x, nrm, o, T, inten = (v[keep] for v in
                                     (rows, x, nrm, o, T, inten))
        alb = s.colour[o]
        lum.index_add_(0, rows, T * alb * self._nee(x, nrm, inten))
        P = int(cfg["path_samples"])
        if not P or depth <= 10 or not len(rows):
            return
        ns = torch.clamp(torch.floor(P * inten), 1, P).long()
        par = torch.repeat_interleave(torch.arange(len(rows),
                                                   device=s.device), ns)
        z = nrm[par]
        u1, u2 = self._rand(len(par)), self._rand(len(par))
        dirs = _directions(z, u1, u2, torch.ones_like(u1))
        w = (dirs * z).sum(-1)
        up = w > 0
        par, dirs, w = par[up], dirs[up], w[up]
        start = x[par]
        Tc = T[par] * alb[par] * (2.0 / ns[par])[:, None]
        ic = w * inten[par]
        t, oc, nc = s.first(start, dirs, matter_only=True)
        far = ~(torch.isfinite(t) & (t < cfg["max_path_length"]))
        lum.index_add_(0, rows[par[far]],
                       Tc[far] * s.background * ic[far][:, None])
        near = ~far
        xc = start[near] + dirs[near] * t[near][:, None]
        self._surfaces(lum, rows[par[near]], xc, nc[near], oc[near],
                       Tc[near], ic[near], depth - 10)

    def _nee(self, x, nrm, inten):
        """The light's term [R, 3] at surfaces x, before their colour."""
        s = self.s
        D = max(int(s.cfg["direct_samples"]), 1)
        if not x.shape[0]:
            return torch.zeros((0, 3), dtype=s.dtype, device=s.device)
        to = s.l_env_c - x
        dist2 = (to * to).sum(-1)
        fov = to / torch.sqrt(dist2)[:, None]
        r2 = s.l_env_r ** 2
        cos_rs = torch.where(dist2 > r2,
                             torch.sqrt(torch.clamp(1.0 - r2 / dist2,
                                                    min=0.0)),
                             torch.full_like(dist2, -1.0))
        cyl = 1.0 - cos_rs
        ns = torch.clamp(torch.floor(D * inten), 1, D).long()
        acc = torch.zeros_like(dist2)
        step = max(1, self.chunk * 4 // D)
        for a in range(0, x.shape[0], step):
            sl = slice(a, a + step)
            par = torch.repeat_interleave(
                torch.arange(a, min(a + step, x.shape[0]),
                             device=s.device), ns[sl])
            u1, u2 = self._rand(len(par)), self._rand(len(par))
            dirs = _directions(fov[par], u1, u2, cyl[par])
            w = (dirs * nrm[par]).sum(-1)
            start = x[par]
            lt, _ = s.enter(start, dirs, torch.tensor([s.light],
                                                       device=s.device),
                            crossing=True)
            lt = lt[:, 0]
            mt, _, _ = s.first(start, dirs, matter_only=True)
            ok = (w > 0) & torch.isfinite(lt) & (mt > lt)
            hp = start + dirs * torch.where(ok, lt,
                                            torch.zeros_like(lt))[:, None]
            dsq = ((hp - s.l_centre) ** 2).sum(-1)
            term = torch.where(ok, s.l_rad / dsq * w * inten[par],
                               torch.zeros_like(w))
            acc.index_add_(0, par, term)
        return s.colour[s.light] * (acc * 2.0 * cyl / ns)[:, None]
