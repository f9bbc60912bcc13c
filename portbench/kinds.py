"""The general traffic generator: each traffic file under
`portbench/traffic/` names one of these kinds and gives its parameters.
A kind sets the program up from a configuration, runs one unit of work
(an image) at a time from the seed, and judges what the timed units
produced against the configuration's plain reference.

A kind is found by name (`harness.cell_kind`): in `KINDS`, else as the
class `KIND` of `portbench/traffic/<kind>.py`, which may build on the
classes here.  It is made as cls(config, traffic, seed, root, device,
reference) and provides setup(tmpdir), run_unit(k), free(),
judge(device, control=False, diag=False) and close().

The reference is the module at the configuration's optional key
"reference", a path from the root of the checkout, and
`portbench/reference.py` without one (`harness.reference`).  A scene
reference provides
  * Scene(config, device, dtype=torch.float64), with
    with_camera(position) (returns the scene) and in_float32() (the
    scene in float32 at the same camera, which the control runs under
    Bf16);
  * Render(scene, seed).radiance(pos): the radiance [N, 3], a numpy
    array, of the samples at sub-pixel positions pos [N, 2], drawn with
    the reference's own random numbers from seed.
The driver's rules belong to the renderer and not to a scene, and stay
in `reference.py` alone: LCG_START, lcg_positions, sqr_grad, saturated
and the control's Bf16; a new reference imports what it needs of them
from there."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from reference import (LCG_START, Bf16, lcg_positions, saturated,
                       sqr_grad)


def _seed(seed, *keys):
    """A numpy generator of the seed (any whole number) and keys."""
    return np.random.default_rng([seed & ((1 << 64) - 1), *keys])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def program_scene(path, render):
    """The scene of an `.acn` file through the program's front end, with
    the configuration's render settings, and the seconds the load took."""
    from actinon_tpu_torch.acn.interp import run_file
    cap = []
    t0 = time.perf_counter()
    run_file(path, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0].clone()
    for k, v in render.items():
        setattr(sc.cfg, k, tuple(v) if isinstance(v, list) else v)
    return sc, time.perf_counter() - t0


class Cell:
    """What every kind shares: the cell's parameters, the seed and where
    the units and the checks go."""

    def __init__(self, config, traffic, seed, root, device, reference):
        self.config = config
        self.reference = reference
        self.batch = config["batch"]
        self.check = config["check"]
        self.scene_path = os.path.join(root, config["scene"])
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.kept = []          # what each unit produced, for the judge

    def picks(self, n_units, n):
        """The indices of the n units to judge, drawn from the seed."""
        r = _seed(self.seed, 7)
        return sorted(r.choice(n_units, size=min(n, n_units),
                               replace=False).tolist())


class RenderFrames(Cell):
    """A fly-through: image k is one `render_scene` call of the whole
    image, every pass the scene asks for, from a loop of `frames` camera
    positions, each moved by an offset of at most `camera_jitter` of its
    distance from the origin.  The positions are the same for every
    seed (so that every run renders the same work); the seed draws the
    order of the loop."""

    def setup(self, tmpdir):
        from actinon_tpu_torch.render import integrator
        self.base, self.scene_load_s = program_scene(self.scene_path,
                                                     self.config["render"])
        self.cam0 = np.asarray(self.base.cfg.camera_position, np.float64)
        self.out = os.path.join(tmpdir, "portbench_image.pnm")
        # each pass's positions and radiance, as the integrator hands them
        # to the driver
        cls = integrator.Integrator
        orig = cls.run_samples
        self.passes = []

        def run_samples(integ, pos_xy):
            lum = orig(integ, pos_xy)
            self.passes.append((pos_xy, lum))
            return lum

        cls.run_samples = run_samples
        self._restore = lambda: setattr(cls, "run_samples", orig)
        self.render(self.base.clone())

    def close(self):
        self._restore()
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.out)

    def camera(self, k):
        n = self.traffic["frames"]
        r = np.random.default_rng([0, int(_seed(self.seed, 1)
                                          .permutation(n)[k % n])])
        v = r.normal(size=3)
        rad = self.traffic["camera_jitter"] * np.linalg.norm(self.cam0)
        return self.cam0 + v / np.linalg.norm(v) * rad * r.random() ** (1 / 3)

    def scene_at(self, k):
        sc = self.base.clone()
        sc.cfg.camera_position = self.camera(k)
        return sc

    def render(self, sc):
        from actinon_tpu_torch.render.driver import render_scene
        stats = {}
        self.passes = []
        img = render_scene(sc, self.out, force=True, dtype=np.float32,
                           batch=self.batch, verbose=False,
                           device=self.device, stats=stats)
        _sync(self.device)
        return img, stats

    def run_unit(self, k):
        sc = self.scene_at(k)
        t0 = time.perf_counter()
        img, stats = self.render(sc)
        wall = time.perf_counter() - t0
        self.kept.append((k, img, self.passes))
        return dict(wall_s=wall, seconds=stats["seconds"],
                    rays_traced=stats["rays_traced"], trips=stats["trips"])

    def free(self):
        self.base = None

    def judge(self, ref_device, control=False, diag=False):
        """The numbers compared (judge_image) of each image drawn from
        the seed."""
        out = []
        for i in self.picks(len(self.kept), self.check["images"]):
            k, img, passes = self.kept[i]
            sc = self.reference.Scene(self.config, ref_device)
            sc.with_camera(self.camera(k))
            out.append(judge_image(self.reference, sc, img, passes,
                                   self.check["tile"],
                                   (self.seed & ((1 << 62) - 1), k),
                                   control, diag))
        return out


def judge_image(reference, sc, img, passes, tile, key, control=False,
                diag=False):
    """One image of the program (img [H, W, 3]; passes: each pass's
    positions [N, 2] and radiance [N, 3]) against the driver's rules and
    the scene reference `reference` (the module; sc its Scene):
      positions_off: the positions of the passes that differ from the
        rules (pass 0: every pixel centre in row order; pass c: the LCG's
        sub-samples of the pixels whose squared gradient in the image of
        the passes before exceeds the threshold's square), a pass too many
        or too few counting as all of its positions;
      image_off: the largest gap of the image to the mean of each pixel's
        displayed sample values;
      radiance_z_max, radiance_z2_mean: over tiles of tile x tile pixels
        and the 3 channels, the gap of the mean displayed sample value to
        the reference's at the same positions, over its standard error
        (the reference's Render draws twice, and the two draws'
        differences give the samples' variance): the largest |z| and the
        mean z*z.
    With control, the reference in bfloat16 takes the program's place in
    the radiance numbers; with diag, what the worst tile holds is added
    (radiance_z)."""
    cfg = sc.cfg
    W, H = cfg["image_width"], cfg["image_height"]
    per_px, gamma = cfg["gradient_samples"], cfg["gamma"]
    ys, xs = np.mgrid[0:H, 0:W]
    want = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    clr = np.zeros((H, W, 3))
    weight = np.zeros((H, W))
    off = 0
    state = LCG_START
    pos_all, lum_all = [], []
    for c in range(cfg["gradient_cycles"] + 1):
        if c:
            avg = clr / np.where(weight > 0, weight, 1.0)[..., None]
            sel = np.argwhere(sqr_grad(avg)
                              > cfg["gradient_threshold"] ** 2)[:, ::-1]
            want, state = lcg_positions(sel, per_px, state)
        if c >= len(passes):
            off += len(want)
            continue
        pos, lum = passes[c]
        if pos.shape != want.shape:
            off += max(len(pos), len(want))
        else:
            off += int(np.sum(np.any(pos != want, -1)))
        sat = saturated(lum, gamma)
        px = pos.astype(np.int64)
        np.add.at(clr, (px[:, 1], px[:, 0]), sat)
        np.add.at(weight, (px[:, 1], px[:, 0]), 1.0)
        pos_all.append(pos)
        lum_all.append(lum)
    off += sum(len(p) for p, _ in passes[cfg["gradient_cycles"] + 1:])
    mean = clr / np.where(weight > 0, weight, 1.0)[..., None]
    image_off = float(np.max(np.abs(img - mean)))

    pos = np.concatenate(pos_all)
    seed = key[0] * 1000003 + key[1]
    with torch.no_grad():
        r1 = reference.Render(sc, seed * 4 + 1).radiance(pos)
        r2 = reference.Render(sc, seed * 4 + 2).radiance(pos)
        if control:
            # the scene's numbers in float32, every operation on them in
            # bfloat16
            lo = sc.in_float32()
            with Bf16():
                got = reference.Render(lo, seed * 4 + 3).radiance(pos)
        else:
            got = np.concatenate(lum_all)
    z, worst = radiance_z(pos, saturated(got, gamma), saturated(r1, gamma),
                          saturated(r2, gamma), tile)
    out = dict(positions_off=float(off), image_off=image_off,
               radiance_z_max=float(np.max(np.abs(z))),
               radiance_z2_mean=float(np.mean(z * z)))
    return dict(out, **worst) if diag else out


def radiance_z(pos, got, r1, r2, tile, floor=1e-4):
    """z [tiles, 3]: per tile and channel, the gap of the mean of got to
    the mean of the two reference draws over its standard error,
    sqrt(1.5 s2 / n + floor**2), s2 the tile's mean of each sample's
    variance over its three draws (got, r1, r2: one estimator's draws
    where the program is sound); and what the worst tile holds."""
    px = pos.astype(np.int64) // tile
    ids = px[:, 1] * (int(px[:, 0].max()) + 1) + px[:, 0]
    _, t = np.unique(ids, return_inverse=True)
    t = t.reshape(-1)
    n = np.bincount(t).astype(np.float64)[:, None]
    s = lambda v: np.stack([np.bincount(t, v[:, j]) for j in range(3)], -1)
    gap = (s(got) - s((r1 + r2) / 2)) / n
    m = (got + r1 + r2) / 3
    s2 = s(((got - m) ** 2 + (r1 - m) ** 2 + (r2 - m) ** 2) / 2) / n
    z = gap / np.sqrt(1.5 * s2 / n + floor ** 2)
    i, c = np.unravel_index(np.argmax(np.abs(z)), z.shape)
    z_ref = gap / np.sqrt(1.5 * s(((r1 - r2) ** 2) / 2) / n / n
                          + floor ** 2)
    at = t == i
    worst = dict(worst_n=float(n[i, 0]), worst_gap=float(gap[i, c]),
                 worst_sd=float(np.sqrt(s2[i, c])),
                 worst_clipped=[float(np.sum(v[at, c] >= 1.0))
                                for v in (got, r1, r2)],
                 z_max_ref_var=float(np.max(np.abs(z_ref))))
    return z, worst


KINDS = {"render_frames": RenderFrames}
