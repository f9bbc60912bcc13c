"""Render driver: progressive/adaptive pass loop, accumulation,
checkpoint/resume, PNM + hash output.  The port's own driver: the JAX
package's `render/driver.py` with this package's Integrator and Tracer.

Counterpart of scene_s_create_image_file (reference src/scene.c:1032-1165):
  * pass 0 samples every pixel center (+0.5, +0.5)
  * passes 1..gradient_cycles re-sample only pixels whose 8-neighbour
    squared color gradient exceeds gradient_threshold^2, with
    `gradient_samples` random subpixel positions each, drawn from a
    sequential LCG carried across passes (resume-exact)
  * every pass merges into the accumulator and rewrites the PNM + prints
    the image hash (the reference's regression oracle)
  * SIGINT saves the accumulator to <file>.tmp.lum_image.npz; a restart
    with recover=True resumes from it (restarting from scratch if the
    image dimensions changed, reference src/scene.c:1083-1086)
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Optional

import numpy as np

from actinon_tpu_torch.render import image as aimg
from actinon_tpu_torch.render.integrator import Integrator
from actinon_tpu_torch.render.tracer import Tracer
from actinon_tpu_torch.rng import HostLcg
from actinon_tpu_torch.scene import ir as sir


def camera_rays(ir: sir.SceneIR, sample_pos: np.ndarray, dtype):
    """Primary ray directions for subpixel sample positions [N,2] (x,y)
    (lum_machine_s_func, reference src/scene.c:958-996)."""
    cfg = ir.cfg
    unit = 1.0 / (cfg.image_height >> 1)
    x = unit * (sample_pos[:, 0] - (cfg.image_width >> 1))
    z = unit * ((cfg.image_height >> 1) - sample_pos[:, 1])
    d = np.stack([x, np.full_like(x, cfg.camera_focal_length), z], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d @ ir.cam_rot.T
    p = np.tile(ir.cam_pos, (len(d), 1))
    return p.astype(dtype), d.astype(dtype)


def _interactive() -> bool:
    """Prompts fire only on a real terminal (the reference always asks
    on stdin, src/scene.c:1036-1097; batch/CI runs here keep the hard
    error instead)."""
    try:
        return sys.stdin.isatty() and sys.stdout.isatty()
    except Exception:
        return False


def _ask(question: str) -> bool:
    """y/n stdin prompt (bcore-style [Y|N] query of the reference
    driver, src/scene.c:1036-1097)."""
    while True:
        sys.stdout.write(f"{question} [y|n] ")
        sys.stdout.flush()
        ans = sys.stdin.readline().strip().lower()
        if ans in ("y", "yes"):
            return True
        if ans in ("n", "no"):
            return False


class _SigintFlag:
    def __init__(self):
        self.received = False
        self._prev = None

    def __enter__(self):
        def handler(sig, frame):
            self.received = True
        self._prev = signal.signal(signal.SIGINT, handler)
        return self

    def __exit__(self, *a):
        signal.signal(signal.SIGINT, self._prev)


def render_scene(scene, out_file: str, force: bool = False,
                 recover: bool = False, dtype=np.float32,
                 batch: int = 1 << 14, verbose: bool = True,
                 max_cycles: Optional[int] = None, device="cuda",
                 stats: Optional[dict] = None) -> np.ndarray:
    """Full render of a host Scene to `out_file` (PNM) on `device`.
    Returns the final float image [H,W,3].  `stats`, when given, receives
    the run's counts: rays_traced (the JAX bench's query accounting),
    samples, trips, seconds and the last pass's hash."""
    cfg = scene.cfg
    log = (lambda *a: print(*a, flush=True)) if verbose else (lambda *a: None)

    ir = sir.compile_scene(scene)
    tracer = Tracer(ir, dtype=dtype, device=device)
    integ = Integrator(tracer, batch=batch)

    tmp_file = out_file + ".tmp.lum_image.npz"
    lum = None
    use_ckpt = recover
    if os.path.exists(tmp_file) and not recover and _interactive():
        # reference prompt parity (src/scene.c:1068-1097): ask before
        # using a recovery file when -r was not given
        use_ckpt = _ask(f"Recovery file '{tmp_file}' found. Use it?")
    if os.path.exists(tmp_file) and use_ckpt:
        lum = aimg.LumImage.load(tmp_file)
        if lum.width != cfg.image_width or lum.height != cfg.image_height:
            log("Checkpoint dimensions changed; restarting")
            lum = None
        else:
            # the interrupted cycle's samples were never merged, so it is
            # re-run from its saved RNG state (reference src/scene.c:1103)
            log(f"Recovered checkpoint; resuming at gradient cycle "
                f"{lum.gradient_cycle}")
    resumed = lum is not None
    if lum is None:
        lum = aimg.LumImage(cfg.image_width, cfg.image_height)

    if os.path.exists(out_file) and not force and not resumed:
        # reference prompt parity (src/scene.c:1036-1067): ask before
        # overwriting an existing output when -f was not given; without
        # a terminal keep the hard error (non-interactive runs must not
        # clobber silently)
        if _interactive() and _ask(f"File '{out_file}' exists. "
                                   f"Overwrite?"):
            pass
        else:
            raise FileExistsError(
                f"{out_file} exists (use force=True / -f to overwrite)")

    n_cycles = cfg.gradient_cycles if max_cycles is None \
        else min(cfg.gradient_cycles, max_cycles)
    sqr_thresh = cfg.gradient_threshold ** 2

    log(f"Objects: {len(ir.objects)} "
        f"({len(ir.lights)} lights) | {cfg.image_width}x{cfg.image_height}"
        f" depth={cfg.trace_depth} direct={cfg.direct_samples}"
        f" path={cfg.path_samples}")
    t_start = time.time()

    n_samples = trips = 0
    h = None
    with _SigintFlag() as flag:
        for cycle in range(lum.gradient_cycle, n_cycles + 1):
            lum.gradient_cycle = cycle
            lcg = HostLcg(int(lum.rval))

            if cycle == 0:
                ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
                pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                               -1).astype(np.float64)
                log(f"pass 0: {len(pos)} samples")
            else:
                grad = lum.sqr_grad()
                sel = np.argwhere(grad > sqr_thresh)   # [K, 2] (y, x)
                # sequential LCG draws, matching the reference's resume
                # semantics (reference src/scene.c:1130-1135); the chain is
                # inherently serial -> native C kernel with python fallback
                try:
                    from actinon_tpu_torch.native import gen_samples
                    pos, new_state = gen_samples(
                        sel[:, 1], sel[:, 0], cfg.gradient_samples,
                        int(lcg.state))
                    lcg.state = np.uint64(new_state)
                except ImportError:
                    pos_list = []
                    for y, x in sel:
                        for _ in range(cfg.gradient_samples):
                            dx = lcg.rnd1()
                            dy = lcg.rnd1()
                            pos_list.append((x + dx, y + dy))
                    pos = np.array(pos_list, np.float64) if pos_list \
                        else np.zeros((0, 2))
                log(f"pass {cycle}: {len(sel)} pixels -> {len(pos)} samples")

            if len(pos):
                acc = integ.run_samples(pos)
                n_samples += len(pos)
                trips += integ.last_trips
                # per-sample gamma saturation (reference src/scene.c:1010)
                sat = np.clip(np.power(np.maximum(acc, 0.0), cfg.gamma),
                              0.0, 1.0)
                # primary misses already contributed background via the
                # integrator; nothing special needed here
                if flag.received:
                    log("SIGINT received; saving checkpoint")
                    lum.save(tmp_file)
                    break
                lum.push_samples(pos, sat)

            lum.rval = lcg.state
            img = lum.averaged()
            aimg.write_pnm(out_file, img)
            h = aimg.image_hash(aimg.pack_cps(img))
            log(f"pass {cycle} done, hash: {h}")

    seconds = time.time() - t_start
    log(f"{seconds:.3f} s")
    if os.path.exists(tmp_file) and not flag.received:
        os.remove(tmp_file)
    if stats is not None:
        stats.update(rays_traced=integ.rays_traced, samples=n_samples,
                     trips=trips, seconds=seconds, hash=h)
    return lum.averaged()
