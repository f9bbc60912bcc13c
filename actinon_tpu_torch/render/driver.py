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

The renderer (the Tracer and the Integrator, with the integrator's drain
states, graph pools and captured stages: render/graphs.py) outlives the
call that built it: `render_scene` keeps the last one, and the next call
takes it where its scene would build the same renderer (`_key`: all but
the camera), so that an image of a scene already rendered from another
camera builds and captures nothing.  The camera reaches the drain only
through `Integrator._camera_rays_dev`, outside every captured stage.
Any other call releases the kept renderer, then builds its own.
`release()` drops it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import operator
import os
import pickle
import signal
import sys
import time
from typing import Optional

import numpy as np
import torch

from actinon_tpu_torch.config import resolve_device
from actinon_tpu_torch.render import image as aimg
from actinon_tpu_torch.render import spans
from actinon_tpu_torch.render.integrator import Integrator
from actinon_tpu_torch.render.tracer import Tracer, numpy_dtype
from actinon_tpu_torch.rng import HostLcg
from actinon_tpu_torch.scene import ir as sir

# the renderer the last render_scene call left: (key, tracer, integrator)
_kept = None

# the RenderConfig fields that reach the renderer only as the IR's
# camera (cam_pos, cam_rot) and through _camera_rays_dev
_CAMERA = frozenset({"camera_position", "camera_view_direction",
                     "camera_top_direction", "camera_focal_length"})
_DTYPE = operator.attrgetter("dtype")
_SHAPE = operator.attrgetter("shape")


def release():
    """Drop the renderer that render_scene keeps between calls, and give
    the device memory of its tables, drain states and graph pools back
    to the device.  The next call builds anew."""
    global _kept
    _kept = None
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _key(ir, dtype, batch, device):
    """What the Tracer and Integrator constructors read, and nothing of
    the camera: a blake2b digest of an exact encoding of the IR's
    objects, lights and background and of every other RenderConfig
    field, with the float type, batch and device; beside it the two
    classes the driver builds with."""
    out = [numpy_dtype(dtype).str, batch, str(resolve_device(device)),
           ir.lights, ir.background,
           sorted((k, v) for k, v in vars(ir.cfg).items()
                  if k not in _CAMERA)]
    _encode(ir.objects, out)
    digest = hashlib.blake2b(pickle.dumps(out, protocol=5),
                             digest_size=32).digest()
    return digest, Tracer, Integrator


def _encode(col, out):
    """Append to `out` an exact encoding of the list `col`, a column at a
    time, so that a scene of many objects costs a few passes in C: the
    instances of one dataclass by field, lists by their lengths and
    their items, arrays of one dtype and shape (some of them None) as
    their bytes, floats as float64 bytes; any other column as it is."""
    kinds = set(map(type, col))
    if kinds == {np.ndarray, type(None)}:
        some = list(map(operator.is_not, col, itertools.repeat(None)))
        out.append(("some", np.array(some).tobytes()))
        col, kinds = list(itertools.compress(col, some)), {np.ndarray}
    kind = kinds.pop() if len(kinds) == 1 else None
    if kind is float:
        out.append(("float", np.array(col, np.float64).tobytes()))
    elif kind is list:
        out.append(("list", list(map(len, col))))
        _encode(list(itertools.chain.from_iterable(col)), out)
    elif kind is np.ndarray and col[0].dtype.kind in "biuf" \
            and len(set(map(_DTYPE, col))) == 1 \
            and len(set(map(_SHAPE, col))) == 1:
        out.append(("array", col[0].dtype.str, col[0].shape,
                    b"".join(map(np.ndarray.tobytes, col))))
    elif kind is not None and dataclasses.is_dataclass(kind) \
            and len(names := set(map(tuple, map(vars, col)))) == 1:
        out.append(("fields", kind, *names))
        for field in zip(*map(dict.values, map(vars, col))):
            _encode(list(field), out)
    else:
        out.append(col)


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
    samples, trips, seconds (the pass loop's, on the spans' clock) and
    the last pass's hash; and the call's record (render/spans.py):
    spans ([name, start_s, end_s, parent index], seconds from the call's
    start; index 0 the root `driver.image`, the whole call), counters
    (`driver.renderer_kept`, `drain.host_reads`, `graphs.captures`,
    `graphs.pool_bytes`) and device_spans ([stage batch, seconds], one a
    CUDA-graph replay).  While a torch profiler records, `stats` is also
    kept in `spans.profiled`.  The call keeps its renderer for the next
    (the module's docstring)."""
    rec = None if stats is None else spans.Record()
    with spans.span(rec, "driver.image"):
        img, counts = _render(scene, out_file, force, recover, dtype, batch,
                              verbose, max_cycles, device, rec)
    if stats is not None:
        stats.update(counts, **rec.result())
        spans.publish(stats)
    return img


def _render(scene, out_file, force, recover, dtype, batch, verbose,
            max_cycles, device, rec):
    """render_scene's body: (the image, its counts), the spans into
    `rec` (or None)."""
    global _kept
    with spans.span(rec, "driver.compile"):
        ir = sir.compile_scene(scene)
        key = _key(ir, dtype, batch, device)
    tracer, integ = _renderer(key, ir, dtype, batch, device, rec)
    integ.record = rec
    try:
        img, counts = _passes(integ, ir, out_file, force, recover, verbose,
                              max_cycles, rec)
    finally:
        integ.record = None
    # kept only where the call returned: one that raised keeps none
    _kept = key, tracer, integ
    return img, counts


def _renderer(key, ir, dtype, batch, device, rec):
    """(tracer, integrator) for the IR: the kept ones where their key is
    `key` (they take the IR, and with it the camera), else new ones,
    built after the kept ones are released (span driver.release), so
    that one renderer at most holds device memory.  Counter
    driver.renderer_kept: 1 where the call took the kept renderer."""
    global _kept
    kept, _kept = _kept, None
    hit = kept is not None and kept[0] == key
    spans.count(rec, "driver.renderer_kept", int(hit))
    if hit:
        _, tracer, integ = kept
        tracer.ir = integ.ir = ir
        integ.cfg = ir.cfg
        return tracer, integ
    with spans.span(rec, "driver.release"):
        del kept
    with spans.span(rec, "driver.tracer"):
        tracer = Tracer(ir, dtype=dtype, device=device)
    with spans.span(rec, "driver.integrator"):
        integ = Integrator(tracer, batch=batch)
    return tracer, integ


def _passes(integ, ir, out_file, force, recover, verbose, max_cycles, rec):
    """The pass loop of one image on the renderer `integ`: (the image,
    its counts)."""
    cfg = ir.cfg
    log = (lambda *a: print(*a, flush=True)) if verbose else (lambda *a: None)
    rays0 = integ.rays_traced

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
    t_start = time.perf_counter()

    n_samples = trips = 0
    h = None
    with _SigintFlag() as flag:
        for cycle in range(lum.gradient_cycle, n_cycles + 1):
            lum.gradient_cycle = cycle
            lcg = HostLcg(int(lum.rval))

            with spans.span(rec, "driver.positions"):
                if cycle == 0:
                    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
                    pos = np.stack([xs.reshape(-1) + 0.5,
                                    ys.reshape(-1) + 0.5],
                                   -1).astype(np.float64)
                    log(f"pass 0: {len(pos)} samples")
                else:
                    grad = lum.sqr_grad()
                    sel = np.argwhere(grad > sqr_thresh)   # [K, 2] (y, x)
                    # sequential LCG draws, matching the reference's resume
                    # semantics (reference src/scene.c:1130-1135); the chain
                    # is inherently serial -> native C kernel with python
                    # fallback
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
                    log(f"pass {cycle}: {len(sel)} pixels -> "
                        f"{len(pos)} samples")

            if len(pos):
                acc = integ.run_samples(pos)
                n_samples += len(pos)
                trips += integ.last_trips
                with spans.span(rec, "driver.accumulate"):
                    # per-sample gamma saturation (reference
                    # src/scene.c:1010)
                    sat = np.clip(np.power(np.maximum(acc, 0.0), cfg.gamma),
                                  0.0, 1.0)
                    # primary misses already contributed background via
                    # the integrator; nothing special needed here
                    if flag.received:
                        log("SIGINT received; saving checkpoint")
                        lum.save(tmp_file)
                        break
                    lum.push_samples(pos, sat)

            lum.rval = lcg.state
            with spans.span(rec, "driver.output"):
                img = lum.averaged()
                aimg.write_pnm(out_file, img)
                h = aimg.image_hash(aimg.pack_cps(img))
            log(f"pass {cycle} done, hash: {h}")

    seconds = time.perf_counter() - t_start
    log(f"{seconds:.3f} s")
    if os.path.exists(tmp_file) and not flag.received:
        os.remove(tmp_file)
    counts = dict(rays_traced=integ.rays_traced - rays0, samples=n_samples,
                  trips=trips, seconds=seconds, hash=h)
    return lum.averaged(), counts
