"""Multi-process runs of the port's parallel/mesh.py on the CPU, for
tests/test_torch_mesh.py.

`launch(jobs, n, tmp_path)` starts n gloo worker processes (this file run
as a script), each joining a world of n ranks through a FileStore under
tmp_path with one torch thread, and returns each rank's results.  A
worker that fails ends the others; a world that does not finish within
its time limit is killed and fails the test, so a stuck rendezvous
cannot hang the suite.

A job is a dict: kind "drain" renders the pixel centres of the smoke
scene glass_table.acn at (w, h, direct, path, depth) through
ShardedIntegrator.run_samples; kind "queue" renders the same samples'
host camera rays as an arbitrary primary queue through
ShardedIntegrator.run_device(primary, n) (each rank the host drain on
its share of the rows); kind "diff" runs
ShardedDiffRenderer.value_and_grad on `lanes` camera samples of
default_rng(5).  The single-device counterparts are `single_drain`,
`single_queue` and `single_diff`, run in the test's own process."""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS_TABLE = os.path.join(ROOT, "actinon_tpu_torch", "scenes",
                           "glass_table.acn")
LIMIT_S = 240         # one world's time limit


def glass_table(run_file, w, h, direct, path, depth):
    """glass_table.acn through a package's front end, at another size."""
    cap = []
    run_file(GLASS_TABLE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = w, h
    sc.cfg.direct_samples, sc.cfg.path_samples = direct, path
    sc.cfg.trace_depth = depth
    return sc


def pixel_centres(cfg):
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    return np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                    -1).astype(np.float64)


def _tracer(job):
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    sc = glass_table(run_file, *job["shape"])
    return Tracer(sir.compile_scene(sc), dtype=np.dtype(job["dtype"]),
                  device="cpu")


def _integ(cls, job, *args):
    integ = cls(_tracer(job), *args, batch=job["batch"])
    integ.seed_mode = job.get("seed_mode", "position")
    return integ


def _diff_positions(cfg, n):
    rng = np.random.default_rng(5)
    return np.stack([rng.uniform(0, cfg.image_width, n),
                     rng.uniform(0, cfg.image_height, n)], -1)


def _flat_grads(loss, grads):
    out = {"loss": np.asarray(float(loss))}
    for g, grp in grads.items():
        for k, v in grp.items():
            out[f"{g}.{k}"] = v.detach().double().numpy()
    return out


def single_drain(job):
    """The single-device drain of a "drain" job: (acc, rays_traced)."""
    from actinon_tpu_torch.render.integrator import Integrator
    integ = _integ(Integrator, job)
    pos = pixel_centres(integ.cfg)
    acc = integ.run_device(None, len(pos), pos_xy=pos)
    return acc, integ.rays_traced


def primary_queue(integ):
    """The pixel centres' host camera rays as a RayQueue."""
    from actinon_tpu_torch.render.driver import camera_rays
    from actinon_tpu_torch.render.integrator import RayQueue
    pos = pixel_centres(integ.cfg)
    n, dt = len(pos), integ.dtype
    p, d = camera_rays(integ.ir, pos, dt)
    return RayQueue(p, d, np.ones(n, dt), np.ones((n, 3), dt),
                    np.full(n, integ.cfg.trace_depth, np.int32),
                    np.arange(n, dtype=np.int32)), n


def single_queue(job):
    """A "queue" job through the single-device host drain, run() with
    device_drain = False: (acc, rays_traced)."""
    from actinon_tpu_torch.render.integrator import Integrator
    integ = _integ(Integrator, job)
    integ.device_drain = False
    acc = integ.run(*primary_queue(integ))
    return acc, integ.rays_traced


def single_diff(job):
    """DiffRenderer.value_and_grad of a "diff" job, flattened."""
    from actinon_tpu_torch.render.diff import DiffRenderer
    from actinon_tpu_torch.render.integrator import Integrator
    dr = DiffRenderer(Integrator(_tracer(job), batch=job["lanes"]),
                      n_steps=job["steps"])
    q0 = dr.primary(_diff_positions(dr.integ.cfg, job["lanes"]))
    return _flat_grads(*dr.value_and_grad(q0))


def _run_job(job, mesh):
    from actinon_tpu_torch.parallel.mesh import (ShardedDiffRenderer,
                                                 ShardedIntegrator)
    if job["kind"] in ("drain", "queue"):
        integ = _integ(ShardedIntegrator, job, mesh)
        if job["kind"] == "drain":
            acc = integ.run_samples(pixel_centres(integ.cfg))
        else:
            acc = integ.run_device(*primary_queue(integ))
        return {"acc": acc, "rays_traced": np.asarray(integ.rays_traced),
                "balance": np.asarray(integ.last_balance)}
    from actinon_tpu_torch.render.diff import DiffRenderer
    from actinon_tpu_torch.render.integrator import Integrator
    dr = DiffRenderer(Integrator(_tracer(job), batch=job["lanes"]),
                      n_steps=job["steps"])
    q0 = dr.primary(_diff_positions(dr.integ.cfg, job["lanes"]))
    return _flat_grads(*ShardedDiffRenderer(dr, mesh).value_and_grad(q0))


def launch(jobs, n, tmp_path, limit_s=LIMIT_S):
    """Run `jobs` ({name: job}) on a gloo world of n worker processes;
    returns one {name: {key: array}} per rank."""
    spec = tmp_path / "jobs.json"
    spec.write_text(json.dumps(jobs))
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(spec), str(r),
         str(n), str(store), str(tmp_path / f"rank{r}.npz")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.time() + limit_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} of {n}: exit {p.returncode} (killed at the "
            f"{limit_s} s limit if negative)\n{logs[r][-3000:]}")
    out = []
    for r in range(n):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            res = {}
            for key in z.files:
                name, field = key.split("/", 1)
                res.setdefault(name, {})[field] = z[key]
            out.append(res)
    return out


def _worker(spec, rank, n, store, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    from actinon_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(n, device="cpu")
    arrays = {}
    for name, job in json.loads(open(spec).read()).items():
        for k, v in _run_job(job, mesh).items():
            arrays[f"{name}/{k}"] = v
    np.savez(out, **arrays)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5])
