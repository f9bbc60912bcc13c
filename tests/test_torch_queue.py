"""The port's primary-queue entry points against the JAX package's, on the
CPU: `RayQueue`, `Integrator.run_device(primary, n)` on rays that are not
camera samples, the host drain `Integrator.run` (device_drain = False,
path 0 and path 4) and `_spawn_paths`, in f64 with seed_mode="counter",
at the contract of tests/test_torch_integrator.py (rtol 1e-6, atol
1e-9); then, inside the port, the f32 host drain against the mixed
device drain at tests/test_path_device.py's bounds, and the two drains'
query accounting (tests/test_accounting.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.integrator import RayQueue as JRayQueue
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.render.integrator import Integrator as TIntegrator
from actinon_tpu_torch.render.integrator import RayQueue as TRayQueue
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho

import _torch_scenes as S

TOL = dict(rtol=1e-6, atol=1e-9)
FIELDS = [f.name for f in dataclasses.fields(TRayQueue)]
# path configs: path children spawn only at depth > 10
PATH = dict(path_samples=4, depth=12)


def queue(cls, n, seed, depth, dt=np.float64):
    """n seeded rays of _torch_scenes.rays (origins in a cube of side 8
    about the scene, any direction: not camera samples), intensity 1,
    two rays a sample id."""
    p, d = S.rays(n, seed=seed, spread=4.0)
    return cls(p.astype(dt), d.astype(dt), np.ones(n, dt),
               np.ones((n, 3), dt), np.full(n, depth, np.int32),
               (np.arange(n) // 2).astype(np.int32))


_PAIRS = {}


def lamp_pair(device_drain=True, **kw):
    """The JAX and port integrators of _torch_scenes.lamp_scene (8x6, 3
    NEE samples, depth 6 unless kw says otherwise) in f64, batch 64,
    counter seeding; made once a config, so that the JAX package
    compiles its drains and steps once (rays_traced reset here)."""
    kw = dict(dict(direct_samples=3, depth=6), **kw)
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        ji = JIntegrator(JTracer(jsir.compile_scene(
            S.lamp_scene(jho, **kw)), dtype=np.float64), batch=64)
        ti = TIntegrator(TTracer(tsir.compile_scene(
            S.lamp_scene(tho, **kw)), dtype=np.float64, device="cpu"),
            batch=64)
        ji.seed_mode = ti.seed_mode = "counter"
        _PAIRS[key] = ji, ti
    ji, ti = _PAIRS[key]
    ji.device_drain = ti.device_drain = device_drain
    ji.rays_traced = ti.rays_traced = 0
    return ji, ti


def _same_queue(tq, jq):
    assert len(tq) == len(jq)
    for f in FIELDS:
        a, b = getattr(tq, f), getattr(jq, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_rayqueue_methods_match_jax():
    """empty, append, pop, padded and len, method for method."""
    dt = np.float32
    tq, jq = TRayQueue.empty(dt), JRayQueue.empty(dt)
    _same_queue(tq, jq)
    tq.append(queue(TRayQueue, 40, 1, 5, dt))
    jq.append(queue(JRayQueue, 40, 1, 5, dt))
    tq.append(queue(TRayQueue, 9, 2, 3, dt))
    jq.append(queue(JRayQueue, 9, 2, 3, dt))
    _same_queue(tq, jq)
    _same_queue(tq.pop(17), jq.pop(17))
    _same_queue(tq, jq)
    _same_queue(tq.padded(64, dt), jq.padded(64, dt))
    _same_queue(tq.padded(len(tq), dt), jq.padded(len(jq), dt))
    pad = tq.padded(64, dt)
    assert (pad.intensity[len(tq):] == 0).all()
    assert (pad.depth[len(tq):] == 0).all()
    assert (pad.d[len(tq):] == [0, 0, 1]).all()
    _same_queue(tq.pop(100), jq.pop(100))
    assert len(tq) == len(jq) == 0


@pytest.mark.parametrize("kw", [dict(), PATH], ids=["normal", "path"])
def test_run_device_primary_matches_jax(kw):
    """run_device(primary, n) on seeded rays that are not camera samples
    (the path config runs the mixed drain).  Some start inside the glass
    ball, where a Fresnel child's intensity is rounding noise (1e-32 on
    one side, 0 on the other), so the query counts may differ by such
    lanes while the images agree; test_run_samples_host_branch_* holds
    the counts on camera rays."""
    ji, ti = lamp_pair(**kw)
    n = 30
    want = ji.run_device(queue(JRayQueue, 2 * n, 3, ji.cfg.trace_depth), n)
    got = ti.run_device(queue(TRayQueue, 2 * n, 3, ti.cfg.trace_depth), n)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(), PATH], ids=["path0", "path4"])
def test_host_drain_run_matches_jax(kw):
    """run(primary, n) with device_drain = False: the host drain, its
    normal and path queues, against the JAX package's (the query counts
    as in test_run_device_primary_matches_jax)."""
    ji, ti = lamp_pair(device_drain=False, **kw)
    n = 30
    steps = []
    want = ji.run(queue(JRayQueue, 2 * n, 4, ji.cfg.trace_depth), n)
    got = ti.run(queue(TRayQueue, 2 * n, 4, ti.cfg.trace_depth), n,
                 progress=lambda *a: steps.append(a))
    assert want.max() > 0
    np.testing.assert_allclose(got, want, **TOL)
    assert steps and steps[-1][1:] == (0, 0)


def descriptors(n, seed):
    """n seeded path-spawn descriptors (the fields of _step's
    path_parent): unit outward normals, diffuse weights, sample counts
    up to beyond the config's path_samples, Oren-Nayar terms on half of
    them, u32 seeds, every third masked off."""
    rng = np.random.default_rng(seed)
    sd = rng.normal(size=(n, 3))
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    prj = rng.normal(size=(n, 3))
    prj -= (prj * sd).sum(1, keepdims=True) * sd
    prj /= np.linalg.norm(prj, axis=1, keepdims=True)
    on_b = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.05, 0.4, n), 0)
    return dict(
        mask=np.arange(n) % 3 != 0, pos=rng.uniform(-3, 3, (n, 3)),
        surf_d=sd, di=rng.uniform(0.05, 1.0, n),
        ns=rng.integers(1, 7, n).astype(np.int32),
        theta_i=rng.uniform(0, 1.5, n), on_a=1 - on_b, on_b=on_b,
        ray_prj=prj, rv=rng.integers(0, 2 ** 32, n, dtype=np.uint32),
        tint=rng.uniform(0, 1, (n, 3)), depth=np.full(n, 3, np.int32),
        sample_id=rng.integers(0, 50, n).astype(np.int32))


def test_spawn_paths_matches_jax():
    """_spawn_paths on the same descriptors: the RNG counters
    4 direct_cap max(n_lights, 1) + 2j and + 1, the 2/ns factor, the
    Oren-Nayar adjust."""
    ji, ti = lamp_pair(**PATH)
    pp = descriptors(96, 5)
    want = {k: np.asarray(v) for k, v in
            jax.jit(ji._spawn_paths)(pp).items()}
    tpp = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind in "iu"
                              else v) for k, v in pp.items()}
    got = {k: v.numpy() for k, v in ti._spawn_paths(tpp).items()}
    assert set(got) == set(want)
    m = want["mask"]
    np.testing.assert_array_equal(got["mask"], m)
    assert m.any() and not m.all()
    for k in ("p", "d", "intensity", "tint", "depth", "sample_id"):
        np.testing.assert_allclose(got[k][m], want[k][m], err_msg=k, **TOL)


def pixels(cfg):
    """The centres of every other pixel of the image (a checkerboard)."""
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    return pos[(xs + ys).reshape(-1) % 2 == 0]


def _camera_queue(ti, pos, dt):
    """Primary camera rays from the port's device-precision raygen."""
    p, d = ti._camera_rays_dev(torch.as_tensor(pos, dtype=ti.tdtype))
    n = len(pos)
    return TRayQueue(p.numpy(), d.numpy(), np.ones(n, dt),
                     np.ones((n, 3), dt),
                     np.full(n, ti.cfg.trace_depth, np.int32),
                     np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("path_samples,depth", [(20, 12), (8, 22)])
def test_host_drain_matches_mixed_drain_f32(path_samples, depth):
    """tests/test_path_device.py:47-66 inside the port: the f32 host
    drain (separate path queue, host-side spawn) against the mixed
    device drain on the same primaries, position seeding; identical RNG
    counters and estimator factors, so only the order of the sums
    differs.  Depth 22: path children at depth 12 > 10 split again."""
    dt = np.float32

    def integ():
        sc = S.lamp_scene(tho, direct_samples=2, depth=depth,
                          path_samples=path_samples)
        return TIntegrator(TTracer(tsir.compile_scene(sc), dtype=dt,
                                   device="cpu"), batch=1 << 9)

    host, dev = integ(), integ()
    host.device_drain = False
    pos = pixels(host.cfg)
    n = len(pos)
    acc_host = host.run(_camera_queue(host, pos, dt), n)
    acc_dev = dev.run_device(_camera_queue(dev, pos, dt), n)
    assert np.isfinite(acc_dev).all() and acc_dev.max() > 0
    assert abs(acc_host.mean() - acc_dev.mean()) < 1e-5
    assert np.abs(acc_host - acc_dev).max() < 1e-2


@pytest.mark.parametrize("path_samples", [0, 4, 20])
def test_host_and_device_drain_count_the_same_queries(path_samples):
    """tests/test_accounting.py:60-83: rays_traced means the same through
    the host drain and the device drain (device-precision primaries, so
    the position-seeded streams and spawn counts agree).  At path 20 a
    parent expands over two trips (PATH_EXPAND = 16), and the mixed drain
    must count the lanes it popped, not the children written back over
    their queue rows."""
    dt = np.float32

    def integ():
        sc = S.lamp_scene(tho, direct_samples=2, depth=12,
                          path_samples=path_samples)
        i = TIntegrator(TTracer(tsir.compile_scene(sc), dtype=dt,
                                device="cpu"), batch=256)
        i.rays_traced = 0
        return i

    dev, host = integ(), integ()
    host.device_drain = False
    pos = pixels(dev.cfg)
    acc_dev = dev.run_samples(pos)
    acc_host = host.run(_camera_queue(host, pos, dt), len(pos))
    assert dev.per_lane_queries == host.per_lane_queries
    assert dev.rays_traced == host.rays_traced > 0
    assert abs(acc_dev.mean() - acc_host.mean()) < 3e-2 * max(
        acc_dev.mean(), 1e-6)


def test_run_samples_host_branch_makes_camera_rays():
    """run_samples with device_drain = False: the host's camera rays
    (driver.camera_rays) through run(), as the JAX package does."""
    ji, ti = lamp_pair(device_drain=False)
    cfg = ti.cfg
    pos = np.random.default_rng(7).uniform(0, 1, (30, 2)) * [
        cfg.image_width, cfg.image_height]
    want = ji.run_samples(pos)
    got = ti.run_samples(pos)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, **TOL)
    assert ti.rays_traced == ji.rays_traced


def test_run_device_needs_a_queue_or_positions():
    _, ti = lamp_pair()
    with pytest.raises(TypeError):
        ti.run_device(None, 4)
