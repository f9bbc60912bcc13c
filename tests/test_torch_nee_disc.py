"""The f32 sphere and quadric discriminants rounded as the JAX package's
compiled code rounds them (ROADMAP C3).

XLA's compiled CPU code contracts each multiply-add of
`_sphere_first_hit` (the dots, q = pp.pp - r r and s s - q) and of
`Tracer._roots` (s s - q) into one rounding; the port forms them in f64
and rounds once.  Rounded twice, a far-floor NEE sample whose light cone
is one ulp wide cancels to a zero discriminant, its light hit lands on
the lamp's centre and the NEE takes its 1e30 cap: lanes 898 and 2084 of
the fwd_bwd cell (glass_table 200x150, default_rng(3)) gave 9.5e19 and
1.1e20 in f32."""

import os

import jax
import numpy as np
import torch

from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.render.tracer import _sphere_first_hit as j_first_hit
from actinon_tpu_torch.render.tracer import Tracer, _sphere_first_hit
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS_TABLE = os.path.join(ROOT, "actinon_tpu_torch", "scenes",
                           "glass_table.acn")


def _ulps(a, b):
    """|a - b| in f32 ulps where both are finite (0 elsewhere), and
    whether both are finite or both are not."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.where(fa & fb, np.abs(ia - ib), 0), fa == fb


def _far_rays(n, seed):
    """Rays from 1,500 to 2,700 units away aimed inside (and just
    outside) a lamp of radius 0.5: the discriminant cancels."""
    rng = np.random.default_rng(seed)
    c = np.float32([2.0, -1.0, 5.0])
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p = (c + u * rng.uniform(1500, 2700, n)[:, None]).astype(np.float32)
    off = rng.normal(size=(n, 3))
    off -= (off * u).sum(1, keepdims=True) * u
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    d = c + off * (0.5 * rng.uniform(0, 1.05, n))[:, None] - p
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return c, p, d


# rays a call: XLA's CPU code splits larger batches over fusions whose
# rounding varied from one process to the next (2,200 of 100,000 lanes
# off by 2-3 ulps in 2 of 6 processes); 16,384 gave the same bits in
# every process tried
CALL = 16384
SEEDS = range(2, 8)


def test_sphere_first_hit_f32_matches_compiled_jax():
    r, eps = np.float32(0.37), np.float32(1e-4)
    f = jax.jit(lambda c, r, p, d: j_first_hit(c, r, p, d, eps))
    got, want = [], []
    for seed in SEEDS:
        c, p, d = _far_rays(CALL, seed)
        want.append(np.asarray(f(c, r, p, d)))
        got.append(_sphere_first_hit(
            torch.as_tensor(c), torch.as_tensor(r), torch.as_tensor(p),
            torch.as_tensor(d), 1e-4).numpy())
    got, want = np.concatenate(got), np.concatenate(want)
    ulps, same_kind = _ulps(got, want)
    assert same_kind.all() and ulps.max() <= 1
    equal = (got == want) | (np.isinf(got) & np.isinf(want))
    assert equal.mean() >= 0.9999
    assert 0.2 < np.isfinite(want).mean() < 0.9


def test_roots_f32_matches_compiled_jax():
    """Tracer._roots on the quadric coefficients of the same cancelling
    rays against a sphere leaf of radius 0.37."""
    f = jax.jit(JTracer._roots)
    got, want = [], []
    for seed in SEEDS:
        c, p, d = _far_rays(CALL, seed)
        pp = (p - c).astype(np.float64)
        A = np.ones(CALL, np.float32)
        Bq = (2 * (pp * d).sum(1)).astype(np.float32)
        Cq = ((pp ** 2).sum(1) - 0.37 ** 2).astype(np.float32)
        want.append([np.asarray(x) for x in f(A, Bq, Cq)])
        got.append([x.numpy() for x in Tracer._roots(
            torch.as_tensor(A), torch.as_tensor(Bq), torch.as_tensor(Cq))])
    for k in (0, 1):
        g = np.concatenate([x[k] for x in got])
        w = np.concatenate([x[k] for x in want])
        ulps, same_kind = _ulps(g, w)
        assert same_kind.all() and ulps.max() <= 1
        assert ((g == w) | (np.isinf(g) & np.isinf(w))).mean() >= 0.9999
    ok_g = np.concatenate([x[4] for x in got])
    assert np.array_equal(ok_g, np.concatenate([x[4] for x in want]))
    assert 0.2 < ok_g.mean() < 0.9


def test_fwd_bwd_far_floor_lanes_below_the_cap():
    """Lanes 898 and 2084 of the fwd_bwd cell in f32 on the CPU: each
    lane's NEE (the sphere lamp's exact hit, the ellipsoid lamp's quadric
    roots) stays finite and far below the 1e30 cap."""
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.diff import DiffRenderer
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.scene import ir as sir
    cap = []
    run_file(GLASS_TABLE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 200, 150
    sc.cfg.direct_samples, sc.cfg.path_samples = 10, 0
    sc.cfg.trace_depth = 25
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(0, 200, 8192), rng.uniform(0, 150, 8192)],
                   -1)
    dr = DiffRenderer(Integrator(
        Tracer(sir.compile_scene(sc), dtype=np.float32, device="cpu"),
        batch=8192))
    q0 = dr.primary(pos)
    lanes = torch.tensor([898, 2084])
    with torch.no_grad():
        rad = dr.radiance(dr.params(),
                          {k: v[lanes] for k, v in q0.items()}).numpy()
    assert np.isfinite(rad).all() and (rad >= 0).all()
    assert rad.max() < 1e3
    assert rad.min() > 0
