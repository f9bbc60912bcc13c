"""The f32 envelope, bound and big-scene discriminants rounded as the JAX
package's compiled CPU code rounds them (ROADMAP C4).

XLA's CPU code contracts multiply-adds into FMAs, and which ones depends
on how an expression is written: `jnp.sum(a * b, -1)` becomes the chain
fma(a2, b2, fma(a1, b1, a0 b0)), the Pallas helpers' `x dx + y dy + z dz`
becomes fma(z, dz, fma(x, dx, y dy)), s s - q becomes fma(s, s, -q) in
every gate, and a squared radius that XLA sees as a constant or computes
apart is rounded on its own.  `_quadric_first_hit` is the exception: its
sums are chains, but its s s - q (of two quotients) rounds twice.  Each
test feeds seeded near-tangent rays, where the two roundings of s s - q
give different gates, through the port's function and the JAX package's
jitted counterpart, and the outcomes must be equal; the port's parent,
which rounded every one of these twice, fails each test on thousands of
rays."""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actinon_tpu.render import pallas_bigscene as jpb
from actinon_tpu.render import pallas_scene as jps
from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.render import bigscene, scene_kernels
from actinon_tpu_torch.render.integrator import Integrator as TIntegrator
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.render.tracer import _tree_eval_mask
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho
from _torch_threads import one_torch_thread  # noqa: F401

f32 = np.float32
# rays a jitted call: XLA's CPU code gave the same bits in every process
# at this batch (tests/test_torch_nee_disc.py)
CALL = 16384


def tangent_rays(c, r, seed, near=2.0, far=3000.0, n=CALL):
    """n f32 rays from log-uniform distances (near r to far) aimed at the
    silhouette of the sphere (c, r), within 1e-3 of it either way."""
    rng = np.random.default_rng(seed)
    c = np.asarray(c, np.float64)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    dist = np.exp(rng.uniform(np.log(near * r), np.log(far), n))
    p = c + u * dist[:, None]
    off = rng.normal(size=(n, 3))
    off -= (off * u).sum(1, keepdims=True) * u
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    d = c + off * (r * rng.uniform(0.999, 1.001, n))[:, None] - p
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p.astype(f32), d.astype(f32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _envelope_scene(ho):
    """Two enveloped single-leaf ellipsoids, and a group of two
    composites (a sphere of radius 2 less a small one) whose envelopes of
    radius 1 lie inside them, so that the envelope gate alone decides a
    near-tangent ray's hit; a sphere light."""
    sc = ho.Scene()
    light = ho.Sphere(0.5)
    light.move(ho.v3(0.0, 0.0, 9.0))
    light.prp.radiance = 20.0
    sc.push(light)
    for k in range(2):
        ell = ho.Squaroid.ellipsoid(1.0, 0.6, 0.4)
        ell.set_envelope(ho.Envelope((0, 0, 0), 1.1))
        ell.move(ho.v3(-4.0 + 8.0 * k, 2.0, 0.5))
        sc.push(ell)
    for k in range(2):
        small = ho.Sphere(0.2)
        small.move(ho.v3(0.0, 0.0, 1.7))
        comp = ho.PairInside(ho.Sphere(2.0), ho.Neg(small))
        comp.set_envelope(ho.Envelope((0, 0, 0), 1.0))
        comp.move(ho.v3(-5.0 + 10.0 * k, -6.0, 1.0))
        sc.push(comp)
    return sc


@pytest.fixture(scope="module")
def tracers():
    jt = JTracer(jsir.compile_scene(_envelope_scene(jho)), dtype=f32)
    tt = TTracer(tsir.compile_scene(_envelope_scene(tho)), dtype=f32,
                 device="cpu")
    return jt, tt


def test_env_gate_rows_rounds_as_jitted_jax(tracers):
    jt, tt = tracers
    rows = np.flatnonzero(jt.tab.env_r > 0)
    assert len(rows) == 2 and np.array_equal(
        rows, np.flatnonzero(tt.tab.env_r > 0))
    f = jax.jit(lambda p, d: jt._env_gate_rows(rows, p, d))
    for seed, row in ((1, rows[0]), (2, rows[1])):
        p, d = tangent_rays(jt.tab.env_c[row], jt.tab.env_r[row], seed)
        want = np.asarray(f(p, d))
        got = tt._env_gate_rows(rows, _t(p), _t(d)).numpy()
        assert np.array_equal(got, want)
        assert 0.2 < want.mean() < 0.8


def test_env_gate_one_rounds_as_jitted_jax(tracers):
    jt, tt = tracers
    c, r = np.float64([1.5, -2.0, 0.7]), 0.85
    f = jax.jit(lambda p, d: jt._env_gate_one(c, r, p, d))
    for seed in (3, 4):
        p, d = tangent_rays(c, r, seed)
        want = np.asarray(f(p, d))
        got = tt._env_gate_one(c, r, _t(p), _t(d)).numpy()
        assert np.array_equal(got, want)
        assert 0.2 < want.mean() < 0.8


def test_env_interval_gate_rounds_as_jitted_jax(tracers):
    """The gate, which is all that either tracer reads on the CPU (XLA
    rounds the t's where-mask apart, in fusions of its own)."""
    jt, tt = tracers
    c, r = np.asarray([-0.5, 3.0, 2.0], f32), f32(0.9)
    f = jax.jit(lambda c, r, p, d: jt._env_interval(c, r, p, d))
    for seed in (5, 6):
        p, d = tangent_rays(c, r, seed)
        want = np.asarray(f(c, r, p, d)[0])
        got = tt._env_interval(_t(c), _t(r), _t(p), _t(d))[0].numpy()
        assert np.array_equal(got, want)
        assert 0.2 < want.mean() < 0.8


def test_group_hit_envelope_gate_rounds_as_jitted_jax(tracers):
    """The composites fill their envelopes, so a near-tangent ray hits
    exactly where the gate passes: finiteness equal on every ray.  The
    JAX package's group walk takes a later crossing than the port's on
    about 0.1 % of these rays, and from a few hundred units misses some
    hits in f32 and in f64 alike (ROADMAP C5), so origins stay within 100
    units and t is held on 99.5 % of the hits."""
    jt, tt = tracers
    jm, tm = jt.comp_groups[0], tt.comp_groups[0]
    assert len(jm) == len(tm) == 2
    f = jax.jit(lambda p, d: jt._group_hit(jm, jt._assemble(), p, d)[0])
    for seed, comp in ((7, jm[0]), (8, jm[1])):
        p, d = tangent_rays(comp.env_c, comp.env_r, seed, near=3.0,
                            far=100.0)
        want = np.asarray(f(p, d))
        got = tt._group_hit(tm, _t(p), _t(d))[0].numpy()
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        both = np.isfinite(want)
        err = np.abs(got[both] - want[both])
        assert (err <= 1e-3 * (1 + want[both])).mean() >= 0.995
        assert 0.5 < both[:, int(comp is jm[1])].mean() < 0.95


def _group_truth(j64, members, p, d):
    """The first boundary crossing (raw t, INF on a miss) of each member
    of a composite group along each ray, in f64 from the f64 tables: every
    leaf's roots in f64, sorted, and the composite's inside-ness tested at
    the midpoints between consecutive roots (far from every surface)."""
    M, m0, c2, c1, rr = (np.asarray(a, np.float64) for a in j64._assemble())
    P, D = p.astype(np.float64), d.astype(np.float64)
    out = np.full((len(P), len(members)), np.inf)
    for g, comp in enumerate(members):
        rows = np.asarray(comp.rows)
        y0 = np.einsum("rj,lij->rli", P, M[rows]) + m0[rows][None]
        dy = np.einsum("rj,lij->rli", D, M[rows])
        A = (c2[rows][None] * dy * dy).sum(-1)
        B = 2 * (c2[rows][None] * dy * y0).sum(-1) \
            + (c1[rows][None] * dy).sum(-1)
        C = (c2[rows][None] * y0 * y0).sum(-1) \
            + (c1[rows][None] * y0).sum(-1) + rr[rows][None]
        disc = B * B - 4 * A * C
        sq = np.sqrt(np.maximum(disc, 0.0))
        with np.errstate(all="ignore"):
            roots = np.concatenate([(-B - sq) / (2 * A),
                                    (-B + sq) / (2 * A)], 1)
        real = np.concatenate([disc >= 0, disc >= 0], 1)
        roots = np.where(real & (roots > 0), roots, np.inf)
        roots.sort(1)

        def inside(t):
            w = A * t[:, None] ** 2 + B * t[:, None] + C <= 0
            return _tree_eval_mask(comp.tree, lambda li: w[:, li])

        prev, done = inside(np.zeros(len(P))), np.zeros(len(P), bool)
        for k in range(roots.shape[1]):
            tk = roots[:, k]
            nxt = roots[:, k + 1] if k + 1 < roots.shape[1] \
                else np.full(len(P), np.inf)
            fin = np.isfinite(tk)
            mid = np.where(fin, 0.5 * (tk + np.where(np.isfinite(nxt), nxt,
                                                      tk + 1.0)), 0.0)
            now = inside(mid)
            flip = fin & (now != prev) & ~done
            out[flip, g] = tk[flip]
            done |= flip
            prev = np.where(fin, now, prev)
    return out


@pytest.mark.parametrize("dt", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_group_walk_at_range_matches_f64_arbiter(dt):
    """ROADMAP C5 at 250 to 350 units: the group case of
    test_group_hit_envelope_gate_rounds_as_jitted_jax without its
    envelope gate, each walk's first boundary against an f64 side test
    of the hit point (_group_truth).  The port's crossing-parity walk and
    the JAX package's own `_group_walk` find the boundary the geometry
    has on all but 1e-4 of the (ray, member) pairs, in f32 and in f64;
    the JAX `_group_hit` takes `_group_walk_poly`, whose fixed 1e-5
    zero shell misreads a leaf's side once |C| ~ t^2 grows, and misses
    or moves more than 5 % of them in both types (a reference-side
    behaviour: that walk is not "the same thing" at range)."""
    jt = JTracer(jsir.compile_scene(_envelope_scene(jho)), dtype=dt)
    j64 = JTracer(jsir.compile_scene(_envelope_scene(jho)),
                  dtype=np.float64)
    tt = TTracer(tsir.compile_scene(_envelope_scene(tho)), dtype=dt,
                 device="cpu")
    jm, tm = jt.comp_groups[0], tt.comp_groups[0]
    G, Lc = len(jm), len(jm[0].rows)
    arows = np.asarray([c.rows for c in jm], np.int64)
    loc = np.concatenate([np.arange(Lc)] * 2)
    roc = np.concatenate([np.zeros(Lc, np.int32), np.ones(Lc, np.int32)])
    tabs = jt._assemble()

    def jax_walks(p, d):
        R = p.shape[0]
        A, Bq, Cq, _, _ = jt._quads(tabs, arows.reshape(-1), p, d)
        t0u, t1u, *_ = jt._roots(A, Bq, Cq)
        cross = jnp.concatenate([t0u.reshape(R, G, Lc),
                                 t1u.reshape(R, G, Lc)], -1)
        cross = jnp.where(cross > 0, cross, jnp.inf)
        sh = (R, G, Lc)
        poly, _ = jt._group_walk_poly(jm[0].tree, cross, loc, roc,
                                      A.reshape(sh), Bq.reshape(sh),
                                      Cq.reshape(sh))
        par, _ = jt._group_walk(jm[0].tree, cross, loc,
                                (Cq <= 0).reshape(sh))
        return poly, par

    f = jax.jit(jax_walks)
    wrong = {"port": 0, "jax_parity": 0, "jax_poly": 0}
    pairs = 0
    for seed, comp in ((17, jm[0]), (18, jm[1])):
        p, d = tangent_rays(comp.env_c, comp.env_r, seed, near=250.0,
                            far=350.0, n=8192)
        p, d = p.astype(dt), d.astype(dt)
        R = p.shape[0]
        A, Bq, Cq = tt._quads(arows.reshape(-1), _t(p), _t(d))
        t0u, t1u, *_ = tt._roots(A, Bq, Cq)
        cross = torch.cat([t0u.reshape(R, G, Lc), t1u.reshape(R, G, Lc)],
                          -1)
        cross = torch.where(cross > 0, cross, torch.inf)
        port = tt._group_walk(tm[0].tree, cross, loc,
                              (Cq <= 0).reshape(R, G, Lc))[0].numpy()
        poly, par = (np.asarray(x) for x in f(p, d))
        truth = _group_truth(j64, jm, p, d)
        hit = np.isfinite(truth)
        assert 0.4 < hit.mean() < 0.6
        for name, got in (("port", port), ("jax_parity", par),
                          ("jax_poly", poly)):
            ok = np.isfinite(got) == hit
            both = ok & hit
            ok[both] = np.abs(got[both] - truth[both]) \
                <= 1e-3 * (1 + truth[both])
            wrong[name] += int((~ok).sum())
        pairs += truth.size
    print(f"C5 at 250-350 units, {np.dtype(dt).name}: wrong of {pairs} "
          f"pairs {wrong}")
    assert wrong["port"] <= 1e-4 * pairs, wrong
    assert wrong["jax_parity"] <= 1e-4 * pairs, wrong
    assert wrong["jax_poly"] >= 0.05 * pairs, wrong


def test_big_sphere_cands_round_as_jitted_jax():
    """K6/K7's plain sphere candidates against the Pallas helper, jitted:
    finiteness equal on every ray, t within one ulp of it (torch's f32
    CPU sqrt is not always correctly rounded)."""
    eps = f32(1e-4)
    c, r = np.float32([0.3, -0.2, 1.1]), f32(0.04)
    blk = np.zeros((4, 128), f32)
    blk[0:3] = c[:, None]
    blk[3] = r * r
    f = jax.jit(lambda p, d: jpb._sphere_cands(
        p[:, 0:1], p[:, 1:2], p[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3],
        blk, eps))
    for seed in (9, 10):
        p, d = tangent_rays(c, r, seed, near=1.5, far=60.0)
        want = np.asarray(f(p, d))[:, 0]
        got = bigscene._sphere_cands(_t(p), _t(d), _t(blk), float(eps))
        got = got.numpy()[:, 0]
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        assert 0.2 < fin.mean() < 0.8
        ulp = np.abs(got[fin].view(np.int32).astype(np.int64)
                     - want[fin].view(np.int32))
        assert ulp.max() <= 1


@pytest.mark.parametrize("module", ["bigscene", "scene_kernels"])
def test_block_cull_rounds_as_jitted_jax(module):
    """The plain block-bound culls of K6/K7 and K4/K5 against the Pallas
    bound test (`_env_hit`; pallas_scene's `block_cull` writes the same
    expression inside its kernels)."""
    c, r = np.float32([2.0, 1.0, -1.5]), f32(2.0)
    bounds = np.zeros((1, 8), f32)
    bounds[0, :3] = c
    bounds[0, 3] = r * r
    f = jax.jit(lambda p, d: jpb._env_hit(
        p[:, 0:1], p[:, 1:2], p[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3],
        *bounds[0, :4]))
    for seed in (11, 12):
        p, d = tangent_rays(c, r, seed)
        want = np.asarray(f(p, d))[:, 0]
        if module == "bigscene":
            got = bigscene._cull(bounds, 0, _t(p), _t(d))
        else:
            got = scene_kernels._cull(types.SimpleNamespace(bounds=bounds),
                                      0, _t(p), _t(d))
        assert np.array_equal(got.numpy(), want)
        assert 0.2 < want.mean() < 0.8


def test_scene_env_interval_lane_rounds_as_jitted_jax():
    """K4/K5's plain per-lane envelope interval against the Pallas
    helper, jitted: the gate on every ray, t_in and t_out within one ulp
    (torch's f32 CPU sqrt)."""
    e = np.float32([0.4, -1.0, 2.5, 0.8])
    f = jax.jit(lambda p, d: jps._env_interval_lane(
        p[:, 0], p[:, 1], p[:, 2], d[:, 0], d[:, 1], d[:, 2], *e))
    for seed in (13, 14):
        p, d = tangent_rays(e[:3], e[3], seed)
        want = [np.asarray(x) for x in f(p, d)]
        pt, dt = _t(p), _t(d)
        got = [x.numpy() for x in scene_kernels._env_interval_lane(
            pt[:, 0], pt[:, 1], pt[:, 2], dt[:, 0], dt[:, 1], dt[:, 2],
            *[_t(x) for x in e])]
        assert np.array_equal(got[0], want[0])
        assert 0.2 < want[0].mean() < 0.8
        for g, w in zip(got[1:], want[1:]):
            ulp = np.abs(g.view(np.int32).astype(np.int64)
                         - w.view(np.int32))
            assert ulp.max() <= 1


def _quadric_rays(seed, B=2048, K=8):
    """Origins from 2 to 500 away and K directions each, within about
    1e-5 rad of a tangent of an ellipsoid (semi-axes 1.2, 0.7, 0.5,
    turned 0.7 rad about z, centred at (1, -2, 3)): its quadric (M, m0,
    c2, rr) and the rays."""
    rng = np.random.default_rng(seed)
    a = 0.7
    M = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    m0 = -M @ np.array([1.0, -2.0, 3.0])
    ax = np.array([1.2, 0.7, 0.5])
    u = rng.normal(size=(B, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    t = rng.normal(size=(B, 3))
    t -= (t * u).sum(1, keepdims=True) * u
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    y = u * (1 + rng.uniform(-1e-4, 1e-4, B))[:, None] * ax
    Minv = np.linalg.inv(M)
    x = (y - m0) @ Minv.T
    tw = (t * ax) @ Minv.T
    tw /= np.linalg.norm(tw, axis=1, keepdims=True)
    p = x - tw * np.exp(rng.uniform(np.log(2), np.log(500), B))[:, None]
    w = tw[:, None, :] + rng.normal(scale=1e-5, size=(B, K, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    qd = dict(M=M.astype(f32), m0=m0.astype(f32),
              c2=(1.0 / ax ** 2).astype(f32), rr=f32(-1.0))
    return qd, p.astype(f32), w.astype(f32)


def test_quadric_first_hit_rounds_as_jitted_jax():
    """The edge terms' detached quadric first hit: its sums are FMA
    chains, its s s - q rounds twice, as the JAX package's compiled code
    rounds them.  Finiteness equal on every ray, t within one ulp
    (torch's f32 CPU sqrt)."""
    fake = types.SimpleNamespace(tr=types.SimpleNamespace(eps=f32(1e-4)))
    f = jax.jit(lambda qd, p, w: JIntegrator._quadric_first_hit(
        fake, qd, p, w))
    for seed in (15, 16):
        qd, p, w = _quadric_rays(seed)
        want = np.asarray(f(qd, p, w))
        got = TIntegrator._quadric_first_hit(
            fake, {k: _t(v) for k, v in qd.items()}, _t(p), _t(w)).numpy()
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        assert 0.2 < fin.mean() < 0.8
        ulp = np.abs(got[fin].view(np.int32).astype(np.int64)
                     - want[fin].view(np.int32))
        assert ulp.max() <= 1


# The CUDA twins, compiled as host C++ (no FMA contraction there: each
# fmaf is the library's, rounded once), on the same near-tangent rays:
# every gate equal to the plain version's, every t within a few ulps
# (torch's f32 CPU sqrt is not always correctly rounded, and a root's
# ulp can grow by one or two through the stable root's quotient).
HOST_DRIVERS = {
    "bigscene_kernels.cu": r"""
extern "C" void host_cands(const float* p, const float* d, const float* blk,
                           float eps, int n, float* out) {
    for (int i = 0; i < n; ++i) out[i] = sphere_cand(blk, 0, load_ray(p, d, i),
                                                     eps);
}
extern "C" void host_bound(const float* p, const float* d, const float* b,
                           int n, unsigned char* out) {
    for (int i = 0; i < n; ++i)
        out[i] = bound_hit(b[0], b[1], b[2], b[3], load_ray(p, d, i), false,
                           0.0f);
}
""",
    "scene_kernels.cu": r"""
extern "C" void host_bound(const float* p, const float* d, const float* b,
                           int n, unsigned char* out) {
    for (int i = 0; i < n; ++i) {
        Ray r{p[3 * i], p[3 * i + 1], p[3 * i + 2], d[3 * i], d[3 * i + 1],
              d[3 * i + 2]};
        out[i] = bound_hit(b[0], b[1], b[2], b[3], r, false, 0.0f);
    }
}
extern "C" void host_env_lane(const float* p, const float* d,
                              const float* feat, int n, unsigned char* gate,
                              float* t_in, float* t_out) {
    Lane L{feat};
    for (int i = 0; i < n; ++i) {
        Ray r{p[3 * i], p[3 * i + 1], p[3 * i + 2], d[3 * i], d[3 * i + 1],
              d[3 * i + 2]};
        gate[i] = env_interval_lane(L, r, t_in[i], t_out[i]);
    }
}
""",
    "trace_kernels.cu": r"""
extern "C" void host_env_gate(const float* p, const float* d, const float* c,
                              float r2, int n, unsigned char* out) {
    for (int i = 0; i < n; ++i) {
        Ray r{p[3 * i], p[3 * i + 1], p[3 * i + 2], d[3 * i], d[3 * i + 1],
              d[3 * i + 2]};
        out[i] = env_gate(c, r2, r);
    }
}
""",
}


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _within_ulp(a, b, ulps=4):
    fin = np.isfinite(b)
    if not np.array_equal(np.isfinite(a), fin):
        return False
    ulp = np.abs(a[fin].view(np.int32).astype(np.int64)
                 - b[fin].view(np.int32))
    return ulp.max(initial=0) <= ulps


@pytest.mark.parametrize("name", sorted(HOST_DRIVERS))
def test_cuda_twins_on_host_equal_plain_near_tangent(name, tmp_path, tracers):
    from test_torch_scene_kernels import host_library
    lib, _ = host_library(name, HOST_DRIVERS[name], tmp_path)
    c, r = np.float32([0.3, -0.2, 1.1]), f32(0.7)
    p, d = tangent_rays(c, r, 21)
    n = len(p)
    pt, dt = _t(p), _t(d)
    u8 = np.zeros(n, np.uint8)
    bounds = np.zeros((1, 8), f32)
    bounds[0, :3], bounds[0, 3] = c, r * r
    if name == "bigscene_kernels.cu":
        blk = np.zeros((4, 128), f32)
        blk[0:3], blk[3] = c[:, None], r * r
        got = np.zeros(n, f32)
        lib.host_cands(_ptr(p), _ptr(d), _ptr(blk), ctypes.c_float(1e-4),
                       n, _ptr(got))
        want = bigscene._sphere_cands(pt, dt, _t(blk), float(f32(1e-4)))
        assert _within_ulp(got, want.numpy()[:, 0])
        lib.host_bound(_ptr(p), _ptr(d), _ptr(bounds), n, _ptr(u8))
        want = bigscene._cull(bounds, 0, pt, dt).numpy()
    elif name == "scene_kernels.cu":
        feat = np.zeros((6, 128), f32)
        feat[2:5, 0], feat[5, 0] = c, r
        t_in, t_out = np.zeros(n, f32), np.zeros(n, f32)
        lib.host_env_lane(_ptr(p), _ptr(d), _ptr(feat), n, _ptr(u8),
                          _ptr(t_in), _ptr(t_out))
        w = scene_kernels._env_interval_lane(
            pt[:, 0], pt[:, 1], pt[:, 2], dt[:, 0], dt[:, 1], dt[:, 2],
            *[_t(x) for x in (c[0], c[1], c[2], r)])
        assert np.array_equal(u8.astype(bool), w[0].numpy())
        gate = w[0].numpy()
        assert _within_ulp(t_in[gate], w[1].numpy()[gate])
        assert _within_ulp(t_out[gate], w[2].numpy()[gate])
        lib.host_bound(_ptr(p), _ptr(d), _ptr(bounds), n, _ptr(u8))
        want = scene_kernels._cull(types.SimpleNamespace(bounds=bounds), 0,
                                   pt, dt).numpy()
    else:
        lib.host_env_gate(_ptr(p), _ptr(d), _ptr(c), ctypes.c_float(r * r),
                          n, _ptr(u8))
        want = tracers[1]._env_gate_one(c, float(r), pt, dt).numpy()
    assert np.array_equal(u8.astype(bool), want)
    assert 0.2 < want.mean() < 0.8
