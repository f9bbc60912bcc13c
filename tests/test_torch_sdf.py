"""The port's plain tracer and integrator on scenes with distance objects,
against the JAX package's XLA paths, on the CPU.

The scene of tests/test_pallas_scene.py (singles, an analytic composite
group, a 3-member SDF solo cluster, a standalone torus, sphere lights) is
built in Python by each package's objects module and compiled by each
package's own front end.  On the CPU both packages march SDF leaves from
the ray origin (the JAX package clips marches to the envelope off the CPU
only), so the plain paths compute the same thing:

  * f64: t within rtol 1e-6, finiteness equal on >= 99.9 % of rays,
    winners (object, sign, normal) equal away from near-ties;
  * f32: the contract of tests/test_pallas_scene.py:_cmp_hits (t within
    rtol/atol 2e-4, finiteness >= 99.8 %, object >= 99 %, normals within
    atol 5e-3 where the object agrees);
  * the device drain of a small SDF scene in counter mode, normal and
    mixed path drains: rtol 1e-6, atol 1e-9 (tests/test_integrator.py:92).
"""

import numpy as np
import pytest
import torch

from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.params import load_jax_params
from actinon_tpu_torch.render.integrator import Integrator as TIntegrator
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho

import _torch_scenes as S
from _torch_threads import one_torch_thread  # noqa: F401

IR = {}


def _ir(pkg):
    if pkg not in IR:
        ho, sir = (jho, jsir) if pkg == "jax" else (tho, tsir)
        IR[pkg] = sir.compile_scene(S.mixed_scene(ho))
    return IR[pkg]


@pytest.fixture(scope="module", params=[np.float64, np.float32],
                ids=["f64", "f32"])
def pair(request):
    dt = request.param
    return (JTracer(_ir("jax"), dtype=dt),
            TTracer(_ir("torch"), dtype=dt, device="cpu"), dt)


def _t(x, dt):
    return torch.as_tensor(np.asarray(x, dt))


def _near_tie(t1, t2):
    with np.errstate(invalid="ignore"):
        return np.abs(t2 - t1) < 1e-4 * (1 + np.abs(t1))


def _cmp_hits(got, want, dt, t2=None):
    """(t, nor, oid, sign) of the port against the JAX tracer's."""
    t_g, n_g, o_g, s_g = got
    t_w, n_w, o_w, s_w = want
    fin = np.isfinite(t_w)
    assert fin.any() and (~fin).any()
    both = fin & np.isfinite(t_g)
    if dt == np.float64:
        assert (np.isfinite(t_g) == fin).mean() >= 0.999
        np.testing.assert_allclose(t_g[both], t_w[both], rtol=1e-6)
        clear = both if t2 is None else both & ~_near_tie(t_w, t2)
        assert (o_g[clear] == o_w[clear]).mean() >= 0.999
        same = clear & (o_g == o_w)
        np.testing.assert_array_equal(s_g[same], s_w[same])
        np.testing.assert_allclose(n_g[same], n_w[same], atol=1e-6)
    else:
        assert (np.isfinite(t_g) == fin).mean() >= 0.998
        np.testing.assert_allclose(t_g[both], t_w[both], rtol=2e-4,
                                   atol=2e-4)
        assert (o_g[both] == o_w[both]).mean() >= 0.99
        same = both & (o_g == o_w)
        np.testing.assert_allclose(n_g[same], n_w[same], rtol=0, atol=5e-3)
        assert (s_g[same] == s_w[same]).mean() >= 0.999


@pytest.mark.parametrize("matter_only", [False, True],
                         ids=["all", "matter"])
def test_nearest2(pair, matter_only):
    jt, tt, dt = pair
    p, d = S.rays(512, seed=1)
    want = [np.asarray(x) for x in jt.nearest2(
        p.astype(dt), d.astype(dt), matter_only=matter_only)]
    got = [x.numpy() for x in tt.nearest2(_t(p, dt), _t(d, dt),
                                          matter_only=matter_only)]
    _cmp_hits(got[:4], want[:4], dt, t2=want[4])
    fin2 = np.isfinite(want[4]) & np.isfinite(got[4])
    tol = 1e-6 if dt == np.float64 else 2e-4
    np.testing.assert_allclose(got[4][fin2], want[4][fin2], rtol=tol,
                               atol=0 if dt == np.float64 else tol)
    if matter_only:
        lights = np.flatnonzero(tt.is_light)
        assert not np.isin(got[2], lights).any()


@pytest.mark.parametrize("query", ["trans_hit", "trans_hit_mixed"])
def test_trans_hit(pair, query):
    jt, tt, dt = pair
    p, d = S.rays(512, seed=5)
    args_j, args_t = (p.astype(dt), d.astype(dt)), (_t(p, dt), _t(d, dt))
    if query == "trans_hit_mixed":
        mask = np.arange(len(p)) % 2 == 0
        args_j += (mask,)
        args_t += (torch.as_tensor(mask),)
    want = [np.asarray(x) for x in getattr(jt, query)(*args_j)]
    got = [x.numpy() for x in getattr(tt, query)(*args_t)]
    fin = np.isfinite(want[0])
    both = fin & np.isfinite(got[0])
    rate = 0.999 if dt == np.float64 else 0.998
    assert (np.isfinite(got[0]) == fin).mean() >= rate
    tol = 1e-6 if dt == np.float64 else 2e-4
    np.testing.assert_allclose(got[0][both], want[0][both], rtol=tol,
                               atol=0 if dt == np.float64 else tol)
    agree = (got[2] == want[2]) & (got[3] == want[3])
    assert agree[both].mean() >= 0.99
    if query == "trans_hit_mixed":
        lights = np.flatnonzero(tt.is_light)
        assert not np.isin(got[2][args_j[2]], lights).any()


def test_shadow_blocked(pair):
    jt, tt, dt = pair
    p, d = S.rays(512, seed=9)
    lim = np.random.default_rng(11).uniform(0.2, 15.0, len(p)).astype(dt)
    want = np.asarray(jt.shadow_blocked(p.astype(dt), d.astype(dt), lim))
    got = tt.shadow_blocked(_t(p, dt), _t(d, dt), _t(lim, dt)).numpy()
    assert want.any() and (~want).any()
    assert (got == want).mean() >= (0.999 if dt == np.float64 else 0.998)


def test_object_hit_t(pair):
    """Every object: singles, the analytic composites, the SDF composites
    and the standalone torus."""
    jt, tt, dt = pair
    p, d = S.rays(256, seed=13)
    sdf_oids = {c.oid for c in tt.comp_solo} | {o for _, o, *_ in
                                                tt.sdf_singles}
    assert len(sdf_oids) == 4
    for oid in range(len(tt.ir.objects)):
        want = np.asarray(jt.object_hit_t(oid, p.astype(dt), d.astype(dt)))
        got = tt.object_hit_t(oid, _t(p, dt), _t(d, dt)).numpy()
        fin = np.isfinite(want)
        both = fin & np.isfinite(got)
        rate = 0.999 if dt == np.float64 else 0.998
        assert (np.isfinite(got) == fin).mean() >= rate, oid
        tol = 1e-6 if dt == np.float64 else 2e-4
        np.testing.assert_allclose(got[both], want[both], rtol=tol,
                                   atol=0 if dt == np.float64 else tol,
                                   err_msg=str(oid))
        if oid in sdf_oids:
            assert fin.any(), oid


def _drain_pair(**kw):
    jt = JTracer(jsir.compile_scene(S.lamp_scene(jho, **kw)),
                 dtype=np.float64)
    tt = TTracer(tsir.compile_scene(S.lamp_scene(tho, **kw)),
                 dtype=np.float64, device="cpu")
    ji, ti = JIntegrator(jt, batch=64), TIntegrator(tt, batch=64)
    ji.seed_mode = ti.seed_mode = "counter"
    return ji, ti


def _pos(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, cfg.image_width, n),
                     rng.uniform(0, cfg.image_height, n)], -1)


@pytest.mark.parametrize("kw", [dict(), dict(path_samples=2, depth=8)],
                         ids=["normal", "mixed"])
def test_drain_matches_run_device(kw):
    """The whole drain of camera samples over an SDF scene (the mixed
    config runs the mixed normal/path drain)."""
    ji, ti = _drain_pair(**kw)
    assert ti.tr.comp_solo and ti.tr.sdf_singles
    pos = _pos(ji.cfg, 24)
    want = ji.run_device(None, len(pos), pos_xy=pos)
    got = ti.run_samples(pos)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert ti.rays_traced == ji.rays_traced


def test_load_jax_params_sdf_round_trip():
    """The JAX export of an SDF scene (with the standalone SDF objects'
    `sdfs{i}_*` keys) loads into the port and comes back equal; moving the
    torus through its key moves what the port's tracer sees."""
    ji, ti = _drain_pair()
    geom = {k: np.array(v) for k, v in ji.tr.geom_params().items()}
    mat = {k: np.array(v) for k, v in ji.mat_params().items()}
    assert {"sdfs0_m", "sdfs0_m0", "sdfs0_prm"} <= set(geom)
    load_jax_params(ti.tr, ti, geom, mat)
    back = ti.tr.geom_params()
    assert set(back) == set(geom)
    for k in geom:
        np.testing.assert_array_equal(back[k], geom[k], err_msg=k)
    p, d = S.rays(256, seed=17, spread=3.0)
    oid = ti.tr.sdf_singles[0][1]
    before = ti.tr.object_hit_t(oid, _t(p, np.float64), _t(d, np.float64))
    want = np.asarray(ji.tr.object_hit_t(oid, p.astype(np.float64),
                                         d.astype(np.float64)))
    np.testing.assert_allclose(before.numpy(), want, rtol=1e-12)
    geom["sdfs0_m0"] = geom["sdfs0_m0"] + np.array([0.0, 0.0, 0.5])
    load_jax_params(ti.tr, ti, geom, mat)
    np.testing.assert_array_equal(ti.tr.geom_params()["sdfs0_m0"],
                                  geom["sdfs0_m0"])
    after = ti.tr.object_hit_t(oid, _t(p, np.float64), _t(d, np.float64))
    assert not np.array_equal(np.isfinite(after.numpy()),
                              np.isfinite(before.numpy()))
