"""The PyTorch port's tracer against the JAX tracer, on the CPU.

The same Python-built scene (every analytic family, an and/not composite
group, a sphere lamp and an ellipsoid lamp in an envelope) is compiled by
each package's own front end; seeded numpy rays go through both tracers.
f64: t at rtol 1e-9 and winner identity exact away from near-ties (the
rule of tests/test_pallas_scene.py:11-13).  f32: discrete agreement
>= 0.998.  The port's composite walk is the crossing-parity walk where
the JAX group path uses its polynomial-sign form, so near-ties are
excluded from identity checks."""

import numpy as np
import pytest
import torch

from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho
from _torch_threads import one_torch_thread  # noqa: F401


def build(ho):
    """Every analytic family as singles, an and/not composite group of
    two, a finite-cylinder composite, a sphere lamp and an ellipsoid lamp
    in an envelope."""
    sc = ho.Scene()
    lamp = ho.Sphere(0.4)
    lamp.move(ho.v3(1.0, 0.0, 8.0))
    lamp.prp.radiance = 30.0
    sc.push(lamp)
    bar = ho.Squaroid.ellipsoid(1.0, 0.35, 0.35)
    bar.set_envelope(ho.Envelope((0, 0, 0), 1.1))
    bar.move(ho.v3(-3.0, 1.5, 6.0))
    bar.prp.radiance = 12.0
    sc.push(bar)
    floor = ho.Plane()
    floor.move(ho.v3(0, 0, -2.5))
    sc.push(floor)
    ball = ho.Sphere(0.8)
    ball.move(ho.v3(4.5, 1.0, 0.0))
    sc.push(ball)
    ell = ho.Squaroid.ellipsoid(1.2, 0.7, 0.5)
    ell.rotate(ho.rot_x(0.4))
    ell.move(ho.v3(-4.5, -1.0, 0.5))
    sc.push(ell)
    cone = ho.Squaroid.cone(0.5, 0.5, 1.0)
    cone.move(ho.v3(0.0, -5.0, 0.0))
    sc.push(cone)
    hyp = ho.Squaroid.hyperboloid2(0.6, 0.6, 0.6)
    hyp.rotate(ho.rot_y(0.7))
    hyp.move(ho.v3(5.0, -4.0, 2.0))
    sc.push(hyp)
    for k in range(2):
        comp = ho.PairInside(ho.Sphere(1.0), ho.Neg(ho.Sphere(0.6)))
        comp.move(ho.v3(2.5 * k - 1.0, 3.0, 0.2 * k))
        comp.set_auto_envelope()
        sc.push(comp)
    cyl = ho.PairInside(ho.Squaroid.cylinder(0.5, 0.5),
                        ho.PairInside(ho.Plane(), ho.Neg(ho.Plane())))
    cyl.o2.o2.o1.move(ho.v3(0, 0, -1.0))
    cyl.o2.o1.move(ho.v3(0, 0, 1.0))
    cyl.move(ho.v3(-2.0, -2.0, 0.0))
    sc.push(cyl)
    return sc


def tracers(dtype):
    jt = JTracer(jsir.compile_scene(build(jho)), dtype=dtype)
    tt = TTracer(tsir.compile_scene(build(tho)), dtype=dtype, device="cpu")
    return jt, tt


def rays(n=600, seed=1, spread=7.0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-spread, spread, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x, dtype))


def test_nearest2_f64():
    jt, tt = tracers(np.float64)
    p, d = rays()
    want = [np.asarray(x) for x in jt.nearest2(p, d)]
    got = [x.numpy() for x in tt.nearest2(_t(p, np.float64),
                                          _t(d, np.float64))]
    t1, n1, o1, s1, t2, n2, o2, s2 = want
    fin = np.isfinite(t1)
    assert fin.mean() > 0.3 and (~fin).any()
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    np.testing.assert_allclose(got[0][fin], t1[fin], rtol=1e-9)
    both2 = np.isfinite(t2) & np.isfinite(got[4])
    np.testing.assert_array_equal(np.isfinite(got[4]), np.isfinite(t2))
    np.testing.assert_allclose(got[4][both2], t2[both2], rtol=1e-9)
    # winner identity away from near-ties between the two hits
    with np.errstate(invalid="ignore"):
        clear = fin & ~(np.abs(t2 - t1) < 1e-6 * (1 + np.abs(t1)))
    np.testing.assert_array_equal(got[2][clear], o1[clear])
    np.testing.assert_array_equal(got[3][clear], s1[clear])
    np.testing.assert_allclose(got[1][clear], n1[clear], atol=1e-9)


@pytest.mark.parametrize("query", ["trans_hit", "trans_hit_matter"])
def test_trans_hit_f64(query):
    jt, tt = tracers(np.float64)
    p, d = rays(seed=5)
    want = [np.asarray(x) for x in getattr(jt, query)(p, d)]
    got = [x.numpy() for x in getattr(tt, query)(_t(p, np.float64),
                                                 _t(d, np.float64))]
    fin = np.isfinite(want[0])
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=1e-9)
    np.testing.assert_allclose(got[1][fin], want[1][fin], atol=1e-9)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_trans_hit_mixed_f64():
    """Per-lane matter-only lanes (the mixed path drain's query)."""
    jt, tt = tracers(np.float64)
    p, d = rays(seed=9)
    mask = np.random.default_rng(3).uniform(size=len(p)) < 0.5
    want = [np.asarray(x) for x in jt.trans_hit_mixed(p, d, mask)]
    got = [x.numpy() for x in tt.trans_hit_mixed(
        _t(p, np.float64), _t(d, np.float64), torch.as_tensor(mask))]
    fin = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=1e-9)
    np.testing.assert_array_equal(got[2], want[2])


def test_shadow_blocked_f64():
    jt, tt = tracers(np.float64)
    p, d = rays(seed=2)
    lim = np.random.default_rng(4).uniform(0.1, 12.0, len(p))
    want = np.asarray(jt.shadow_blocked(p, d, lim))
    got = tt.shadow_blocked(_t(p, np.float64), _t(d, np.float64),
                            _t(lim, np.float64)).numpy()
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_object_hit_t(dtype):
    """Every light (a sphere and an enveloped ellipsoid) and a composite."""
    jt, tt = tracers(dtype)
    p, d = rays(seed=6)
    comp_oid = jt.composites[0].oid
    for oid in (0, 1, comp_oid):
        want = np.asarray(jt.object_hit_t(oid, p.astype(dtype),
                                          d.astype(dtype)))
        got = tt.object_hit_t(oid, _t(p, dtype), _t(d, dtype)).numpy()
        fin = np.isfinite(want)
        assert fin.any()
        if dtype == np.float64:
            np.testing.assert_array_equal(np.isfinite(got), fin)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-9)
        else:
            assert (np.isfinite(got) == fin).mean() >= 0.998
            both = fin & np.isfinite(got)
            np.testing.assert_allclose(got[both], want[both], rtol=1e-4,
                                       atol=1e-4)


def test_discrete_agreement_f32():
    jt, tt = tracers(np.float32)
    p, d = rays(n=1000, seed=7)
    p32, d32 = p.astype(np.float32), d.astype(np.float32)
    t1, _, o1, s1 = [np.asarray(x) for x in jt.nearest(p32, d32)]
    g = tt.nearest(_t(p, np.float32), _t(d, np.float32))
    assert (g[2].numpy() == o1).mean() >= 0.998
    assert (np.isfinite(g[0].numpy()) == np.isfinite(t1)).mean() >= 0.998
    lim = np.random.default_rng(8).uniform(0.1, 12.0, len(p))
    want = np.asarray(jt.shadow_blocked(p32, d32, lim.astype(np.float32)))
    got = tt.shadow_blocked(_t(p, np.float32), _t(d, np.float32),
                            _t(lim, np.float32)).numpy()
    assert (got == want).mean() >= 0.998


def test_geom_params_keys_and_values():
    """The port exports the JAX tracer's geometry parameters: same keys,
    same values."""
    jt, tt = tracers(np.float64)
    jg = {k: np.asarray(v) for k, v in jt.geom_params().items()}
    tg = tt.geom_params()
    assert set(jg) == set(tg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-15, err_msg=k)


def test_sdf_scene_raises():
    """SDF scenes load; what still raises is a packed scene table whose
    winner codes (shape << 24 | member << 8 | leaf) would overflow: 129
    standalone tori of distinct march lengths are 129 shapes."""
    from actinon_tpu_torch.render import scene_kernels
    sc = tho.Scene()
    for k in range(129):
        t = tho.make_torus(1.0, 0.3)
        t.cycles = 50 + k
        t.move(tho.v3(3.0 * k, 0.0, 0.0))
        sc.push(t)
    tt = TTracer(tsir.compile_scene(sc), dtype=np.float32, device="cpu")
    assert len(tt.sdf_singles) == 129
    with pytest.raises(ValueError, match="shape index"):
        scene_kernels.SceneTable(tt, matter_only=False)


def test_default_device_is_cuda():
    """Entry points default to the card and raise without one."""
    import inspect
    assert inspect.signature(TTracer).parameters["device"].default == "cuda"
    ir = tsir.compile_scene(build(tho))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTracer(ir, dtype=np.float32)
