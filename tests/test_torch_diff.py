"""The port's differentiable renderer (actinon_tpu_torch/render/diff.py)
on the CPU in f64: the scenes of tests/test_diff.py's material,
refraction, geometry and path cases.

  * Agreement with the JAX package: the loss within rtol 1e-8 and every
    gradient entry within rtol 1e-5 plus 1e-8 of its table's largest
    magnitude, against jax.value_and_grad through actinon_tpu.render.diff
    (each scene's JAX values computed once per module), by the replay as
    it runs on the CPU and with host reads off, as a CUDA-graph capture
    runs it (tests/test_torch_diff_graph.py holds the two bit-equal).
  * Finite differences on the port alone, at tests/test_diff.py's
    tolerances.
  * The replay against the port's counter-mode wavefront drain, the
    state radiance leaves behind, and the routing under `diff`/`ovr`.

The edge-aware and SDF cases are in test_torch_diff_edge.py,
test_torch_diff_quadric.py and test_torch_diff_sdf.py (one file each, so
that the JAX compilations spread over the test workers)."""

import numpy as np
import pytest
import torch

from _torch_diff import (assert_matches_jax, fd_check, jax_value_and_grad,
                         port_setup)
from _torch_threads import one_torch_thread  # noqa: F401

# (scene, sel_mode): the plain, balanced-selection, CSG and path variants
AGREE = [("plain", "uniform"), ("glass", "balanced"), ("lens", "uniform"),
         ("path", "balanced")]


@pytest.fixture(scope="module")
def jax_vals():
    cache = {}

    def get(name, sel_mode):
        if (name, sel_mode) not in cache:
            cache[(name, sel_mode)] = jax_value_and_grad(name, sel_mode)
        return cache[(name, sel_mode)]
    return get


@pytest.mark.parametrize("name,sel_mode", AGREE,
                         ids=[f"{n}-{s}" for n, s in AGREE])
def test_grads_match_jax(jax_vals, name, sel_mode):
    dr, q0 = port_setup(name, sel_mode)
    assert_matches_jax(dr.value_and_grad(q0), jax_vals(name, sel_mode))


@pytest.mark.parametrize("name,sel_mode", AGREE,
                         ids=[f"{n}-{s}" for n, s in AGREE])
def test_no_read_replay_matches_jax(monkeypatch, jax_vals, name, sel_mode):
    """The replay as a CUDA-graph capture runs it (host reads off: every
    bounce and every NEE, as the JAX scan runs them) against the jitted
    JAX value_and_grad, at the same tolerance."""
    from actinon_tpu_torch.render import diff, tracer
    monkeypatch.setattr(diff, "host_reads_ok", lambda device: False)
    monkeypatch.setattr(tracer, "host_reads_ok", lambda device: False)
    dr, q0 = port_setup(name, sel_mode)
    got = dr.value_and_grad(q0)
    assert dr.steps_run == dr.n_steps
    assert_matches_jax(got, jax_vals(name, sel_mode))


@pytest.mark.parametrize("name,sel_mode", [("glass", "balanced"),
                                           ("path", "balanced")],
                         ids=["glass-balanced", "path-balanced"])
def test_skipped_nee_bounce_matches_jax(jax_vals, name, sel_mode):
    """Batches in which some bounce has no diffusely shaded lane, so its
    NEE and the NEE's backward are skipped (`Integrator._nee_gated`, the
    JAX step's lax.cond), against jax.value_and_grad in f64."""
    from actinon_tpu_torch.render.integrator import Integrator
    ran = []
    orig = Integrator._nee_gated

    def spy(self, pos, surf_d, di, gate, *rest):
        ran.append(bool(gate.any()))
        return orig(self, pos, surf_d, di, gate, *rest)

    dr, q0 = port_setup(name, sel_mode)
    dr.integ._nee_gated = spy.__get__(dr.integ)
    got = dr.value_and_grad(q0)
    assert True in ran and False in ran
    assert_matches_jax(got, jax_vals(name, sel_mode))


# (scene, group, key, flat index, delta, rtol, sign of the gradient):
# tests/test_diff.py's TestMaterialGrads, TestRefractionGrads,
# TestGeometryGrads and TestPathTracing
FD = [
    ("plain", "mat", "l_rad", 0, 1e-3, 1e-5, 1),
    ("plain", "mat", "m_color", 1 * 3 + 1, 1e-4, 1e-4, 1),   # floor green
    ("plain", "mat", "background", 2, 1e-4, 1e-5, 0),
    ("plain", "mat", "l_pos", 2, 1e-4, 5e-3, 0),
    # the sample count floor(direct_samples * intensity * diffuse) is a
    # step function of the weight: 0.7 sits away from its steps
    ("diffuse07", "mat", "m_diffuse", 1, 1e-4, 5e-3, 0),
    ("glass", "mat", "m_rix", 2, 1e-5, 2e-2, 0),             # glass ball
    ("glass", "mat", "m_transp", 2 * 3 + 0, 1e-5, 2e-2, 0),
    ("plain", "geom", "sph_r", 1, 1e-5, 2e-2, 0),            # the ball
    ("plain", "geom", "sph_c", 1 * 3 + 2, 1e-5, 2e-2, 0),
    ("plain", "geom", "pla_k", 0, 1e-5, 2e-2, 0),
    ("lens", "geom", "c0_l0_r", 0, 1e-5, 3e-2, 0),
    ("path", "mat", "m_color", 1 * 3 + 0, 1e-4, 5e-3, 0),
]


@pytest.mark.parametrize("name,group,key,idx,delta,rtol,sign", FD,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in FD])
def test_fd_matches_autograd(name, group, key, idx, delta, rtol, sign):
    dr, q0 = port_setup(name)
    g_ad, _ = fd_check(dr, q0, group, key, idx, delta, rtol)
    if sign:
        assert g_ad * sign > 0


def test_radiance_matches_forward_expectation():
    """A scene without specular branches: the replay equals the port's
    counter-mode wavefront drain (run_device) lane for lane."""
    dr, _ = port_setup("plain", sel_mode="balanced")
    rng = np.random.default_rng(5)
    cfg = dr.integ.cfg
    pos = np.stack([rng.uniform(0, cfg.image_width, 32),
                    rng.uniform(0, cfg.image_height, 32)], -1)
    rad = dr.radiance(dr.params(), dr.primary(pos)).numpy()
    dr.integ.seed_mode = "counter"
    acc = dr.integ.run_device(None, len(pos), pos_xy=pos)
    assert rad.max() > 0
    np.testing.assert_allclose(rad, acc, rtol=1e-8, atol=1e-10)


def test_radiance_leaves_state_as_found():
    """radiance restores the overrides, flags and seed mode, drops its
    assembled tables, and a forward step after it equals one before it
    bit for bit."""
    dr, q0 = port_setup("lens", sel_mode="balanced")
    integ, tr = dr.integ, dr.tr
    lane = {k: q0[k] for k in ("p", "d", "intensity", "tint", "depth",
                               "sample_id")}
    before = integ._step(lane)
    tabs = tuple(t.clone() for t in tr.tabs)
    mats = {k: v.clone() for k, v in integ._dev.items()}
    dr.value_and_grad(q0)
    assert (tr.ovr, tr.diff, integ.ovr, integ.seed_mode,
            integ.edge_aware) == ({}, False, {}, "position", False)
    assert tr._ovr_tabs is None and integ._ovr_mats is None
    for a, b in zip(tabs, tr.tabs):
        assert torch.equal(a, b) and not b.requires_grad
    for k, v in integ._dev.items():
        assert torch.equal(mats[k], v) and not v.requires_grad
    after = integ._step(lane)
    assert torch.equal(before[1], after[1])
    for name in before[2]:
        for f, v in before[2][name].items():
            assert torch.equal(v, after[2][name][f]), (name, f)


def test_diff_routes_every_query_plain(monkeypatch):
    """Under `diff` or `ovr` the kernel routes are off, the CPU test
    flags included, and a replay over a scene that the packed scene
    kernels would carry calls no kernel wrapper."""
    from actinon_tpu_torch.render import bigscene, kernels, scene_kernels
    dr, q0 = port_setup("torus", dtype=np.float32)
    tr, integ = dr.tr, dr.integ
    tr.scene_kernels_on_cpu = tr.bigscene_on_cpu = True
    tr.BIG_MIN_ROWS = 1
    monkeypatch.setattr(kernels, "nee_supported", lambda integ: True)
    real = tr.device
    tr.device = torch.device("cuda")        # the predicates alone
    integ.seed_mode = "position"
    assert tr._kernel_device_ok() and tr._scene_route_ok() \
        and tr._bigscene_ok() and integ._nee_kernel_ok()
    for attr, on, off in ((tr, "diff", True), (tr, "ovr", {"sph_r": 1}),
                          (integ, "ovr", {"l_rad": 1})):
        saved = getattr(attr, on)
        setattr(attr, on, off)
        assert not integ._nee_kernel_ok()
        if attr is tr:
            assert not (tr._kernel_device_ok() or tr._kernels_ok()
                        or tr._scene_route_ok() or tr._bigscene_ok())
        setattr(attr, on, saved)
    tr.device = real

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called under diff")
    for mod, names in ((scene_kernels, ("scene_top2", "scene_anyhit")),
                       (bigscene, ("big_top2", "big_anyhit")),
                       (kernels, ("shadow_any_hit", "object_hit", "nee"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    loss, grads = dr.value_and_grad(q0)
    assert np.isfinite(float(loss))
    assert float(grads["geom"]["sdfs0_prm"].abs()) > 0


def test_edge_coverage_warning():
    """Scenes with occluder classes the edge terms leave out (SDF, cone)
    warn; fully covered scenes do not."""
    import warnings
    from actinon_tpu_torch.render.diff import (DiffRenderer,
                                               EdgeCoverageWarning,
                                               edge_coverage_gaps)
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    from _torch_diff import coverage_scene, make_scene

    def integ(sc):
        return Integrator(Tracer(sir.compile_scene(sc), dtype=np.float64,
                                 device="cpu"), batch=64)
    i1 = integ(coverage_scene(ho))
    gaps = edge_coverage_gaps(i1.tr)
    assert "SDF object" in gaps and "cone/hyperboloid quadric" in gaps
    with pytest.warns(EdgeCoverageWarning):
        DiffRenderer(i1, edge_aware=True)
    i2 = integ(make_scene(ho, lens=True))
    assert not edge_coverage_gaps(i2.tr)
    with warnings.catch_warnings():
        warnings.simplefilter("error", EdgeCoverageWarning)
        DiffRenderer(i2, edge_aware=True)
