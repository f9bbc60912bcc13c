"""The port's CUDA kernels on the card.  Every test here needs a card and
skips itself without one; the file imports nothing of JAX, so it runs on
the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets up JAX.)  Each kernel is
held to the contracts of tests/test_pallas.py and
tests/test_pallas_scene.py against its plain PyTorch version on the same
CUDA tensors: shadow booleans agree on >= 99.8 % of rays, object hits
agree in finiteness on >= 99.8 % and in t within 1e-3 (1 + t), NEE
radiance is within rel 1e-2 on >= 99 % of lanes; the scene, big-scene
and diagnostic kernels as stated above their tests."""

import os

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "actinon_tpu_torch", "scenes", "glass_table.acn")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def integ():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    cap[0].cfg.direct_samples = 6
    tr = Tracer(sir.compile_scene(cap[0]), dtype=np.float32, device="cuda")
    return Integrator(tr, batch=4096)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2])
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lim = rng.uniform(0.1, 12.0, n).astype(np.float32)
    return (torch.as_tensor(x, device="cuda") for x in (p, d, lim))


def test_shadow_kernel_matches_plain(integ):
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    p, d, lim = _rays(8192, 1)
    before = kernels.LAUNCHES["shadow"]
    got = kernels.shadow_any_hit(tr, p, d, lim)
    assert kernels.LAUNCHES["shadow"] == before + 1
    want = kernels.shadow_plain(tr, p, d, lim)
    assert want.any() and (~want).any()
    assert float((got == want).float().mean()) >= 0.998


K2_SIZES = [1, 31, 33, 5120, 40960, 327680]


@pytest.mark.parametrize("n", K2_SIZES)
def test_shadow_designs_equal(integ, n):
    """K2's two designs (a warp a ray, a thread a ray) give every ray the
    same boolean, each meets the contract against the plain version, and
    the wrapper counts the launch under the design it took."""
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    p, d, lim = _rays(n, 100 + n % 97)
    got = {}
    for design in ("warp", "thread"):
        before = dict(kernels.LAUNCHES)
        got[design] = kernels.shadow_any_hit(tr, p, d, lim, design=design)
        assert kernels.LAUNCHES[f"shadow_{design}"] == \
            before[f"shadow_{design}"] + 1
        assert kernels.LAUNCHES["shadow"] == before["shadow"] + 1
    torch.cuda.synchronize()
    assert torch.equal(got["warp"], got["thread"])
    want = kernels.shadow_plain(tr, p, d, lim)
    for design in ("warp", "thread"):
        assert float((got[design] == want).float().mean()) >= 0.998
    if n > 1000:
        assert bool(want.any()) and bool((~want).any())


def test_shadow_launch_picks_design_by_size(integ):
    """shadow_launch takes the warp design up to SHADOW_WARP_MAX_RAYS and
    the thread design above, a thread block for each SHADOW_WARPS or
    SHADOW_THREADS rays, and the default design is what the wrapper
    counts, on each side of the threshold."""
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    m = kernels.SHADOW_WARP_MAX_RAYS
    for n, design in ((m, "warp"), (m + 1, "thread")):
        launch = kernels.shadow_launch(tr, n)
        assert launch["design"] == design == kernels.shadow_design(n)
        per = launch["rays_per_block"]
        assert launch["grid"] == -(-n // per)
        assert launch["shared_bytes"] < kernels.SHARED_MAX
        p, d, lim = _rays(n, 5)
        before = dict(kernels.LAUNCHES)
        kernels.shadow_any_hit(tr, p, d, lim)
        other = "thread" if design == "warp" else "warp"
        assert kernels.LAUNCHES[f"shadow_{design}"] == \
            before[f"shadow_{design}"] + 1
        assert kernels.LAUNCHES[f"shadow_{other}"] == \
            before[f"shadow_{other}"]


def test_shadow_refuses_shared_overflow(integ, monkeypatch):
    """A scene table beyond a thread block's shared memory is refused, by
    the wrapper and by the C launcher in both designs, and nothing
    launches."""
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    p, d, lim = _rays(64, 3)
    st = kernels.scene_table(tr)
    out = torch.empty((64,), dtype=torch.bool, device="cuda")
    before = dict(kernels.LAUNCHES)
    need = kernels.shadow_launch(tr, 64)["shared_bytes"]
    monkeypatch.setattr(kernels, "SHARED_MAX", need - 4)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.shadow_any_hit(tr, p, d, lim)
    for warp in (1, 0):
        rc = kernels._lib().actinon_shadow(
            st.f.data_ptr(), st.i.data_ptr(), 60000, st.i.numel(),
            p.data_ptr(), d.data_ptr(), lim.data_ptr(), out.data_ptr(), 64,
            float(tr.eps), warp, kernels._stream())
        assert rc != 0
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("oid", [0, 1, 3])
def test_object_hit_kernel_matches_plain(integ, oid):
    """Both lamps (a sphere and the enveloped ellipsoid) and the goblet."""
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    p, d, _ = _rays(8192, 2 + oid)
    target = torch.as_tensor(tr.ir.objects[oid].pos, dtype=torch.float32,
                             device="cuda")
    if oid == 3:
        target = torch.tensor([0.0, 0.0, 1.5], device="cuda")
    aim = target - p[:4096]
    d[:4096] = aim / torch.linalg.norm(aim, dim=-1, keepdim=True)
    got = kernels.object_hit(tr, oid, p, d)
    want = kernels.object_hit_plain(tr, oid, p, d)
    fin = torch.isfinite(want)
    assert int(fin.sum()) > 2048
    assert float((torch.isfinite(got) == fin).float().mean()) >= 0.998
    both = fin & torch.isfinite(got)
    assert bool((torch.abs(got[both] - want[both])
                 <= 1e-3 * (1 + want[both])).all())


def test_nee_kernel_matches_plain(integ):
    from actinon_tpu_torch.render import kernels
    rng = np.random.default_rng(7)
    B, cap = 4096, integ.direct_cap
    pos = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2])
    sd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    di = np.where(rng.uniform(0, 1, B) > 0.3,
                  rng.uniform(0, 1.2, B), 0.0).astype(np.float32)
    sigma = rng.uniform(0, 0.4, B).astype(np.float32)
    sig2 = sigma * sigma
    on_a = np.where(sigma > 0, 1 - 0.5 * sig2 / (sig2 + 0.33), 1).astype(
        np.float32)
    on_b = np.where(sigma > 0, 0.45 * sig2 / (sig2 + 0.09), 0).astype(
        np.float32)
    prj = rng.normal(0, 1, (B, 3)).astype(np.float32)
    prj /= np.linalg.norm(prj, axis=-1, keepdims=True)
    rv = rng.integers(0, 2 ** 32, B, dtype=np.uint32)
    ns = np.minimum(np.maximum((cap * di).astype(np.int32), 1), cap)
    t = lambda x: torch.as_tensor(x, device="cuda")
    args = (t(pos), t(sd), t(di),
            t(np.cos(rng.uniform(0, np.pi * 0.999, B)).astype(np.float32)),
            t(on_a), t(on_b), t(prj), t(rv.view(np.int32)).view(torch.uint32),
            t(ns))
    got = kernels.nee(integ, *args)
    want = kernels.nee_plain(integ, *args)
    assert bool((want > 0).any())
    rel = torch.abs(got - want) / (torch.abs(want) + 1e-4)
    assert float((rel.max(dim=1).values < 1e-2).float().mean()) >= 0.99


def test_wrappers_refuse_bad_tensors(integ):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    p, d, lim = _rays(64, 9)
    with pytest.raises(TypeError):
        kernels.shadow_any_hit(tr, p.double(), d, lim)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.shadow_any_hit(tr, p.t().contiguous().t(), d, lim)
    with pytest.raises(ValueError, match="shape"):
        kernels.object_hit(tr, 0, p[:, :2].contiguous(), d)


def test_float64_on_cuda_raises(integ):
    """The kernels are f32: a CUDA tracer in f64 is refused."""
    from actinon_tpu_torch.render.tracer import Tracer
    with pytest.raises(ValueError, match="float32"):
        Tracer(integ.tr.ir, dtype=np.float64, device="cuda")


def test_render_on_card_is_deterministic(integ, tmp_path):
    """Two renders of the smoke scene on the card give the same fold hash
    (deterministic accumulation), through the NEE kernel."""
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.driver import render_scene
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 48, 36
    hashes = []
    for k in range(2):
        stats = {}
        kernels.reset_launches()
        render_scene(sc.clone(), str(tmp_path / f"{k}.pnm"), force=True,
                     verbose=False, batch=1 << 12, device="cuda",
                     stats=stats)
        assert kernels.LAUNCHES["nee"] > 0
        hashes.append(stats["hash"])
    assert hashes[0] == hashes[1]


# -- K4 and K5, the packed scene kernels ------------------------------------
#
# Contracts of tests/test_pallas_scene.py against the plain versions on
# the same CUDA tensors: finiteness equal on >= 99.8 % of rays, winner
# codes equal on >= 99 % of the finite lanes, t within rtol/atol 2e-4
# where the codes agree, any-hit booleans equal on >= 99.8 % of rays.


def _scene_tracer(name):
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    import _torch_scenes as S
    if name == "mixed":
        sc = S.mixed_scene(ho)
    else:
        from actinon_tpu_torch.acn.interp import run_file
        cap = []
        run_file(S.LAMP_ROW, render_fn=lambda s, fn: cap.append(s.clone()),
                 args=["-f"])
        sc = cap[0]
    return Tracer(sir.compile_scene(sc), dtype=np.float32, device="cuda")


@pytest.fixture(scope="module", params=["mixed", "lamp_row"])
def scene_tr(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return _scene_tracer(request.param)


def _scene_rays(n, seed):
    """Random rays through the scene's box, half of them aimed at points
    near the scene's centre so that they meet the composites."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-7, 7, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(0.1, 6, n)
    aim = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    aim[:, 2] = rng.uniform(0, 4, n)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[: n // 2] = aim[: n // 2] - p[: n // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lim = rng.uniform(0.1, 12.0, n).astype(np.float32)
    lim[::7] = np.inf
    lm = (rng.uniform(0, 1, n) < 0.5).astype(np.float32)
    return (torch.as_tensor(x, device="cuda") for x in (p, d, lim, lm))


def test_scene_top2_kernel_matches_plain(scene_tr):
    from actinon_tpu_torch.render import kernels, scene_kernels
    tr = scene_tr
    st, _ = tr._scene_tables()
    p, d, _, lm = _scene_rays(8192, 21)
    before = kernels.LAUNCHES["scene_top2"]
    t_k, c_k = scene_kernels.scene_top2(tr, p, d, lm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scene_top2"] == before + 1
    t_p, c_p = scene_kernels.scene_top2_plain(st, p, d, lm)
    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    assert float(fin_p[:, 0].float().mean()) > 0.2
    assert float((fin_k == fin_p).float().mean()) >= 0.998
    both = fin_k & fin_p
    assert float((c_k[both] == c_p[both]).float().mean()) >= 0.99
    # t where the winners agree (a different winner is a near-tie)
    same = both & (c_k == c_p)
    assert bool((torch.abs(t_k[same] - t_p[same])
                 <= 2e-4 + 2e-4 * torch.abs(t_p[same])).all())
    assert bool((c_k[~fin_k] == -1).all())


def test_scene_anyhit_kernel_matches_plain(scene_tr):
    from actinon_tpu_torch.render import kernels, scene_kernels
    tr = scene_tr
    _, stm = tr._scene_tables()
    p, d, lim, _ = _scene_rays(8192, 22)
    before = kernels.LAUNCHES["scene_anyhit"]
    got = scene_kernels.scene_anyhit(tr, p, d, lim)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scene_anyhit"] == before + 1
    want = scene_kernels.scene_anyhit_plain(stm, p, d, lim)
    assert want.any() and (~want).any()
    assert float((got == want).float().mean()) >= 0.998


def test_sdf_render_on_card_launches_scene_kernels(tmp_path):
    """A small lamp_row render on the card goes through K4 and K5 and
    repeats its fold hash."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.driver import render_scene
    import _torch_scenes as S
    cap = []
    run_file(S.LAMP_ROW, render_fn=lambda s, fn: cap.append(s.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 32, 24
    sc.cfg.direct_samples = 2
    hashes = []
    for k in range(2):
        stats = {}
        kernels.reset_launches()
        img = render_scene(sc.clone(), str(tmp_path / f"{k}.pnm"),
                           force=True, verbose=False, batch=1 << 12,
                           device="cuda", stats=stats)
        assert np.isfinite(img).all()
        assert kernels.LAUNCHES["scene_top2"] > 0
        assert kernels.LAUNCHES["scene_anyhit"] > 0
        assert kernels.LAUNCHES["nee"] == 0
        hashes.append(stats["hash"])
    assert hashes[0] == hashes[1]


def test_scene_wrappers_refuse_bad_tensors(scene_tr):
    from actinon_tpu_torch.render import scene_kernels
    p, d, lim, lm = _scene_rays(64, 23)
    with pytest.raises(TypeError):
        scene_kernels.scene_top2(scene_tr, p.double(), d, lm)
    with pytest.raises(ValueError, match="contiguous"):
        scene_kernels.scene_anyhit(scene_tr, p, d.t().contiguous().t(), lim)
    with pytest.raises(ValueError, match="shape"):
        scene_kernels.scene_anyhit(scene_tr, p, d, lim[:10])


# -- K6 and K7, the big-scene sphere kernels ---------------------------------
#
# Contracts of tests/test_bigscene.py against the plain versions on the
# same CUDA tensors: finiteness equal on >= 99.8 % of rays, block indices
# equal on >= 99 % of the finite lanes, t within 2e-4 (1 + t) where they
# agree, any-hit booleans equal on >= 99.8 % of rays.


@pytest.fixture(scope="module")
def big_tr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    import _torch_scenes as S
    tr = Tracer(sir.compile_scene(S.many_sphere_scene(ho, n=2000)),
                dtype=np.float32, device="cuda")
    assert tr._bigscene_ok()
    return tr


def _big_rays(n, seed):
    import _torch_scenes as S
    p, d = S.rays(n, seed=seed, spread=10.0)
    lim = np.random.default_rng(seed).uniform(0.5, 20.0, n).astype(
        np.float32)
    lim[::7] = np.inf
    return (torch.as_tensor(x, device="cuda") for x in (p, d, lim))


def test_big_top2_kernel_matches_plain(big_tr):
    from actinon_tpu_torch.render import bigscene, kernels
    p, d, _ = _big_rays(8192, 31)
    big = big_tr._bigscene()
    before = kernels.LAUNCHES["big_top2"]
    t_k, g_k = bigscene.big_top2(big_tr, p, d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_top2"] == before + 1
    t_p, g_p = bigscene.big_top2_plain(big.blocks, p, d, table=big.table)
    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    assert float(fin_p[:, 0].float().mean()) > 0.2
    assert float((fin_k == fin_p).float().mean()) >= 0.998
    both = fin_k & fin_p
    assert float((g_k[both] == g_p[both]).float().mean()) >= 0.99
    same = both & (g_k == g_p)
    assert bool((torch.abs(t_k[same] - t_p[same])
                 <= 2e-4 * (1 + torch.abs(t_p[same]))).all())
    assert bool((g_k[~fin_k] == 0).all())


def test_big_anyhit_kernel_matches_plain(big_tr):
    from actinon_tpu_torch.render import bigscene, kernels
    p, d, lim = _big_rays(8192, 32)
    big = big_tr._bigscene()
    before = kernels.LAUNCHES["big_anyhit"]
    got = bigscene.big_anyhit(big_tr, p, d, lim)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["big_anyhit"] == before + 1
    want = bigscene.big_anyhit_plain(big.blocks, p, d, lim, table=big.table)
    assert want.any() and (~want).any()
    assert float((got == want).float().mean()) >= 0.998


def test_big_wrappers_refuse_bad_tensors(big_tr):
    from actinon_tpu_torch.render import bigscene
    p, d, lim = _big_rays(64, 33)
    with pytest.raises(TypeError):
        bigscene.big_top2(big_tr, p.double(), d)
    with pytest.raises(ValueError, match="shape"):
        bigscene.big_anyhit(big_tr, p, d, lim[:10])


def test_big_scene_render_launches_k4_k6_k7(big_tr, tmp_path):
    """A small render of the sphere scene goes through K6 and K7 (and K4
    for the light), never K1, K2 or K5, and repeats its fold hash."""
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.driver import render_scene
    from actinon_tpu_torch.scene import objects as ho
    import _torch_scenes as S
    sc = S.many_sphere_scene(ho, n=2000)
    cfg = sc.cfg
    cfg.image_width, cfg.image_height = 32, 24
    cfg.direct_samples, cfg.trace_depth = 2, 4
    cfg.camera_position = (0.0, -14.0, 2.0)
    cfg.camera_view_direction = (0.0, 1.0, 0.0)
    cfg.camera_top_direction = (0.0, 0.0, 1.0)
    hashes = []
    for k in range(2):
        stats = {}
        kernels.reset_launches()
        img = render_scene(sc.clone(), str(tmp_path / f"{k}.pnm"),
                           force=True, verbose=False, batch=1 << 12,
                           device="cuda", stats=stats)
        assert np.isfinite(img).all()
        L = kernels.LAUNCHES
        assert L["big_top2"] > 0 and L["big_anyhit"] > 0
        assert L["scene_top2"] > 0
        assert L["nee"] == L["shadow"] == L["scene_anyhit"] == 0
        hashes.append(stats["hash"])
    assert hashes[0] == hashes[1]


# -- K4 and K6, the warp kernels, on exact ties and ragged sizes ------------
#
# On the tie lattices of tests/_torch_scenes.py every root is exact in
# f32, so each warp kernel must equal its plain version bit for bit: t,
# and every index or code, on copies of one sphere or member that tie
# exactly, and on ray counts that leave warps and thread blocks partly
# empty.  K6's lattice has more blocks than one bound stage holds and a
# partial last block; K4's singles shape spans three member blocks.

RAGGED = [1, 31, 33, 32773]


@pytest.fixture(scope="module")
def tie_big():
    """A stand-in tracer whose `_bigscene` holds the tie lattice's
    blocks on the card (what big_top2 reads of a tracer)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from types import SimpleNamespace
    from actinon_tpu_torch.render import bigscene
    import _torch_scenes as S
    c = S.tie_centres(S.TIE_BIG_SHAPE)
    blocks = bigscene.SphereBlocks(np.arange(len(c)), c,
                                   np.full(len(c), 0.25), 1e-4)
    assert blocks.G > bigscene.BOUND_CHUNK and blocks.n % bigscene.LB
    table, bounds = blocks.upload("cuda")
    big = SimpleNamespace(blocks=blocks, table=table, bounds=bounds)
    return SimpleNamespace(_bigscene=lambda: big)


@pytest.mark.parametrize("n", RAGGED)
def test_big_top2_kernel_exact_on_ties(tie_big, n):
    from actinon_tpu_torch.render import bigscene
    import _torch_scenes as S
    big = tie_big._bigscene()
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.axis_rays(n, S.TIE_BIG_SHAPE, seed=n))
    t_k, g_k = bigscene.big_top2(tie_big, p, d)
    torch.cuda.synchronize()
    t_p, g_p = bigscene.big_top2_plain(big.blocks, p, d, table=big.table)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(g_k, g_p)
    if n > 1000:
        fin = torch.isfinite(t_p[:, 0])
        assert bool(((t_p[:, 0] == t_p[:, 1]) & fin).any())


def _anyhit_limits(blocks, table, p, d, seed):
    """K7 limits on its own comparisons: the nearest eps-backed hit t
    exactly, one ulp below it, random limits and, on every fifth ray,
    none (INF)."""
    from actinon_tpu_torch.render import bigscene
    t1 = bigscene.big_top2_plain(blocks, p, d, table=table)[0][:, 0]
    t1 = t1.cpu().numpy()
    lim = np.random.default_rng(seed).uniform(0.5, 20.0, len(t1)).astype(
        np.float32)
    fin = np.isfinite(t1)
    lim[1::5] = np.where(fin[1::5], t1[1::5], lim[1::5])
    lim[2::5] = np.where(fin[2::5], np.nextafter(t1[2::5], np.float32(0)),
                         lim[2::5])
    lim[::5] = np.inf
    return torch.as_tensor(lim, device="cuda")


@pytest.mark.parametrize("design", ["warp", "thread"])
@pytest.mark.parametrize("n", RAGGED)
def test_big_anyhit_kernel_exact_on_ties(tie_big, n, design):
    """K7 in both designs on the tie lattice, limits exactly at a hit's t
    and one ulp below it: the plain version's booleans bit for bit, each
    launch counted under its design."""
    from actinon_tpu_torch.render import bigscene, kernels
    import _torch_scenes as S
    big = tie_big._bigscene()
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.axis_rays(n, S.TIE_BIG_SHAPE, seed=n + 1))
    lim = _anyhit_limits(big.blocks, big.table, p, d, seed=n)
    before = kernels.LAUNCHES[f"big_anyhit_{design}"]
    got = bigscene.big_anyhit(tie_big, p, d, lim, design=design)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f"big_anyhit_{design}"] == before + 1
    want = bigscene.big_anyhit_plain(big.blocks, p, d, lim, table=big.table)
    assert torch.equal(got, want)
    if n > 1000:
        assert bool(want.any()) and bool((~want).any())


def test_big_anyhit_designs_equal_on_fractal_blocks():
    """K7's two designs give every ray the same boolean on fractal-shaped
    blocks (256 blocks, random rays), with limits at and one ulp below
    the plain version's hits and with random limits; on the random
    limits both meet the contract against the plain version.  (A limit
    exactly at the plain version's t is no test of the kernel against
    it: nvcc contracts the candidate to FMA, so its t may lie an ulp
    away.  The tie lattice holds that case bit for bit.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from types import SimpleNamespace
    from actinon_tpu_torch.render import bigscene
    import _torch_scenes as S
    c, r = S.fractal_spheres()
    blocks = bigscene.SphereBlocks(np.arange(len(c)), c, r, 1e-4)
    table, bounds = blocks.upload("cuda")
    big = SimpleNamespace(blocks=blocks, table=table, bounds=bounds)
    tr = SimpleNamespace(_bigscene=lambda: big)
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.rays(65536, seed=83, spread=6.0))
    at_hits = _anyhit_limits(blocks, table, p, d, seed=89)
    rand = torch.as_tensor(np.random.default_rng(97).uniform(
        0.5, 20.0, p.shape[0]).astype(np.float32), device="cuda")
    for lim in (at_hits, rand):
        warp = bigscene.big_anyhit(tr, p, d, lim, design="warp")
        thread = bigscene.big_anyhit(tr, p, d, lim, design="thread")
        torch.cuda.synchronize()
        assert torch.equal(warp, thread)
    want = bigscene.big_anyhit_plain(blocks, p, d, rand, table=table)
    assert bool(want.any()) and bool((~want).any())
    assert float((warp == want).float().mean()) >= 0.998


@pytest.fixture(scope="module")
def tie_scene_tr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    import _torch_scenes as S
    tr = Tracer(sir.compile_scene(S.tie_scene(ho)), dtype=np.float32,
                device="cuda")
    assert tr._prefer_scene_query() and not tr._bigscene_ok()
    st, _ = tr._scene_tables()
    assert max(sh.M for sh in st.shapes) > 128 and st.shapes[0].has_light
    return tr


@pytest.mark.parametrize("n", RAGGED)
def test_scene_top2_kernel_exact_on_ties(tie_scene_tr, n):
    from actinon_tpu_torch.render import scene_kernels
    import _torch_scenes as S
    tr = tie_scene_tr
    st, _ = tr._scene_tables()
    p, d = S.axis_rays(n, S.TIE_SHAPE, seed=n)
    lm = (np.random.default_rng(n).uniform(size=n) < 0.5).astype(np.float32)
    p, d, lm = (torch.as_tensor(x, device="cuda") for x in (p, d, lm))
    t_k, c_k = scene_kernels.scene_top2(tr, p, d, lm)
    torch.cuda.synchronize()
    t_p, c_p = scene_kernels.scene_top2_plain(st, p, d, lm)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(c_k, c_p)
    if n > 1000:
        fin = torch.isfinite(t_p[:, 0])
        assert bool(((t_p[:, 0] == t_p[:, 1]) & fin).any())


def test_scene_top2_refuses_shared_overflow(tie_scene_tr, monkeypatch):
    """A descriptor beyond a thread block's shared memory (beside K4's
    bound stages) is refused, by the wrapper and by the C launcher, and
    nothing launches."""
    from actinon_tpu_torch.render import kernels, scene_kernels
    import _torch_scenes as S
    tr = tie_scene_tr
    st, _ = tr._scene_tables()
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.axis_rays(64, S.TIE_SHAPE, seed=3))
    lm = torch.zeros(64, device="cuda")
    t = torch.empty((64, 2), device="cuda")
    c = torch.empty((64, 2), dtype=torch.int32, device="cuda")
    before = kernels.LAUNCHES["scene_top2"]
    need = scene_kernels.top2_launch(st)["shared_bytes"]
    monkeypatch.setattr(scene_kernels, "SHARED_MAX", need - 4)
    with pytest.raises(ValueError, match="shared memory"):
        scene_kernels.scene_top2(tr, p, d, lm)
    rc = kernels._lib().actinon_scene_top2(
        st.table_t.data_ptr(), st.bounds_t.data_ptr(),
        st.block_shape_t.data_ptr(), st.desc_t.data_ptr(), p.data_ptr(),
        d.data_ptr(), lm.data_ptr(), t.data_ptr(), c.data_ptr(), 64,
        float(st.eps), 60000, kernels._stream())
    assert rc != 0
    assert kernels.LAUNCHES["scene_top2"] == before


# -- K5 and K1, the warp any-hit and NEE kernels ----------------------------
#
# K5's booleans are an OR over the members, so the warp kernel with its
# any-exit must equal its plain version on exact-tie inputs bit for bit,
# limits exactly at the nearest hit and one ulp before it included.  K1's
# sums run in a fixed order: two launches give the same bits.


def _tie_limits(stm, p, d, seed):
    """The nearest matter hit exactly, one ulp before it, random limits
    and, on every fifth ray, none (INF)."""
    from actinon_tpu_torch.render import scene_kernels
    n = p.shape[0]
    t1 = scene_kernels.scene_top2_plain(
        stm, p, d, torch.ones(n, device=p.device))[0][:, 0]
    lim = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.2, 15.0, n).astype(np.float32), device=p.device)
    fin = torch.isfinite(t1)
    k = torch.arange(n, device=p.device) % 5
    lim = torch.where((k == 1) & fin, t1, lim)
    lim = torch.where((k == 2) & fin, torch.nextafter(t1, torch.zeros_like(
        t1)), lim)
    return torch.where(k == 0, torch.full_like(lim, float("inf")), lim)


@pytest.mark.parametrize("n", RAGGED)
def test_scene_anyhit_kernel_exact_on_ties(tie_scene_tr, n):
    from actinon_tpu_torch.render import kernels, scene_kernels
    import _torch_scenes as S
    tr = tie_scene_tr
    _, stm = tr._scene_tables()
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.axis_rays(n, S.TIE_SHAPE, seed=n + 1))
    lim = _tie_limits(stm, p, d, seed=n)
    before = kernels.LAUNCHES["scene_anyhit"]
    got = scene_kernels.scene_anyhit(tr, p, d, lim)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scene_anyhit"] == before + 1
    want = scene_kernels.scene_anyhit_plain(stm, p, d, lim)
    assert torch.equal(got, want)
    if n > 1000:
        assert want.any() and (~want).any()


def test_scene_anyhit_refuses_shared_overflow(tie_scene_tr, monkeypatch):
    from actinon_tpu_torch.render import kernels, scene_kernels
    import _torch_scenes as S
    tr = tie_scene_tr
    _, stm = tr._scene_tables()
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.axis_rays(64, S.TIE_SHAPE, seed=5))
    lim = torch.full((64,), 5.0, device="cuda")
    out = torch.empty((64,), dtype=torch.bool, device="cuda")
    before = kernels.LAUNCHES["scene_anyhit"]
    need = scene_kernels.anyhit_launch(stm)["shared_bytes"]
    monkeypatch.setattr(scene_kernels, "SHARED_MAX", need - 4)
    with pytest.raises(ValueError, match="shared memory"):
        scene_kernels.scene_anyhit(tr, p, d, lim)
    rc = kernels._lib().actinon_scene_anyhit(
        stm.table_t.data_ptr(), stm.bounds_t.data_ptr(),
        stm.block_shape_t.data_ptr(), stm.desc_t.data_ptr(), p.data_ptr(),
        d.data_ptr(), lim.data_ptr(), out.data_ptr(), 64, float(stm.eps),
        60000, kernels._stream())
    assert rc != 0
    assert kernels.LAUNCHES["scene_anyhit"] == before


def test_scene_kernels_exact_past_one_bound_stage():
    """K4 and K5 over a singles shape of more bounds than one of K4's
    shared-memory stages holds (tie_singles at TIE_BIG_SHAPE, about
    18,000 spheres in some 145 blocks, kept in the scene tables in place
    of the big-scene kernels), so K4's bounds pass through both stages and
    the last is partly filled: bit for bit the plain versions on axis
    rays, K5's limits at the nearest hit and one ulp before it included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from actinon_tpu_torch.render import scene_kernels
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    import _torch_scenes as S
    tr = Tracer(sir.compile_scene(S.tie_singles(ho, S.TIE_BIG_SHAPE)),
                dtype=np.float32, device="cuda")
    st, stm = (scene_kernels.SceneTable(tr, m) for m in (False, True))
    tr._kernel_cache["scene_tables"] = (st, stm)
    for t in (st, stm):
        nb = t.bounds_t.shape[0]
        assert nb > scene_kernels.CHUNK and nb % scene_kernels.CHUNK
    n = 4099
    p, d = S.axis_rays(n, S.TIE_BIG_SHAPE, seed=7)
    lm = (np.random.default_rng(8).uniform(size=n) < 0.5).astype(np.float32)
    p, d, lm = (torch.as_tensor(x, device="cuda") for x in (p, d, lm))
    t_k, c_k = scene_kernels.scene_top2(tr, p, d, lm)
    torch.cuda.synchronize()
    t_p, c_p = scene_kernels.scene_top2_plain(st, p, d, lm)
    assert bool(torch.isfinite(t_p[:, 0]).any())
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(c_k, c_p)
    lim = _tie_limits(stm, p, d, seed=9)
    got = scene_kernels.scene_anyhit(tr, p, d, lim)
    torch.cuda.synchronize()
    want = scene_kernels.scene_anyhit_plain(stm, p, d, lim)
    assert want.any() and (~want).any()
    assert torch.equal(got, want)


def _nee_args(integ, B, seed):
    rng = np.random.default_rng(seed)
    cap = integ.direct_cap
    pos = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2])
    sd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    di = np.where(rng.uniform(0, 1, B) > 0.3,
                  rng.uniform(0, 1.2, B), 0.0).astype(np.float32)
    on_b = np.where(rng.uniform(0, 1, B) > 0.5, 0.2, 0.0).astype(np.float32)
    prj = rng.normal(0, 1, (B, 3)).astype(np.float32)
    prj /= np.linalg.norm(prj, axis=-1, keepdims=True)
    rv = rng.integers(0, 2 ** 32, B, dtype=np.uint32)
    ns = np.minimum(np.maximum((cap * di).astype(np.int32), 1), cap)
    t = lambda x: torch.as_tensor(x, device="cuda")
    return (t(pos), t(sd), t(di),
            t(np.cos(rng.uniform(0, np.pi * 0.999, B)).astype(np.float32)),
            t((1 - on_b).astype(np.float32)), t(on_b), t(prj),
            t(rv.view(np.int32)).view(torch.uint32), t(ns))


def test_warp_kernels_deterministic(integ, tie_scene_tr):
    """K1 (fixed-order sums) and K5 (an OR) give the same bits on two
    launches, at sizes that leave the last thread block part empty."""
    from actinon_tpu_torch.render import kernels, scene_kernels
    import _torch_scenes as S
    args = _nee_args(integ, 4097, 17)
    a, b = kernels.nee(integ, *args), kernels.nee(integ, *args)
    torch.cuda.synchronize()
    assert bool((a > 0).any())
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    tr = tie_scene_tr
    _, stm = tr._scene_tables()
    p, d = (torch.as_tensor(x, device="cuda")
            for x in S.axis_rays(8195, S.TIE_SHAPE, seed=7))
    lim = _tie_limits(stm, p, d, seed=7)
    assert torch.equal(scene_kernels.scene_anyhit(tr, p, d, lim),
                       scene_kernels.scene_anyhit(tr, p, d, lim))


def test_nee_refuses_shared_overflow(integ, monkeypatch):
    """Tables beyond a thread block's shared memory are refused, by the
    wrapper and by the C launcher, and nothing launches."""
    from actinon_tpu_torch.render import kernels
    args = _nee_args(integ, 64, 3)
    st, lt = kernels.scene_table(integ.tr), kernels.light_table(integ)
    out = torch.empty((64, 3), device="cuda")
    before = kernels.LAUNCHES["nee"]
    need = kernels.nee_launch(integ)["shared_bytes"]
    monkeypatch.setattr(kernels, "SHARED_MAX", need - 4)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.nee(integ, *args)
    rc = kernels._lib().actinon_nee(
        st.f.data_ptr(), st.i.data_ptr(), 60000, st.i.numel(),
        lt.f.data_ptr(), lt.i.data_ptr(), lt.n, int(integ.direct_cap),
        *(a.data_ptr() for a in args), out.data_ptr(), 64,
        float(integ.tr.eps), kernels._stream())
    assert rc != 0
    assert kernels.LAUNCHES["nee"] == before


def test_nee_many_samples_render_launches_k1(tmp_path):
    """A glass_table render at 2 lights x 8,000 samples goes through K1,
    whose samples pass the warp's shared slice in chunks (whole slices
    would need 512 KB), and gives a finite image."""
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.driver import render_scene
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 4, 3
    sc.cfg.direct_samples, sc.cfg.trace_depth = 8000, 3
    kernels.reset_launches()
    img = render_scene(sc, str(tmp_path / "many.pnm"), force=True,
                       verbose=False, batch=1 << 10, device="cuda")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nee"] > 0
    assert np.isfinite(img).all() and img.max() > 0


# -- K8 and K9, the diagnostic ops -------------------------------------------


def test_diag_kernels_match_torch():
    """Each op launches its kernel once and is held to torch's op on the
    same tensor: sqrt and division bit-equal (IEEE-rounded in both), the
    library transcendentals and rsqrt within 4 ulp, a * b + c within one
    rounding of each term (the kernel's FMA against torch's two
    roundings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from actinon_tpu_torch import diag_ops
    from actinon_tpu_torch.render import kernels
    inp = diag_ops.tool_inputs("cuda")
    for name in diag_ops.UNARY:
        x = inp["x"][name]
        before = kernels.LAUNCHES["diag_unary"]
        got = diag_ops.unary(name, x)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["diag_unary"] == before + 1
        ud = diag_ops.ulp_diff(got, diag_ops.unary_plain(name, x))
        assert int(ud.max()) <= (0 if name == "sqrt" else 4), name
    a, b, c = inp["args"]["mul_add"]
    before = kernels.LAUNCHES["diag_expr"]
    assert int(diag_ops.ulp_diff(diag_ops.expr("div", a, b), a / b).max()) \
        == 0
    got = diag_ops.expr("mul_add", a, b, c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["diag_expr"] == before + 2
    err = torch.abs(got - (a * b + c))
    assert bool((err <= 2.0 ** -23 * (torch.abs(a * b) + torch.abs(c))).all())


# -- the differentiable renderer (render/diff.py) ----------------------------


def _diff_glass_table(dtype, device, n, **kw):
    """A DiffRenderer over glass_table at 40x30, direct=4, depth=8, and
    its first n camera samples of default_rng(3)."""
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.diff import DiffRenderer
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 40, 30
    sc.cfg.direct_samples, sc.cfg.trace_depth = 4, 8
    tr = Tracer(sir.compile_scene(sc), dtype=dtype, device=device,
                use_kernels=dtype == np.float32)
    dr = DiffRenderer(Integrator(tr, batch=n), **kw)
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(0, 40, n), rng.uniform(0, 30, n)], -1)
    return dr, dr.primary(pos)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the port on the card")


@pytest.mark.parametrize("edge_aware", [False, True])
def test_diff_on_card_finite_and_launches_no_kernel(edge_aware):
    """value_and_grad on the card in f32: a finite loss and gradients.
    The replay launches no kernel; the edge terms' detached light hits
    may (K3, as the JAX package's forward query would)."""
    _need_card()
    from actinon_tpu_torch.render import kernels
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512,
                               edge_aware=edge_aware)
    before = dict(kernels.LAUNCHES)
    loss, grads = dr.value_and_grad(q0)
    torch.cuda.synchronize()
    moved = {k for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert moved <= ({"object_hit"} if edge_aware else set()), moved
    assert np.isfinite(float(loss))
    for g, grp in grads.items():
        for k, v in grp.items():
            assert bool(torch.isfinite(v).all()), (g, k)
    assert float(grads["mat"]["l_rad"].abs().max()) > 0


def test_diff_card_matches_cpu_f64():
    """The same lanes in f64 on the card (the plain path) and on the CPU:
    the loss within rel 1e-6, each gradient within 1e-5 of its table's
    largest magnitude plus rel 1e-5."""
    _need_card()
    got = []
    for dev in ("cuda", "cpu"):
        dr, q0 = _diff_glass_table(np.float64, dev, 128)
        loss, grads = dr.value_and_grad(q0)
        got.append((float(loss), grads))
    (lc, gc), (lh, gh) = got
    np.testing.assert_allclose(lc, lh, rtol=1e-6)
    for g, grp in gh.items():
        for k, want in grp.items():
            want = want.numpy()
            np.testing.assert_allclose(
                gc[g][k].cpu().numpy(), want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max(initial=0.0)),
                err_msg=f"{g}.{k}")


def test_diff_fd_on_card():
    """Central differences in f64 on the card, uniform selection: the
    sphere lamp's radiance (tests/test_diff.py's tolerance)."""
    _need_card()
    dr, q0 = _diff_glass_table(np.float64, "cuda", 128, sel_mode="uniform")
    _, grads = dr.value_and_grad(q0)
    params = dr.params()
    g_ad = float(grads["mat"]["l_rad"][0])

    def at(eps):
        ps = {g: dict(v) for g, v in params.items()}
        ps["mat"]["l_rad"] = params["mat"]["l_rad"].clone()
        ps["mat"]["l_rad"][0] += eps
        with torch.no_grad():
            return float(dr.render_loss(ps, q0))

    g_fd = (at(1e-3) - at(-1e-3)) / 2e-3
    assert g_ad > 0
    assert abs(g_ad - g_fd) <= 1e-9 + 1e-5 * max(abs(g_ad), abs(g_fd)), \
        (g_ad, g_fd)


# -- multi-device rendering (parallel/mesh.py) and the C3 discriminants ------


def test_world_of_one_nccl_equals_run_device():
    """A world of one over NCCL: ShardedIntegrator's image is
    run_device's, bit for bit, on a small glass_table render."""
    _need_card()
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.parallel.mesh import ShardedIntegrator, make_mesh
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    mesh = make_mesh(1, device="cuda")
    assert (mesh.size, mesh.backend) == (1, "nccl")
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 40, 30
    sc.cfg.direct_samples, sc.cfg.trace_depth = 4, 8
    ir = sir.compile_scene(sc)
    ys, xs = np.mgrid[0:30, 0:40]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    sh = ShardedIntegrator(Tracer(ir, dtype=np.float32), mesh, batch=1024)
    single = Integrator(Tracer(ir, dtype=np.float32), batch=1024)
    acc_sh = sh.run_samples(pos)
    acc_1 = single.run_device(None, len(pos), pos_xy=pos)
    assert np.array_equal(acc_sh, acc_1) and acc_1.max() > 0
    assert sh.rays_traced == single.rays_traced and sh.last_balance == 1.0


def test_sharded_diff_world_of_one_equals_value_and_grad():
    _need_card()
    from actinon_tpu_torch.parallel.mesh import ShardedDiffRenderer, make_mesh
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512)
    loss, grads = dr.value_and_grad(q0)
    loss_s, grads_s = ShardedDiffRenderer(
        dr, make_mesh(1, device="cuda")).value_and_grad(q0)
    assert abs(float(loss_s) - float(loss)) < 1e-5
    for g, grp in grads.items():
        for k, want in grp.items():
            np.testing.assert_allclose(grads_s[g][k].cpu().numpy(),
                                       want.cpu().numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{g}.{k}")


def test_sphere_first_hit_same_bits_on_card_and_cpu():
    """The f32 light hit's dots, q and discriminant, each rounded once
    (formed in f64), and Tracer._roots' s, q and discriminant test: the
    same bits on the card as on the CPU.  The hits themselves take a
    square root, which torch's CPU f32 sqrt rounds up to an ulp away from
    the card's (IEEE) one: the same finiteness, rel 1e-6."""
    _need_card()
    from actinon_tpu_torch.render.tracer import (Tracer, _disc, _dot_fma32,
                                                 _fma32, _sphere_first_hit)
    rng = np.random.default_rng(11)
    n = 65536
    c = torch.tensor([2.0, -1.0, 5.0])
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p = torch.as_tensor(c.numpy() + u * rng.uniform(1, 2700, n)[:, None],
                        dtype=torch.float32)
    d = torch.as_tensor(c.numpy() + rng.normal(0, 0.3, (n, 3)),
                        dtype=torch.float32) - p
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    r = torch.tensor(0.37)

    def parts(c, r, p, d):
        pp = p - c
        s = _dot_fma32(pp, d)
        q = _fma32(-r, r, _dot_fma32(pp, pp))
        return s, q, _disc(s, q), _sphere_first_hit(c, r, p, d, 1e-4)

    cpu = parts(c, r, p, d)
    card = [x.cpu() for x in parts(c.cuda(), r.cuda(), p.cuda(), d.cuda())]
    for a, b in zip(cpu[:3], card[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    fin = torch.isfinite(cpu[3])
    assert fin.any() and (~fin).any()
    assert torch.equal(fin, torch.isfinite(card[3]))
    torch.testing.assert_close(card[3][fin], cpu[3][fin], rtol=1e-6,
                               atol=0)
    A, B, C = (torch.as_tensor(x, dtype=torch.float32) for x in (
        np.ones(n), 2 * (u * rng.normal(size=(n, 3))).sum(1),
        rng.normal(size=n)))
    got_cpu = Tracer._roots(A, B, C)
    got_card = [x.cpu() for x in Tracer._roots(A.cuda(), B.cuda(),
                                                C.cuda())]
    for k in (2, 3, 4):                                # s, q, ok
        assert torch.equal(got_cpu[k], got_card[k])
    for k in (0, 1):                                   # t0u, t1u
        f = torch.isfinite(got_cpu[k])
        assert torch.equal(f, torch.isfinite(got_card[k]))
        torch.testing.assert_close(got_card[k][f], got_cpu[k][f],
                                   rtol=1e-6, atol=1e-6)


# -- the primary-queue entry points ------------------------------------------


def test_run_device_queue_equals_positions_on_card():
    """run_device(primary, n) on the primaries of the device-precision
    raygen (the padded position block run_device builds its own rays
    from) is run_device(None, n, pos_xy)'s image bit for bit, with its
    queries, through K1; the host drain (run, device_drain = False) on
    the same queue launches K1 too and agrees within
    tests/test_path_device.py's bounds."""
    _need_card()
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.integrator import Integrator, RayQueue
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.image_width, sc.cfg.image_height = 40, 30
    sc.cfg.direct_samples, sc.cfg.trace_depth = 4, 8
    integ = Integrator(Tracer(sir.compile_scene(sc), dtype=np.float32),
                       batch=1024)
    ys, xs = np.mgrid[0:30, 0:40]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    n = len(pos)
    blk = np.zeros((2048, 2))
    blk[:n] = pos
    p, d = integ._camera_rays_dev(torch.as_tensor(blk, dtype=torch.float32,
                                                  device="cuda"))
    q = RayQueue(p[:n].cpu().numpy(), d[:n].cpu().numpy(),
                 np.ones(n, np.float32), np.ones((n, 3), np.float32),
                 np.full(n, 8, np.int32), np.arange(n, dtype=np.int32))
    acc_p = integ.run_device(None, n, pos_xy=pos)
    rays_p = integ.rays_traced
    kernels.reset_launches()
    acc_q = integ.run_device(q, n)
    assert kernels.LAUNCHES["nee"] > 0
    assert np.array_equal(acc_q, acc_p) and acc_p.max() > 0
    assert integ.rays_traced == 2 * rays_p
    integ.device_drain = False
    kernels.reset_launches()
    acc_h = integ.run(q, n)
    assert kernels.LAUNCHES["nee"] > 0
    assert abs(acc_h.mean() - acc_p.mean()) < 1e-5
    assert np.abs(acc_h - acc_p).max() < 1e-2
    assert integ.rays_traced == 3 * rays_p


# -- the graph drain (render/graphs.py) ---------------------------------------
#
# Each stage of the device drain replays a CUDA graph whose WHILE node runs
# `Integrator._trip` while the stage lasts (render/cond.py), the NEE inside
# under an IF node; the same trips run eagerly with drain_graphs = False.
# The two must give the same bits, trips, queries and kernel launches (the
# gated bodies' launches counted on the card), the graph drain reading the
# host once a stage.


def _graph_integ(name):
    """A small integrator on the card and its pixel centres: the headline
    path (glass_table, K1), lamp_row (K3-K7), the sphere scene (K4, K6,
    K7), counter seeding (K2, K3) and the path 8 config (the mixed
    drain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from actinon_tpu_torch.acn.interp import run_file
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    from actinon_tpu_torch.scene import objects as ho
    import _torch_scenes as S
    if name == "fractal":
        sc = S.many_sphere_scene(ho, n=2000)
        sc.cfg.camera_position = (0.0, -14.0, 2.0)
        sc.cfg.camera_view_direction = (0.0, 1.0, 0.0)
        sc.cfg.camera_top_direction = (0.0, 0.0, 1.0)
    else:
        cap = []
        run_file(S.LAMP_ROW if name == "lamp_row" else SCENE,
                 render_fn=lambda s, fn: cap.append(s.clone()), args=["-f"])
        sc = cap[0]
    cfg = sc.cfg
    cfg.image_width, cfg.image_height = 32, 24
    cfg.direct_samples, cfg.trace_depth = 3, 8
    if name == "path8":
        cfg.direct_samples, cfg.path_samples, cfg.trace_depth = 4, 8, 22
    integ = Integrator(Tracer(sir.compile_scene(sc), dtype=np.float32,
                              device="cuda"), batch=1 << 12)
    integ.seed_mode = "counter" if name == "counter" else "position"
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    return integ, pos


def _drain_once(integ, pos, graphs):
    from actinon_tpu_torch.render import kernels
    integ.drain_graphs = graphs
    integ.rays_traced = 0
    kernels.reset_launches()
    acc = integ.run_device(None, len(pos), pos_xy=pos)
    return acc, integ.last_trips, integ.rays_traced, dict(kernels.LAUNCHES)


@pytest.mark.parametrize("name", ["headline", "lamp_row", "fractal",
                                  "counter", "path8"])
def test_graph_drain_equals_eager(name):
    """The eager drain, then the graph drain twice (capture, then replays
    only): bit-equal images, equal trips, queries and launches."""
    integ, pos = _graph_integ(name)
    assert integ.drain_graphs
    want = _drain_once(integ, pos, False)
    assert want[0].max() > 0
    for _ in range(2):
        replays = integ._graphs.replays if integ._graphs else 0
        got = _drain_once(integ, pos, True)
        assert np.array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        stages = len(integ._stages(integ.batch))
        assert integ.last_host_reads <= stages
        assert integ._graphs.replays - replays == integ.last_host_reads
    assert integ._graphs.captures > 0


def test_missing_conditional_nodes_raise(monkeypatch):
    """Where conditional nodes are unavailable the captured paths raise at
    their first capture: no graph drain or diff graph runs flattened or
    eagerly in their place."""
    from actinon_tpu_torch.render import cond
    integ, pos = _graph_integ("headline")
    monkeypatch.setattr(cond, "_probe", lambda: "none on this card")
    monkeypatch.setattr(cond._S, "ok", None)
    try:
        with pytest.raises(RuntimeError, match="none on this card"):
            integ.run_device(None, len(pos), pos_xy=pos)
        assert not integ._graphs._graphs
        dr, q0 = _diff_glass_table(np.float32, "cuda", 128)
        with pytest.raises(RuntimeError, match="unavailable"):
            dr.value_and_grad(q0)
        assert not dr._graphs._graphs
    finally:
        cond._S.ok = None      # the real check runs again at next use


def test_graph_replay_reads_nothing_back():
    """A captured trip's replay under sync_debug_mode "error": no
    operation in it waits for the card."""
    integ, pos = _graph_integ("headline")
    integ.run_device(None, len(pos), pos_xy=pos)
    graph = next(iter(integ._graphs._graphs.values()))[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_graph_drain_after_set_geom():
    """set_geom drops the captured trips: the graph drain of moved
    geometry equals a fresh eager drain of it, not the old image."""
    integ, pos = _graph_integ("headline")
    before = _drain_once(integ, pos, True)[0]
    geom = integ.tr.geom_params()
    geom["sph_c"] = geom["sph_c"] + np.float32(0.25)
    integ.tr.set_geom(geom)
    got = _drain_once(integ, pos, True)[0]
    fresh, _ = _graph_integ("headline")
    fresh.tr.set_geom(geom)
    want = _drain_once(fresh, pos, False)[0]
    assert np.array_equal(got, want)
    assert not np.array_equal(got, before)


# -- the diff replay as a CUDA graph (render/graphs.py DiffGraphs) ---------
#
# On a card DiffRenderer.value_and_grad replays one CUDA graph of the whole
# replay, the loss and its backward; diff_graphs = False runs the same code
# eagerly.  The two must give the same bits.


def _vg_equal(a, b):
    bad = [] if torch.equal(a[0], b[0]) else ["loss"]
    return bad + [f"{g}.{k}" for g, grp in b[1].items()
                  for k, v in grp.items() if not torch.equal(a[1][g][k], v)]


DIFF_GRAPH = [(np.float32, 512, "balanced", False),
              (np.float32, 512, "uniform", False),
              (np.float32, 512, "uniform", True),
              (np.float64, 128, "balanced", False),
              (np.float64, 128, "uniform", False),
              (np.float64, 128, "uniform", True)]


@pytest.mark.parametrize(
    "dtype,n,sel_mode,edge_aware", DIFF_GRAPH,
    ids=[f"{np.dtype(c[0]).name}-{c[2]}{'-edge' if c[3] else ''}"
         for c in DIFF_GRAPH])
def test_diff_graph_equals_eager(dtype, n, sel_mode, edge_aware):
    """The eager call, then the graph call twice (capture and replay,
    then a replay alone): loss and gradients bit for bit, every bounce
    replayed, one capture, and no kernel launched but the edge terms' K3
    in f32, as often as in the eager call (the NEE runs under an IF node
    in every bounce of the replay, where the eager call stops once every
    lane is dead)."""
    _need_card()
    from actinon_tpu_torch.render import kernels
    dr, q0 = _diff_glass_table(dtype, "cuda", n, sel_mode=sel_mode,
                               edge_aware=edge_aware)
    assert dr.diff_graphs
    dr.diff_graphs = False
    kernels.reset_launches()
    want = dr.value_and_grad(q0)
    torch.cuda.synchronize()
    eager_k3 = kernels.LAUNCHES["object_hit"]
    assert float(want[0]) > 0
    dr.diff_graphs = True
    dr.value_and_grad(q0)
    for _ in range(2):
        kernels.reset_launches()
        got = dr.value_and_grad(q0)
        torch.cuda.synchronize()
        assert _vg_equal(got, want) == []
        moved = {k for k, v in kernels.LAUNCHES.items() if v}
        assert moved <= ({"object_hit"} if edge_aware else set()), moved
        assert kernels.LAUNCHES["object_hit"] == eager_k3
    assert dr.steps_run == dr.n_steps and dr._graphs.captures == 1


def test_diff_graph_replay_reads_nothing_back():
    """The captured value_and_grad's replay under sync_debug_mode
    "error": no operation in it waits for the card."""
    _need_card()
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512)
    dr.value_and_grad(q0)
    graph = next(iter(dr._graphs._graphs.values())).graph
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _only_graph(dr):
    (got,) = dr._graphs._graphs.values()
    return got.graph


def _moved_params(dr, step):
    """New parameter values, as a fit's step makes them: the spheres
    moved and the lamps brighter by `step`."""
    geom, mat = dr.tr.geom_params(), dr.integ.mat_params()
    return {"geom": {"sph_c": geom["sph_c"] + np.float32(0.05 * step)},
            "mat": {"l_rad": mat["l_rad"] * np.float32(1 + 0.1 * step)}}


def test_diff_graph_after_set_geom():
    """set_geom and set_mat keep the captured value_and_grad (the
    parameters reach it through its leaves): the next graph call replays
    the same graph, with no capture, and equals the eager call at the new
    parameters, not the old result."""
    _need_card()
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512)
    before = dr.value_and_grad(q0)
    graph = _only_graph(dr)
    moved = _moved_params(dr, 1)
    geom = dr.tr.geom_params()
    geom.update(moved["geom"])
    mat = dr.integ.mat_params()
    mat.update(moved["mat"])
    got = []
    for setter, values in ((dr.tr.set_geom, geom),
                           (dr.integ.set_mat, mat)):
        setter(values)
        dr.diff_graphs = True
        got.append(dr.value_and_grad(q0))
        assert dr._graphs.captures == 1 and _only_graph(dr) is graph
        dr.diff_graphs = False
        assert _vg_equal(got[-1], dr.value_and_grad(q0)) == []
    assert not torch.equal(got[0][1]["geom"]["sph_c"],
                           before[1]["geom"]["sph_c"])
    assert not torch.equal(got[1][0], got[0][0])


def test_diff_graph_params_argument():
    """value_and_grad at given parameter values, as a fit passes them:
    each call replays the one graph, bit for bit the eager call at the
    same values and the graph call after set_geom/set_mat to them."""
    _need_card()
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512)
    dr.value_and_grad(q0)
    graph = _only_graph(dr)
    for step in (1, 2):
        moved = _moved_params(dr, step)
        got = dr.value_and_grad(q0, params=moved)
        assert dr._graphs.captures == 1 and _only_graph(dr) is graph
    dr.diff_graphs = False
    assert _vg_equal(got, dr.value_and_grad(q0, params=moved)) == []
    dr.diff_graphs = True
    geom = dr.tr.geom_params()
    geom.update(moved["geom"])
    mat = dr.integ.mat_params()
    mat.update(moved["mat"])
    dr.tr.set_geom(geom)
    dr.integ.set_mat(mat)
    assert _vg_equal(got, dr.value_and_grad(q0)) == []
    assert _only_graph(dr) is graph


def test_diff_graph_edge_recaptures_after_set_geom():
    """With edge_aware the silhouette terms' detached queries read the
    tracer's own leaf table (glass_table's ellipsoid lamp), so set_geom
    drops the graph: the next call captures anew and equals the eager
    call at the moved geometry."""
    _need_card()
    dr, q0 = _diff_glass_table(np.float32, "cuda", 256, sel_mode="uniform",
                               edge_aware=True)
    dr.value_and_grad(q0)
    geom = dr.tr.geom_params()
    geom.update(_moved_params(dr, 1)["geom"])
    dr.tr.set_geom(geom)
    got = dr.value_and_grad(q0)
    assert dr._graphs.captures == 1 and dr._graphs.capture_s > 0
    dr.diff_graphs = False
    assert _vg_equal(got, dr.value_and_grad(q0)) == []


def test_diff_graph_no_diffuse_lane(monkeypatch):
    """Lanes that shade no surface diffusely (rays from the camera up and
    away from the scene: background only): the eager call never runs the
    NEE, and the graph's warm-up, which runs with host reads off as the
    capture does, still fills every constant the NEE reads, so the
    capture uploads nothing and the graph call equals the eager call."""
    _need_card()
    from actinon_tpu_torch.render.integrator import Integrator
    n = 256
    rng = np.random.default_rng(5)
    d = np.stack([rng.uniform(-0.3, 0.3, n), -np.ones(n),
                  rng.uniform(0.1, 0.5, n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def lanes(dr):
        q = dict(dr.primary(np.zeros((n, 2))))
        q["p"] = torch.as_tensor(np.broadcast_to(
            dr.tr.ir.cam_pos, (n, 3)).astype(np.float32), device="cuda")
        q["d"] = torch.as_tensor(d.astype(np.float32), device="cuda")
        return q

    nee = Integrator._nee
    calls = []

    def counted(self, *a, **k):
        calls.append(torch.cuda.is_current_stream_capturing())
        return nee(self, *a, **k)

    monkeypatch.setattr(Integrator, "_nee", counted)
    dr, _ = _diff_glass_table(np.float32, "cuda", n)
    dr.diff_graphs = False
    want = dr.value_and_grad(lanes(dr))
    assert calls == [] and float(want[0]) > 0
    dr, _ = _diff_glass_table(np.float32, "cuda", n)
    got = dr.value_and_grad(lanes(dr))
    assert True in calls and dr._graphs.captures == 1
    assert _vg_equal(got, want) == []


def test_sharded_diff_graph_world_of_one():
    """ShardedDiffRenderer at world size one through graphs: bit for bit
    its eager share, and value_and_grad within test_mesh's bounds."""
    _need_card()
    from actinon_tpu_torch.parallel.mesh import ShardedDiffRenderer, make_mesh
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512)
    sh = ShardedDiffRenderer(dr, make_mesh(1, device="cuda"))
    got = sh.value_and_grad(q0)
    assert dr._graphs.captures == 1
    loss, grads = dr.value_and_grad(q0)
    assert dr._graphs.captures == 2          # the whole batch: another key
    dr.diff_graphs = False
    assert _vg_equal(got, sh.value_and_grad(q0)) == []
    assert abs(float(got[0]) - float(loss)) < 1e-5
    for g, grp in grads.items():
        for k, want in grp.items():
            np.testing.assert_allclose(got[1][g][k].cpu().numpy(),
                                       want.cpu().numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{g}.{k}")


def test_diff_failed_capture_raises(monkeypatch):
    """A replay that reads the card back while it is captured makes the
    capture fail, and value_and_grad raises: it does not fall back to
    the eager call, and no allocation is routed to the failed graph's
    pool after it.  (Near the end of the file, beside the drain's: the
    failed capture leaves its pool.)"""
    _need_card()
    dr, q0 = _diff_glass_table(np.float32, "cuda", 512)
    share = dr._share

    def reads_back(leaves, q, weight=None, total=None):
        out = share(leaves, q, weight, total)
        if torch.cuda.is_current_stream_capturing():
            float(out[0])
        return out

    monkeypatch.setattr(dr, "_share", reads_back)
    with pytest.raises(RuntimeError):
        dr.value_and_grad(q0)
    torch.cuda.synchronize()
    _routing_ended(dr._graphs._pool)


def _routing_ended(pool):
    """No allocation routing to `pool` is left after its failed capture:
    a new allocation lands in a segment of another pool."""
    x = torch.empty((3 << 20) + 4096, dtype=torch.uint8, device="cuda")
    ptr = x.data_ptr()
    seg = next(s for s in torch.cuda.memory_snapshot()
               if s["address"] <= ptr < s["address"] + s["total_size"])
    assert tuple(seg["segment_pool_id"]) != tuple(pool)


def test_failed_capture_raises(monkeypatch):
    """A trip that reads the card back while it is captured makes the
    capture fail, and the drain raises: it does not fall back to eager
    trips, and no allocation is routed to the failed graph's pool after
    it.  (Last in the file: the failed capture leaves its pool.)"""
    integ, pos = _graph_integ("headline")
    trip = integ._trip

    def reads_back(st, Bk):
        trip(st, Bk)
        if torch.cuda.is_current_stream_capturing():
            int(st["count"])

    monkeypatch.setattr(integ, "_trip", reads_back)
    with pytest.raises(RuntimeError):
        integ.run_device(None, len(pos), pos_xy=pos)
    torch.cuda.synchronize()
    (pool,) = integ._graphs._pools.values()
    _routing_ended(pool)
