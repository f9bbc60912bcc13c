"""The port's big-scene route (K6/K7 of `render/bigscene.py`) and the
diagnostic ops (K8/K9 of `diag_ops.py`) against the JAX package, on the
CPU.

  * `SphereBlocks` equals `pallas_bigscene.SphereBlocks` exactly (rows,
    table, bounds), and the scene table without the big rows equals the
    JAX one, on the 600-sphere scene of tests/test_bigscene.py and on the
    parsed lamp_row.acn smoke scene (528 beads);
  * `big_top2_plain` / `big_anyhit_plain` against the Pallas kernels in
    interpret mode on the same rays, with the tolerances of
    tests/test_bigscene.py (finiteness >= 99.9 %, t within rtol/atol 2e-4,
    block indices >= 99.5 % on the finite lanes, any-hit >= 99.9 %);
  * the tracer's big route (the plain versions standing in for the kernels
    on a CPU tensor) against the JAX tracer with `use_bigscene_interpret`,
    with and without the scene route, and on a coherent camera tile;
  * the CUDA source of K6/K7 compiled as host C++ against the plain
    versions (K6's and K7's warp helpers lane by lane, with the shuffle
    butterfly and the any-exit in loops, K7's thread kernel thread by
    thread);
  * set_geom rebuilds the blocks; a counter-mode render takes the same
    image through the big route as through the plain one;
  * the plain diag ops against the JAX tool's math on the CPU.
"""

import ctypes
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actinon_tpu.render import pallas_bigscene as pb
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch import diag_ops
from actinon_tpu_torch.render import bigscene as bs
from actinon_tpu_torch.render import kernels
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho

import _torch_scenes as S
from test_torch_scene_kernels import WARP_REDUCE, _assert_tables_equal, \
    _lamp_row_pair, host_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    """(JAX tracer, port tracer) of the 600-sphere scene, both on their
    plain routes; each test sets the route it takes."""
    return (JTracer(jsir.compile_scene(S.many_sphere_scene(jho)),
                    dtype=np.float32),
            TTracer(tsir.compile_scene(S.many_sphere_scene(tho)),
                    dtype=np.float32, device="cpu"))


def _big_tracer(tt, scene_route=False):
    tk = TTracer(tt.ir, dtype=np.float32, device="cpu")
    tk.bigscene_on_cpu = True
    tk.scene_kernels_on_cpu = scene_route
    assert tk._bigscene_ok() and not tt._bigscene_ok()
    return tk


def _jax_big(jt, scene_route=False):
    jk = JTracer(jt.ir, dtype=np.float32)
    jk.use_bigscene_interpret = True
    jk.use_scene_interpret = scene_route
    assert jk._bigscene_ok()
    return jk


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def test_big_rows_and_blocks_equal_jax(pair):
    jt, tt = pair
    np.testing.assert_array_equal(tt.big_rows, jt.big_rows)
    assert len(tt.big_rows) == 600
    jk = _jax_big(jt)
    jb, _, _, jrows = jk._bigscene()
    big = _big_tracer(tt)._bigscene()
    tb = big.blocks
    np.testing.assert_array_equal(tb.rows, jb.rows)
    np.testing.assert_array_equal(tb.table, jb.table)
    np.testing.assert_array_equal(tb.bounds, jb.bounds)
    assert (tb.G, tb.n, tb.eps) == (jb.G, jb.n, jb.eps)
    np.testing.assert_array_equal(big.rows_padded.numpy(), jrows)
    # the kernels read the tables row-major
    assert tb.table.flags.c_contiguous and tb.bounds.flags.c_contiguous
    assert big.table.is_contiguous() and big.table.shape == (tb.G, 8, bs.LB)


def test_morton_order_equals_jax():
    rng = np.random.default_rng(5)
    q = rng.integers(0, 1024, (3, 4096)).astype(np.uint32)
    np.testing.assert_array_equal(bs._morton3(*q), pb._morton3(*q))


@pytest.mark.parametrize("scene", ["spheres", "lamp_row"])
def test_scene_table_without_big_rows_equals_jax(pair, scene):
    """K4's table loses the big rows, as the JAX one does."""
    jt, tt = pair if scene == "spheres" else _lamp_row_pair()
    big = jt.big_rows
    assert len(big) >= 512 and np.array_equal(tt.big_rows, big)
    for matter_only in (False, True):
        st = _assert_tables_equal(jt, tt, matter_only, exclude_rows=big)
        assert not np.isin(st.covered_single_rows, big).any()
    if scene == "spheres":
        tk = _big_tracer(tt, scene_route=True)
        st, stm = tk._scene_tables()
        assert [sh.M for sh in st.shapes] == [1] and not stm.shapes


@pytest.fixture(scope="module")
def pallas_out(pair):
    """K6 and K7 in interpret mode, built and run once on 800 rays."""
    jt, _ = pair
    jb, *_ = _jax_big(jt)._bigscene()
    p, d = S.rays(800, seed=1, spread=10.0)
    lim = np.random.default_rng(9).uniform(0.5, 20.0, 800).astype(
        np.float32)
    lim[::7] = np.inf
    t, g = pb.build_top2_kernel(jb, interpret=True)(p, d)
    blocked = pb.build_anyhit_kernel(jb, interpret=True)(p, d, lim)
    return dict(p=p, d=d, lim=lim, t=np.asarray(t), g=np.asarray(g),
                blocked=np.asarray(blocked))


def test_big_top2_plain_matches_pallas(pair, pallas_out):
    _, tt = pair
    o = pallas_out
    blocks = _big_tracer(tt)._bigscene().blocks
    work = bs._Work()
    t, g = bs.big_top2_plain(blocks, *_t(o["p"], o["d"]), work=work)
    t, g = t.numpy(), g.numpy()
    fin = np.isfinite(o["t"])
    assert fin[:, 0].mean() > 0.1 and (~fin[:, 0]).any()
    assert (np.isfinite(t) == fin).mean() >= 0.999
    both = fin & np.isfinite(t)
    np.testing.assert_allclose(t[both], o["t"][both], rtol=2e-4, atol=2e-4)
    assert (g[both] == o["g"][both]).mean() >= 0.995
    assert (g[~np.isfinite(t)] == 0).all()
    # the work counts: a test per ray and block, lanes only where it passed
    assert work.culls == 800 * blocks.G
    assert 0 < work.blocks < work.culls
    assert work.lanes <= work.blocks * bs.LB and work.merges <= work.blocks


def test_big_anyhit_plain_matches_pallas(pair, pallas_out):
    _, tt = pair
    o = pallas_out
    blocks = _big_tracer(tt)._bigscene().blocks
    got = bs.big_anyhit_plain(blocks, *_t(o["p"], o["d"], o["lim"])).numpy()
    assert o["blocked"].any() and (~o["blocked"]).any()
    assert (got == o["blocked"]).mean() >= 0.999


def _hits(out):
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("scene_route", [False, True],
                         ids=["plain_route", "scene_route"])
def test_big_route_matches_jax(pair, scene_route):
    """nearest, trans_hit and shadow_blocked through K6/K7's plain
    versions against the JAX tracer through the Pallas kernels
    (interpret mode), with the contract of tests/test_bigscene.py."""
    jt, tt = pair
    tk, jk = _big_tracer(tt, scene_route), _jax_big(jt, scene_route)
    p, d = S.rays(512, seed=31, spread=10.0)
    t_k, n_k, o_k, _ = _hits(tk.nearest(*_t(p, d), rng_rough=False))
    t_x, n_x, o_x, _ = _hits(jk.nearest(p, d, rng_rough=False))
    fin = np.isfinite(t_x)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(t_k) == fin).mean() > 0.999
    both = fin & np.isfinite(t_k)
    np.testing.assert_allclose(t_k[both], t_x[both], rtol=2e-4, atol=2e-4)
    assert (o_k[both] == o_x[both]).mean() > 0.995
    same = both & (o_k == o_x)
    np.testing.assert_allclose(n_k[same], n_x[same], rtol=0, atol=5e-3)
    tr_k = _hits(tk.trans_hit(*_t(p, d)))
    tr_x = _hits(jk.trans_hit(p, d))
    both = np.isfinite(tr_x[0]) & np.isfinite(tr_k[0])
    np.testing.assert_allclose(tr_k[0][both], tr_x[0][both], rtol=2e-4,
                               atol=2e-4)
    assert ((tr_k[2] == tr_x[2]) & (tr_k[3] == tr_x[3]))[both].mean() > 0.995
    lim = np.random.default_rng(41).uniform(0.5, 20.0, 512).astype(
        np.float32)
    b_k = tk.shadow_blocked(*_t(p, d, lim)).numpy()
    b_x = np.asarray(jk.shadow_blocked(p, d, lim))
    assert b_x.any() and (~b_x).any()
    assert (b_k == b_x).mean() > 0.999


def test_big_route_coherent_tile(pair):
    """The coherent camera-style tile of tests/test_bigscene.py:87-111
    (every ray from far outside along one axis): a wrong sign of the
    block cull would skip every block ahead of the rays.  The big route
    against the port's plain tracer."""
    _, tt = pair
    tk = _big_tracer(tt)
    n = 512
    xs = np.linspace(-8, 8, n).astype(np.float32)
    p = np.stack([xs, np.full(n, -30.0, np.float32),
                  np.zeros(n, np.float32)], axis=-1)
    d = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    t_k, _, oid_k, _ = _hits(tk.nearest(*_t(p, d), rng_rough=False))
    t_x, _, oid_x, _ = _hits(tt.nearest(*_t(p, d), rng_rough=False))
    fin = np.isfinite(t_x)
    assert fin.mean() > 0.3
    assert (np.isfinite(t_k) == fin).all()
    np.testing.assert_allclose(t_k[fin], t_x[fin], rtol=2e-4, atol=2e-4)
    assert (oid_k[fin] == oid_x[fin]).mean() > 0.995
    limit = np.full(n, 60.0, np.float32)
    b_k = tk.shadow_blocked(*_t(p, d, limit)).numpy()
    b_x = tt.shadow_blocked(*_t(p, d, limit)).numpy()
    assert (b_k == b_x).all()


def test_set_geom_rebuilds_blocks(pair):
    _, tt = pair
    tk = _big_tracer(tt)
    b0 = tk._bigscene()
    g = tk.geom_params()
    g["sph_r"] = g["sph_r"] * 1.5
    tk.set_geom(g)
    b1 = tk._bigscene()
    assert b1 is not b0
    np.testing.assert_array_equal(b1.blocks.rows, b0.blocks.rows)
    assert not np.array_equal(b1.blocks.table[:, 3], b0.blocks.table[:, 3])
    assert (b1.blocks.bounds[:, 3] > b0.blocks.bounds[:, 3]).all()


def test_counter_render_big_route_matches_plain():
    """A counter-mode render of the sphere scene takes the same image
    through the big route as through the plain one (per pixel, away from
    the rare grazing hit that the two root formulas resolve apart)."""
    from actinon_tpu_torch.render.integrator import Integrator
    sc = S.many_sphere_scene(tho)
    cfg = sc.cfg
    cfg.image_width, cfg.image_height = 8, 6
    cfg.direct_samples, cfg.path_samples, cfg.trace_depth = 2, 0, 3
    cfg.camera_position = (0.0, -12.0, 2.0)
    cfg.camera_view_direction = (0.0, 1.0, 0.0)
    cfg.camera_top_direction = (0.0, 0.0, 1.0)
    ir = tsir.compile_scene(sc)
    ys, xs = np.mgrid[0:6, 0:8]
    pos = np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    out = []
    for big in (False, True):
        tr = TTracer(ir, dtype=np.float32, device="cpu")
        tr.bigscene_on_cpu = big
        integ = Integrator(tr, batch=256)
        integ.seed_mode = "counter"
        out.append(np.asarray(integ.run_samples(pos)))
    plain, big = out
    assert np.isfinite(big).all() and plain.max() > 0
    close = np.isclose(big, plain, rtol=1e-3, atol=1e-4).all(axis=1)
    assert close.mean() >= 0.95


# -- the CUDA source of K6/K7 on the host ------------------------------------

HOST_DRIVER = WARP_REDUCE + r"""
// K6: a ray's walk as the warp kernel takes it: per 32 blocks the lanes'
// culls as the ballot's mask, the passed blocks in ascending order, each
// block's 32 lanes in turn, then the butterfly and the merge
extern "C" void host_top2(const float* tab, const float* bnd, int G,
                          const float* p, const float* d, float* t_out,
                          int* i_out, int n, float eps) {
    for (int i = 0; i < n; ++i) {
        const Ray r = load_ray(p, d, i);
        Top2 ray = top2_empty();
        for (int s = 0; s < G; s += 32) {
            unsigned mask = 0;
            for (int j = 0; j < 32; ++j)
                if (s + j < G && block_cull(bnd, s + j, r, false, 0.0f))
                    mask |= 1u << j;
            for (; mask; mask &= mask - 1) {
                const int g = s + __builtin_ctz(mask);
                Top2 v[32];
                for (int j = 0; j < 32; ++j)
                    v[j] = lane_top2(tab + (size_t)g * 8 * LB, j, r, eps);
                top2_merge(ray, warp_reduce(v), g);
            }
        }
        t_out[2 * i] = ray.t1;
        t_out[2 * i + 1] = ray.t2;
        i_out[2 * i] = ray.i1;
        i_out[2 * i + 1] = ray.i2;
    }
}
// K7's warp design: a ray's walk as the warp kernel takes it: per 32
// blocks the lanes' limit-aware culls as the ballot's mask, the passed
// blocks in ascending order, each block's 32 lanes (4 sphere lanes each)
// ORed as __any_sync ORs them, leaving after the first block with a hit
extern "C" void host_anyhit_warp(const float* tab, const float* bnd, int G,
                                 const float* p, const float* d,
                                 const float* lim, uint8_t* out, int n,
                                 float eps) {
    for (int i = 0; i < n; ++i) {
        const Ray r = load_ray(p, d, i);
        const float l = read_limit(lim, i);
        bool hit = false;
        for (int s = 0; s < G && !hit; s += 32) {
            unsigned mask = 0;
            for (int j = 0; j < 32; ++j)
                if (s + j < G && block_cull(bnd, s + j, r, true, l))
                    mask |= 1u << j;
            for (; mask && !hit; mask &= mask - 1) {
                const int g = s + __builtin_ctz(mask);
                for (int j = 0; j < 32; ++j)
                    hit |= lane_anyhit(tab + (size_t)g * 8 * LB, j, r, eps,
                                       l);
            }
        }
        out[i] = hit ? 1 : 0;
    }
}
// K7's thread design: one call per thread
extern "C" void host_anyhit(const float* tab, const float* bnd, int G,
                            const float* p, const float* d, const float* lim,
                            uint8_t* out, int n, float eps) {
    blockDim.x = 256;
    for (int b = 0; b < (n + 255) / 256; ++b)
        for (int t = 0; t < 256; ++t) {
            blockIdx.x = b; threadIdx.x = t;
            big_anyhit_kernel(tab, bnd, G, p, d, lim, out, n, eps);
        }
}
"""


def test_cuda_source_on_host_matches_plain(pair, tmp_path):
    """csrc/bigscene_kernels.cu compiled as host C++, on the tables as the
    wrappers pass them: K6's helpers driven as the warp kernel drives
    them (the ballot's cull mask, 32 lanes a block, the shuffle
    butterfly, the merge), K7's kernel one call per thread; the results
    of the plain versions (the contract of K6/K7 on the card).  The
    launch constants the wrapper reports are the source's."""
    lib, src = host_library("bigscene_kernels.cu", HOST_DRIVER, tmp_path)
    assert f"kTop2Warps = {bs.TOP2_WARPS};" in src
    assert f"kChunk = {bs.BOUND_CHUNK};" in src
    assert bs.BOUND_CHUNK % 32 == 0   # a ballot's 32 blocks lie in one stage
    _, tt = pair
    big = _big_tracer(tt)._bigscene()
    n = 1024
    p, d = S.rays(n, seed=43, spread=10.0)
    lim = np.random.default_rng(47).uniform(0.5, 20.0, n).astype(np.float32)
    lim[::5] = np.inf
    P, D, LIM = _t(p, d, lim)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    G, eps = ctypes.c_int(big.blocks.G), ctypes.c_float(float(big.blocks.eps))
    t = torch.empty((n, 2), dtype=torch.float32)
    g = torch.empty((n, 2), dtype=torch.int32)
    lib.host_top2(ptr(big.table), ptr(big.bounds), G, ptr(P), ptr(D), ptr(t),
                  ptr(g), ctypes.c_int(n), eps)
    assert lib.host_split() == 0
    t_p, g_p = bs.big_top2_plain(big.blocks, P, D)
    fin = torch.isfinite(t_p)
    assert float(fin[:, 0].float().mean()) > 0.1
    assert float((torch.isfinite(t) == fin).float().mean()) >= 0.998
    both = fin & torch.isfinite(t)
    assert float((g[both] == g_p[both]).float().mean()) >= 0.99
    same = both & (g == g_p)
    assert bool((torch.abs(t[same] - t_p[same])
                 <= 2e-4 * (1 + torch.abs(t_p[same]))).all())
    assert bool((g[~torch.isfinite(t)] == 0).all())
    out = torch.empty((n,), dtype=torch.bool)
    lib.host_anyhit(ptr(big.table), ptr(big.bounds), G, ptr(P), ptr(D),
                    ptr(LIM), ptr(out), ctypes.c_int(n), eps)
    want = bs.big_anyhit_plain(big.blocks, P, D, LIM)
    assert want.any() and (~want).any()
    assert float((out == want).float().mean()) >= 0.998


def test_cuda_source_on_host_exact_on_ties(tmp_path):
    """K6's warp helpers on the host, driven as above, against the plain
    version on the tie lattice (one to three copies of each sphere, more
    blocks than one bound stage holds, a partial last block), where every
    root is exact in f32: t bit for bit and every index equal."""
    lib, _ = host_library("bigscene_kernels.cu", HOST_DRIVER, tmp_path)
    c = S.tie_centres(S.TIE_BIG_SHAPE)
    blocks = bs.SphereBlocks(np.arange(len(c)), c, np.full(len(c), 0.25),
                             1e-4)
    assert blocks.G > bs.BOUND_CHUNK and blocks.n % bs.LB
    table, bounds = blocks.upload("cpu")
    n = 2048
    P, D = _t(*S.axis_rays(n, S.TIE_BIG_SHAPE, seed=7))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    t = torch.empty((n, 2), dtype=torch.float32)
    g = torch.empty((n, 2), dtype=torch.int32)
    lib.host_top2(ptr(table), ptr(bounds), ctypes.c_int(blocks.G), ptr(P),
                  ptr(D), ptr(t), ptr(g), ctypes.c_int(n),
                  ctypes.c_float(float(blocks.eps)))
    assert lib.host_split() == 0
    t_p, g_p = bs.big_top2_plain(blocks, P, D, table=table)
    fin = torch.isfinite(t_p[:, 0])
    assert 0.5 < float(fin.float().mean()) < 1.0
    assert bool(((t_p[:, 0] == t_p[:, 1]) & fin).any())
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(g, g_p)


def _fractal_blocks():
    """Sphere blocks shaped like sphere_fractal.acn's (32,768 spheres, 256
    Morton blocks: two bound stages of the warp kernel, eight ballot
    rounds)."""
    c, r = S.fractal_spheres()
    return bs.SphereBlocks(np.arange(len(c)), c, r, 1e-4)


def _anyhit_limits(blocks, table, P, D, seed):
    """Limits for K7 that land on its own comparisons: the nearest
    eps-backed hit t exactly (blocked), one ulp below it (blocked only by
    another sphere), random limits and, on every fifth ray, none (INF)."""
    t1 = bs.big_top2_plain(blocks, P, D, table=table)[0][:, 0].numpy()
    lim = np.random.default_rng(seed).uniform(0.5, 20.0, len(t1)).astype(
        np.float32)
    fin = np.isfinite(t1)
    lim[1::5] = np.where(fin[1::5], t1[1::5], lim[1::5])
    lim[2::5] = np.where(fin[2::5], np.nextafter(t1[2::5], np.float32(0)),
                         lim[2::5])
    lim[::5] = np.inf
    return torch.as_tensor(lim)


@pytest.fixture(scope="module")
def big_host(tmp_path_factory):
    """(library, source) of csrc/bigscene_kernels.cu compiled as host C++
    with HOST_DRIVER, once for the module."""
    return host_library("bigscene_kernels.cu", HOST_DRIVER,
                        tmp_path_factory.mktemp("big_host"))


@pytest.mark.parametrize("shape", ["fractal", "ties"])
def test_anyhit_warp_on_host_exact(shape, big_host):
    """K7's warp design driven as the warp kernel drives it (rounds of 32
    limit-aware culls in ballot order, 4 sphere lanes a thread, an OR
    across the warp, the exit after the first block with a hit), compiled
    as host C++: bit for bit the plain version's booleans and the thread
    design's, on fractal-shaped blocks (random rays) and on the tie
    lattice (axis rays, every root exact in f32), with limits exactly at a
    hit's t and one ulp below it."""
    lib, src = big_host
    assert f"kAnyWarps = {bs.ANYHIT_WARPS};" in src
    if shape == "fractal":
        blocks = _fractal_blocks()
        p, d = S.rays(2048, seed=71, spread=6.0)
    else:
        c = S.tie_centres(S.TIE_BIG_SHAPE)
        blocks = bs.SphereBlocks(np.arange(len(c)), c,
                                 np.full(len(c), 0.25), 1e-4)
        p, d = S.axis_rays(2048, S.TIE_BIG_SHAPE, seed=73)
    assert blocks.G > bs.BOUND_CHUNK
    table, bounds = blocks.upload("cpu")
    P, D = _t(p, d)
    LIM = _anyhit_limits(blocks, table, P, D, seed=79)
    want = bs.big_anyhit_plain(blocks, P, D, LIM, table=table)
    assert want.any() and (~want).any()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    out = {}
    for name in ("host_anyhit_warp", "host_anyhit"):
        out[name] = torch.empty((len(p),), dtype=torch.bool)
        getattr(lib, name)(ptr(table), ptr(bounds), ctypes.c_int(blocks.G),
                           ptr(P), ptr(D), ptr(LIM), ptr(out[name]),
                           ctypes.c_int(len(p)),
                           ctypes.c_float(float(blocks.eps)))
    assert torch.equal(out["host_anyhit_warp"], want)
    assert torch.equal(out["host_anyhit"], want)


# -- K8/K9: the diagnostic ops -----------------------------------------------


def _diag_tool():
    path = os.path.join(ROOT, "tools", "diag_tpu_ops.py")
    spec = importlib.util.spec_from_file_location("diag_tpu_ops", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_diag_plain_ops_match_tool_math():
    """The plain versions (torch's ops on the CPU) against the JAX tool's
    jitted ops on the same inputs: division is IEEE-rounded in both
    (bit-equal); XLA's CPU sqrt is within 1 ulp of torch's IEEE-rounded
    one, the rest within a few ulp."""
    tool = _diag_tool()
    inp = diag_ops.tool_inputs("cpu")
    fns = {"sin": jnp.sin, "cos": jnp.cos, "sqrt": jnp.sqrt,
           "rsqrt": jax.lax.rsqrt, "exp": jnp.exp}
    for name, fn in fns.items():
        x = inp["x"][name]
        lo, hi = diag_ops.RANGES[name]
        assert float(x.min()) >= lo and float(x.max()) <= hi
        want = np.asarray(jax.jit(fn)(x.numpy()))
        got = diag_ops.unary(name, x).numpy()
        ud = tool.ulp_diff(got, want)
        assert ud.max() <= (1 if name == "sqrt" else 4), (name, ud.max())
    a, b, c = (t.numpy() for t in inp["args"]["mul_add"])
    ud = tool.ulp_diff(diag_ops.expr("div", *_t(a, b)).numpy(),
                       np.asarray(jax.jit(lambda a, b: a / b)(a, b)))
    assert ud.max() == 0
    # a * b + c: torch rounds twice (product, then sum), as numpy does;
    # XLA may contract to one FMA, which differs by at most one rounding
    # of each term (2^-23 (|a b| + |c|)), many ulp where the sum cancels
    got = diag_ops.expr("mul_add", *_t(a, b, c)).numpy()
    np.testing.assert_array_equal(got, a * b + c)
    xla = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    assert (np.abs(got - xla) <= 2.0 ** -23 * (np.abs(a * b) + np.abs(c))
            ).all()
    np.testing.assert_array_equal(
        diag_ops.ulp_diff(*_t(a, b)).numpy(), tool.ulp_diff(a, b))


def test_diag_compare_and_einsum_on_cpu(capsys):
    """On CPU tensors the wrappers are torch's ops: every row bit-equal,
    no launch; the einsum and the explicit sum agree with f64 numpy."""
    kernels.reset_launches()
    rows = diag_ops.compare("cpu")
    assert [r["name"] for r in rows] == list(diag_ops.UNARY) \
        + list(diag_ops.EXPR)
    assert all(r["bit_equal"] == 1.0 and r["max_ulp"] == 0 for r in rows)
    assert kernels.LAUNCHES["diag_unary"] == kernels.LAUNCHES["diag_expr"] \
        == 0
    ein = diag_ops.einsum_check("cpu")
    assert ein["explicit"]["mean_rel"] < 1e-6
    assert ein["einsum_default"]["mean_rel"] < 1e-6
    assert diag_ops.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu" and len(lines) == 10
    assert lines[1].startswith("sin[0,2pi]") and "mean_ulp" in lines[1]
