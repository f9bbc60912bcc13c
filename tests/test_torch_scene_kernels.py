"""The port's packed scene table and the plain versions of K4/K5 against
the JAX package's `render/pallas_scene.py`, on the CPU.

  * `SceneTable` equals `pallas_scene.SceneTable` value for value (table,
    bounds, every shape's structure and reconstruction tables, the
    covered and leftover sets), on the scene of tests/test_pallas_scene.py
    and on the parsed lamp_row.acn smoke scene, so that winner codes
    compare directly between the packages;
  * `scene_top2_plain` / `scene_anyhit_plain` against the Pallas kernels
    in interpret mode on the same rays: t within rtol/atol 2e-4, codes
    equal on >= 99 % of the finite lanes, any-hit equal on >= 99.8 %;
  * the CUDA source of K4/K5 compiled as host C++ (a shim maps the CUDA
    keywords; K4's warp helpers run lane by lane with the shuffle
    butterfly in a loop, K5's member test in rounds of 32 members with
    the warp's any-exit) against the plain versions: the kernels'
    arithmetic and table reads without a card;
  * the tracer's scene-kernel route (the plain versions standing in for
    the kernels on a CPU tensor) against the JAX XLA tracer, with the
    contract of tests/test_pallas_scene.py:_cmp_hits, and on a coherent
    camera-style tile (tests/test_pallas_scene.py:176-195).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from actinon_tpu.acn.interp import run_file as jrun_file
from actinon_tpu.render import pallas_scene as ps
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu.scene import objects as jho
from actinon_tpu_torch.acn.interp import run_file as trun_file
from actinon_tpu_torch.render import scene_kernels as sk
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho

import _torch_scenes as S


def _mixed_pair():
    return (JTracer(jsir.compile_scene(S.mixed_scene(jho)),
                    dtype=np.float32),
            TTracer(tsir.compile_scene(S.mixed_scene(tho)),
                    dtype=np.float32, device="cpu"))


def _lamp_row_pair():
    got = {}
    for name, run, sir in (("jax", jrun_file, jsir), ("torch", trun_file,
                                                      tsir)):
        cap = []
        run(S.LAMP_ROW, render_fn=lambda sc, fn: cap.append(sc.clone()),
            args=["-f"])
        got[name] = sir.compile_scene(cap[0])
    return (JTracer(got["jax"], dtype=np.float32),
            TTracer(got["torch"], dtype=np.float32, device="cpu"))


@pytest.fixture(scope="module")
def mixed():
    return _mixed_pair()


def _solo_index(tr, ids):
    return sorted(i for i, c in enumerate(tr.comp_solo) if id(c) in ids)


def _comps(comps):
    return [(c.oid, list(c.rows), repr(c.tree)) for c in comps]


def _assert_tables_equal(jt, tt, matter_only, exclude_rows=None):
    a = ps.SceneTable(jt, matter_only=matter_only, exclude_rows=exclude_rows)
    b = sk.SceneTable(tt, matter_only=matter_only, exclude_rows=exclude_rows)
    np.testing.assert_array_equal(b.table, a.table)
    np.testing.assert_array_equal(b.bounds, a.bounds)
    assert b.eps == a.eps
    assert len(b.shapes) == len(a.shapes)
    for sa, sb in zip(a.shapes, b.shapes):
        assert (sb.kind, sb.tree, sb.Lc, sb.M) == (sa.kind, sa.tree, sa.Lc,
                                                   sa.M)
        assert list(sb.an_slots) == list(sa.an_slots)
        assert [tuple(x) for x in sb.sdf_slots] == \
            [tuple(x) for x in sa.sdf_slots]
        assert (sb.shape_id, sb.row_off, sb.rows_per_block, sb.bid0,
                sb.has_light) == (sa.shape_id, sa.row_off,
                                  sa.rows_per_block, sa.bid0, sa.has_light)
        np.testing.assert_array_equal(sb.rows_flat, sa.rows_flat)
        np.testing.assert_array_equal(sb.oid, sa.oid)
        for li in sa.sdf_m:
            np.testing.assert_array_equal(sb.sdf_m[li], sa.sdf_m[li])
            np.testing.assert_array_equal(sb.sdf_m0[li], sa.sdf_m0[li])
            np.testing.assert_array_equal(sb.sdf_prm[li], sa.sdf_prm[li])
    np.testing.assert_array_equal(b.covered_single_rows,
                                  a.covered_single_rows)
    assert b.covered_sdf_idx == a.covered_sdf_idx
    assert _solo_index(tt, b.covered_solo_ids) == \
        _solo_index(jt, a.covered_solo_ids)
    assert [_comps(g) for g in b.rest_groups] == \
        [_comps(g) for g in a.rest_groups]
    assert _comps(b.rest_solos) == _comps(a.rest_solos)
    return b


@pytest.mark.parametrize("matter_only", [False, True],
                         ids=["full", "matter"])
def test_scene_table_equals_jax(mixed, matter_only):
    jt, tt = mixed
    st = _assert_tables_equal(jt, tt, matter_only)
    kinds = {sh.kind for sh in st.shapes}
    assert kinds == {"singles", "sdfsingle", "cluster"}
    # the kernels read the tables row-major
    assert st.table.flags.c_contiguous and st.table_t.is_contiguous()
    assert not st.rest_groups and not st.rest_solos


def test_lamp_row_table_equals_jax():
    """The parsed smoke scene (parsing only, no render): both tables, and
    the scene has the content it was written for."""
    jt, tt = _lamp_row_pair()
    assert len(tt.tab) + len(tt.sdf_singles) + sum(
        lf is not None for c in tt.composites for lf in c.sdf_leaves) >= 950
    assert sum(c.has_sdf for c in tt.comp_solo) >= 76
    st = _assert_tables_equal(jt, tt, False)
    _assert_tables_equal(jt, tt, True)
    assert len(st.rest_groups) == 1 and len(st.rest_groups[0][0].rows) >= 13
    assert tt.sdf_singles and any(sh.has_light and sh.kind == "cluster"
                                  for sh in st.shapes)


@pytest.fixture(scope="module")
def pallas_out(mixed):
    """The Pallas kernels in interpret mode, built and run once: top-2 on
    512 rays with half the lanes matter-only, any-hit on 512 rays."""
    jt, _ = mixed
    stf = ps.SceneTable(jt, matter_only=False)
    stm = ps.SceneTable(jt, matter_only=True)
    top2, _ = ps.build_kernels(stf, interpret=True)
    _, anyhit = ps.build_kernels(stm, interpret=True)
    p, d = S.rays(512, seed=21)
    lm = (np.arange(512) % 2).astype(np.float32)
    lim = np.random.default_rng(23).uniform(0.2, 15.0, 512).astype(
        np.float32)
    lim[::9] = np.inf
    t12, c12 = top2(p, d, lm)
    blocked = anyhit(p, d, lim)
    return dict(p=p, d=d, lm=lm, lim=lim, t=np.asarray(t12),
                c=np.asarray(c12), blocked=np.asarray(blocked))


def test_scene_top2_plain_matches_pallas(mixed, pallas_out):
    _, tt = mixed
    st, _ = tt._scene_tables()
    o = pallas_out
    t, c = sk.scene_top2_plain(st, torch.as_tensor(o["p"]),
                               torch.as_tensor(o["d"]),
                               torch.as_tensor(o["lm"]))
    t, c = t.numpy(), c.numpy()
    fin = np.isfinite(o["t"])
    assert fin[:, 0].mean() > 0.3 and (~fin[:, 0]).any()
    assert (np.isfinite(t) == fin).mean() >= 0.998
    both = fin & np.isfinite(t)
    np.testing.assert_allclose(t[both], o["t"][both], rtol=2e-4, atol=2e-4)
    assert (c[both] == o["c"][both]).mean() >= 0.99
    assert (c[~np.isfinite(t)] == -1).all()


def test_scene_anyhit_plain_matches_pallas(mixed, pallas_out):
    _, tt = mixed
    _, stm = tt._scene_tables()
    o = pallas_out
    got = sk.scene_anyhit_plain(stm, torch.as_tensor(o["p"]),
                                torch.as_tensor(o["d"]),
                                torch.as_tensor(o["lim"])).numpy()
    assert o["blocked"].any() and (~o["blocked"]).any()
    assert (got == o["blocked"]).mean() >= 0.998


def test_plain_work_counts(mixed):
    """The plain versions count the work the bound charges: culls on
    every block and ray, marches only where a gate passed."""
    _, tt = mixed
    st, stm = tt._scene_tables()
    p, d = (torch.as_tensor(x) for x in S.rays(128, seed=3))
    work = sk._Work()
    sk.scene_top2_plain(st, p, d, torch.zeros(128), work=work)
    n_blocks = sum(sh.n_blocks for sh in st.shapes)
    assert work.culls == 128 * n_blocks
    assert 0 < work.steps and 0 < work.sweeps and 0 < work.comparators
    assert work.gates >= work.analytic // 4 > 0
    w5 = sk._Work()
    sk.scene_anyhit_plain(stm, p, d, torch.full((128,), 0.01), work=w5)
    assert w5.steps < work.steps


def _route_pair(mixed):
    jt, tt = mixed
    tk = TTracer(tt.ir, dtype=np.float32, device="cpu")
    tk.scene_kernels_on_cpu = True
    assert tk._scene_route_ok() and tk._prefer_scene_query()
    assert not tt._scene_route_ok()
    return jt, tk


def _hits(out):
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("matter_only", [False, True],
                         ids=["all", "matter"])
def test_scene_route_nearest(mixed, matter_only):
    """The port's scene-kernel route against the JAX XLA tracer."""
    jt, tk = _route_pair(mixed)
    p, d = S.rays(512, seed=31)
    t_k, n_k, o_k, s_k = _hits(tk.nearest(
        torch.as_tensor(p), torch.as_tensor(d), matter_only=matter_only,
        rng_rough=False))
    t_x, n_x, o_x, s_x = _hits(jt.nearest(p, d, matter_only=matter_only,
                                          rng_rough=False))
    fin = np.isfinite(t_x)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(t_k) == fin).mean() > 0.998
    both = fin & np.isfinite(t_k)
    np.testing.assert_allclose(t_k[both], t_x[both], rtol=2e-4, atol=2e-4)
    assert (o_k[both] == o_x[both]).mean() > 0.99
    same = both & (o_k == o_x)
    np.testing.assert_allclose(n_k[same], n_x[same], rtol=0, atol=5e-3)
    assert (s_k[same] == s_x[same]).mean() > 0.999
    if matter_only:
        assert not np.isin(o_k, np.flatnonzero(tk.is_light)).any()


def test_scene_route_mixed_and_shadow(mixed):
    jt, tk = _route_pair(mixed)
    p, d = S.rays(512, seed=37)
    mask = np.arange(len(p)) % 2 == 0
    o_k = _hits(tk.trans_hit_mixed(torch.as_tensor(p), torch.as_tensor(d),
                                   torch.as_tensor(mask)))
    o_x = _hits(jt.trans_hit_mixed(p, d, mask))
    both = np.isfinite(o_x[0]) & np.isfinite(o_k[0])
    np.testing.assert_allclose(o_k[0][both], o_x[0][both], rtol=2e-4,
                               atol=2e-4)
    lights = np.flatnonzero(tk.is_light)
    assert not np.isin(o_k[2][mask], lights).any()
    assert not np.isin(o_k[3][mask], lights).any()
    lim = np.random.default_rng(41).uniform(0.2, 15.0, len(p)).astype(
        np.float32)
    b_k = tk.shadow_blocked(torch.as_tensor(p), torch.as_tensor(d),
                            torch.as_tensor(lim)).numpy()
    b_x = np.asarray(jt.shadow_blocked(p, d, lim))
    assert b_x.any() and (~b_x).any()
    assert (b_k == b_x).mean() > 0.998


def test_scene_route_past_one_bound_stage(mixed, monkeypatch, tmp_path):
    """The tracer's scene route with K4 and K5 as their CUDA source walks
    the tables (compiled as host C++, driven as the warp kernels drive
    it), K4 at a stage of 3 bounds, so that the table passes through its
    shared-memory stages more than once, the last one partly filled, and
    nothing gating the route on the table's size: both kernels are
    called, and the nearest hits and the shadow test still match the JAX
    tracer with the contract of the scene route above."""
    lib, _ = host_library("scene_kernels.cu", HOST_DRIVER, tmp_path, chunk=3)
    jt, tt = mixed
    tk = TTracer(tt.ir, dtype=np.float32, device="cpu")
    tk.scene_kernels_on_cpu = True
    stf, stm = tk._scene_tables()
    for st in (stf, stm):
        assert st.bounds_t.shape[0] > 3 and st.bounds_t.shape[0] % 3 != 0
    assert tk._prefer_scene_query() and tk._prefer_scene_shadow()
    calls = []

    def top2(tr, p, d, lm):
        calls.append("top2")
        t = torch.empty((p.shape[0], 2), dtype=torch.float32)
        c = torch.empty((p.shape[0], 2), dtype=torch.int32)
        _host_top2(lib, tr._scene_tables()[0], p, d, lm, t, c)
        return t, c

    def anyhit(tr, p, d, limit):
        calls.append("anyhit")
        return _host_anyhit(lib, tr._scene_tables()[1], p, d, limit, 0)

    monkeypatch.setattr(sk, "scene_top2", top2)
    monkeypatch.setattr(sk, "scene_anyhit", anyhit)
    p, d = S.rays(512, seed=31)
    t_k, _, o_k, _ = _hits(tk.nearest(torch.as_tensor(p), torch.as_tensor(d),
                                      rng_rough=False))
    t_x, _, o_x, _ = _hits(jt.nearest(p, d, rng_rough=False))
    fin = np.isfinite(t_x)
    assert fin.any() and (~fin).any()
    assert (np.isfinite(t_k) == fin).mean() > 0.998
    both = fin & np.isfinite(t_k)
    np.testing.assert_allclose(t_k[both], t_x[both], rtol=2e-4, atol=2e-4)
    assert (o_k[both] == o_x[both]).mean() > 0.99
    lim = np.random.default_rng(41).uniform(0.2, 15.0, len(p)).astype(
        np.float32)
    b_k = tk.shadow_blocked(torch.as_tensor(p), torch.as_tensor(d),
                            torch.as_tensor(lim)).numpy()
    b_x = np.asarray(jt.shadow_blocked(p, d, lim))
    assert b_x.any() and (~b_x).any()
    assert (b_k == b_x).mean() > 0.998
    assert "top2" in calls and "anyhit" in calls


def test_scene_coherent_tile(mixed):
    """A coherent camera-style tile (shared direction): the block-cull
    regression shape of tests/test_pallas_scene.py:176-195, the scene
    route against the port's plain tracer."""
    _, tt = mixed
    _, tk = _route_pair(mixed)
    n = 256
    xs = np.linspace(-6, 6, n).astype(np.float32)
    p = np.stack([xs, np.full(n, -20.0, np.float32),
                  np.zeros(n, np.float32)], -1)
    d = np.tile(np.asarray([[0, 1, 0]], np.float32), (n, 1))
    t_k, _, oid_k, _ = _hits(tk.nearest(torch.as_tensor(p),
                                        torch.as_tensor(d), rng_rough=False))
    t_x, _, oid_x, _ = _hits(tt.nearest(torch.as_tensor(p),
                                        torch.as_tensor(d), rng_rough=False))
    fin = np.isfinite(t_x)
    assert fin.mean() > 0.2
    assert (np.isfinite(t_k) == fin).all()
    both = fin & np.isfinite(t_k)
    np.testing.assert_allclose(t_k[both], t_x[both], rtol=2e-4, atol=2e-4)
    assert (oid_k[both] == oid_x[both]).mean() > 0.99


def test_set_geom_rebuilds_scene_tables(mixed):
    """The packed table bakes the geometry: set_geom drops it, and the
    next table carries the new values."""
    _, tk = _route_pair(mixed)
    st0, _ = tk._scene_tables()
    g = tk.geom_params()
    g["sph_r"] = g["sph_r"] * 1.5
    tk.set_geom(g)
    st1, _ = tk._scene_tables()
    assert st1 is not st0
    assert not np.array_equal(st1.table, st0.table)
    assert st1.table.shape == st0.table.shape


HOST_SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
using std::max;
using std::min;
#define __host__
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __int_as_float(int i) {
    float f; memcpy(&f, &i, 4); return f;
}
struct Idx { unsigned x; };
static Idx blockIdx, threadIdx, blockDim;
"""

# A warp's lanes in turn: the kernels' five __shfl_xor_sync steps, each
# lane combining its pair with lane j ^ o's; counts the lanes that end
# with another pair than lane 0 (the kernels assume none).
WARP_REDUCE = r"""
static int n_split = 0;
static Top2 warp_reduce(Top2 v[32]) {
    for (int o = 16; o > 0; o >>= 1) {
        Top2 w[32];
        for (int j = 0; j < 32; ++j) w[j] = top2_combine(v[j], v[j ^ o]);
        for (int j = 0; j < 32; ++j) v[j] = w[j];
    }
    for (int j = 1; j < 32; ++j)
        n_split += memcmp(&v[j], &v[0], sizeof(Top2)) != 0;
    return v[0];
}
extern "C" int host_split() { return n_split; }
"""


def host_library(name, driver, tmp_path, chunk=None):
    """csrc/`name` up to its C interface, compiled as host C++ after the
    shim, with `driver` appended: the loaded library and the source.  The
    warp kernels (under __CUDACC__) drop out; their helpers and the
    one-thread kernels stay.  chunk: a stage of that many bounds in
    place of the source's kChunk, so that a small table spans several."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    from actinon_tpu_torch.render import kernels
    path = next(s for s in kernels.SOURCES if os.path.basename(s) == name)
    src = open(path).read()
    body = src.replace("#include <cuda_runtime.h>", "")
    body = body[:body.index('extern "C" {')]
    if chunk is not None:
        body = body.replace("constexpr int kChunk = 128;",
                            f"constexpr int kChunk = {chunk};")
    cpp = tmp_path / f"host_{name}{chunk or ''}.cpp"
    cpp.write_text(HOST_SHIM + body + driver)
    so = tmp_path / f"libhost_{name}{chunk or ''}.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(so), str(cpp)], check=True, capture_output=True)
    return ctypes.CDLL(str(so)), src


HOST_DRIVER = WARP_REDUCE + r"""
// the kernels' stage of bounds [g0, g0 + m): (centre, r2) of each row
static void stage_chunk(float (*sb)[4], const float* bnd, int g0, int m) {
    for (int k = 0; k < m; ++k)
        for (int w = 0; w < 4; ++w) sb[k][w] = bnd[8 * (g0 + k) + w];
}
// the ballot of staged bounds s0 .. s0 + 31 of a stage of m
static unsigned ballot(const float (*sb)[4], int s0, int m, const Ray& r,
                       bool has_lim, float lim) {
    unsigned pass = 0;
    for (int j = 0; j < 32; ++j)
        if (s0 + j < m && bound_hit(sb[s0 + j][0], sb[s0 + j][1],
                                    sb[s0 + j][2], sb[s0 + j][3], r, has_lim,
                                    lim))
            pass |= 1u << j;
    return pass;
}
// K4: a ray's walk as the warp kernel takes it: the bounds staged kChunk
// at a time, culled 32 at a time (the ballot), the passed blocks in
// order, each with its shape (bshape), the 32 lanes of each in turn,
// then the butterfly and the merge
extern "C" void host_top2(const float* tab, const float* bnd,
                          const int* bshape, const int* desc, const float* p,
                          const float* d, const float* lm, float* t_out,
                          int* c_out, int n, float eps) {
    const Eps E = make_eps(eps);
    const int n_blk = table_blocks(desc);
    static float sb[kChunk][4];
    for (int i = 0; i < n; ++i) {
        const Ray r = load_ray(p, d, i);
        const bool lane_matter = lm[i] > 0.0f;
        Top2 ray = top2_empty();
        for (int g0 = 0; g0 < n_blk; g0 += kChunk) {
            const int m = min(kChunk, n_blk - g0);
            stage_chunk(sb, bnd, g0, m);
            for (int s0 = 0; s0 < m; s0 += 32) {
                for (unsigned mask = ballot(sb, s0, m, r, false, 0.0f); mask;
                     mask &= mask - 1) {
                    const int bid = g0 + s0 + __builtin_ctz(mask);
                    const int* sh = desc + 1 + bshape[bid] * SH_SIZE;
                    const int b = bid - sh[SH_BID0];
                    const bool mask_light = sh[SH_LIGHT] && lane_matter;
                    Top2 v[32];
                    for (int j = 0; j < 32; ++j)
                        v[j] = lane_top2(desc, sh, block_rows(tab, sh, b), b,
                                         j, r, mask_light, E);
                    top2_merge(ray, warp_reduce(v));
                }
            }
        }
        t_out[2 * i] = ray.t1;
        t_out[2 * i + 1] = ray.t2;
        c_out[2 * i] = is_finite(ray.t1) ? ray.i1 : -1;
        c_out[2 * i + 1] = is_finite(ray.t2) ? ray.i2 : -1;
    }
}
extern "C" long host_shared_bytes(int n_desc) {
    return (long)top2_shared_bytes(n_desc);
}
// K5: a ray's walk as the warp kernel takes it: the bounds culled 32 at a
// time (the ballot), each passed block with its shape (bshape), each
// round of 32 members of it in turn, stopping after the first round in
// which any lane is blocked (__any_sync); serial: shape by shape, the
// members one at a time up to the first hit (the one-thread design)
extern "C" void host_anyhit(const float* tab, const float* bnd,
                            const int* bshape, const int* desc,
                            const float* p, const float* d,
                            const float* lim_in, uint8_t* out, int n,
                            float eps, int serial) {
    const Eps E = make_eps(eps);
    const int n_blk = table_blocks(desc);
    for (int i = 0; i < n; ++i) {
        const Ray r = load_ray(p, d, i);
        const float l = lim_in[i];
        const float lim = is_finite(l) ? l : F32_BIG;
        bool blocked = false;
        if (serial) {
            for (int s = 0; s < desc[0] && !blocked; ++s) {
                const int* sh = desc + 1 + s * SH_SIZE;
                for (int b = 0; b < sh[SH_NBLK] && !blocked; ++b) {
                    if (!block_cull(bnd, sh[SH_BID0] + b, r, true, lim))
                        continue;
                    const float* blk = block_rows(tab, sh, b);
                    const int n_lanes = min(LB, sh[SH_M] - b * LB);
                    for (int m = 0; m < n_lanes && !blocked; ++m)
                        blocked = member_blocks(desc, sh, blk, m, r, lim, E);
                }
            }
            out[i] = blocked ? 1 : 0;
            continue;
        }
        for (int c0 = 0; c0 < n_blk && !blocked; c0 += 32) {
            unsigned pass = 0;
            for (int j = 0; j < 32; ++j)
                if (c0 + j < n_blk && block_cull(bnd, c0 + j, r, true, lim))
                    pass |= 1u << j;
            while (pass != 0u && !blocked) {
                const int bid = c0 + __builtin_ctz(pass);
                pass &= pass - 1u;
                const int* sh = desc + 1 + bshape[bid] * SH_SIZE;
                const int b = bid - sh[SH_BID0];
                const float* blk = block_rows(tab, sh, b);
                const int n_lanes = min(LB, sh[SH_M] - b * LB);
                for (int m0 = 0; m0 < n_lanes && !blocked; m0 += 32) {
                    bool hit[32];
                    for (int k = 0; k < 32; ++k)
                        hit[k] = m0 + k < n_lanes
                                 && member_blocks(desc, sh, blk, m0 + k, r,
                                                  lim, E);
                    for (int k = 0; k < 32; ++k) blocked = blocked || hit[k];
                }
            }
        }
        out[i] = blocked ? 1 : 0;
    }
}
"""


def test_cuda_source_on_host_matches_plain(mixed, tmp_path):
    """csrc/scene_kernels.cu compiled as host C++, on the scene tables as
    the wrappers pass them: K4's helpers driven as the warp kernel drives
    them (32 lanes a block, the shuffle butterfly, the merge), K5's
    member test as the warp kernel drives it and as the one-thread
    member loop did; the same results as the plain versions
    (t within rtol/atol 2e-4, codes equal on >= 99 % of the finite lanes,
    any-hit equal on >= 99.8 %).  The launch geometry the wrapper reports
    is the source's."""
    lib, src = host_library("scene_kernels.cu", HOST_DRIVER, tmp_path)
    assert f"kTop2Warps = {sk.TOP2_WARPS};" in src
    assert f"kAnyWarps = {sk.ANY_WARPS};" in src
    assert f"kChunk = {sk.CHUNK};" in src
    _, tt = mixed
    st, stm = tt._scene_tables()
    launch = sk.top2_launch(st)
    lib.host_shared_bytes.restype = ctypes.c_long
    assert launch["shared_bytes"] == lib.host_shared_bytes(st.desc_t.numel())
    assert sk.anyhit_launch(stm)["shared_bytes"] \
        == 4 * sk.kernels._pad4(stm.desc_t.numel())
    assert launch["threads"] == 32 * launch["rays_per_block"]
    n = 1024
    p, d = S.rays(n, seed=43)
    lm = (np.arange(n) % 2).astype(np.float32)
    lim = np.random.default_rng(47).uniform(0.2, 15.0, n).astype(np.float32)
    lim[::5] = np.inf
    P, D, LM, LIM = (torch.as_tensor(x) for x in (p, d, lm, lim))
    t = torch.empty((n, 2), dtype=torch.float32)
    c = torch.empty((n, 2), dtype=torch.int32)
    _host_top2(lib, st, P, D, LM, t, c)
    assert lib.host_split() == 0
    t_p, c_p = sk.scene_top2_plain(st, P, D, LM)
    fin = torch.isfinite(t_p)
    assert float(fin[:, 0].float().mean()) > 0.3
    assert float((torch.isfinite(t) == fin).float().mean()) >= 0.998
    both = fin & torch.isfinite(t)
    np.testing.assert_allclose(t[both].numpy(), t_p[both].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert float((c[both] == c_p[both]).float().mean()) >= 0.99
    want = sk.scene_anyhit_plain(stm, P, D, LIM)
    assert want.any() and (~want).any()
    for serial in (0, 1):
        out = _host_anyhit(lib, stm, P, D, LIM, serial)
        assert float((out == want).float().mean()) >= 0.998


def _host_top2(lib, st, P, D, LM, t, c):
    """K4 on the host, as the warp kernel walks the table st, into t, c."""
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    lib.host_top2(ptr(st.table_t), ptr(st.bounds_t), ptr(st.block_shape_t),
                  ptr(st.desc_t), ptr(P), ptr(D), ptr(LM), ptr(t), ptr(c),
                  ctypes.c_int(P.shape[0]), ctypes.c_float(float(st.eps)))


def _host_anyhit(lib, stm, P, D, LIM, serial):
    """K5 on the host: the warp kernel's rounds of 32 members with the
    any-exit (serial=0), or the one-thread design's member loop."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    out = torch.empty((P.shape[0],), dtype=torch.bool)
    lib.host_anyhit(ptr(stm.table_t), ptr(stm.bounds_t),
                    ptr(stm.block_shape_t), ptr(stm.desc_t), ptr(P), ptr(D),
                    ptr(LIM), ptr(out), ctypes.c_int(P.shape[0]),
                    ctypes.c_float(float(stm.eps)), ctypes.c_int(serial))
    return out


def test_cuda_source_on_host_exact_on_ties(tmp_path):
    """K4's warp helpers on the host, driven as above, against the plain
    version on the tie scene (two copies of each lattice sphere in a
    301-member singles shape of three blocks, the light masked for half
    the rays, four pairs of identical composites), where every root is
    exact in f32: t bit for bit and every code equal."""
    _top2_exact_on_ties(host_library("scene_kernels.cu", HOST_DRIVER,
                                     tmp_path)[0])


def _top2_exact_on_ties(lib):
    tr = TTracer(tsir.compile_scene(S.tie_scene(tho)), dtype=np.float32,
                 device="cpu")
    st, _ = tr._scene_tables()
    assert max(sh.M for sh in st.shapes) > sk.LB and st.shapes[0].has_light
    n = 2048
    p, d = S.axis_rays(n, S.TIE_SHAPE, seed=11)
    lm = (np.random.default_rng(13).uniform(size=n) < 0.5).astype(
        np.float32)
    P, D, LM = (torch.as_tensor(x) for x in (p, d, lm))
    t = torch.empty((n, 2), dtype=torch.float32)
    c = torch.empty((n, 2), dtype=torch.int32)
    _host_top2(lib, st, P, D, LM, t, c)
    assert lib.host_split() == 0
    t_p, c_p = sk.scene_top2_plain(st, P, D, LM)
    fin = torch.isfinite(t_p[:, 0])
    assert 0.5 < float(fin.float().mean()) < 1.0
    assert bool(((t_p[:, 0] == t_p[:, 1]) & fin).any())
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(c, c_p)
    return st


def test_staged_walk_on_host_exact_on_ties(tmp_path):
    """The same at a stage of 3 bounds: the tie scene's table passes
    through K4's shared-memory stages more than once, the last one partly
    filled, and the walk still gives the plain version's bits."""
    lib, _ = host_library("scene_kernels.cu", HOST_DRIVER, tmp_path,
                          chunk=3)
    st = _top2_exact_on_ties(lib)
    nb = st.bounds_t.shape[0]
    assert nb > 3 and nb % 3 != 0


def _tie_limits(stm, P, D, seed):
    """Limits for K5 that land on its own comparisons: the nearest matter
    hit exactly (blocked), one ulp before it (blocked only by another
    member), random limits and, on every fifth ray, none (INF)."""
    n = P.shape[0]
    t1 = sk.scene_top2_plain(stm, P, D, torch.ones(n))[0][:, 0].numpy()
    lim = np.random.default_rng(seed).uniform(0.2, 15.0, n).astype(
        np.float32)
    fin = np.isfinite(t1)
    lim[1::5] = np.where(fin[1::5], t1[1::5], lim[1::5])
    lim[2::5] = np.where(fin[2::5], np.nextafter(t1[2::5], np.float32(0)),
                         lim[2::5])
    lim[::5] = np.inf
    return torch.as_tensor(lim)


@pytest.mark.parametrize("scene", ["mixed", "ties"])
def test_anyhit_warp_on_host_exact(mixed, scene, tmp_path):
    """K5's member test driven as the warp kernel drives it (rounds of 32
    members of each passed block, the any-exit after a round), compiled
    as host C++: bit for bit the plain version's booleans and the
    one-thread member loop's, on the mixed scene and on the tie lattice
    (axis rays, every root exact in f32), with limits exactly at the
    nearest hit and one ulp before it."""
    lib, _ = host_library("scene_kernels.cu", HOST_DRIVER, tmp_path)
    if scene == "mixed":
        tr = mixed[1]
        p, d = S.rays(2048, seed=53)
    else:
        tr = TTracer(tsir.compile_scene(S.tie_scene(tho)), dtype=np.float32,
                     device="cpu")
        p, d = S.axis_rays(2048, S.TIE_SHAPE, seed=59)
    _, stm = tr._scene_tables()
    P, D = torch.as_tensor(p), torch.as_tensor(d)
    LIM = _tie_limits(stm, P, D, seed=61)
    want = sk.scene_anyhit_plain(stm, P, D, LIM)
    assert want.any() and (~want).any()
    got = _host_anyhit(lib, stm, P, D, LIM, 0)
    assert torch.equal(got, want)
    assert torch.equal(got, _host_anyhit(lib, stm, P, D, LIM, 1))
