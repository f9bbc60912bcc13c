"""The plain versions of the port's CUDA kernels against the JAX
package's Pallas kernels in interpret mode, on the CPU.

Inputs are seeded numpy arrays handed to both packages, in f32 over the
port's shipped smoke scene (actinon_tpu_torch/scenes/glass_table.acn),
with direct_samples <= 6 and B = 256.  Contracts are those of
tests/test_pallas.py: shadow booleans agree on >= 99.8 % of rays; NEE
radiance within rel 1e-2 on >= 99 % of lanes; object hits agree in
finiteness on >= 99.8 % and in t within 1e-3 (1 + t).  The kernels
themselves run only on a card: tests/test_torch_cuda.py holds them to
the same contracts there.  Here csrc/trace_kernels.cu also compiles as
host C++ (the shim of tests/test_torch_scene_kernels.py): K1's helpers
run lane by lane as the warp kernel runs them (the (light, sample) pairs
in strides of 32, each light's sum in sample order, the lights in light
order, the samples through the warp's slice in chunks), K2's two designs
(the thread design's walk ray by ray; the warp design's lanes in turn,
its ballots and shuffles written out) against the plain shadow test bit
for bit, and K3's walk against the plain object hit bit for bit."""

import ctypes
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from actinon_tpu.acn.interp import run_file as jrun_file
from actinon_tpu.render import pallas_kernels as pk
from actinon_tpu.render.integrator import Integrator as JIntegrator
from actinon_tpu.render.tracer import Tracer as JTracer
from actinon_tpu.scene import ir as jsir
from actinon_tpu_torch.acn.interp import run_file as trun_file
from actinon_tpu_torch.render import kernels
from actinon_tpu_torch.render.integrator import Integrator as TIntegrator
from actinon_tpu_torch.render.tracer import Tracer as TTracer
from actinon_tpu_torch.scene import ir as tsir
from actinon_tpu_torch.scene import objects as tho

import _torch_scenes as S
from test_torch_scene_kernels import host_library
from _torch_threads import one_torch_thread  # noqa: F401

SCENE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "actinon_tpu_torch", "scenes",
    "glass_table.acn")
B = 256


def _load(run_file, sir, direct=6):
    cap = []
    run_file(SCENE, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    sc = cap[0]
    sc.cfg.direct_samples = direct
    return sir.compile_scene(sc)


@pytest.fixture(scope="module")
def pair():
    jt = JTracer(_load(jrun_file, jsir), dtype=np.float32)
    tt = TTracer(_load(trun_file, tsir), dtype=np.float32, device="cpu")
    return jt, tt


def _rays(n, seed, spread=6.0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2])          # above the floor
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _nee_inputs(cap, seed=7):
    """The kernels' NEE inputs, as tests/test_pallas.py draws them."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2])
    sd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    di = rng.uniform(0, 1.2, B).astype(np.float32)
    gate = rng.uniform(0, 1, B) > 0.3
    theta_i = rng.uniform(0, np.pi * 0.999, B).astype(np.float32)
    sigma = rng.uniform(0, 0.4, B).astype(np.float32)
    sig2 = sigma * sigma
    on_a = np.where(sigma > 0, 1.0 - 0.5 * sig2 / (sig2 + 0.33),
                    1.0).astype(np.float32)
    on_b = np.where(sigma > 0, 0.45 * sig2 / (sig2 + 0.09),
                    0.0).astype(np.float32)
    prj = rng.normal(0, 1, (B, 3)).astype(np.float32)
    prj /= np.linalg.norm(prj, axis=-1, keepdims=True)
    rv = rng.integers(0, 2 ** 32, B, dtype=np.uint32)
    ns = np.minimum(np.maximum((cap * di).astype(np.int32), 1), cap)
    return dict(pos=pos, surf_d=sd, di=np.where(gate, di, 0.0).astype(
        np.float32), cos_ti=np.cos(theta_i), on_a=on_a, on_b=on_b,
        ray_prj=prj, rv=rv, ns=ns)


def _torch_args(a, device="cpu"):
    t = lambda x: torch.as_tensor(x, device=device)
    rv = torch.as_tensor(a["rv"].view(np.int32), device=device).view(
        torch.uint32)
    return (t(a["pos"]), t(a["surf_d"]), t(a["di"]), t(a["cos_ti"]),
            t(a["on_a"]), t(a["on_b"]), t(a["ray_prj"]), rv,
            t(a["ns"]).to(torch.int32))


def test_smoke_scene_inside_kernel_coverage(pair):
    """The JAX package's own coverage rules take the whole smoke scene:
    no SDF, <= 192 leaves, every composite within MAX_COMP_COLS, and a
    NEE kernel is built."""
    jt, tt = pair
    singles, comps, rest = pk.kernel_coverage(jt, matter_only=True)
    assert not rest and not jt.sdf_singles
    assert len(jt.tab) <= 192
    assert len(singles) == 2 and len(comps) == 2
    integ = JIntegrator(jt, batch=B)
    assert pk.build_nee_kernel(integ, interpret=True) is not None
    # the port's rules agree
    cov = kernels.coverage(tt)
    assert len(cov.singles) == 2 and len(cov.comps) == 2 and not cov.rest
    assert kernels.nee_supported(TIntegrator(tt, batch=B))
    # one lamp is not a single sphere: its NEE goes through object_hit_t
    assert not all(TIntegrator(tt, batch=B).l_sphere_exact)


def test_shadow_plain_matches_pallas(pair):
    jt, tt = pair
    p, d = _rays(B, 11)
    lim = np.random.default_rng(1).uniform(0.1, 12.0, B).astype(np.float32)
    fn, rest = pk.build_shadow_kernel(jt, interpret=True)
    assert not rest
    want = np.asarray(fn(jnp.asarray(p), jnp.asarray(d), jnp.asarray(lim)))
    got = kernels.shadow_any_hit(tt, torch.as_tensor(p), torch.as_tensor(d),
                                 torch.as_tensor(lim)).numpy()
    assert want.any() and (~want).any()
    assert (got == want).mean() >= 0.998


@pytest.mark.parametrize("oid", [0, 1, 3])
def test_object_hit_plain_matches_pallas(pair, oid):
    """Both lamps (a sphere and the enveloped ellipsoid) and the goblet
    composite."""
    jt, tt = pair
    p, d = _rays(B, 12 + oid)
    # aim half the rays at the object so hits are plentiful
    target = np.asarray(jt.ir.objects[oid].pos, np.float32)
    if oid == 3:
        target = np.array([0.0, 0.0, 1.5], np.float32)
    aim = target - p[: B // 2]
    d[: B // 2] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    fn = pk.build_object_hit_kernel(jt, oid, interpret=True)
    want = np.asarray(fn(jnp.asarray(p), jnp.asarray(d)))
    got = kernels.object_hit(tt, oid, torch.as_tensor(p),
                             torch.as_tensor(d)).numpy()
    fin = np.isfinite(want)
    assert fin.sum() > B // 4
    assert (np.isfinite(got) == fin).mean() >= 0.998
    both = fin & np.isfinite(got)
    assert np.all(np.abs(got[both] - want[both]) <= 1e-3 * (1 + want[both]))


def test_nee_plain_matches_pallas(pair):
    jt, tt = pair
    jinteg = JIntegrator(jt, batch=B)
    tinteg = TIntegrator(tt, batch=B)
    a = _nee_inputs(jinteg.direct_cap)
    kfn = pk.build_nee_kernel(jinteg, interpret=True)
    want = np.asarray(kfn(*[jnp.asarray(a[k]) for k in (
        "pos", "surf_d", "di", "cos_ti", "on_a", "on_b", "ray_prj", "rv",
        "ns")]))
    got = kernels.nee(tinteg, *_torch_args(a)).numpy()
    assert (want > 0).any()
    rel = np.abs(got - want) / (np.abs(want) + 1e-4)
    frac = (rel.max(axis=1) < 1e-2).mean()
    assert frac >= 0.99, f"only {frac} of lanes agree"


def test_cpu_wrappers_launch_nothing(pair):
    """On CPU tensors the wrappers take their plain versions and count no
    launch."""
    _, tt = pair
    kernels.reset_launches()
    p, d = _rays(8, 3)
    kernels.shadow_any_hit(tt, torch.as_tensor(p), torch.as_tensor(d),
                           torch.full((8,), 5.0))
    kernels.object_hit(tt, 0, torch.as_tensor(p), torch.as_tensor(d))
    assert kernels.LAUNCHES == {"nee": 0, "shadow": 0, "shadow_warp": 0,
                                "shadow_thread": 0, "object_hit": 0,
                                "scene_top2": 0, "scene_anyhit": 0,
                                "big_top2": 0, "big_anyhit": 0,
                                "big_anyhit_warp": 0,
                                "big_anyhit_thread": 0,
                                "diag_unary": 0, "diag_expr": 0}


def test_scene_table_layout(pair):
    """The packed table's header points at records that describe the
    tracer's geometry (the layout csrc/trace_kernels.cu reads)."""
    _, tt = pair
    st = kernels.scene_table(tt)
    f, i = st.f.numpy(), st.i.numpy()
    n_leaf, n_comp, n_ss, n_sc = i[:4]
    assert n_leaf == len(tt.tab) and n_comp == 2 and n_ss == n_sc == 2
    M, m0, c2, c1, rr = tt.tables_np
    for r in range(n_leaf):
        rec = f[i[4] + r * kernels.LF_SIZE:][:kernels.LF_SIZE]
        np.testing.assert_array_equal(rec[:9], M[r].reshape(9))
        np.testing.assert_array_equal(rec[18], rr[r])
        assert i[i[6] + r * kernels.LI_SIZE] == tt.tab.kind[r]
    for k, comp in enumerate(tt.composites):
        start, n, pstart, plen = i[i[7] + 4 * k: i[7] + 4 * k + 4]
        assert list(i[i[8] + start: i[8] + start + n]) == list(comp.rows)
        prog = list(i[i[9] + pstart: i[9] + pstart + plen])
        assert prog == kernels._postfix(comp.tree, [])
        assert sum(op >= 0 for op in prog) == n


HOST_DRIVER = r"""
// K1: each lane as the warp kernel takes it, `chunk` samples of each light
// at a time (the kernel's kNeeChunk, or any other chunk for the tests):
// thread t's pairs t, t + 32, ... of the chunk's (light, sample) pairs,
// then each light's running sum over the chunk in sample order, and at
// the end the lights in light order
extern "C" void host_nee(const float* sf, const int* si, const float* LF,
                         const int* LI, int n_lights, int cap,
                         const float* pos, const float* surf_d,
                         const float* di, const float* cos_ti,
                         const float* on_a, const float* on_b,
                         const float* ray_prj, const uint32_t* rv,
                         const int* ns_in, float* out, int n, float eps,
                         int chunk) {
    const View V = view_of(Scene{sf, si});
    float* terms = new float[n_lights * chunk + 2 * n_lights];
    for (int i = 0; i < n; ++i) {
        const NeeLane N = load_nee_lane(i, pos, surf_d, di, cos_ti, on_a,
                                        on_b, ray_prj, rv, ns_in);
        float lum[3] = {0.0f, 0.0f, 0.0f};
        if (N.di > 0.0f) {
            const int ns = nee_samples(N, cap);
            float* acc = terms + n_lights * chunk;
            float* fac = acc + n_lights;
            for (int li = 0; li < n_lights; ++li) acc[li] = 0.0f;
            for (int j0 = 0; j0 < ns; j0 += chunk) {
                const int m = min(chunk, ns - j0);
                for (int t = 0; t < 32; ++t)
                    for (int k = t; k < n_lights * m; k += 32) {
                        const int li = k / m, j = k - li * m;
                        const float* lt = LF + li * LT_SIZE;
                        const int* lti = LI + li * LTI_SIZE;
                        terms[k] = nee_sample(V, lt, lti,
                                              light_frame(lt, lti, N), N, li,
                                              j0 + j, cap, eps);
                    }
                for (int li = 0; li < n_lights; ++li)
                    acc[li] = nee_light_sum(acc[li], terms + li * m, m);
            }
            for (int li = 0; li < n_lights; ++li)
                fac[li] = 2.0f * light_frame(LF + li * LT_SIZE,
                                             LI + li * LTI_SIZE, N).cyl
                          / (float)N.ns;
            nee_lum(LF, acc, fac, n_lights, lum);
        }
        for (int ch = 0; ch < 3; ++ch) out[3 * i + ch] = lum[ch];
    }
    delete[] terms;
}
extern "C" long host_nee_shared_bytes(int n_f, int n_i, int n_lights) {
    return (long)nee_shared_bytes(n_f, n_i, n_lights);
}
// K3: one call per thread
extern "C" void host_object_hit(const float* sf, const int* si, int kind,
                                int idx, const float* p, const float* d,
                                float* out, int n, float eps) {
    blockDim.x = 128;
    for (int b = 0; b < (n + 127) / 128; ++b)
        for (int t = 0; t < 128; ++t) {
            blockIdx.x = b; threadIdx.x = t;
            object_hit_kernel(Scene{sf, si}, kind, idx, p, d, out, n, eps);
        }
}
// K2, thread design: each ray's walk, as a thread of shadow_kernel runs it
extern "C" void host_shadow(const float* sf, const int* si, const float* p,
                            const float* d, const float* lim, uint8_t* out,
                            int n, float eps) {
    const View V = view_of(Scene{sf, si});
    for (int i = 0; i < n; ++i)
        out[i] = shadow_blocked(V, load_ray(p, d, i), read_limit(lim, i),
                                eps) ? 1 : 0;
}
// K2, warp design: comp_blocks_warp with the warp's 32 lanes in turn, its
// ballots and shuffles written out (lane j holds columns j and j + 32)
static bool host_comp_blocks_warp(const View& V, int ci, const Ray& r,
                                  float lim, float eps) {
    const int* CI = V.comp_i + ci * CI_SIZE;
    const int* rows = V.rows + CI[CI_ROWS];
    const int nc = 2 * CI[CI_N];
    float t[2][32];
    bool in[2][32];
    uint32_t kept[2] = {0u, 0u}, ins[2] = {0u, 0u};
    for (int h = 0; h < 2; ++h)
        for (int lane = 0; lane < 32; ++lane) {
            t[h][lane] = finf();
            in[h][lane] = false;
            if (h == 0 || nc > 32)
                warp_column(V, rows, nc, lane + 32 * h, r, t[h][lane],
                            in[h][lane]);
            if (column_kept(t[h][lane], lim, eps)) kept[h] |= 1u << lane;
            if (in[h][lane] && !(lane & 1)) ins[h] |= 1u << lane;
        }
    if ((kept[0] | kept[1]) == 0) return false;
    const uint32_t inside = even_bits(ins[0]) | (even_bits(ins[1]) << 16);
    uint32_t pa[2][32] = {}, pb[2][32] = {};
    for (int h2 = 0; h2 < 2; ++h2)
        for (uint32_t m = kept[h2]; m; m &= m - 1) {
            const int s = __builtin_ctz(m);
            const float tc = t[h2][s];   // the shuffle from lane s
            for (int lane = 0; lane < 32; ++lane)
                for (int h = 0; h < 2; ++h)
                    parity_step(tc, s + 32 * h2, t[h][lane], pa[h][lane],
                                pb[h][lane]);
        }
    const int* prog = V.prog + CI[CI_PROG];
    const int plen = CI[CI_PLEN];
    bool any = false;   // the ballot of the lanes' flips
    for (int lane = 0; lane < 32; ++lane)
        for (int h = 0; h < 2; ++h)
            any = any || (((kept[h] >> lane) & 1u)
                          && column_flips(prog, plen, inside, pa[h][lane],
                                          pb[h][lane]));
    return any;
}
// shadow_blocked_warp: the singles 32 lanes a round, then the composites'
// gates 32 a round and each that passes in order
extern "C" void host_shadow_warp(const float* sf, const int* si,
                                 const float* p, const float* d,
                                 const float* lim, uint8_t* out, int n,
                                 float eps) {
    const View V = view_of(Scene{sf, si});
    for (int i = 0; i < n; ++i) {
        const Ray r = load_ray(p, d, i);
        const float l = read_limit(lim, i);
        bool blocked = false;
        for (int k0 = 0; k0 < V.nss && !blocked; k0 += 32)
            for (int lane = 0; lane < 32; ++lane)
                blocked = blocked || (k0 + lane < V.nss
                                      && single_hit(V, V.ss[k0 + lane], r,
                                                    eps) <= l);
        for (int k0 = 0; k0 < V.nsc && !blocked; k0 += 32) {
            uint32_t pass = 0;
            for (int lane = 0; lane < 32; ++lane)
                if (k0 + lane < V.nsc && comp_gate(V, V.sc[k0 + lane], r))
                    pass |= 1u << lane;
            for (; pass && !blocked; pass &= pass - 1)
                blocked = host_comp_blocks_warp(
                    V, V.sc[k0 + __builtin_ctz(pass)], r, l, eps);
        }
        out[i] = blocked ? 1 : 0;
    }
}
"""


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _host_nee(lib, integ, args, chunk):
    """K1 on the host (HOST_DRIVER's host_nee) over the lanes args."""
    st, lt = kernels.scene_table(integ.tr), kernels.light_table(integ)
    n = args[0].shape[0]
    out = torch.empty((n, 3), dtype=torch.float32)
    lib.host_nee(_ptr(st.f), _ptr(st.i), _ptr(lt.f), _ptr(lt.i),
                 ctypes.c_int(lt.n), ctypes.c_int(integ.direct_cap),
                 *(_ptr(a) for a in args), _ptr(out), ctypes.c_int(n),
                 ctypes.c_float(float(integ.tr.eps)), ctypes.c_int(chunk))
    return out


def test_nee_cuda_source_on_host_matches_plain(pair, tmp_path):
    """K1's per-sample helper and fixed-order sums, compiled as host C++
    and driven lane by lane as the warp kernel drives them, against
    nee_plain: dead lanes exactly 0 in both, live lanes within rel 1e-2
    on >= 99 %.  The shared memory the wrapper reports is the source's."""
    _, tt = pair
    lib, src = host_library("trace_kernels.cu", HOST_DRIVER, tmp_path)
    assert f"kNeeWarps = {kernels.NEE_WARPS};" in src
    assert f"kNeeChunk = {kernels.NEE_CHUNK};" in src
    integ = TIntegrator(tt, batch=B)
    st, lt = kernels.scene_table(tt), kernels.light_table(integ)
    cap = integ.direct_cap
    lib.host_nee_shared_bytes.restype = ctypes.c_long
    launch = kernels.nee_launch(integ)
    assert launch["shared_bytes"] == lib.host_nee_shared_bytes(
        st.f.numel(), st.i.numel(), lt.n)
    assert launch["threads"] == 32 * launch["lanes_per_block"]
    args = _torch_args(_nee_inputs(cap, seed=19))
    out = _host_nee(lib, integ, args, kernels.NEE_CHUNK)
    want = kernels.nee_plain(integ, *args)
    dead = args[2] <= 0
    assert bool(dead.any()) and bool((want[~dead] > 0).any())
    assert bool((out[dead] == 0).all()) and bool((want[dead] == 0).all())
    rel = torch.abs(out - want) / (torch.abs(want) + 1e-4)
    frac = float((rel[~dead].max(dim=1).values < 1e-2).float().mean())
    assert frac >= 0.99, f"only {frac} of live lanes agree"


def test_nee_chunked_sums_on_host_bit_equal(tmp_path):
    """K1's samples through the warp's slice in chunks: at 40 samples a
    light, the kernel's chunk of 32 (two chunks) and a chunk of 7 give
    the unchunked sums (one chunk of all 40) bit for bit, and the lanes
    agree with nee_plain within rel 1e-2 on >= 99 %."""
    assert kernels.NEE_CHUNK < 40
    lib, _ = host_library("trace_kernels.cu", HOST_DRIVER, tmp_path)
    integ = TIntegrator(TTracer(_load(trun_file, tsir, direct=40),
                                dtype=np.float32, device="cpu"), batch=64)
    a = _nee_inputs(integ.direct_cap, seed=23)
    args = _torch_args({k: v[:64] for k, v in a.items()})
    assert int(args[8].max()) > kernels.NEE_CHUNK
    whole = _host_nee(lib, integ, args, integ.direct_cap)
    assert bool((whole > 0).any())
    for chunk in (kernels.NEE_CHUNK, 7):
        got = _host_nee(lib, integ, args, chunk)
        assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
    want = kernels.nee_plain(integ, *args)
    live = args[2] > 0
    rel = torch.abs(whole - want) / (torch.abs(want) + 1e-4)
    assert float((rel[live].max(dim=1).values < 1e-2).float().mean()) >= 0.99


def _many_light_scene(n_lights):
    """A floor, a ball and n_lights sphere lamps in a row above them."""
    sc = tho.Scene()
    floor = tho.Plane()
    sc.push(floor)
    ball = tho.Sphere(0.5)
    ball.move(tho.v3(0.0, 0.0, 1.0))
    sc.push(ball)
    for k in range(n_lights):
        lamp = tho.Sphere(0.1)
        lamp.move(tho.v3(0.3 * k - 0.15 * n_lights, 0.0, 6.0))
        lamp.prp.radiance = 5.0
        sc.push(lamp)
    return sc


@pytest.mark.parametrize("n_lights,direct", [(2, 8000), (72, 200)])
def test_nee_launch_fits_many_samples(n_lights, direct):
    """K1's shared memory does not grow with the sample count: at 2
    lights x 8,000 samples and 72 lights x 200 (where whole per-lane
    sample slices would need 512 KB and 461 KB) it fits a thread block,
    and it equals the launch of the same tables at 1 sample."""
    if n_lights == 2:
        ir = _load(trun_file, tsir, direct=direct)
    else:
        sc = _many_light_scene(n_lights)
        sc.cfg.direct_samples = direct
        ir = tsir.compile_scene(sc)
    integ = TIntegrator(TTracer(ir, dtype=np.float32, device="cpu"),
                        batch=B)
    assert integ.n_lights == n_lights and integ.direct_cap == direct
    assert kernels.nee_supported(integ)
    launch = kernels.nee_launch(integ)
    assert launch["shared_bytes"] <= kernels.SHARED_MAX
    integ.direct_cap = 1
    assert kernels.nee_launch(integ) == launch


def test_shadow_cuda_source_on_host_matches_plain(pair, tmp_path):
    """K2's kernel, whose shadow test returns at the first blocking
    object, compiled as host C++ and run thread by thread: the same
    booleans as shadow_plain on every ray.  The limits are finite, as
    the callers pass them (0 where the NEE found no light hit): the
    kernel reads a limit that is not finite as 3e38, as the Pallas kernel
    does, where the plain version compares with it as it is."""
    _, tt = pair
    lib, _ = host_library("trace_kernels.cu", HOST_DRIVER, tmp_path)
    st = kernels.scene_table(tt)
    n = 2048
    p, d = _rays(n, 23)
    lim = np.random.default_rng(29).uniform(0.1, 12.0, n).astype(np.float32)
    lim[::9] = 0.0
    P, D, LIM = (torch.as_tensor(x) for x in (p, d, lim))
    out = torch.empty((n,), dtype=torch.bool)
    lib.host_shadow(_ptr(st.f), _ptr(st.i), _ptr(P), _ptr(D), _ptr(LIM),
                    _ptr(out), ctypes.c_int(n), ctypes.c_float(float(tt.eps)))
    want = kernels.shadow_plain(tt, P, D, LIM)
    assert want.any() and (~want).any()
    assert torch.equal(out, want)


# -- K2's two designs and K3's walk on the host ------------------------------

SHADOW_DRIVERS = {"thread": "host_shadow", "warp": "host_shadow_warp"}


@pytest.fixture(scope="module")
def trace_lib(tmp_path_factory):
    lib, src = host_library("trace_kernels.cu", HOST_DRIVER,
                            tmp_path_factory.mktemp("trace"))
    return lib, src


def _host_shadow(lib, design, tr, p, d, lim):
    st = kernels.scene_table(tr)
    P, D, LIM = (torch.as_tensor(x) for x in (p, d, lim))
    out = torch.empty((P.shape[0],), dtype=torch.bool)
    getattr(lib, SHADOW_DRIVERS[design])(
        _ptr(st.f), _ptr(st.i), _ptr(P), _ptr(D), _ptr(LIM), _ptr(out),
        ctypes.c_int(P.shape[0]), ctypes.c_float(float(tr.eps)))
    return out, kernels.shadow_plain(tr, P, D, LIM)


def _aimed_rays(tt, n, seed):
    """n rays over the glass_table scene, half of them aimed at the goblet
    (whose envelope most of them then pass)."""
    p, d = _rays(n, seed)
    aim = np.array([0.0, 0.0, 1.5], np.float32) - p[: n // 2]
    d[: n // 2] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    return p, d


def _goblet(tt):
    cov = kernels.coverage(tt)
    return max(cov.comps, key=lambda c: len(c.rows))


@pytest.mark.parametrize("design", list(SHADOW_DRIVERS))
def test_shadow_designs_on_host_match_plain(pair, trace_lib, design):
    """Each K2 design (the warp design lane by lane) gives shadow_plain's
    boolean on every ray of the glass_table scene: random rays and rays
    aimed at the goblet, random limits, every ninth limit 0."""
    _, tt = pair
    p, d = _aimed_rays(tt, 2048, 31)
    lim = np.random.default_rng(37).uniform(0.1, 12.0, 2048).astype(
        np.float32)
    lim[::9] = 0.0
    got, want = _host_shadow(trace_lib[0], design, tt, p, d, lim)
    assert want.any() and (~want).any()
    assert torch.equal(got, want)


def _crossing_limits(tr, comp, p, d, seed):
    """Per ray, fl(t - eps) of one of composite comp's finite forward
    crossings (chosen at random; 0 where it has none), then each one ulp
    below and above."""
    cross, _, _ = tr._composite_crossings(comp, torch.as_tensor(p),
                                          torch.as_tensor(d))
    cross = cross.numpy()
    fin = np.isfinite(cross)
    pick = np.random.default_rng(seed).random(cross.shape) * fin
    col = np.argmax(pick, axis=1)
    t = cross[np.arange(len(p)), col]
    at = np.where(fin.any(1), t - np.float32(tr.eps), 0).astype(np.float32)
    return fin.any(1), (at, np.nextafter(at, np.float32(-np.inf)),
                        np.nextafter(at, np.float32(np.inf)))


@pytest.mark.parametrize("design", list(SHADOW_DRIVERS))
def test_shadow_designs_on_host_exact_at_crossings(pair, trace_lib, design):
    """Limits exactly at fl(t - eps) of a goblet crossing, and one ulp
    below and above it: each K2 design equals shadow_plain on every ray
    (the walks drop the columns past the limit, and keep every column
    that can block)."""
    _, tt = pair
    p, d = _aimed_rays(tt, 1024, 41)
    has, lims = _crossing_limits(tt, _goblet(tt), p, d, 43)
    assert has.mean() > 0.3
    flips = []
    for lim in lims:
        got, want = _host_shadow(trace_lib[0], design, tt, p, d, lim)
        assert torch.equal(got, want)
        flips.append(want.numpy())
    # the ulp matters on some rays: the limits sit on the boundary
    assert (flips[0] != flips[1]).any()


@pytest.fixture(scope="module")
def face_tie_tr():
    return TTracer(tsir.compile_scene(S.face_tie_scene(tho)),
                   dtype=np.float32, device="cpu")


@pytest.mark.parametrize("design", list(SHADOW_DRIVERS))
def test_shadow_designs_on_host_exact_on_face_ties(face_tie_tr, trace_lib,
                                                   design):
    """Composites whose leaves share a face (coincident half-spaces and
    spheres under &, a sphere less its own copy): crossings tie exactly,
    and each K2 design equals shadow_plain on every ray, at random limits
    and at fl(t - eps) of each composite's crossings and one ulp either
    side."""
    tr = face_tie_tr
    cov = kernels.coverage(tr)
    assert len(cov.comps) == 3 and not cov.rest
    rng = np.random.default_rng(47)
    n = 1536
    x = rng.choice(np.float32([-2.5, 0.0, 2.5]), n)
    p = np.stack([x + rng.uniform(-0.9, 0.9, n),
                  rng.uniform(-0.9, 0.9, n),
                  rng.choice(np.float32([-1.5, 3.0]), n)], -1).astype(
        np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = np.where(p[:, 2] > 0, -1.0, 1.0)
    d[n // 2:] += rng.normal(0, 0.2, (n - n // 2, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rand = rng.uniform(0.1, 6.0, n).astype(np.float32)
    lim_sets = [rand]
    for k, comp in enumerate(cov.comps):
        lim_sets += _crossing_limits(tr, comp, p, d, 53 + k)[1]
    blocked = 0
    for lim in lim_sets:
        got, want = _host_shadow(trace_lib[0], design, tr, p, d, lim)
        assert torch.equal(got, want)
        blocked += int(want.sum())
    assert 0 < blocked < n * len(lim_sets)


@pytest.mark.parametrize("design", list(SHADOW_DRIVERS))
def test_shadow_designs_on_host_exact_on_wide_composite(trace_lib, design):
    """A composite of 21 leaves (42 columns: two a lane in the warp
    design, local memory in the thread design): each K2 design equals
    shadow_plain on every ray, at random limits and at fl(t - eps) of its
    crossings and one ulp either side."""
    tr = TTracer(tsir.compile_scene(S.wide_comp_scene(tho)),
                 dtype=np.float32, device="cpu")
    comp, = kernels.coverage(tr).comps
    assert 2 * len(comp.rows) == 42
    rng = np.random.default_rng(61)
    n = 1024
    p = np.stack([rng.uniform(-4.5, 4.5, n), rng.uniform(-3, 3, n),
                  rng.uniform(2, 4, n)], -1).astype(np.float32)
    aim = np.stack([rng.uniform(-4.0, 4.0, n), rng.uniform(-0.3, 0.3, n),
                    rng.uniform(-0.3, 0.3, n)], -1).astype(np.float32)
    # a quarter along the row, from either end; a quarter from inside a
    # leaf (a row sphere, or the hole), in any direction
    q = n // 4
    p[2 * q:3 * q, 0] = rng.choice(np.float32([-5, 5]), q)
    p[2 * q:3 * q, 2] = rng.uniform(-0.2, 0.2, q)
    d = aim - p
    p[3 * q:] = np.stack([0.4 * rng.integers(0, 20, n - 3 * q) - 3.8,
                          np.zeros(n - 3 * q), np.zeros(n - 3 * q)], -1)
    p[3 * q:] += rng.uniform(-0.15, 0.15, (n - 3 * q, 3))
    d[3 * q:] = rng.normal(0, 1, (n - 3 * q, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    has, lims = _crossing_limits(tr, comp, p, d, 67)
    assert has.mean() > 0.5
    blocked = 0
    for lim in (rng.uniform(0.1, 8.0, n).astype(np.float32),) + lims:
        got, want = _host_shadow(trace_lib[0], design, tr, p, d, lim)
        assert torch.equal(got, want)
        blocked += int(want.sum())
    assert 0 < blocked < 4 * n


def _ieee_sqrt(x):
    """f32 square root rounded once: the f64 root rounded to f32 (the
    double rounding is exact for sqrt, 53 >= 2 * 24 + 2)."""
    pos = x > 0
    root = torch.sqrt(torch.where(pos, x, 1.0).double()).to(x.dtype)
    return torch.where(pos, root, 0.0)


def test_object_hit_on_host_bit_equal_goblet(pair, trace_lib, monkeypatch):
    """K3 (the walk with its envelope gate first) gives object_hit_plain's
    bits on the goblet, hits and misses alike.  The plain version takes
    an IEEE square root here, as the kernel's sqrtf is on the card and the
    host: torch's f32 sqrt on a CPU with AVX-512 can round to the other
    neighbour (sqrt(0.84449768) to 0.91896552, where 0.91896558 is the
    nearer), which moves a root by an ulp."""
    _, tt = pair
    lib, _ = trace_lib
    from actinon_tpu_torch.render import tracer as ttracer
    monkeypatch.setattr(ttracer, "safe_sqrt", _ieee_sqrt)
    oid = _goblet(tt).oid
    st = kernels.scene_table(tt)
    p, d = (torch.as_tensor(x) for x in _aimed_rays(tt, 2048, 59))
    out = torch.empty((2048,), dtype=torch.float32)
    lib.host_object_hit(_ptr(st.f), _ptr(st.i), ctypes.c_int(1),
                        ctypes.c_int(st.comp_index[oid]), _ptr(p), _ptr(d),
                        _ptr(out), ctypes.c_int(2048),
                        ctypes.c_float(float(tt.eps)))
    want = kernels.object_hit_plain(tt, oid, p, d)
    assert int(torch.isfinite(want).sum()) > 512
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_shadow_launch_on_host(pair, trace_lib):
    """K2's launch constants are the source's; the design flips at
    SHADOW_WARP_MAX_RAYS; a thread block takes SHADOW_WARPS or
    SHADOW_THREADS rays; the shared memory holds the padded table."""
    _, tt = pair
    src = trace_lib[1]
    assert f"kShadowWarps = {kernels.SHADOW_WARPS};" in src
    assert f"kShadowThreads = {kernels.SHADOW_THREADS};" in src
    m = kernels.SHADOW_WARP_MAX_RAYS
    warp = kernels.shadow_launch(tt, m)
    thread = kernels.shadow_launch(tt, m + 1)
    assert (warp["design"], thread["design"]) == ("warp", "thread")
    assert warp["threads"] == 32 * warp["rays_per_block"]
    assert thread["threads"] == thread["rays_per_block"]
    st = kernels.scene_table(tt)
    assert warp["shared_bytes"] == thread["shared_bytes"] == 4 * (
        -(-st.f.numel() // 4) * 4 + -(-st.i.numel() // 4) * 4)
    assert warp["grid"] == -(-m // kernels.SHADOW_WARPS)
    assert thread["grid"] == -(-(m + 1) // kernels.SHADOW_THREADS)
    assert kernels.nee_launch(TIntegrator(tt, batch=B))["shared_bytes"] \
        > warp["shared_bytes"]
