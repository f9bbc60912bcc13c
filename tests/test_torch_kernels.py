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
order, the samples through the warp's slice in chunks), and K2's
kernel, whose shadow test stops at the first blocking object, thread by
thread."""

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

from test_torch_scene_kernels import host_library

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
    assert kernels.LAUNCHES == {"nee": 0, "shadow": 0, "object_hit": 0,
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
    const Scene S{sf, si};
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
                        terms[k] = nee_sample(S, lt, lti,
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
// K2: one call per thread
extern "C" void host_shadow(const float* sf, const int* si, const float* p,
                            const float* d, const float* lim, uint8_t* out,
                            int n, float eps) {
    blockDim.x = 128;
    for (int b = 0; b < (n + 127) / 128; ++b)
        for (int t = 0; t < 128; ++t) {
            blockIdx.x = b; threadIdx.x = t;
            shadow_kernel(Scene{sf, si}, p, d, lim, out, n, eps);
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
