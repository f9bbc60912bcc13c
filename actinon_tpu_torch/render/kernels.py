"""Hand-written CUDA kernels of the trace queries, each beside its plain
PyTorch version.

Counterpart of the JAX package's `render/pallas_kernels.py`.  The three
kernels live in `csrc/trace_kernels.cu`:

  * `nee`        (K1) — the whole per-light next-event-estimation loop
    of a lane; replaces `pallas_kernels.build_nee_kernel`;
  * `shadow_any_hit` (K2) — any matter hit within a limit; replaces
    `pallas_kernels.build_shadow_kernel`; two designs, a warp a ray up to
    SHADOW_WARP_MAX_RAYS rays and a thread a ray above (`shadow_launch`);
  * `object_hit` (K3) — the eps-backed first hit of one object; replaces
    `pallas_kernels.build_object_hit_kernel`.

The Pallas kernels were generated per scene with every leaf baked in as
an immediate.  Here one kernel source serves every scene: the geometry
the JAX package's `kernel_coverage` and `_light_coverage` select is
flattened into a read-only table (`SceneTable`, `LightTable`: the flat
leaf/composite table of K1-K3, not the packed table of the scene kernels
K4/K5 in `render/scene_kernels.py`) that every thread of a warp reads in
step.  K1 takes one warp per NEE lane, its (light, sample) pairs across
the warp, NEE_CHUNK samples of each light at a time, and copies both
tables into shared memory once per thread block (`nee_launch`); K2 copies
the scene table there too.
Composites with SDF leaves lie outside this coverage, as in the JAX
package.  The library of all the port's kernels
(this module's, `scene_kernels`' K4/K5, `bigscene`'s K6/K7, `diag_ops`'
K8/K9 and `cond`'s conditional-node helpers) builds at first use with one
`nvcc` call, from the
sources in this package only, into `_build/`; it is keyed by a hash of
the sources.

A wrapper takes the plain version when its tensors lie on the CPU, and
only then.  On a CUDA tensor it launches its kernel or raises; each
launch adds one to `LAUNCHES[name]` (a launch captured in a CUDA graph
adds one at each replay that runs it instead: render/graphs.py,
render/cond.py).  The plain versions call the
tracer's and integrator's own plain code: the arithmetic is written once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import numpy as np
import torch

MAX_COMP_COLS = 64        # composite size cap of the crossing walk

# launches per kernel (a launch of the wrapper's kernel adds one; K2's and
# K7's launches also count by design: "shadow_warp", "shadow_thread",
# "big_anyhit_warp" and "big_anyhit_thread")
LAUNCHES: Dict[str, int] = {"nee": 0, "shadow": 0, "shadow_warp": 0,
                            "shadow_thread": 0, "object_hit": 0,
                            "scene_top2": 0, "scene_anyhit": 0,
                            "big_top2": 0, "big_anyhit": 0,
                            "big_anyhit_warp": 0, "big_anyhit_thread": 0,
                            "diag_unary": 0, "diag_expr": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", f)
           for f in ("trace_kernels.cu", "scene_kernels.cu",
                     "bigscene_kernels.cu", "diag_ops.cu", "graph_cond.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

SHARED_MAX = 232448   # shared memory a thread block may have on sm_90
NEE_WARPS = 4         # K1: NEE lanes (one warp each) a thread block; must
                      # match kNeeWarps of csrc/trace_kernels.cu
NEE_CHUNK = 32        # K1: samples of each light a warp's shared slice
                      # holds at a time; must match kNeeChunk
SHADOW_WARPS = 4      # K2, warp design: rays (one warp each) a block;
                      # must match kShadowWarps
SHADOW_THREADS = 128  # K2, thread design: rays a block; kShadowThreads
# K2 takes the warp design up to this many rays, the thread design above.
# A warp a ray spreads a ray's objects and crossing columns over 32
# lanes, so a small batch finishes in about one ray's parallel walk; a
# thread a ray runs a fraction of the instructions per ray, and wins
# once the batch fills the card.  On an H100 (700 W; chip_smoke.py's "k2
# sweep" lines, both designs in turns on rays spread evenly over the
# counter render's 40,960-ray batch and over the synthetic batch): the
# warp design won at 1,024 to 20,480 rays on both (the render's rays,
# 5,120: 0.0060 against 0.0121 ms; 20,480: 0.0111 against 0.0124), the
# thread design from 30,720 up (40,960: 0.0125 against 0.0199; the
# synthetic 327,680: 0.0543 against 0.1519).  20,480 is the largest size
# the warp design won on both.
SHADOW_WARP_MAX_RAYS = 20480

# table layout: must match csrc/trace_kernels.cu
H_SIZE = 16
LF_SIZE, LI_SIZE = 24, 4
CF_SIZE, CI_SIZE = 8, 4
LTF_SIZE, LTI_SIZE = 16, 4
OP_AND, OP_OR, OP_NOT = -1, -2, -3


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# coverage: which geometry the kernels take (the JAX package's rules)


@dataclasses.dataclass
class Coverage:
    singles: List[int]        # unified rows of single-leaf matter objects
    comps: list               # matter composites within MAX_COMP_COLS
    rest: list                # matter composites the kernels leave out


def _comp_fits(comp) -> bool:
    """An analytic composite within the walk's column cap; composites
    with SDF leaves never fit (their marches are not in these kernels)."""
    return not comp.has_sdf and 2 * len(comp.rows) <= MAX_COMP_COLS


def coverage(tr) -> Coverage:
    """`kernel_coverage(tracer, matter_only=True)`
    (pallas_kernels.py:228-255) over the tracer's composites."""
    got = tr._kernel_cache.get("coverage")
    if got is None:
        tab = tr.tab
        singles = [int(r) for r in tr.single_rows if not tab.is_light[r]]
        comps, rest = [], []
        for comp in tr.composites:
            if comp.is_light:
                continue
            (comps if _comp_fits(comp) else rest).append(comp)
        got = tr._kernel_cache["coverage"] = Coverage(singles, comps, rest)
    return got


def object_desc(tr, oid: int):
    """("leaf", row) or ("comp", composite) for one object, or None when
    it is an SDF object or a composite with SDF leaves or too large for
    the walk (build_object_hit_kernel, pallas_kernels.py:695-724)."""
    rows = np.flatnonzero((tr.tab.oid == oid) & tr.tab.single)
    if len(rows):
        return ("leaf", int(rows[0]))
    for comp in tr.composites:
        if comp.oid == oid:
            return ("comp", comp) if _comp_fits(comp) else None
    return None


def nee_supported(integ) -> bool:
    """The NEE kernel covers the scene (build_nee_kernel returns a kernel,
    pallas_kernels.py:478-484): no matter outside coverage (no SDF
    composite, no standalone matter SDF), and every light within
    `_light_coverage` (pallas_kernels.py:426-464)."""
    tr = integ.tr
    if coverage(tr).rest or not integ.n_lights \
            or any(not light for *_, light in tr.sdf_singles):
        return False
    return all(object_desc(integ.tr, oid) is not None
               for oid in integ.l_oid)


# ---------------------------------------------------------------------------
# the read-only tables the kernels read


def _postfix(tree, out):
    if tree[0] == "leaf":
        out.append(int(tree[1]))
    elif tree[0] == "not":
        _postfix(tree[1], out)
        out.append(OP_NOT)
    else:
        _postfix(tree[1], out)
        _postfix(tree[2], out)
        out.append(OP_AND if tree[0] == "and" else OP_OR)
    return out


@dataclasses.dataclass
class SceneTable:
    f: torch.Tensor            # float32 records (leaves, composites)
    i: torch.Tensor            # int32 header, records, rows, programs
    comp_index: Dict[int, int]  # oid -> composite record


def _f32sq(x: float) -> float:
    """x*x rounded once to f32 (the Pallas kernels square python floats)."""
    return float(np.float32(float(x) * float(x)))


def scene_table(tr) -> SceneTable:
    """The tracer's geometry as the kernels read it: every leaf of the
    unified table, every composite the walk takes, and the shadow
    coverage lists (cached; set_geom rebuilds it)."""
    got = tr._kernel_cache.get("scene_table")
    if got is not None:
        return got
    tab = tr.tab
    M, m0, c2, c1, rr = tr.tables_np
    L = len(tab)
    leaf_f = np.zeros((L, LF_SIZE), np.float64)
    leaf_i = np.zeros((L, LI_SIZE), np.int64)
    for r in range(L):
        er = float(tab.env_r[r])
        leaf_f[r] = np.concatenate([
            np.asarray(M[r], np.float64).reshape(9), m0[r], c2[r], c1[r],
            [rr[r]], tab.env_c[r], [er, _f32sq(er)]])
        leaf_i[r] = (int(tab.kind[r]), int(np.all(c2[r] == 0)),
                     int(er > 0), 0)
    comps = [c for c in tr.composites if _comp_fits(c)]
    comp_f = np.zeros((len(comps), CF_SIZE), np.float64)
    comp_i = np.zeros((len(comps), CI_SIZE), np.int64)
    rowlist: List[int] = []
    prog: List[int] = []
    comp_index = {}
    for k, comp in enumerate(comps):
        comp_index[comp.oid] = k
        has_env = comp.env_c is not None and comp.env_r > 0
        er = float(comp.env_r) if has_env else -1.0
        ec = np.asarray(comp.env_c, np.float64) if has_env else np.zeros(3)
        comp_f[k, :5] = [*ec, er, _f32sq(er)]
        code = _postfix(comp.tree, [])
        comp_i[k] = (len(rowlist), len(comp.rows), len(prog), len(code))
        rowlist.extend(int(r) for r in comp.rows)
        prog.extend(code)
    cov = coverage(tr)
    ss = cov.singles
    sc = [comp_index[c.oid] for c in cov.comps]

    ints = [np.zeros(H_SIZE, np.int64), leaf_i.reshape(-1),
            comp_i.reshape(-1), np.asarray(rowlist, np.int64),
            np.asarray(prog, np.int64), np.asarray(ss, np.int64),
            np.asarray(sc, np.int64)]
    offs = np.cumsum([0] + [len(a) for a in ints])
    head = ints[0]
    head[:12] = (L, len(comps), len(ss), len(sc), 0, L * LF_SIZE,
                 offs[1], offs[2], offs[3], offs[4], offs[5], offs[6])
    f = np.concatenate([leaf_f.reshape(-1), comp_f.reshape(-1), [0.0]])
    i = np.concatenate(ints + [np.zeros(1, np.int64)])
    got = SceneTable(
        torch.as_tensor(f.astype(np.float32), device=tr.device),
        torch.as_tensor(i.astype(np.int32), device=tr.device), comp_index)
    tr._kernel_cache["scene_table"] = got
    return got


@dataclasses.dataclass
class LightTable:
    f: torch.Tensor
    i: torch.Tensor
    n: int


def light_table(integ) -> LightTable:
    """Per-light sampling and hit descriptors (`_light_coverage`,
    pallas_kernels.py:426-464) against the scene table (cached;
    load_jax_params rebuilds it)."""
    got = integ._kernel_cache.get("light_table")
    if got is not None:
        return got
    st = scene_table(integ.tr)
    n = integ.n_lights
    lf = np.zeros((max(n, 1), LTF_SIZE), np.float64)
    li = np.zeros((max(n, 1), LTI_SIZE), np.int64)
    for k in range(n):
        kind, ref = object_desc(integ.tr, integ.l_oid[k])
        plane = integ.l_fov[k] == "plane"
        pn = integ.l_plane_n[k] if plane else np.zeros(3)
        lf[k, :14] = [*pn, *integ.l_cone_pos[k], *integ.l_pos[k],
                      _f32sq(integ.l_radius[k]), integ.l_rad[k],
                      *integ.l_color[k]]
        li[k] = (int(plane), 0 if kind == "leaf" else 1,
                 ref if kind == "leaf" else st.comp_index[ref.oid], 0)
    dev = integ.tr.device
    got = LightTable(torch.as_tensor(lf.reshape(-1).astype(np.float32),
                                     device=dev),
                     torch.as_tensor(li.reshape(-1).astype(np.int32),
                                     device=dev), n)
    integ._kernel_cache["light_table"] = got
    return got


# ---------------------------------------------------------------------------
# build and load


_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc():
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtrace_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu for sm_90a into one library, in one nvcc call,
    unless the library of these sources is already built; returns its
    path.  Raises on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, path)
    return path


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.actinon_shadow.argtypes = [P, P, I, I, P, P, P, P, I, F, I,
                                           P]
            lib.actinon_object_hit.argtypes = [P, P, I, I, P, P, P, I, F, P]
            lib.actinon_nee.argtypes = [P, P, I, I, P, P, I, I, P, P, P, P,
                                        P, P, P, P, P, P, I, F, P]
            lib.actinon_scene_top2.argtypes = [P, P, P, P, P, P, P, P, P,
                                               I, F, I, P]
            lib.actinon_scene_anyhit.argtypes = [P, P, P, P, P, P, P, P, I,
                                                 F, I, P]
            lib.actinon_big_top2.argtypes = [P, P, I, P, P, P, P, I, F, P]
            lib.actinon_big_anyhit.argtypes = [P, P, I, P, P, P, P, I, F, I,
                                                P]
            lib.actinon_diag_op.argtypes = [I, P, P, P, P, I, P]
            for fn in (lib.actinon_shadow, lib.actinon_object_hit,
                       lib.actinon_nee, lib.actinon_scene_top2,
                       lib.actinon_scene_anyhit, lib.actinon_big_top2,
                       lib.actinon_big_anyhit, lib.actinon_diag_op):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check(t, shape, dtype, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _pad4(words: int) -> int:
    return -(-words // 4) * 4


def _table_shared_bytes(st) -> int:
    """The scene table in a thread block's shared memory (K1, K2): its
    floats, then its ints, each padded to 16 bytes (csrc/trace_kernels.cu
    `scene_shared_bytes`)."""
    return 4 * (_pad4(st.f.numel()) + _pad4(st.i.numel()))


# ---------------------------------------------------------------------------
# K2: shadow any-hit


def shadow_plain(tr, p, d, limit):
    """Plain version of the shadow kernel: the tracer's non-kernel
    any-hit (JAX tracer.py:2226-2258) over the kernel's coverage (no rest
    composites, no standalone SDF objects)."""
    out = {c.oid for c in coverage(tr).rest}
    out.update(oid for _, oid, *_ in tr.sdf_singles)
    return tr._shadow_plain(p, d, limit, exclude_oids=frozenset(out))


def shadow_design(n: int) -> str:
    """K2's design for a batch of n rays: "warp" or "thread"."""
    return "warp" if n <= SHADOW_WARP_MAX_RAYS else "thread"


def shadow_launch(tr, n: int, design=None) -> dict:
    """K2's launch for n rays: the design (`shadow_design(n)` unless
    given), threads and rays a thread block, the grid, and the dynamic
    shared memory that holds the scene table's floats and ints, each
    padded to 16 bytes (csrc/trace_kernels.cu `scene_shared_bytes`; at
    most about 50 KB within the kernels' 192 leaves)."""
    design = design or shadow_design(n)
    per_block = SHADOW_WARPS if design == "warp" else SHADOW_THREADS
    return dict(design=design,
                threads=32 * per_block if design == "warp" else per_block,
                rays_per_block=per_block, grid=-(-n // per_block),
                shared_bytes=_table_shared_bytes(scene_table(tr)))


def shadow_any_hit(tr, p, d, limit, design=None):
    """blocked [N] bool: any covered matter hit within (., limit].
    design: "warp" or "thread", by default `shadow_design(N)`; both give
    the same booleans.  Raises where the scene table does not fit a
    thread block's shared memory (never within the kernels' 192
    leaves)."""
    if p.device.type == "cpu":
        return shadow_plain(tr, p, d, limit)
    N = p.shape[0]
    _check(p, (N, 3), torch.float32, "p")
    _check(d, (N, 3), torch.float32, "d")
    _check(limit, (N,), torch.float32, "limit")
    design = design or shadow_design(N)
    st = scene_table(tr)
    shared = _table_shared_bytes(st)
    if shared > SHARED_MAX:
        raise ValueError(f"shadow: the scene table needs {shared} bytes of "
                         f"shared memory, a thread block has {SHARED_MAX}")
    # torch.bool is one byte holding 0 or 1: the kernel writes it directly
    out = torch.empty((N,), dtype=torch.bool, device=p.device)
    if N == 0:
        return out
    rc = _lib().actinon_shadow(st.f.data_ptr(), st.i.data_ptr(),
                               st.f.numel(), st.i.numel(), p.data_ptr(),
                               d.data_ptr(), limit.data_ptr(),
                               out.data_ptr(), N, float(tr.eps),
                               int(design == "warp"), _stream())
    _launched("shadow", rc)
    LAUNCHES[f"shadow_{design}"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: single-object first hit


def object_hit_plain(tr, oid, p, d):
    """Plain version of the object-hit kernel (JAX
    tracer.py:2280-2295)."""
    return tr._object_hit_plain(oid, p, d)


def object_hit(tr, oid: int, p, d):
    """a [N]: eps-backed first hit of object `oid`, INF on a miss."""
    if p.device.type == "cpu":
        return object_hit_plain(tr, oid, p, d)
    N = p.shape[0]
    _check(p, (N, 3), torch.float32, "p")
    _check(d, (N, 3), torch.float32, "d")
    desc = object_desc(tr, oid)
    if desc is None:
        raise ValueError(f"object {oid} is outside the object-hit kernel's "
                         f"coverage")
    out = torch.empty((N,), dtype=torch.float32, device=p.device)
    if N == 0:
        return out
    st = scene_table(tr)
    kind, ref = desc
    args = (0, ref) if kind == "leaf" else (1, st.comp_index[ref.oid])
    rc = _lib().actinon_object_hit(st.f.data_ptr(), st.i.data_ptr(), *args,
                                   p.data_ptr(), d.data_ptr(),
                                   out.data_ptr(), N, float(tr.eps),
                                   _stream())
    _launched("object_hit", rc)
    return out


# ---------------------------------------------------------------------------
# K1: the fused NEE loop


def nee_plain(integ, pos, surf_d, di, cos_ti, on_a, on_b, ray_prj, rv, ns):
    """Plain version of the NEE kernel: the integrator's non-kernel NEE
    (`_nee_exact_batch` and the per-light loop) with plain shadow and
    light-hit queries, fed the kernel's pre-gated di and cos(theta_i)."""
    from actinon_tpu_torch.render.tracer import safe_acos
    tr = integ.tr
    return integ._nee_plain(pos, surf_d, di, di > 0, safe_acos(cos_ti),
                            on_a, on_b, ray_prj, rv, ns, tr._shadow_plain,
                            tr._object_hit_plain)


def nee_launch(integ) -> dict:
    """K1's launch geometry: threads and NEE lanes (one warp each) a
    thread block, and the dynamic shared memory that holds the scene and
    light tables, each padded to 16 bytes, and per warp n_lights *
    NEE_CHUNK sample terms (the samples pass through in chunks) and
    n_lights (sum, factor) pairs (csrc/trace_kernels.cu
    `nee_shared_bytes`).  It does not grow with the sample count: within
    the kernels' 192 leaves (tracer.MAX_KERNEL_LEAVES, lights included)
    it stays below about 155 KB of a thread block's 227 KB."""
    st, lt = scene_table(integ.tr), light_table(integ)
    n = lt.n
    words = (_pad4(n * LTF_SIZE) + _pad4(n * LTI_SIZE)
             + NEE_WARPS * _pad4(n * NEE_CHUNK + 2 * n))
    return dict(threads=32 * NEE_WARPS, lanes_per_block=NEE_WARPS,
                shared_bytes=_table_shared_bytes(st) + 4 * words)


def nee(integ, pos, surf_d, di, cos_ti, on_a, on_b, ray_prj, rv, ns):
    """lum [B,3] of the per-light NEE loop.  pos, surf_d, ray_prj [B,3]
    f32; di (zero where the lane does not shade), cos_ti, on_a, on_b [B]
    f32; rv [B] uint32 stream ids; ns [B] int32 sample counts, any
    number of them.  Raises where the tables do not fit a thread block's
    shared memory beside the sample slices (never within the kernels' 192
    leaves)."""
    if pos.device.type == "cpu":
        return nee_plain(integ, pos, surf_d, di, cos_ti, on_a, on_b,
                         ray_prj, rv, ns)
    B = pos.shape[0]
    for name, t in (("pos", pos), ("surf_d", surf_d), ("ray_prj", ray_prj)):
        _check(t, (B, 3), torch.float32, name)
    for name, t in (("di", di), ("cos_ti", cos_ti), ("on_a", on_a),
                    ("on_b", on_b)):
        _check(t, (B,), torch.float32, name)
    _check(rv, (B,), torch.uint32, "rv")
    _check(ns, (B,), torch.int32, "ns")
    if not nee_supported(integ):
        raise ValueError("the scene is outside the NEE kernel's coverage")
    shared = nee_launch(integ)["shared_bytes"]
    if shared > SHARED_MAX:
        raise ValueError(f"nee: the tables and sample slices need {shared} "
                         f"bytes of shared memory, a thread block has "
                         f"{SHARED_MAX}")
    out = torch.empty((B, 3), dtype=torch.float32, device=pos.device)
    if B == 0:
        return out
    st = scene_table(integ.tr)
    lt = light_table(integ)
    rc = _lib().actinon_nee(
        st.f.data_ptr(), st.i.data_ptr(), st.f.numel(), st.i.numel(),
        lt.f.data_ptr(), lt.i.data_ptr(), lt.n, int(integ.direct_cap),
        pos.data_ptr(), surf_d.data_ptr(),
        di.data_ptr(), cos_ti.data_ptr(), on_a.data_ptr(), on_b.data_ptr(),
        ray_prj.data_ptr(), rv.data_ptr(), ns.data_ptr(), out.data_ptr(), B,
        float(integ.tr.eps), _stream())
    _launched("nee", rc)
    return out
