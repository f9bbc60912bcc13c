"""Vectorized ray-scene intersection over the compiled Scene IR.

PyTorch counterpart of the JAX package's `render/tracer.py`.  Every
analytic leaf surface — half-space, sphere, quadric — is one row of a
unified *generalized quadric* table

    side(x) = sum_i c2_i y_i^2 + sum_i c1_i y_i + r,   y = M x + m0

so a scene traversal is the two affine maps pl = M p + m0, dl = M d, the
two roots of A t^2 + B t + C = 0 for all leaves at once, the family root
policies (reference src/gmath.h:38-97, src/objects.c:791-801), a
crossing-parity walk for CSG composites, and one global top-2 merge.
Normals are rebuilt for the winners only: grad side = (2 c2 y + c1) M.

The differentiable renderer (`render/diff.py`) sets `ovr`, a dict of
tensors keyed as `geom_params()`: the queries then read leaf tables that
`_assemble` builds from them, so autograd reaches every override.  With
`diff` set, the SDF marches run on detached rays and a standalone SDF
hit is reattached by one Newton step of its implicit function.  Under
either, every query takes the plain torch path, as the JAX package
turns its Pallas routes off under traced overrides and AD.

Distance (SDF) leaves are marched: a standalone SDF object by one
bidirectional sphere march (reference src/objects.c:903-959), an SDF leaf
inside a composite by up to SDF_CROSSINGS sequential marches that feed
the crossing walk.  Composites with SDF leaves are or-decomposed and
clustered by shape; a cluster's members evaluate as one batch dimension.
The plain path marches from the ray origin, as the JAX package does on
the CPU (its envelope clip of the marches applies off the CPU only); the
JAX package's XLA-speed variants of the same math (gate-compacted pairs,
solo-cluster scans, the polynomial-sign walk) are not ported.

On a CUDA device in f32 the queries run through the hand-written kernels,
under the JAX package's routing rules: the packed scene kernels of
`render/scene_kernels.py` (K4, K5; they clip their marches to the
envelopes, as the Pallas kernels always do) for SDF and large scenes, the
Morton-block sphere kernels of `render/bigscene.py` (K6, K7) for the
spheres of scenes with at least BIG_MIN_ROWS of them, and the kernels of
`render/kernels.py` (K2, K3) for small analytic scenes and single-object
hits.  All functions take and return tensors shaped [R] /
[R,3] on the tracer's device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from actinon_tpu_torch.config import resolve_device
from actinon_tpu_torch.render import cond
from actinon_tpu_torch.scene import ir as sir

INF = math.inf
CHUNK = 1024           # single-leaf candidate chunk (running top-2)
MAX_KERNEL_LEAVES = 192  # leaf-table size the kernels take (tracer.py:2164)
SDF_CROSSINGS = 4      # bounded crossing count for SDF leaves inside CSG
MARCH_ACCEPT = 1.5     # march acceptance = MARCH_ACCEPT * eps: a step of
                       # dist+eps overshoots the zero by <= eps for a
                       # 1-Lipschitz SDF, plus f32 evaluation noise
MAX_SCENE_MEMBERS = 192  # the scene kernels carry larger populations
                         # (JAX tracer._prefer_scene_query)


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype or torch dtype -> torch dtype (f32 / f64 only)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


_NP_TYPES = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int64: np.int64, torch.bool: np.bool_}


def numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return {torch.float32: np.dtype(np.float32),
                torch.float64: np.dtype(np.float64)}[dtype]
    return np.dtype(dtype)


_NO_READS = [0]


@contextlib.contextmanager
def no_host_reads():
    """Within it, host_reads_ok is False on every device: a CUDA graph's
    warm-up runs the very ops that its capture records."""
    _NO_READS[0] += 1
    try:
        yield
    finally:
        _NO_READS[0] -= 1


def host_reads_ok(device) -> bool:
    """A query may read a tensor back to decide a loop: on the CPU, and
    on a CUDA device unless a CUDA graph is being captured; never on a
    device that holds no data (meta), nor within `no_host_reads`."""
    if _NO_READS[0]:
        return False
    if device.type == "cuda":
        return not torch.cuda.is_current_stream_capturing()
    return device.type == "cpu"


def _norm3(v):
    ln2 = torch.sum(v * v, dim=-1, keepdim=True)
    pos = ln2 > 0
    ln = torch.sqrt(torch.where(pos, ln2, 1.0))
    return torch.where(pos, v / ln, v)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_acos(x):
    """arccos with clamped input."""
    inside = torch.abs(x) < 1.0
    xin = torch.where(inside, x, 0.0)
    edge = torch.where(x >= 1.0, 0.0, math.pi).to(x.dtype)
    return torch.where(inside, torch.arccos(xin), edge)


def _fma32(a, b, c):
    """a * b + c of f32 tensors, rounded once to f32: formed in f64, where
    the product of two f32 values is exact (the same bits on the CPU and
    on CUDA; autograd passes through the casts)."""
    return (a.double() * b.double() + c.double()).float()


def _dot_fma32(a, b):
    """a . b over the last axis as XLA's compiled CPU code rounds a
    `jnp.sum(a * b, -1)` of f32 tensors: fma(a2, b2, fma(a1, b1, a0 b0));
    in f64 the plain dot."""
    if a.dtype != torch.float32:
        return _dot(a, b)
    t = a[..., 0] * b[..., 0]
    return _fma32(a[..., 2], b[..., 2], _fma32(a[..., 1], b[..., 1], t))


def _disc(s, q):
    """The discriminant s * s - q; in f32 rounded once, fma(s, s, -q), as
    the JAX package's compiled code rounds it.  Rounded twice, the light
    hit of a far-field NEE sample whose cone is one ulp wide cancels to 0
    and lands on the light's centre, where the NEE takes its 1e30 cap."""
    if s.dtype == torch.float32:
        return _fma32(s, s, -q)
    return s * s - q


def _sphere_first_hit(c, r, p, d, eps):
    """Reference sphere_ray_hit semantics (src/gmath.h:64-85): entry root
    when outside+approaching, exit root when inside or behind-center.
    Used by the integrator's NEE light intersection.  In f32 the dots, q
    and the discriminant round as XLA's compiled code rounds them on the
    CPU (each multiply-add once); f64 keeps the plain formulas."""
    pp = p - c
    if pp.dtype == torch.float32:
        if not isinstance(r, torch.Tensor):
            # a fill, not an upload: a captured trip may not copy from
            # the host
            r = torch.full((), r, dtype=pp.dtype, device=pp.device)
        s = _dot_fma32(pp, d)
        q = _fma32(-r, r, _dot_fma32(pp, pp))
    else:
        s = _dot(pp, d)
        q = _dot(pp, pp) - r * r
    disc = _disc(s, q)
    ok = disc >= 0
    root = safe_sqrt(torch.where(ok, disc, 0.0))
    entering = (s < 0) & (q > 0)
    exiting = (s < 0) | (q < 0)
    a = torch.where(entering, -s - root,
                    torch.where(exiting, -s + root, INF))
    return torch.where(ok, a - eps, INF)


def as_table(v, dtype, device):
    """An override value as a table tensor: a tensor keeps its autograd
    graph; an array or number is copied."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(v, numpy_dtype(dtype)), dtype=dtype,
                           device=device)


def same_ovr(saved, ovr) -> bool:
    """`saved`, a copy of an override dict, holds the very objects that
    `ovr` holds now (tables built from it are still current)."""
    return saved.keys() == ovr.keys() and all(
        ovr[k] is v for k, v in saved.items())


@dataclasses.dataclass
class _BigScene:
    """The sphere blocks of K6/K7 and their device tensors: the block
    table and bounds, and `rows_padded` [G * 128] (the unified row of each
    block lane; 0 on dead lanes) that maps a kernel's gidx to a row."""
    blocks: object
    table: torch.Tensor
    bounds: torch.Tensor
    rows_padded: torch.Tensor


def _min_idx(a, dim, keepdim=False):
    """(min, argmin) over `dim`; ties take the first index.  A tensor that
    needs a gradient takes `amin`, whose backward shares the gradient
    among tied entries as `jnp.min`'s does (torch.min gives it to one)."""
    if a.requires_grad:
        return (torch.amin(a, dim=dim, keepdim=keepdim),
                torch.argmin(a, dim=dim, keepdim=keepdim))
    return torch.min(a, dim=dim, keepdim=keepdim)


ONE_HOT_ROWS = 64   # tables up to this many rows: one-hot row lookups
                    # under autograd (the JAX tracer's L <= 64 rule)


def _rows(idx, *tabs):
    """tab[idx] for each of `tabs` (row-aligned tables).  Under autograd a
    small table is read through one one-hot product, as the JAX package
    reads it: the backward is then one matmul, where a gather's backward
    sums thousands of duplicate rows one by one (CUDA's deterministic
    index_put).  The one-hot product is exact: each output is one row
    times 1 plus zeros."""
    n = tabs[0].shape[0]
    if not (any(t.requires_grad for t in tabs) and n <= ONE_HOT_ROWS):
        return tuple(t[idx] for t in tabs)
    flat = torch.cat([t.reshape(n, -1) for t in tabs], dim=1)
    oh = (idx[..., None] == torch.arange(n, device=idx.device)).to(
        flat.dtype)
    got = torch.matmul(oh, flat)
    out, k = [], 0
    for t in tabs:
        w = int(np.prod(t.shape[1:], dtype=np.int64))
        out.append(got[..., k:k + w].reshape(idx.shape + t.shape[1:]))
        k += w
    return tuple(out)


def _top2_cols(a):
    """Smallest and second-smallest over the last axis of [R, K] (K >= 1).
    Returns (vals [R,2], idx [R,2]); ties take the first column."""
    K = a.shape[1]
    t1, i1 = _min_idx(a, 1)
    cols = torch.arange(K, device=a.device)
    a2 = torch.where(cols[None, :] == i1[:, None], INF, a)
    t2, i2 = _min_idx(a2, 1)
    return torch.stack([t1, t2], dim=1), torch.stack([i1, i2], dim=1)


def _tree_eval_mask(tree, leaf_vals):
    """Static unroll of the CSG tree program; leaf_vals(li) yields the
    bool inside-mask of local leaf li."""
    if tree[0] == "leaf":
        return leaf_vals(tree[1])
    if tree[0] == "and":
        return _tree_eval_mask(tree[1], leaf_vals) \
            & _tree_eval_mask(tree[2], leaf_vals)
    if tree[0] == "or":
        return _tree_eval_mask(tree[1], leaf_vals) \
            | _tree_eval_mask(tree[2], leaf_vals)
    if tree[0] == "not":
        return ~_tree_eval_mask(tree[1], leaf_vals)
    raise ValueError(tree)


def _sdf_eval(kind, param, pos):
    """Signed distance of the unit shape at local points pos [..., 3]
    (reference src/distance.c); param broadcasts against pos[..., 0]."""
    if kind == sir.SDF_SPHERE:
        return torch.sqrt(torch.sum(pos * pos, -1)) - 1.0
    if kind == sir.SDF_TORUS:
        x, y = pos[..., 0], pos[..., 1]
        f = torch.sqrt(x * x + y * y)
        f_inv = torch.where(f > 0, 1.0 / torch.where(f > 0, f, 1.0), 1.0)
        xu, yu = x * f_inv, y * f_inv
        return torch.sqrt((xu - x) ** 2 + (yu - y) ** 2 + pos[..., 2] ** 2) \
            - param
    raise ValueError(kind)


def _affine(m, m0, x):
    """m x + m0 for points x [..., 3] and frames m [..., 3, 3] that
    broadcast against them (m0 None: the linear part alone)."""
    y = torch.matmul(m, x[..., None])[..., 0]
    return y if m0 is None else y + m0


# ---------------------------------------------------------------------------
# unified leaf table


class _Unified:
    """SoA table of all analytic leaves (numpy; uploaded by the Tracer)."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.M = []        # [L,3,3]
        self.m0 = []       # [L,3]
        self.c2 = []       # [L,3]
        self.c1 = []       # [L,3]
        self.rr = []       # [L]
        self.kind = []     # [L] sir.PLANE/SPHERE/QUADRIC
        self.neg = []      # [L] normal flip
        self.oid = []      # [L] owning object id
        self.is_light = []
        self.single = []   # candidate column (owning object single-leaf)
        self.env_c = []    # [L,3] owning object envelope (singles only)
        self.env_r = []    # [L]
        # parameter bookkeeping (geom_params / set_geom): every leaf of a
        # family, composite leaves included, as in the JAX tracer
        self.sph_rows, self.sph_c, self.sph_r = [], [], []
        self.pla_rows, self.pla_n, self.pla_k = [], [], []
        self.qua_rows = []
        self.qua_m, self.qua_m0, self.qua_coef, self.qua_r = [], [], [], []
        self.comp_keys = []  # (row, key_prefix, family)

    def add(self, lf: sir.Leaf, oid: int, is_light: bool, single: bool,
            env_c, env_r, key: Optional[str]) -> int:
        row = len(self.rr)
        eye = np.eye(3)
        if lf.family == sir.PLANE:
            M, m0 = eye, np.zeros(3)
            c2, c1, r = np.zeros(3), np.asarray(lf.n, float), float(lf.k)
            self.pla_rows.append(row)
            self.pla_n.append(np.asarray(lf.n, float))
            self.pla_k.append(float(lf.k))
        elif lf.family == sir.SPHERE:
            M, m0 = eye, -np.asarray(lf.c, float)
            c2, c1, r = np.ones(3), np.zeros(3), -float(lf.r) ** 2
            self.sph_rows.append(row)
            self.sph_c.append(np.asarray(lf.c, float))
            self.sph_r.append(float(lf.r))
        elif lf.family == sir.QUADRIC:
            M, m0 = np.asarray(lf.m, float), np.asarray(lf.m0, float)
            c2, c1, r = np.asarray(lf.coef, float), np.zeros(3), float(lf.r)
            self.qua_rows.append(row)
            self.qua_m.append(M); self.qua_m0.append(m0)
            self.qua_coef.append(c2); self.qua_r.append(r)
        else:
            raise ValueError(lf.family)
        self.M.append(M); self.m0.append(m0)
        self.c2.append(c2); self.c1.append(c1); self.rr.append(r)
        self.kind.append(lf.family); self.neg.append(lf.neg)
        self.oid.append(oid); self.is_light.append(is_light)
        self.single.append(single)
        self.env_c.append(env_c if env_c is not None else np.zeros(3))
        self.env_r.append(env_r if env_c is not None else -1.0)
        if key is not None:
            self.comp_keys.append((row, key, lf.family))
        return row

    def finalize(self):
        dt = self.dtype
        z = lambda a, shp: (np.asarray(a, dt) if len(a)
                            else np.zeros(shp, dt))
        self.M = z(self.M, (0, 3, 3)); self.m0 = z(self.m0, (0, 3))
        self.c2 = z(self.c2, (0, 3)); self.c1 = z(self.c1, (0, 3))
        self.rr = z(self.rr, (0,))
        self.kind = np.asarray(self.kind, np.int32)
        self.neg = np.asarray(self.neg, bool)
        self.oid = np.asarray(self.oid, np.int32)
        self.is_light = np.asarray(self.is_light, bool)
        self.single = np.asarray(self.single, bool)
        self.env_c = z(self.env_c, (0, 3)); self.env_r = z(self.env_r, (0,))
        self.sph_c = z(self.sph_c, (0, 3)); self.sph_r = z(self.sph_r, (0,))
        self.pla_n = z(self.pla_n, (0, 3)); self.pla_k = z(self.pla_k, (0,))
        self.qua_m = z(self.qua_m, (0, 3, 3))
        self.qua_m0 = z(self.qua_m0, (0, 3))
        self.qua_coef = z(self.qua_coef, (0, 3))
        self.qua_r = z(self.qua_r, (0,))
        for n in ("sph_rows", "pla_rows", "qua_rows"):
            setattr(self, n, np.asarray(getattr(self, n), np.int64))

    def __len__(self):
        return len(self.rr)


class _Composite:
    """One CSG object: tree program over unified rows + SDF leaves."""

    def __init__(self, oid, tree, rows, sdf_leaves, env_c, env_r, is_light):
        self.oid = oid
        self.tree = tree          # local leaf indices
        self.rows = rows          # local analytic leaf -> global row (or -1)
        self.sdf_leaves = sdf_leaves  # local leaf -> sir.Leaf (or None)
        self.env_c = env_c
        self.env_r = env_r
        self.is_light = is_light

    @property
    def has_sdf(self) -> bool:
        return any(lf is not None for lf in self.sdf_leaves)


# -- or-decomposition of analytic composites --------------------------------
#
# A union of spatially DISJOINT solids hits like independent objects: the
# first boundary of A|B is min(first(A), first(B)) whenever A and B cannot
# overlap.  Splitting or-nodes whose operand bounds are disjoint gives
# each part a tight envelope gate and lets same-shape parts batch into one
# group walk (the reference's author-defined bounding-sphere hierarchy,
# src/compound.c:215-244).


def _sdf_leaf_bound(lf):
    """Conservative bounding sphere of one positive SDF leaf from its
    local frame: the unit shape (sphere r=1 / torus ring 1 + tube prm)
    mapped through the inverse affine transform."""
    if lf.neg:
        return None
    m = np.asarray(lf.m, np.float64)
    try:
        minv = np.linalg.inv(m)
    except np.linalg.LinAlgError:
        return None
    if lf.sdf_kind == sir.SDF_SPHERE:
        r_local = 1.0
    elif lf.sdf_kind == sir.SDF_TORUS:
        r_local = 1.0 + float(lf.sdf_param)
    else:
        return None
    c = minv @ (-np.asarray(lf.m0, np.float64))
    smax = float(np.linalg.svd(minv, compute_uv=False)[0])
    return (c, r_local * smax)


def _leaf_bound(tab, row):
    """Conservative bounding sphere of one positive analytic leaf, or
    None when unbounded (planes, negations, open quadrics)."""
    if tab.neg[row]:
        return None
    if tab.kind[row] == sir.SPHERE:
        return (-np.asarray(tab.m0[row], np.float64),
                float(np.sqrt(-tab.rr[row])))
    if tab.kind[row] == sir.QUADRIC:
        M = np.asarray(tab.M[row], np.float64)
        m0 = np.asarray(tab.m0[row], np.float64)
        c2 = np.asarray(tab.c2[row], np.float64)
        rr = float(tab.rr[row])
        if np.all(c2 > 0) and rr < 0:        # ellipsoid
            try:
                Minv = np.linalg.inv(M)
            except np.linalg.LinAlgError:
                return None
            r_local = float(np.sqrt(-rr / np.min(c2)))
            smax = float(np.linalg.svd(Minv, compute_uv=False)[0])
            return (Minv @ (-m0), r_local * smax)
    return None


def _merge_bounds(b1, b2):
    """Smallest sphere around two bounding spheres (None = unbounded)."""
    if b1 is None or b2 is None:
        return None
    c1, r1 = b1
    c2_, r2 = b2
    d = float(np.linalg.norm(c2_ - c1))
    if d + r2 <= r1:
        return b1
    if d + r1 <= r2:
        return b2
    r = 0.5 * (d + r1 + r2)
    c = c1 + (c2_ - c1) * ((r - r1) / d if d > 0 else 0.0)
    return (c, r)


def _tree_bound(tree, rows, tab, sdf_leaves):
    """Bounding sphere of a subtree (None = unbounded).  An intersection
    is bounded by ANY bounded operand; a union needs both."""
    if tree[0] == "leaf":
        if rows[tree[1]] >= 0:
            return _leaf_bound(tab, rows[tree[1]])
        if sdf_leaves[tree[1]] is not None:
            return _sdf_leaf_bound(sdf_leaves[tree[1]])
        return None
    if tree[0] == "not":
        return None
    b1 = _tree_bound(tree[1], rows, tab, sdf_leaves)
    b2 = _tree_bound(tree[2], rows, tab, sdf_leaves)
    if tree[0] == "and":
        if b1 is None:
            return b2
        if b2 is None:
            return b1
        return b1 if b1[1] <= b2[1] else b2
    return _merge_bounds(b1, b2)


def _or_parts(tree):
    if tree[0] == "or":
        return _or_parts(tree[1]) + _or_parts(tree[2])
    return [tree]


def _tree_leaves(tree):
    if tree[0] == "leaf":
        return [tree[1]]
    if tree[0] == "not":
        return _tree_leaves(tree[1])
    return _tree_leaves(tree[1]) + _tree_leaves(tree[2])


def _reindex_tree(tree, mapping):
    if tree[0] == "leaf":
        return ("leaf", mapping[tree[1]])
    if tree[0] == "not":
        return ("not", _reindex_tree(tree[1], mapping))
    return (tree[0], _reindex_tree(tree[1], mapping),
            _reindex_tree(tree[2], mapping))


def _decompose_composite(comp, tab, eps):
    """Split a composite's top-level union into mini-composites for its
    spatially disjoint components (analytic AND SDF leaves — SDF parts
    bound through their local frames, _sdf_leaf_bound).  Components keep
    the parent's oid; bounded components get their own tight envelope.
    Returns [comp] unchanged when nothing splits."""
    parts = _or_parts(comp.tree)
    if len(parts) < 2:
        return [comp]
    bounds = [_tree_bound(p, comp.rows, tab, comp.sdf_leaves)
              for p in parts]
    n = len(parts)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # an unbounded part (contains planes/negations) may overlap anything:
    # it glues the whole union back together (conservative)
    margin = 8.0 * eps
    for i in range(n):
        for j in range(i + 1, n):
            if bounds[i] is None or bounds[j] is None:
                parent[find(i)] = find(j)
                continue
            ci, ri = bounds[i]
            cj, rj = bounds[j]
            if np.linalg.norm(cj - ci) <= ri + rj + margin:
                parent[find(i)] = find(j)
    comps: Dict[int, list] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    if len(comps) < 2:
        return [comp]
    out = []
    for idxs in comps.values():
        tree = parts[idxs[0]]
        bound = bounds[idxs[0]]
        for i in idxs[1:]:
            tree = ("or", tree, parts[i])
            bound = _merge_bounds(bound, bounds[i])
        locs = sorted(set(_tree_leaves(tree)))
        mapping = {l: k for k, l in enumerate(locs)}
        new_tree = _reindex_tree(tree, mapping)
        new_rows = [comp.rows[l] for l in locs]
        new_sdfs = [comp.sdf_leaves[l] for l in locs]
        if bound is not None:
            env_c, env_r = bound[0], bound[1] * 1.001 + 4.0 * eps
        else:
            env_c, env_r = comp.env_c, comp.env_r
        out.append(_Composite(comp.oid, new_tree, new_rows, new_sdfs, env_c,
                              env_r, comp.is_light))
    return out


def _shape_clusters(comps):
    """Group composites by shape identity: same CSG tree, same
    analytic/SDF slot pattern, same static SDF kinds, same envelope
    presence, same light flag.  Members of a cluster differ only in
    numeric parameters, so they evaluate as one batch dimension."""
    clusters: Dict = {}
    for comp in comps:
        key = (repr(comp.tree),
               tuple(r >= 0 for r in comp.rows),
               tuple(None if lf is None else
                     (lf.sdf_kind, int(lf.cycles), bool(lf.neg))
                     for lf in comp.sdf_leaves),
               comp.env_c is not None and comp.env_r > 0,
               comp.is_light)
        clusters.setdefault(key, []).append(comp)
    return list(clusters.values())


# ---------------------------------------------------------------------------


class Tracer:
    """Per-scene tracer over the unified leaf table: vectorized nearest /
    transition / shadow queries on one device."""

    def __init__(self, ir: sir.SceneIR, dtype=np.float32, eps=None,
                 device="cuda", use_kernels=True):
        self.ir = ir
        self.dtype = numpy_dtype(dtype)
        self.tdtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.dtype != np.float32 \
                and use_kernels:
            raise ValueError(
                "CUDA renders run in float32: the trace kernels are f32, "
                "as the Pallas kernels are; use dtype=float32, "
                "device='cpu', or use_kernels=False (the plain path)")
        self.eps = eps if eps is not None else \
            (1e-6 if self.dtype == np.float64 else 1e-4)
        # counterpart of the JAX tracer's `use_pallas`: False keeps every
        # query on the plain PyTorch path (A/B comparisons, and f64 on a
        # card)
        self.use_kernels = use_kernels
        # counterpart of the JAX tracer's `use_scene_interpret`: tests set
        # it to take the scene-kernel route on a CPU tracer, where the
        # kernels' wrappers run their plain versions
        self.scene_kernels_on_cpu = False
        # counterpart of the JAX tracer's `use_bigscene_interpret`: tests
        # set it to take the big-scene route (K6, K7) on a CPU tracer
        self.bigscene_on_cpu = False
        # differentiable-path hooks (render/diff.py): `ovr` maps
        # geom_params keys to tensors that replace the scene's own values
        # in the queries (autograd reaches them); `diff` marches the SDF
        # leaves on detached rays and reattaches standalone SDF hits
        # through their implicit function
        self.ovr = {}
        self.diff = False
        self._ovr_tabs = None

        self.n_obj = len(ir.objects)
        self.is_light = np.array([o.is_light for o in ir.objects], bool)
        self.roughness = np.array([o.roughness for o in ir.objects],
                                  self.dtype)

        tab = _Unified(self.dtype)
        composites: List[_Composite] = []
        sdf_singles = []   # (leaf, oid, env_c, env_r, is_light)
        for oid, obj in enumerate(ir.objects):
            env_c = obj.env_c if obj.env_c is not None else None
            env_r = obj.env_r
            if obj.single_leaf:
                lf = obj.leaves[0]
                if lf.family == sir.SDF:
                    # the leaf's own entry-clip envelope, else the object's
                    sdf_singles.append((lf, oid, lf.env_c if lf.env_c
                                        is not None else env_c,
                                        lf.env_r if lf.env_c is not None
                                        else (env_r if env_c is not None
                                              else -1.0), obj.is_light))
                else:
                    tab.add(lf, oid, obj.is_light, True, env_c,
                            env_r if env_c is not None else -1.0, None)
            else:
                ci = len(composites)
                rows, sdfs = [], []
                for li, lf in enumerate(obj.leaves):
                    if lf.family == sir.SDF:
                        rows.append(-1)
                        sdfs.append(lf)
                    else:
                        rows.append(tab.add(lf, oid, obj.is_light, False,
                                            None, -1.0, f"c{ci}_l{li}_"))
                        sdfs.append(None)
                composites.append(_Composite(
                    oid, obj.tree, rows, sdfs, env_c,
                    env_r if env_c is not None else -1.0, obj.is_light))
        tab.finalize()
        self.tab = tab
        self.composites = composites
        self._sdf_singles0 = sdf_singles   # the scene's own SDF leaves
        self.sdf_singles = list(sdf_singles)

        # or-decomposition first: disjoint union components evaluate
        # independently with tight envelopes.  All-analytic parts group
        # by tree shape and evaluate as ONE batched crossing-parity walk;
        # the parts of composites with SDF leaves are the solo composites,
        # clustered by shape (_solo_clusters)
        groups: Dict = {}
        self.comp_solo = []
        for comp in composites:
            if comp.has_sdf:
                self.comp_solo.extend(
                    _decompose_composite(comp, tab, self.eps))
                continue
            for sub in _decompose_composite(comp, tab, self.eps):
                groups.setdefault(repr(sub.tree), []).append(sub)
        self.comp_groups = list(groups.values())
        self._solo_cl = _shape_clusters(self.comp_solo)

        self.single_rows = np.flatnonzero(tab.single).astype(np.int64)
        # big-scene kernel coverage (JAX tracer.py:603-617): single-leaf
        # matter spheres whose envelope is absent or encloses the sphere
        # (the envelope gate is then redundant), the rows of K6/K7
        sph = (tab.kind == sir.SPHERE) & tab.single & ~tab.is_light
        if sph.any():
            c = -tab.m0
            r = np.sqrt(np.maximum(-tab.rr, 0.0))
            off = np.linalg.norm(tab.env_c - c, axis=-1)
            env_ok = (tab.env_r <= 0) \
                | (off + r <= tab.env_r * (1 + 1e-6) + 1e-9)
            self.big_rows = np.flatnonzero(sph & env_ok).astype(np.int32)
        else:
            self.big_rows = np.zeros((0,), np.int32)
        self._idx_cache = {}
        self._kernel_cache = {}
        self._geom_ovr = {}
        # the leaf table as the queries and kernels read it (numpy);
        # set_geom replaces it
        self.tables_np = (tab.M, tab.m0, tab.c2, tab.c1, tab.rr)
        self._generation = 0
        self._upload()

    # -- tables on the device -------------------------------------------------

    def _upload(self, tables=None):
        """Copy the leaf table (or assembled `tables`) to the device."""
        t = self.tab
        dev, dt = self.device, self.tdtype
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        if tables is None:
            tables = (t.M, t.m0, t.c2, t.c1, t.rr)
        self.tabs = tuple(f(a) for a in tables)
        self.t_env_c = f(t.env_c)
        self.t_env_r = f(t.env_r)
        self.t_neg = torch.as_tensor(t.neg, device=dev)
        self.t_oid = torch.as_tensor(t.oid.astype(np.int64), device=dev)
        self.t_rough = f(self.roughness)
        self._kernel_cache.clear()
        self._generation += 1     # drops the drains' graphs

    def _const(self, a, dtype=None):
        """The device tensor of a static numpy value `a` (in `dtype`, the
        tracer's float type by default), cached by its contents until the
        tables change (_upload): a query uploads nothing, so that a drain
        trip can be captured as a CUDA graph, where a copy from pageable
        host memory is refused."""
        a = np.asarray(a, _NP_TYPES[dtype or self.tdtype])
        key = ("const", a.dtype.str, a.shape, a.tobytes())
        got = self._kernel_cache.get(key)
        if got is None:
            got = self._kernel_cache[key] = torch.as_tensor(
                a, device=self.device)
        return got

    def _idx(self, rows):
        """Device index tensor for a static numpy row set (cached)."""
        rows = np.asarray(rows, np.int64)
        key = (rows.shape, rows.tobytes())
        got = self._idx_cache.get(key)
        if got is None:
            got = torch.as_tensor(rows, device=self.device)
            self._idx_cache[key] = got
        return got

    def geom_params(self):
        """The geometry parameters as a dict of numpy arrays, with the
        keys and values of the JAX tracer's `geom_params` (family arrays
        over every leaf of the family, per-leaf keys for composite leaves,
        and the frame and parameter of each standalone SDF object as
        `sdfs{i}_*`).  The current values, after any set_geom."""
        t = self.tab
        p = {}
        for si, (lf, _oid, _ec, _er, _light) in \
                enumerate(self._sdf_singles0):
            p[f"sdfs{si}_m"] = lf.m
            p[f"sdfs{si}_m0"] = lf.m0
            p[f"sdfs{si}_prm"] = np.asarray(lf.sdf_param)
        if len(t.sph_rows):
            p["sph_c"] = t.sph_c
            p["sph_r"] = t.sph_r
        if len(t.pla_rows):
            p["pla_n"] = t.pla_n
            p["pla_k"] = t.pla_k
        if len(t.qua_rows):
            p["qua_m"] = t.qua_m
            p["qua_m0"] = t.qua_m0
            p["qua_coef"] = t.qua_coef
            p["qua_r"] = t.qua_r
        for row, key, fam in t.comp_keys:
            if fam == sir.PLANE:
                p[key + "n"] = t.c1[row]
                p[key + "k"] = t.rr[row]
            elif fam == sir.SPHERE:
                p[key + "c"] = -t.m0[row]
                p[key + "r"] = np.sqrt(-t.rr[row])
            elif fam == sir.QUADRIC:
                p[key + "m"] = t.M[row]
                p[key + "m0"] = t.m0[row]
                p[key + "coef"] = t.c2[row]
                p[key + "r"] = t.rr[row]
        p.update(self._geom_ovr)
        return {k: np.asarray(v, self.dtype) for k, v in p.items()}

    def set_geom(self, params: Dict[str, np.ndarray]):
        """Take geometry parameters (keys of geom_params) in place of the
        scene's own and rebuild the device leaf table from them — the JAX
        tracer's `_assemble` with `ovr` set: the family arrays are written
        first, then the per-leaf composite keys.  The `sdfs{i}_*` keys
        replace the standalone SDF objects' frames and parameters (the
        JAX package reads them in its differentiable renderer only; a
        forward render here marches with them).  This is the numpy route
        of forward renders; the differentiable renderer passes tensors
        through `ovr` instead.  The kernels' tables are rebuilt from the
        new values at their next use."""
        t = self.tab
        dt = self.dtype
        self._geom_ovr = {k: np.asarray(v, dt) for k, v in params.items()}
        g = lambda k, base: np.asarray(self._geom_ovr.get(k, base), dt)
        o = lambda k, base: (np.asarray(self._geom_ovr[k], np.float64)
                             if k in self._geom_ovr else base)
        self.sdf_singles = [
            (dataclasses.replace(
                lf, m=o(f"sdfs{si}_m", lf.m), m0=o(f"sdfs{si}_m0", lf.m0),
                sdf_param=float(o(f"sdfs{si}_prm", lf.sdf_param))),
             oid, ec, er, light)
            for si, (lf, oid, ec, er, light) in
            enumerate(self._sdf_singles0)]
        M, m0, c2, c1, rr = (t.M.copy(), t.m0.copy(), t.c2.copy(),
                             t.c1.copy(), t.rr.copy())
        if len(t.sph_rows):
            sr = g("sph_r", t.sph_r)
            m0[t.sph_rows] = -g("sph_c", t.sph_c)
            rr[t.sph_rows] = -sr * sr
        if len(t.pla_rows):
            c1[t.pla_rows] = g("pla_n", t.pla_n)
            rr[t.pla_rows] = g("pla_k", t.pla_k)
        if len(t.qua_rows):
            M[t.qua_rows] = g("qua_m", t.qua_m)
            m0[t.qua_rows] = g("qua_m0", t.qua_m0)
            c2[t.qua_rows] = g("qua_coef", t.qua_coef)
            rr[t.qua_rows] = g("qua_r", t.qua_r)
        for row, key, fam in t.comp_keys:
            if fam == sir.PLANE:
                c1[row] = g(key + "n", t.c1[row])
                rr[row] = g(key + "k", t.rr[row])
            elif fam == sir.SPHERE:
                c = g(key + "c", -t.m0[row])
                r = g(key + "r", np.sqrt(-t.rr[row]))
                m0[row] = -c
                rr[row] = -r * r
            elif fam == sir.QUADRIC:
                M[row] = g(key + "m", t.M[row])
                m0[row] = g(key + "m0", t.m0[row])
                c2[row] = g(key + "coef", t.c2[row])
                rr[row] = g(key + "r", t.rr[row])
        self.tables_np = (M, m0, c2, c1, rr)
        self._upload(self.tables_np)

    def _as(self, x):
        return torch.as_tensor(x, dtype=self.tdtype, device=self.device)

    # -- differentiable table access ------------------------------------------

    def _traced(self) -> bool:
        """Overrides or AD are on: the queries stay on the plain path."""
        return bool(self.ovr) or self.diff

    def _t(self, name, value):
        """Table read with an optional override from `ovr` (a tensor keeps
        its autograd graph); without one, the cached device constant of
        the numpy `value`."""
        o = self.ovr.get(name)
        if o is None:
            return self._const(value)
        return as_table(o, self.tdtype, self.device)

    def _assemble(self):
        """The (M, m0, c2, c1, rr) leaf tables built from the `ovr`
        tensors, in the order of writes of set_geom (the JAX tracer's
        `_assemble`): the family arrays first, then the per-leaf composite
        keys.  Out-of-place writes, so autograd reaches every override;
        the base tables are the cached device constants (`_const`), so
        that a captured replay uploads nothing."""
        t = self.tab
        M, m0, c2, c1, rr = (self._const(a) for a in (t.M, t.m0, t.c2,
                                                       t.c1, t.rr))

        def put(tab, rows, val):
            idx = self._idx(np.atleast_1d(np.asarray(rows, np.int64)))
            return tab.index_copy(0, idx, val.reshape(
                (idx.shape[0],) + tab.shape[1:]))

        if len(t.sph_rows):
            sr = self._t("sph_r", t.sph_r)
            m0 = put(m0, t.sph_rows, -self._t("sph_c", t.sph_c))
            rr = put(rr, t.sph_rows, -sr * sr)
        if len(t.pla_rows):
            c1 = put(c1, t.pla_rows, self._t("pla_n", t.pla_n))
            rr = put(rr, t.pla_rows, self._t("pla_k", t.pla_k))
        if len(t.qua_rows):
            M = put(M, t.qua_rows, self._t("qua_m", t.qua_m))
            m0 = put(m0, t.qua_rows, self._t("qua_m0", t.qua_m0))
            c2 = put(c2, t.qua_rows, self._t("qua_coef", t.qua_coef))
            rr = put(rr, t.qua_rows, self._t("qua_r", t.qua_r))
        for row, key, fam in t.comp_keys:
            if fam == sir.PLANE:
                c1 = put(c1, row, self._t(key + "n", t.c1[row]))
                rr = put(rr, row, self._t(key + "k", t.rr[row]))
            elif fam == sir.SPHERE:
                r = self._t(key + "r", np.sqrt(-t.rr[row]))
                m0 = put(m0, row, -self._t(key + "c", -t.m0[row]))
                rr = put(rr, row, -r * r)
            elif fam == sir.QUADRIC:
                M = put(M, row, self._t(key + "m", t.M[row]))
                m0 = put(m0, row, self._t(key + "m0", t.m0[row]))
                c2 = put(c2, row, self._t(key + "coef", t.c2[row]))
                rr = put(rr, row, self._t(key + "r", t.rr[row]))
        return M, m0, c2, c1, rr

    def _tables(self):
        """The leaf tables the queries read: the device tables, or under
        `ovr` the assembled ones, built once per `ovr` (the same dict
        holding the same tensors; the differentiable renderer drops them
        when its call ends)."""
        if not self.ovr:
            return self.tabs
        if self._ovr_tabs is None or not same_ovr(self._ovr_tabs[0],
                                                  self.ovr):
            self._ovr_tabs = (dict(self.ovr), self._assemble())
        return self._ovr_tabs[1]

    # -- unified root math ---------------------------------------------------

    def _quads(self, rows, p, d):
        """A t^2 + B t + C coefficients of all `rows` leaves along p+td
        ([R, c] each); C equals side(p), the origin inside-ness."""
        M, m0, c2, c1, rr = self._tables()
        idx = self._idx(rows)
        Mr = M[idx]                                     # [c,3,3]
        pl = (p[:, None, None, 0] * Mr[None, :, :, 0]
              + p[:, None, None, 1] * Mr[None, :, :, 1]
              + p[:, None, None, 2] * Mr[None, :, :, 2]) + m0[idx][None]
        dl = (d[:, None, None, 0] * Mr[None, :, :, 0]
              + d[:, None, None, 1] * Mr[None, :, :, 1]
              + d[:, None, None, 2] * Mr[None, :, :, 2])
        c2r = c2[idx][None]
        c1r = c1[idx][None]
        A = torch.sum(c2r * dl * dl, -1)
        Bq = 2.0 * torch.sum(c2r * dl * pl, -1) + torch.sum(c1r * dl, -1)
        Cq = torch.sum(c2r * pl * pl, -1) + torch.sum(c1r * pl, -1) \
            + rr[idx][None]
        return A, Bq, Cq

    @staticmethod
    def _roots(A, Bq, Cq):
        """Both real roots (t0 <= t1, INF where none) in a
        cancellation-stable form, the normalized (s, q) of the sphere
        entry/exit policy, and the linear root for A == 0."""
        is_quad = A != 0
        safe_A = torch.where(is_quad, A, 1.0)
        s = (Bq * 0.5) / safe_A
        q = Cq / safe_A
        disc = _disc(s, q)
        ok = is_quad & (disc >= 0)
        root = safe_sqrt(torch.where(ok, disc, 0.0))
        ta = -s - root
        tb = -s + root
        tb_nz = torch.abs(tb) > 0
        ta_nz = torch.abs(ta) > 0
        t0 = torch.where(s < 0, torch.where(
            tb_nz, q / torch.where(tb_nz, tb, 1.0), ta), ta)
        t1 = torch.where(s > 0, torch.where(
            ta_nz, q / torch.where(ta_nz, ta, 1.0), tb), tb)
        lin_nz = Bq != 0
        t_lin = torch.where(lin_nz, -Cq / torch.where(lin_nz, Bq, 1.0), INF)
        t0u = torch.where(is_quad, torch.where(ok, t0, INF), t_lin)
        t1u = torch.where(is_quad, torch.where(ok, t1, INF),
                          torch.full_like(t1, INF))
        return t0u, t1u, s, q, ok

    def _policy(self, kind_rows, t0u, t1u, s, q, ok):
        """First-hit offset per leaf column under its family's root policy
        (eps-backed).  kind_rows is static numpy [c]."""
        is_pl = self._const(kind_rows == sir.PLANE, torch.bool)[None]
        is_sp = self._const(kind_rows == sir.SPHERE, torch.bool)[None]
        eps = self.eps
        # plane: forward crossing (reference src/gmath.h:38-49)
        a_pl = torch.where(t0u > 0, t0u - eps, INF)
        # sphere: entry when outside+approaching, exit when inside
        # (reference src/gmath.h:64-85)
        entering = (s < 0) & (q > 0)
        exiting = (s < 0) | (q < 0)
        a_sp = torch.where(entering, t0u, torch.where(exiting, t1u, INF))
        a_sp = torch.where(ok, a_sp - eps, INF)
        # quadric: smaller non-negative root (reference
        # src/objects.c:791-801)
        a_qu = torch.where(t0u >= 0, t0u, torch.where(t1u >= 0, t1u, INF))
        a_qu = torch.where(torch.isfinite(a_qu), a_qu - eps, INF)
        return torch.where(is_pl, a_pl, torch.where(is_sp, a_sp, a_qu))

    def _env_gate_rows(self, rows, p, d):
        """Envelope culling mask per candidate column (envelope_s_ray_hits,
        reference src/objects.c:90-96): True = keep."""
        idx = self._idx(rows)
        ec = self.t_env_c[idx][None]                  # [1,c,3]
        er = self.t_env_r[idx][None]                  # [1,c]
        pp = p[:, None, :] - ec
        # f32: the dots and s s - q each rounded once, er er apart (a
        # constant to XLA), as the JAX package's compiled gate rounds them
        s = _dot_fma32(pp, d[:, None, :])
        q = _dot_fma32(pp, pp) - er * er
        disc = _disc(s, q)
        exists = (disc >= 0) & ((s < 0) | (q < 0))
        return (er <= 0) | exists

    def _env_gate_one(self, env_c, env_r, p, d):
        ec = self._const(env_c)
        pp = p - ec
        s = _dot_fma32(pp, d)
        q = _dot_fma32(pp, pp) - float(self.dtype.type(env_r) ** 2)
        disc = _disc(s, q)
        return (disc >= 0) & ((s < 0) | (q < 0))

    # -- SDF leaves ----------------------------------------------------------

    def _sdf_local(self, m, m0, p, d):
        """Ray into an SDF leaf's local unit frame: (pl, dl_unit, dn) with
        dn the direction's local norm (the offset rescale factor).  m, m0
        broadcast against p, d ([3,3] for one leaf, [G,3,3] against
        [R,1,3] rays for a cluster's members)."""
        pl = _affine(m, m0, p)
        dl0 = _affine(m, None, d)
        dn = torch.sqrt(torch.sum(dl0 * dl0, -1))
        dl = dl0 / torch.where(dn > 0, dn, 1.0)[..., None]
        return pl, dl, dn

    def _sdf_march(self, kind, cycles, prm, pl, dl, offs0, dead):
        """Bounded bidirectional sphere march from local offset offs0
        (reference src/objects.c:903-959): at most `cycles` steps, ending
        early once no lane is active, as the JAX tracer's while loop.
        Returns (offs_local, dist)."""
        eps = self.eps
        p0 = pl + dl * offs0[..., None]
        dist = _sdf_eval(kind, prm, p0)
        forward = dist > 0
        offs1 = torch.zeros_like(dist)
        active = ~dead

        def steps(n, offs1, dist, active):
            for _ in range(n):
                step = torch.where(forward, dist + eps, -(dist - eps))
                offs1 = torch.where(active, offs1 + step, offs1)
                dnew = _sdf_eval(kind, prm, p0 + dl * offs1[..., None])
                dist = torch.where(active, dnew, dist)
                crossed = torch.where(forward, (dist < 0) | (dist > 1e30),
                                      (dist > 0) | (dist < -1e30))
                active = active & ~crossed
            return offs1, dist, active

        # an inactive lane's step moves nothing, so any number of steps
        # past the last active lane gives the same result.  On the card
        # each `any` is a read or a node: test it every 8 steps
        every = 1 if self.device.type == "cpu" else 8
        if self.diff:
            # the JAX tracer's fixed scan under diff; eagerly it stops at
            # the first test that finds no active lane
            test = host_reads_ok(self.device)
            for i in range(0, int(cycles), every):
                if test and not bool(active.any()):
                    break
                offs1, dist, active = steps(min(every, int(cycles) - i),
                                            offs1, dist, active)
            return offs0 + offs1, dist

        # blocks of `every` steps while a lane is active (a WHILE node
        # under a capture), then the remainder; the state moves in place
        n_blocks, rest = divmod(int(cycles), every)
        blocks = torch.zeros((), dtype=torch.int64, device=self.device)

        def block(n):
            got = steps(n, offs1, dist, active)
            for buf, v in zip((offs1, dist, active), got):
                buf.copy_(v)

        def full():
            block(every)
            blocks.add_(1)

        cond.while_loop(lambda: (blocks < n_blocks) & active.any(), full,
                        bound=n_blocks)
        if rest:
            with cond.if_node(active.any()) as run:
                if run:
                    block(rest)
        return offs0 + offs1, dist

    def _sdf_normal(self, kind, prm, m, neg, q_local):
        """Forward-difference gradient normal in world space (reference
        src/objects.c:940-952), with the Neg flip baked in; m [..., 3, 3]
        broadcasts against q_local [..., 3] (per-ray frames too)."""
        eps = self.eps
        d0 = _sdf_eval(kind, prm, q_local)
        ex = torch.eye(3, dtype=self.tdtype, device=self.device)
        grad = torch.stack([
            (_sdf_eval(kind, prm, q_local + ex[i] * eps) - d0) / eps
            for i in range(3)], dim=-1)
        nor = _norm3(torch.matmul(grad[..., None, :], m)[..., 0, :])
        return -nor if neg else nor

    def _hit_sdf_leaf(self, lf, env_c, env_r, p, d, si=None):
        """First hit of a standalone SDF object: envelope-clipped entry,
        one bounded march, gradient normal.  Returns (a [R] eps-backed,
        nor [R,3]).

        Under `diff` the march is a root-finder on detached rays.  For
        standalone object `si` the converged offset t* is reattached by
        the Newton step t* - f / fp.detach() of its implicit function
        f(t) = sdf(m (p + t d) + m0; prm), with f read through the
        overrides sdfs{si}_m, _m0 and _prm: the primal moves by at most
        the march's acceptance shell, and the tangent is the
        implicit-function derivative -(df/dθ) / (df/dt) (the JAX
        tracer's _hit_sdf_leaf).  Grazing rays, whose slope fp is below
        0.01 of the local direction norm, are not reattached."""
        p_t, d_t = p, d
        if self.diff:
            p, d = p.detach(), d.detach()
        R = p.shape[0]
        if env_c is not None and env_r > 0:
            ec = self._const(env_c)
            outside = _dot(p - ec, p - ec) > env_r * env_r
            t_env = _sphere_first_hit(ec, float(self.dtype.type(env_r)),
                                      p, d, 0.0)
            dead = outside & ~torch.isfinite(t_env)
            offs0w = torch.where(outside & torch.isfinite(t_env), t_env, 0.0)
        else:
            dead = torch.zeros((R,), dtype=torch.bool, device=self.device)
            offs0w = torch.zeros((R,), dtype=self.tdtype, device=self.device)
        m = self._const(lf.m)
        pl, dl, dn = self._sdf_local(m, self._const(lf.m0),
                                     p + d * offs0w[:, None], d)
        offs_l, dist = self._sdf_march(lf.sdf_kind, lf.cycles, lf.sdf_param,
                                       pl, dl, torch.zeros_like(dn), dead)
        hit = ~dead & (torch.abs(dist) <= MARCH_ACCEPT * self.eps)
        t_star = offs0w + offs_l / torch.where(dn > 0, dn, 1.0)
        if self.diff and si is not None:
            m_t = self._t(f"sdfs{si}_m", lf.m)
            m0_t = self._t(f"sdfs{si}_m0", lf.m0)
            prm_t = self._t(f"sdfs{si}_prm", lf.sdf_param)
            # missed lanes evaluate at the origin: their offset may be
            # huge, and an overflow there would turn the masked-out
            # gradient into NaN
            t_w = torch.where(hit, t_star, 0.0)
            ql_t = _affine(m_t, m0_t, p_t + d_t * t_w[:, None])
            f = _sdf_eval(lf.sdf_kind, prm_t, ql_t)
            # detached slope df/dt: the forward-difference local gradient
            # dotted with the local direction per world unit
            ql_d, prm_d = ql_t.detach(), prm_t.detach()
            d0 = _sdf_eval(lf.sdf_kind, prm_d, ql_d)
            ex = torch.eye(3, dtype=self.tdtype, device=self.device)
            grad_l = torch.stack([
                (_sdf_eval(lf.sdf_kind, prm_d, ql_d + ex[i] * self.eps)
                 - d0) / self.eps for i in range(3)], dim=-1)
            fp = _dot(grad_l, _affine(m_t.detach(), None, d))
            fp_ok = torch.abs(fp) > 0.01 * dn
            fp_safe = torch.where(fp_ok, fp, 1.0)
            t_star = t_star - torch.where(fp_ok, f / fp_safe, 0.0)
            nor = self._sdf_normal(lf.sdf_kind, prm_t, m_t, lf.neg, ql_t)
        else:
            nor = self._sdf_normal(lf.sdf_kind, lf.sdf_param, m, lf.neg,
                                   pl + dl * offs_l[:, None])
        return torch.where(hit, t_star - self.eps, INF), nor

    def _sdf_crossings(self, kind, cycles, prm, m, m0, p, d, alive=None):
        """Up to SDF_CROSSINGS forward surface crossings of an SDF leaf
        along p+td (world offsets, INF-padded, last axis) — the crossing
        supply for SDF leaves inside CSG composites (reference
        pair-marching, src/objects.c:1052-1094).  Each crossing is found
        by a bounded march from the ray origin; the next march restarts
        just past the surface shell.  Lanes where `alive` is False never
        march.  Under `diff` the rays are detached: the crossings feed a
        discrete parity walk, and composite SDF leaves carry no gradient,
        as in the JAX tracer."""
        if self.diff:
            p, d = p.detach(), d.detach()
        pl, dl, dn = self._sdf_local(m, m0, p, d)
        dn_safe = torch.where(dn > 0, dn, 1.0)
        offs = torch.zeros_like(dn)
        dead = torch.zeros_like(dn, dtype=torch.bool) if alive is None \
            else ~alive
        out = []
        for _ in range(SDF_CROSSINGS):
            offs_l, dist = self._sdf_march(kind, cycles, prm, pl, dl, offs,
                                           dead)
            hit = ~dead & (torch.abs(dist) <= MARCH_ACCEPT * self.eps)
            out.append(torch.where(hit & (offs_l > 0), offs_l / dn_safe,
                                   INF))
            dead = dead | ~hit
            offs = offs_l + 4.0 * self.eps   # step through the eps shell
        return torch.stack(out, dim=-1)

    def _env_interval(self, env_c, env_r, p, d):
        """(gate, t_in, t_out) of envelope spheres along p+td; t_in
        clamped to 0 when starting inside.  In f32 the gate's dots and
        discriminant round as the JAX package's compiled code rounds them
        (each multiply-add once; env_r env_r apart).  That code splits
        the t's where-mask into fusions of their own, which round s s - q
        twice; on the CPU the JAX tracer reads only the gate, as the
        port's caller does."""
        pp = p - env_c
        s = _dot_fma32(pp, d)
        q = _dot_fma32(pp, pp) - env_r * env_r
        disc = _disc(s, q)
        gate = (disc >= 0) & ((s < 0) | (q < 0))
        root = safe_sqrt(torch.clamp(disc, min=0.0))
        return gate, torch.clamp(-s - root, min=0.0), -s + root

    # -- composite objects ---------------------------------------------------

    def _member_stacks(self, members):
        """Per-member parameters of a same-shape composite list, stacked
        on a leading member axis (cached; _upload clears them): analytic
        rows [G, n_an], rows map [G, Lc], per SDF slot (m [G,3,3],
        m0 [G,3], prm [G]), envelopes (c [G,3], r [G]) when present."""
        key = ("stacks",) + tuple(id(c) for c in members)
        got = self._kernel_cache.get(key)
        if got is not None:
            return got
        proto = members[0]
        an = [li for li, r in enumerate(proto.rows) if r >= 0]
        sdf = {}
        for li, lf in enumerate(proto.sdf_leaves):
            if lf is not None:
                sdf[li] = (
                    self._as(np.stack([c.sdf_leaves[li].m for c in members])),
                    self._as(np.stack([c.sdf_leaves[li].m0
                                       for c in members])),
                    self._as([c.sdf_leaves[li].sdf_param for c in members]))
        env = None
        if proto.env_c is not None and proto.env_r > 0:
            env = (self._as(np.stack([c.env_c for c in members])),
                   self._as([c.env_r for c in members]))
        got = dict(
            an=an, arows=np.asarray([[c.rows[li] for li in an]
                                     for c in members], np.int64),
            rows=self._idx(np.asarray([c.rows for c in members])),
            sdf=sdf, env=env)
        self._kernel_cache[key] = got
        return got

    def _crossings(self, members, p, d, alive=None):
        """Forward crossings [R, G, NC] of same-shape composites (two
        columns per analytic leaf, t0 then t1, then SDF_CROSSINGS per SDF
        leaf), the local leaf of each column, and the origin inside bits
        [R, G, Lc] — each member gets the op sequence of the JAX tracer's
        _solo_body_core.  `alive` [R, G] keeps dead lanes from marching."""
        R, G = p.shape[0], len(members)
        proto = members[0]
        x = self._member_stacks(members)
        cols, leaf_of_col = [], []
        inside = [None] * len(proto.rows)
        if x["an"]:
            A, Bq, Cq = self._quads(x["arows"].reshape(-1), p, d)
            t0u, t1u, _, _, _ = self._roots(A, Bq, Cq)
            shp = (R, G, len(x["an"]))
            t0u, t1u, Cq = t0u.reshape(shp), t1u.reshape(shp), Cq.reshape(shp)
            for ai, li in enumerate(x["an"]):
                cols += [t0u[..., ai], t1u[..., ai]]
                leaf_of_col += [li, li]
                inside[li] = Cq[..., ai] <= 0        # side(p) = C
        pg, dg = p[:, None, :], d[:, None, :]
        for li, (m, m0, prm) in x["sdf"].items():
            lf = proto.sdf_leaves[li]
            ts = self._sdf_crossings(lf.sdf_kind, lf.cycles, prm, m, m0,
                                     pg, dg, alive)
            cols += list(ts.unbind(-1))
            leaf_of_col += [li] * SDF_CROSSINGS
            inside[li] = _sdf_eval(lf.sdf_kind, prm, _affine(m, m0, pg)) <= 0
        cross = torch.stack(cols, dim=-1)
        cross = torch.where(cross > 0, cross, INF)
        return cross, np.asarray(leaf_of_col), torch.stack(inside, dim=-1)

    def _composite_crossings(self, comp: _Composite, p, d):
        """Forward crossings [R, NC], the local leaf of each column, and
        the origin inside bits [R, Lc] of one composite."""
        cross, leaf_of_col, inside = self._crossings([comp], p, d)
        return cross[:, 0], leaf_of_col, inside[:, 0]

    def _walk(self, comp: _Composite, cross, leaf_of_col, inside):
        """Crossing-parity walk of ONE composite: the G=1 case of
        _group_walk.  Returns (t_boundary [R] raw, local leaf id [R])."""
        hit_t, leaf_loc = self._group_walk(
            comp.tree, cross[:, None, :], leaf_of_col, inside[:, None, :])
        return hit_t[:, 0], leaf_loc[:, 0]

    def _hit_composite(self, comp: _Composite, p, d):
        """Boundary hit of one composite: (t [R] eps-backed, local leaf
        [R], global row [R])."""
        cross, leaf_of_col, inside = self._composite_crossings(comp, p, d)
        hit_t, leaf_loc = self._walk(comp, cross, leaf_of_col, inside)
        if comp.env_c is not None and comp.env_r > 0:
            gate = self._env_gate_one(comp.env_c, comp.env_r, p, d)
            hit_t = torch.where(gate, hit_t, INF)
        row = self._idx(comp.rows)[leaf_loc]
        a = torch.where(torch.isfinite(hit_t), hit_t - self.eps, INF)
        return a, leaf_loc, row

    def _shadow_composite(self, comp: _Composite, p, d, limit):
        """Any boundary flip within (0, limit]: the shadow-side form of
        _hit_composite."""
        cross, leaf_of_col, inside = self._composite_crossings(comp, p, d)
        hit_t, _ = self._walk(comp, cross, leaf_of_col, inside)
        blocked = torch.isfinite(hit_t) & (hit_t - self.eps <= limit)
        if comp.env_c is not None and comp.env_r > 0:
            blocked = blocked & self._env_gate_one(comp.env_c, comp.env_r,
                                                   p, d)
        return blocked

    def _group_walk(self, tree, cross, leaf_of_col, inside0):
        """Crossing-parity walk batched over a composite group axis.
        cross [R, G, NC] forward crossings (INF-padded), leaf_of_col
        static [NC], inside0 [R, G, Lc] origin inside-ness.

        A leaf's inside-ness at candidate t_j is its origin bit XOR the
        parity of its crossings at or before t_j ("<=") and strictly
        before t_j ("<"); the tree program evaluated on both sides tells
        whether t_j flips the composite.  Ties of equal t flip jointly.
        The per-leaf crossing counts are one [.., NC] x [NC, Lc] product
        of 0/1 values, exact in either float type.  Returns (hit_t [R, G]
        raw, leaf_loc [R, G])."""
        R, G, NC = cross.shape
        Lc = inside0.shape[-1]
        dt = self.tdtype
        lcol = self._const(leaf_of_col, torch.int64)
        oh = self._const(np.eye(Lc)[np.asarray(leaf_of_col)])
        valid = torch.isfinite(cross)
        # chunk rays so the [Rt, G, NC, NC] order tensors stay bounded
        Rt = int(max(128, min(R, (1 << 24) // max(G * NC * NC, 1))))
        flips = []
        for s in range(0, R, Rt):
            tc = cross[s:s + Rt]
            vl = valid[s:s + Rt]
            ba = (tc[..., None, :] <= tc[..., :, None]) & vl[..., None, :]
            bb = (tc[..., None, :] < tc[..., :, None]) & vl[..., None, :]
            b2 = torch.stack([ba, bb], dim=1).to(dt)   # [Rt,2,G,j,c]
            cnt = torch.matmul(b2, oh)                 # [Rt,2,G,j,Lc]
            p2 = (torch.round(cnt).to(torch.int64) & 1) != 0
            ins = inside0[s:s + Rt][:, None, :, None, :]
            w2 = ins ^ p2
            v2 = _tree_eval_mask(tree, lambda li: w2[..., li])
            flips.append((v2[:, 0] != v2[:, 1]) & vl)
        flip = torch.cat(flips, dim=0)                 # [R, G, NC]
        tcand = torch.where(flip, cross, INF)
        hit_t, j = _min_idx(tcand, -1)
        return hit_t, lcol[j]

    def _group_hit(self, members, p, d):
        """Boundary hits of one same-tree composite group: (a [R, G]
        eps-backed and env-gated, row [R, G] global unified rows)."""
        R = p.shape[0]
        G = len(members)
        Lc = len(members[0].rows)
        arows = np.asarray([c.rows for c in members], np.int64)  # [G, L]
        A, Bq, Cq = self._quads(arows.reshape(-1), p, d)
        t0u, t1u, _, _, _ = self._roots(A, Bq, Cq)
        cross = torch.cat([t0u.reshape(R, G, Lc), t1u.reshape(R, G, Lc)],
                          dim=-1)                       # [R, G, 2L]
        cross = torch.where(cross > 0, cross, INF)
        leaf_of_col = np.concatenate([np.arange(Lc), np.arange(Lc)])
        hit_t, leaf_loc = self._group_walk(
            members[0].tree, cross, leaf_of_col,
            (Cq <= 0).reshape(R, G, Lc))
        # envelope gates [R, G] (envelope_s_ray_hits, reference
        # src/objects.c:90-96)
        env_c = np.stack([c.env_c if c.env_c is not None else np.zeros(3)
                          for c in members])
        env_r = np.asarray([c.env_r if c.env_c is not None else -1.0
                            for c in members])
        ec = self._const(env_c)[None]                  # [1, G, 3]
        er = self._const(env_r)[None]
        pp = p[:, None, :] - ec
        s = _dot_fma32(pp, d[:, None, :])
        q = _dot_fma32(pp, pp) - er * er
        disc = _disc(s, q)
        gate = (er <= 0) | ((disc >= 0) & ((s < 0) | (q < 0)))
        hit_t = torch.where(gate, hit_t, INF)
        a = torch.where(torch.isfinite(hit_t), hit_t - self.eps, INF)
        rows_b = self._idx(arows)[None].expand(R, G, Lc)
        row = torch.gather(rows_b, 2, leaf_loc[..., None])[..., 0]
        return a, row

    # -- shape clusters of solo composites (the SDF composites' parts) ------

    def _solo_clusters(self):
        """comp_solo partitioned into shape-identical clusters."""
        return self._solo_cl

    def _cluster_walk(self, cluster, p, d):
        """Boundary of every member of a shape cluster, evaluated as one
        batch dimension: (hit_t [R, G] raw, env-gated; leaf_loc [R, G])."""
        x = self._member_stacks(cluster)
        gate = None
        if x["env"] is not None:
            ec, er = x["env"]
            gate, _, _ = self._env_interval(ec[None], er[None],
                                            p[:, None, :], d[:, None, :])
        cross, leaf_of_col, inside = self._crossings(cluster, p, d, gate)
        hit_t, leaf_loc = self._group_walk(cluster[0].tree, cross,
                                           leaf_of_col, inside)
        if gate is not None:
            hit_t = torch.where(gate, hit_t, INF)
        return hit_t, leaf_loc

    def _cluster_hit(self, cluster, p, d):
        """Boundary hits of a shape cluster: (a [R, G] eps-backed, row
        [R, G] global unified rows (-1 for SDF leaves), nor [R, G, 3] the
        SDF winners' normals, zero elsewhere)."""
        R = p.shape[0]
        x = self._member_stacks(cluster)
        hit_t, leaf_loc = self._cluster_walk(cluster, p, d)
        rows_b = x["rows"][None].expand(R, *x["rows"].shape)
        row = torch.gather(rows_b, 2, leaf_loc[..., None])[..., 0]
        a = torch.where(torch.isfinite(hit_t), hit_t - self.eps, INF)
        t_safe = torch.where(torch.isfinite(a), a, 0.0)
        hx = p[:, None, :] + d[:, None, :] * t_safe[..., None]
        nor = torch.zeros(hx.shape, dtype=self.tdtype, device=self.device)
        for li, (m, m0, prm) in x["sdf"].items():
            lf = cluster[0].sdf_leaves[li]
            nl = self._sdf_normal(lf.sdf_kind, prm, m, lf.neg,
                                  _affine(m, m0, hx))
            nor = torch.where((leaf_loc == li)[..., None], nl, nor)
        return a, row, nor

    def _cluster_shadow(self, cluster, p, d, limit):
        """Any member's boundary within (0, limit]: blocked [R]."""
        hit_t, _ = self._cluster_walk(cluster, p, d)
        b = torch.isfinite(hit_t) & (hit_t - self.eps <= limit[:, None])
        return torch.any(b, dim=1)

    # -- core query ------------------------------------------------------

    def _single_chunks(self, matter_only, R=None, exclude_big=False):
        """Static chunk partition of candidate rows (single-leaf objects);
        with R the chunk shrinks so [R, c, 3] temporaries stay bounded.
        exclude_big drops the rows the big-scene kernels cover."""
        rows = self.single_rows
        if matter_only and len(rows):
            rows = rows[~self.tab.is_light[rows]]
        if exclude_big and len(self.big_rows):
            rows = np.setdiff1d(rows, self.big_rows)
        c = CHUNK
        if R:
            c = int(min(CHUNK, max(64, (1 << 23) // max(R, 1))))
        return [rows[i:i + c] for i in range(0, len(rows), c)]

    def _chunk_candidates(self, rows, p, d):
        """Policy-root candidates [R, c] for one chunk of single rows."""
        A, Bq, Cq = self._quads(rows, p, d)
        t0u, t1u, s, q, ok = self._roots(A, Bq, Cq)
        a = self._policy(self.tab.kind[rows], t0u, t1u, s, q, ok)
        return torch.where(self._env_gate_rows(rows, p, d), a, INF)

    def _query(self, p, d, matter_only, want2, rng_rough, lane_matter=None):
        """Top-1/2 hit over the whole scene, single pass.  Returns
        (t [R,kw], nor [R,kw,3], oid [R,kw], sign [R,kw]).

        lane_matter: optional [R] bool — lanes marked True ignore light
        candidates (the mixed normal/path wavefront; reference path rays
        trace the matter compound only, src/scene.c:607)."""
        dt, dev = self.tdtype, self.device
        p = p.to(dt)
        d = d.to(dt)
        R = p.shape[0]
        kw = 2 if want2 else 1

        cols_t, cols_row = [], []
        oid_special = []  # (col, oid: int or [R]) for SDF-surface winners
        nor_ovr = []      # (col, [R,3]) explicit normals (SDF surfaces)
        use_big = self._bigscene_ok()
        stf = None
        if self._scene_route_ok() and self._prefer_scene_query():
            stf, _ = self._scene_tables()
            if not stf.shapes:
                stf = None
        if use_big:
            # the big-scene sphere kernel (K6): the top-2 over the sphere
            # blocks, as unified rows
            from actinon_tpu_torch.render import bigscene
            t2k, gik = bigscene.big_top2(self, p.contiguous(),
                                         d.contiguous())
            row2k = self._bigscene().rows_padded[gik.long()]
        if stf is not None:
            # 0. the packed scene kernel (K4): ONE launch carries the
            # singles, standalone SDFs, solo clusters and analytic groups
            # as a global top-2; only the leftovers below stay plain.  The
            # K6 columns come first: column order decides exact ties
            from actinon_tpu_torch.render import scene_kernels
            if use_big:
                cols_t += [t2k[:, j] for j in range(kw)]
                cols_row += [row2k[:, j] for j in range(kw)]
            if matter_only:
                lmf = torch.ones((R,), dtype=dt, device=dev)
            elif lane_matter is not None:
                lmf = lane_matter.to(dt)
            else:
                lmf = torch.zeros((R,), dtype=dt, device=dev)
            t12k, c12k = scene_kernels.scene_top2(self, p.contiguous(),
                                                  d.contiguous(), lmf)
            rowk, oidk, nork = self._decode_scene(stf, t12k, c12k, p, d)
            for j in (0, 1):
                k = len(cols_t)
                cols_t.append(t12k[:, j])
                cols_row.append(rowk[:, j])
                oid_special.append((k, oidk[:, j]))
                nor_ovr.append((k, nork[:, j]))
        else:
            # 1. single-leaf objects: the big-scene kernel's seed, then a
            # chunked running top-k merge over the remaining rows
            best_t = torch.full((R, kw), INF, dtype=dt, device=dev)
            best_row = torch.zeros((R, kw), dtype=torch.int64, device=dev)
            if use_big:
                best_t = t2k[:, :kw].to(dt)
                best_row = row2k[:, :kw]
            for rows in self._single_chunks(matter_only, R,
                                            exclude_big=use_big):
                a = self._chunk_candidates(rows, p, d)
                if lane_matter is not None \
                        and self.tab.is_light[rows].any():
                    lmask = self._const(self.tab.is_light[rows],
                                        torch.bool)
                    a = torch.where(lane_matter[:, None] & lmask[None, :],
                                    INF, a)
                if want2:
                    tkc, ikc = _top2_cols(a)
                else:
                    tkc, ikc = _min_idx(a, 1, keepdim=True)
                rkc = self._idx(rows)[ikc]
                cand_t = torch.cat([best_t, tkc], dim=1)
                cand_r = torch.cat([best_row, rkc], dim=1)
                if want2:
                    best_t, sel = _top2_cols(cand_t)
                else:
                    best_t, sel = _min_idx(cand_t, 1, keepdim=True)
                best_row = torch.gather(cand_r, 1, sel)
            # 2. final candidate columns: the kw single winners, then one
            # column per composite and per standalone SDF object
            cols_t += [best_t[:, i] for i in range(kw)]
            cols_row += [best_row[:, i] for i in range(kw)]

        for members in (stf.rest_groups if stf else self.comp_groups):
            mf = [c for c in members if not (matter_only and c.is_light)]
            if not mf:
                continue
            a_g, row_g = self._group_hit(mf, p, d)
            for gi, comp in enumerate(mf):
                a = a_g[:, gi]
                if lane_matter is not None and comp.is_light:
                    a = torch.where(lane_matter, INF, a)
                cols_t.append(a)
                cols_row.append(row_g[:, gi])

        # solo composites: each cluster evaluates as one batch, and the
        # columns are keyed back to the members so that they stay in
        # comp_solo order (argmin ties between coincident surfaces depend
        # on the column order)
        solo = {}
        for cluster in self._solo_clusters():
            if stf and id(cluster[0]) in stf.covered_solo_ids:
                continue
            if matter_only and cluster[0].is_light:
                continue
            a_g, row_g, nor_g = self._cluster_hit(cluster, p, d)
            for gi, comp in enumerate(cluster):
                solo[id(comp)] = (a_g[:, gi], row_g[:, gi], nor_g[:, gi])
        for comp in self.comp_solo:
            got = solo.get(id(comp))
            if got is None:
                continue
            a, row, nor = got
            if lane_matter is not None and comp.is_light:
                a = torch.where(lane_matter, INF, a)
            k = len(cols_t)
            cols_t.append(a)
            cols_row.append(row)
            oid_special.append((k, comp.oid))
            nor_ovr.append((k, nor))

        for si, (lf, oid, env_c, env_r, light) in enumerate(self.sdf_singles):
            if stf and si in stf.covered_sdf_idx:
                continue
            if matter_only and light:
                continue
            a, nor = self._hit_sdf_leaf(lf, env_c, env_r, p, d, si=si)
            if lane_matter is not None and light:
                a = torch.where(lane_matter, INF, a)
            k = len(cols_t)
            cols_t.append(a)
            cols_row.append(torch.full((R,), -1, dtype=torch.int64,
                                       device=dev))
            oid_special.append((k, oid))
            nor_ovr.append((k, nor))

        T = torch.stack(cols_t, dim=1)                 # [R, K]
        ROWS = torch.stack(cols_row, dim=1)
        if want2:
            t12, sel = _top2_cols(T)
        else:
            t12, sel = _min_idx(T, 1, keepdim=True)
        row12 = torch.gather(ROWS, 1, sel)             # [R, kw]

        # 3. winner normals + oid from the unified table: the analytic
        # gradient (2 c2 y + c1) M
        M, m0, c2, c1, rr = self._tables()
        t_safe = torch.where(torch.isfinite(t12), t12, 0.0)
        x = p[:, None, :] + d[:, None, :] * t_safe[..., None]  # [R,kw,3]
        if len(self.tab):
            row_s = torch.clamp(row12, min=0)
            Mw, m0w, c2w, c1w = _rows(row_s, M, m0, c2, c1)
            y = torch.sum(Mw * x[..., None, :], -1) + m0w
            g = 2.0 * c2w * y + c1w
            grad = torch.sum(g[..., :, None] * Mw, -2)
            nor = _norm3(grad)
            nor = torch.where(self.t_neg[row_s][..., None], -nor, nor)
            oid12 = self.t_oid[row_s]
        else:
            nor = torch.zeros((R, kw, 3), dtype=dt, device=dev)
            oid12 = torch.zeros((R, kw), dtype=torch.int64, device=dev)
        sdf_win = row12 == -1
        for k, oc in oid_special:
            # oc: a python int, or [R] (the scene kernel's winners)
            ocb = oc if isinstance(oc, int) else oc[:, None].to(oid12.dtype)
            oid12 = torch.where((sel == k) & sdf_win, ocb, oid12)
        for k, n_ovr in nor_ovr:
            use = ((sel == k) & sdf_win)[..., None]
            nor = torch.where(use, n_ovr[:, None, :], nor)

        sign = torch.where(_dot(nor, d[:, None, :]) > 0, 1.0, -1.0).to(dt)
        fin = torch.isfinite(t12)
        nor = torch.where(fin[..., None], nor, 0.0)
        oid12 = torch.where(fin, oid12, -1)
        sign = torch.where(fin, sign, 0.0)

        if rng_rough and np.any(self.roughness > 0):
            n1 = self._perturb(nor[:, 0, :], p, d, t12[:, 0], oid12[:, 0])
            nor = torch.cat([n1[:, None, :], nor[:, 1:, :]], dim=1)
        return t12, nor, oid12, sign

    # -- public queries ----------------------------------------------------

    def nearest2(self, p, d, matter_only=False, rng_rough=True):
        """Nearest AND second-nearest hit over the whole scene, one pass.
        Returns (t1, nor1, oid1, sign1, t2, nor2, oid2, sign2); oid=-1 and
        nor=0 where miss."""
        t12, nor, oid, sign = self._query(p, d, matter_only, True, rng_rough)
        return (t12[:, 0], nor[:, 0, :], oid[:, 0], sign[:, 0],
                t12[:, 1], nor[:, 1, :], oid[:, 1], sign[:, 1])

    def nearest(self, p, d, matter_only=False, rng_rough=True):
        """Nearest hit over the whole scene: (t[R], nor[R,3], oid[R],
        sign[R]); oid=-1 where miss."""
        t12, nor, oid, sign = self._query(p, d, matter_only, False,
                                          rng_rough)
        return t12[:, 0], nor[:, 0, :], oid[:, 0], sign[:, 0]

    def _perturb(self, nor, p, d, t, oid):
        """Surface-roughness normal perturbation (reference
        src/objects.c:261-284): per-component log-shaped bump seeded from
        the hit position."""
        from actinon_tpu_torch import rng as argn
        rough = self.t_rough[torch.clamp(oid, min=0)]
        t_safe = torch.where(torch.isfinite(t), t, 0.0)
        hp = p + d * t_safe[:, None]
        seed = argn.seed_from_v3(hp, 1246)
        f = torch.stack([argn.uniform_signed(seed, k, self.tdtype) * 0.99
                         for k in range(3)], dim=-1)
        bump = torch.log((1.0 - f) / (1.0 + f))
        new = _norm3(nor + rough[:, None] * bump)
        use = (rough > 0)[:, None] & torch.isfinite(t)[:, None]
        return torch.where(use, new, nor)

    # -- transition query (media boundaries) -------------------------------

    def _trans_from_pair(self, hits):
        """Transition data from a nearest2 result: a second object whose
        hit lies within eps of the minimum fills the other role (the
        glass/wine media-transition case, reference
        src/compound.c:284-297)."""
        t, nor, oid, sign, t2, nor2, oid2, sign2 = hits
        exiting = sign > 0
        exit_nor = torch.where(exiting[:, None], nor, -nor)
        enter = torch.where(~exiting & (oid >= 0), oid, -1)
        exit_ = torch.where(exiting & (oid >= 0), oid, -1)
        close = torch.isfinite(t) & torch.isfinite(t2) \
            & (torch.abs(t2 - t) < 2 * self.eps)
        exiting2 = sign2 > 0
        enter = torch.where(close & ~exiting2 & (enter < 0), oid2, enter)
        exit_ = torch.where(close & exiting2 & (exit_ < 0), oid2, exit_)
        return t, exit_nor, enter, exit_

    def trans_hit(self, p, d):
        """scene_s_trans_hit + compound_s_ray_trans_hit semantics
        (reference src/scene.c:362-382, src/compound.c:246-299).
        Returns (t, exit_nor [anti-ray], enter_oid, exit_oid)."""
        return self._trans_from_pair(self.nearest2(p, d, matter_only=False))

    def trans_hit_matter(self, p, d):
        """Transition hit over the matter compound only — the path-ray
        trace (reference src/scene.c:607)."""
        return self._trans_from_pair(self.nearest2(p, d, matter_only=True))

    def trans_hit_mixed(self, p, d, path_mask):
        """Per-lane transition hit: lanes with path_mask=True trace matter
        only, the rest trace light+matter, in ONE traversal."""
        t12, nor, oid, sign = self._query(p, d, False, True, True,
                                          lane_matter=path_mask)
        return self._trans_from_pair(
            (t12[:, 0], nor[:, 0, :], oid[:, 0], sign[:, 0],
             t12[:, 1], nor[:, 1, :], oid[:, 1], sign[:, 1]))

    # -- kernel routing ------------------------------------------------------

    def _kernel_device_ok(self):
        """The hand-written kernels run on this tracer: a CUDA device, f32,
        no overrides or AD (the kernels have no backward), and not
        switched off for an A/B comparison."""
        return (self.use_kernels and not self._traced()
                and self.device.type == "cuda"
                and self.dtype == np.float32)

    def _kernels_ok(self):
        """The shadow and NEE kernels apply (the JAX tracer's `_pallas_ok`
        with "TPU backend" read as "CUDA tensor, f32"): at most 192
        leaves, as the Pallas kernels demand."""
        return self._kernel_device_ok() and len(self.tab) <= \
            MAX_KERNEL_LEAVES

    def _scene_route_ok(self):
        """The packed scene kernels apply (the JAX tracer's `_scene_ok`):
        the kernel device rules, or a CPU f32 tracer that a test sends
        down the kernel route (`scene_kernels_on_cpu`)."""
        return self._kernel_device_ok() or (
            self.scene_kernels_on_cpu and self.use_kernels
            and not self._traced() and self.dtype == np.float32)

    def _prefer_scene_shadow(self):
        """Scenes with SDF composites or standalone matter SDFs shadow
        through the scene kernel (K5); pure analytic small scenes keep the
        shadow kernel (K2)."""
        return bool(self.comp_solo) \
            or any(not light for *_, light in self.sdf_singles)

    def _prefer_scene_query(self):
        """The scene kernel (K4) carries the nearest/transition query for
        march-bound scenes (SDF composites, standalone SDFs) and large
        member populations; small all-analytic scenes keep the plain
        query.  Where the big-scene kernels apply, their spheres leave
        K4's singles shape for K6 (`_scene_tables`)."""
        if self.comp_solo or self.sdf_singles:
            return True
        n_members = len(self.single_rows) \
            + sum(len(g) for g in self.comp_groups)
        return n_members > MAX_SCENE_MEMBERS

    def _scene_tables(self):
        """(full table, matter-only table) of the scene kernels, without
        the big-scene kernels' rows where those apply (JAX tracer.py:1692;
        cached; set_geom rebuilds them)."""
        got = self._kernel_cache.get("scene_tables")
        if got is None:
            from actinon_tpu_torch.render import scene_kernels
            ex = self.big_rows if self._bigscene_ok() else None
            got = (scene_kernels.SceneTable(self, False, exclude_rows=ex),
                   scene_kernels.SceneTable(self, True, exclude_rows=ex))
            self._kernel_cache["scene_tables"] = got
        return got

    BIG_MIN_ROWS = 512   # sphere rows below which K6/K7 do not apply

    def _bigscene_ok(self):
        """The big-scene sphere kernels K6/K7 apply (the JAX tracer's
        `_bigscene_ok`): at least BIG_MIN_ROWS sphere rows, f32, and the
        kernel device rules, or a CPU f32 tracer that a test sends down
        the big-scene route (`bigscene_on_cpu`)."""
        if len(self.big_rows) < self.BIG_MIN_ROWS \
                or self.dtype != np.float32:
            return False
        return self._kernel_device_ok() or (
            self.bigscene_on_cpu and self.use_kernels
            and not self._traced())

    def _bigscene(self) -> _BigScene:
        """The Morton sphere blocks of K6/K7 over `big_rows`, from the
        current leaf table (cached; set_geom rebuilds them)."""
        got = self._kernel_cache.get("bigscene")
        if got is None:
            from actinon_tpu_torch.render import bigscene
            _, m0, _, _, rr = self.tables_np
            rows = self.big_rows
            blocks = bigscene.SphereBlocks(
                rows, -m0[rows], np.sqrt(np.maximum(-rr[rows], 0.0)),
                float(self.eps))
            rows_padded = np.zeros(blocks.G * bigscene.LB, np.int64)
            rows_padded[:blocks.n] = blocks.rows
            got = _BigScene(blocks, *blocks.upload(self.device),
                            torch.as_tensor(rows_padded, device=self.device))
            self._kernel_cache["bigscene"] = got
        return got

    def _decode_scene(self, st, t12, c12, p, d):
        """Decode the scene kernel's packed (shape << 24 | member << 8 |
        leaf) winner codes [R, 2] into unified rows, object ids and SDF
        winner normals."""
        fin = torch.isfinite(t12)
        code = torch.where(fin, c12, -1).to(torch.int64)
        shp = code >> 24
        member = (code >> 8) & 0xFFFF
        leaf = code & 0xFF
        rows = torch.full(code.shape, -1, dtype=torch.int64,
                          device=self.device)
        oid = torch.full(code.shape, -1, dtype=torch.int64,
                         device=self.device)
        nor = torch.zeros(code.shape + (3,), dtype=self.tdtype,
                          device=self.device)
        t_safe = torch.where(fin, t12, 0.0)
        x = p[:, None, :] + d[:, None, :] * t_safe[..., None]
        for sh in st.shapes:
            dev = st.device_arrays(sh)
            m = (shp == sh.shape_id) & (code >= 0)
            midx = torch.clamp(member, 0, len(sh.oid) - 1)
            idxf = torch.clamp(member * sh.Lc + leaf, 0,
                               len(sh.rows_flat) - 1)
            rows = torch.where(m, dev["rows_flat"][idxf], rows)
            oid = torch.where(m, dev["oid"][midx], oid)
            for (li, kind, _cycles, neg) in sh.sdf_slots:
                mm, mm0, prm = (a[midx] for a in dev["sdf"][li])
                # per-ray frames: the JAX tracer's _sdf_normal_dyn
                nli = self._sdf_normal(kind, prm, mm, neg,
                                       _affine(mm, mm0, x))
                nor = torch.where((m & (leaf == li))[..., None], nli, nor)
        return rows, oid, nor

    # -- shadow queries ------------------------------------------------------

    @torch.no_grad()
    def shadow_blocked(self, p, d, limit):
        """True where ANY matter hit lies within (.., limit] — the NEE
        shadow test `compound_s_ray_hit(matter) > a` (reference
        src/scene.c:571) as an any-hit reduction.  On a CUDA device the
        kernel-covered scene subset runs as one hand-written kernel (K5
        for SDF scenes, K2 for small analytic ones), and the spheres of a
        big scene as K7; what a kernel leaves out stays on the plain
        walks.  The answer is boolean, so no gradient flows through it
        and autograd records nothing here."""
        dt = self.tdtype
        p = p.to(dt)
        d = d.to(dt)
        limit = limit.to(dt)
        R = p.shape[0]
        use_big = self._bigscene_ok()
        if self._scene_route_ok() and self._prefer_scene_shadow():
            from actinon_tpu_torch.render import scene_kernels
            _, stm = self._scene_tables()
            blocked = (scene_kernels.scene_anyhit(
                self, p.contiguous(), d.contiguous(), limit.contiguous())
                if stm.shapes else
                torch.zeros((R,), dtype=torch.bool, device=self.device))
            for mf in stm.rest_groups:
                a_g, _ = self._group_hit(mf, p, d)
                blocked = blocked | torch.any(a_g <= limit[:, None], dim=1)
            for cluster in _shape_clusters(stm.rest_solos):
                blocked = blocked | self._cluster_shadow(cluster, p, d,
                                                         limit)
        elif self._kernels_ok():
            from actinon_tpu_torch.render import kernels
            blocked = kernels.shadow_any_hit(self, p, d, limit)
            for comp in kernels.coverage(self).rest:
                blocked = blocked | self._shadow_composite(comp, p, d,
                                                           limit)
            for lf, _oid, env_c, env_r, light in self.sdf_singles:
                if not light:
                    a, _ = self._hit_sdf_leaf(lf, env_c, env_r, p, d)
                    blocked = blocked | (a <= limit)
        else:
            blocked = self._shadow_plain(p, d, limit, exclude_big=use_big)
        if use_big:
            # K7 over the spheres that the branches above left out (JAX
            # tracer.py:2187-2189, 2228-2234)
            from actinon_tpu_torch.render import bigscene
            blocked = blocked | bigscene.big_anyhit(
                self, p.contiguous(), d.contiguous(), limit.contiguous())
        return blocked

    def _shadow_plain(self, p, d, limit, exclude_oids=frozenset(),
                      exclude_big=False):
        """The plain any-hit over all matter except the objects in
        `exclude_oids` (and, with exclude_big, the big-scene kernels'
        sphere rows): chunked singles, grouped composite walks, solo
        clusters and standalone SDF marches (JAX tracer.py:2226-2258)."""
        R = p.shape[0]
        blocked = torch.zeros((R,), dtype=torch.bool, device=self.device)
        for rows in self._single_chunks(True, R, exclude_big=exclude_big):
            rows = rows[~np.isin(self.tab.oid[rows], list(exclude_oids))]
            if not len(rows):
                continue
            a = self._chunk_candidates(rows, p, d)
            blocked = blocked | torch.any(a <= limit[:, None], dim=1)
        for members in self.comp_groups:
            mf = [c for c in members
                  if not c.is_light and c.oid not in exclude_oids]
            if not mf:
                continue
            a_g, _ = self._group_hit(mf, p, d)
            blocked = blocked | torch.any(a_g <= limit[:, None], dim=1)
        for cluster in self._solo_clusters():
            mf = [c for c in cluster
                  if not c.is_light and c.oid not in exclude_oids]
            if mf:
                blocked = blocked | self._cluster_shadow(mf, p, d, limit)
        for lf, oid, env_c, env_r, light in self.sdf_singles:
            if light or oid in exclude_oids:
                continue
            a, _ = self._hit_sdf_leaf(lf, env_c, env_r, p, d)
            blocked = blocked | (a <= limit)
        return blocked

    def shadow_nearest_t(self, p, d):
        """Nearest matter hit distance (normals irrelevant, roughness
        skipped).  The recursive oracle's shadow test; the integrator
        uses shadow_blocked."""
        t, _, _, _ = self.nearest(p, d, matter_only=True, rng_rough=False)
        return t

    def shadow_t(self, p, d):
        return self.shadow_nearest_t(p, d)

    def object_hit_t(self, oid: int, p, d):
        """First-hit distance of ONE object (eps-backed, INF on miss) —
        the true-geometry light intersection for NEE
        (obj_ray_hit(light_src, ...), reference src/scene.c:564).  On a
        CUDA device an analytic object within the kernel's size runs as
        the hand-written object-hit kernel (K3); SDF objects march."""
        dt = self.tdtype
        p = p.to(dt)
        d = d.to(dt)
        if self._kernel_device_ok():
            from actinon_tpu_torch.render import kernels
            if kernels.object_desc(self, oid) is not None:
                return kernels.object_hit(self, oid, p, d)
        return self._object_hit_plain(oid, p, d)

    def _object_hit_plain(self, oid: int, p, d):
        """The plain single-object first hit (JAX tracer.py:2280-2295)."""
        rows = np.flatnonzero((self.tab.oid == oid) & self.tab.single)
        if len(rows):
            return self._chunk_candidates(rows.astype(np.int64), p, d)[:, 0]
        for comp in self.composites:
            if comp.oid == oid:
                a, _, _ = self._hit_composite(comp, p, d)
                return a
        for si, (lf, o, env_c, env_r, _light) in \
                enumerate(self.sdf_singles):
            if o == oid:
                a, _ = self._hit_sdf_leaf(lf, env_c, env_r, p, d, si=si)
                return a
        raise ValueError(f"object {oid} not found")
