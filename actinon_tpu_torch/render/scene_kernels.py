"""The packed scene kernels (K4 top-2, K5 any-hit), each beside its plain
PyTorch version.

Counterpart of the JAX package's `render/pallas_scene.py`.  Shape-identical
composites put their MEMBERS ON LANES of one packed parameter table:
`SceneTable` here is that packed table ([TOT, 128] f32 blocks of member
lanes plus per-block bounding spheres), value for value the JAX one, so
that the winner codes of the two packages compare directly.  It is not
the flat leaf/composite table of K1-K3 (`render/kernels.SceneTable`).

Four shape families share the table, in this order: the single-leaf
objects (one trivial shape, root policy per lane), standalone SDF objects
(one shape per SDF kind; one bidirectional march), solo clusters
(composites with SDF leaves after or-decomposition, clustered by shape;
marched crossings + crossing-parity walk) and analytic composite groups
(parity walk over the quadric roots).  The walk is the sorted incremental
toggle walk: a Batcher network sorts a member's crossings, and one sweep
flips each crossing's leaf bit.  Winners are packed codes
`shape << 24 | member << 8 | leaf`, decoded by `Tracer._decode_scene`.

  * `scene_top2` (K4) — the global top-2 eps-backed candidates over the
    full table; replaces `pallas_scene.build_kernels` -> `kernel_top2`;
  * `scene_anyhit` (K5) — any matter hit within a limit over the
    matter-only table; replaces `build_kernels` -> `kernel_anyhit`.

Both kernels live in `csrc/scene_kernels.cu` and build into the library
of `render/kernels.py`.  A wrapper takes the plain version when its
tensors lie on the CPU, and only then; on a CUDA tensor it launches its
kernel or raises, and each launch adds one to `kernels.LAUNCHES`.  The
plain versions compute what the kernels compute, block by block over
[rays, 128 members]: the per-ray block cull, the envelope-clipped marches
with the envelope-exit and limit bails, the sorted walk and the K4 merge
order (per block: the block's best and second-best, first lane on ties,
then the Pallas merge formulas).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from actinon_tpu_torch.render import kernels
from actinon_tpu_torch.render.tracer import (Tracer, _disc, _fma32,
                                             _merge_bounds, _tree_eval_mask)
from actinon_tpu_torch.scene import ir as sir

INF = math.inf
F32_BIG = float(np.float32(3e38))
LB = 128          # members per block (lanes)
NC_CAP = 64       # max crossing columns per shape
LC_CAP = 32       # max leaves per shape
HDR = 6           # alive, is_light, env c (3), env r
AN_ROWS = 20      # M 9, m0 3, c2 3, c1 3, rr 1, kind 1
SDF_ROWS = 13     # m 9, m0 3, param 1
MAX_SHAPES = 128  # shape << 24 stays a positive int32
MAX_MEMBERS = 1 << 16   # member << 8 holds 16 bits
TOP2_WARPS = 4    # K4: rays (one warp each) a thread block; must match
                  # kTop2Warps of csrc/scene_kernels.cu
ANY_WARPS = 4     # K5: the same, kAnyWarps
CHUNK = 128       # K4: block bounds a shared-memory stage holds, kChunk
SHARED_MAX = kernels.SHARED_MAX

# shape descriptor for csrc/scene_kernels.cu (int32 records after a
# one-word header holding the shape count); must match the source
SH_KIND, SH_NBLK, SH_M, SH_ROW0, SH_RPB, SH_BID0, SH_ID, SH_LIGHT = range(8)
SH_LC, SH_NAN, SH_NSDF, SH_AUX, SH_PROG, SH_PLEN, SH_PAIRS = range(8, 15)
SH_NPAIRS, SH_SIZE = 15, 16
KINDS = {"singles": 0, "sdfsingle": 1, "cluster": 2}


# ---------------------------------------------------------------------------
# table build


class _Shape:
    """One lane-major shape family: static structure + per-member
    parameter lanes + host-side reconstruction tables."""

    __slots__ = ("kind", "tree", "Lc", "an_slots", "sdf_slots", "M",
                 "n_blocks", "row_off", "rows_per_block", "bid0",
                 "rows_flat", "oid", "sdf_m", "sdf_m0", "sdf_prm",
                 "shape_id", "has_light", "_lanes", "_envs")

    def __init__(self, kind, tree, Lc, an_slots, sdf_slots, M):
        if M > MAX_MEMBERS:
            raise ValueError(
                f"a shape of {M} members: winner codes hold a member "
                f"index below {MAX_MEMBERS:,}")
        self.kind = kind              # 'singles' | 'cluster' | 'sdfsingle'
        self.tree = tree
        self.Lc = Lc
        self.an_slots = an_slots      # local leaf idx of analytic slots
        self.sdf_slots = sdf_slots    # [(li, sdf_kind, cycles, neg)]
        self.M = M
        self.n_blocks = -(-M // LB)
        self.rows_flat = None         # np [Mpad*Lc] int32 (unified rows)
        self.oid = None               # np [Mpad] int32
        self.sdf_m = {}               # li -> np [Mpad,3,3]
        self.sdf_m0 = {}
        self.sdf_prm = {}
        self.has_light = False

    @property
    def mpad(self):
        return self.n_blocks * LB

    @property
    def n_cols(self):
        return 2 * len(self.an_slots) + 4 * len(self.sdf_slots)


def _an_rows(tr, row):
    """The 20 per-lane parameter values of one unified-table row (the
    tracer's current tables, after any set_geom)."""
    M, m0, c2, c1, rr = tr.tables_np
    return ([float(M[row][i][j]) for i in range(3) for j in range(3)]
            + [float(x) for x in m0[row]] + [float(x) for x in c2[row]]
            + [float(x) for x in c1[row]]
            + [float(rr[row]), float(tr.tab.kind[row])])


def _tree_nodes(tree):
    if tree[0] == "leaf":
        return 1
    if tree[0] == "not":
        return 1 + _tree_nodes(tree[1])
    return 1 + _tree_nodes(tree[1]) + _tree_nodes(tree[2])


def _sort_network(n):
    """Batcher odd-even mergesort comparator pairs for n inputs (the
    power-of-2 network pruned of comparators that touch +INF-padded
    slots — exact for ascending sorts because a comparator whose upper
    index is padding never moves anything)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        pairs.append((i + j, i + j + k))
            k >>= 1
        p <<= 1
    return pairs


def _check_sorted_walk(sh):
    """The Pallas kernel picks the sorted toggle walk when its cost model
    says it is cheaper than the pairwise walk, which is every shape with
    NC >= 2; only the sorted walk is ported, so a shape the rule would
    send to the pairwise walk is refused."""
    nc = sh.n_cols
    nodes = _tree_nodes(sh.tree)
    cost_sorted = 5 * len(_sort_network(nc)) + nc * (2 * sh.Lc + nodes + 7)
    cost_nc2 = 6 * nc * nc + 2 * nc * (sh.Lc + nodes)
    if not cost_sorted < cost_nc2:
        raise NotImplementedError(
            f"a shape of {nc} crossing columns would take the pairwise "
            f"walk, which is not ported")


class SceneTable:
    """The packed per-scene parameter table of the scene kernels: shape
    specs, the [TOT, 128] member table, the [NB, 8] block bounds, and the
    leftovers the tracer evaluates on its plain paths (`rest_groups`,
    `rest_solos`).  matter_only=True builds the shadow table (light
    members dropped, reference src/scene.c:571 traces the matter compound
    only).  exclude_rows drops single rows from the singles shape: the
    tracer passes the big-scene kernels' sphere rows where K6/K7 carry
    them (JAX pallas_scene.py:154-172, tracer.py:1692)."""

    def __init__(self, tracer, matter_only: bool, exclude_rows=None):
        self.eps = np.float32(tracer.eps)
        self.matter_only = matter_only
        self.device = tracer.device
        tab = tracer.tab
        shapes: List[_Shape] = []
        self.rest_groups: List[list] = []
        self.rest_solos: List = []
        self.covered_solo_ids: set = set()
        self.covered_sdf_idx: set = set()
        self.covered_single_rows = np.zeros((0,), np.int32)

        # -- singles ------------------------------------------------------
        rows = tracer.single_rows
        if matter_only and len(rows):
            rows = rows[~tab.is_light[rows]]
        if exclude_rows is not None and len(exclude_rows) and len(rows):
            rows = np.setdiff1d(rows, exclude_rows)
        members_s = []
        for r in rows:
            members_s.append(dict(
                env_c=tab.env_c[r], env_r=float(tab.env_r[r]),
                light=bool(tab.is_light[r]), an=[_an_rows(tracer, int(r))],
                sdf=[], rows=[int(r)], oid=int(tab.oid[r])))
        if members_s:
            sh = _Shape("singles", None, 1, [0], [], len(members_s))
            self._fill(sh, members_s)
            shapes.append(sh)
            self.covered_single_rows = np.asarray(rows, np.int32)

        # -- standalone SDF objects (Tracer._hit_sdf_leaf semantics) ------
        by_key: Dict = {}
        for si, (lf, oid, env_c, env_r, light) in enumerate(
                tracer.sdf_singles):
            if matter_only and light:
                continue
            key = (lf.sdf_kind, int(lf.cycles), bool(lf.neg))
            by_key.setdefault(key, []).append((lf, oid, env_c, env_r,
                                               light))
            self.covered_sdf_idx.add(si)
        for (kind, cycles, neg), ms in by_key.items():
            members = []
            for lf, oid, env_c, env_r, light in ms:
                members.append(dict(
                    env_c=np.asarray(env_c if env_c is not None
                                     else np.zeros(3)),
                    env_r=float(env_r if env_c is not None else -1.0),
                    light=light, an=[],
                    sdf=[(np.asarray(lf.m, np.float32),
                          np.asarray(lf.m0, np.float32),
                          float(lf.sdf_param))],
                    rows=[-1], oid=oid))
            sh = _Shape("sdfsingle", ("leaf", 0), 1, [],
                        [(0, kind, cycles, neg)], len(members))
            self._fill(sh, members)
            shapes.append(sh)

        # -- solo clusters (analytic + SDF composites) --------------------
        for cluster in tracer._solo_clusters():
            proto = cluster[0]
            if matter_only and proto.is_light:
                continue
            n_an = sum(1 for r in proto.rows if r >= 0)
            sslots = [(li, lf.sdf_kind, int(lf.cycles), bool(lf.neg))
                      for li, lf in enumerate(proto.sdf_leaves)
                      if lf is not None]
            nc = 2 * n_an + 4 * len(sslots)
            if nc > NC_CAP or len(proto.rows) > LC_CAP:
                self.rest_solos.extend(cluster)
                continue
            an_slots = [li for li, r in enumerate(proto.rows) if r >= 0]
            members = []
            for c in cluster:
                members.append(dict(
                    env_c=np.asarray(c.env_c if c.env_c is not None
                                     else np.zeros(3)),
                    env_r=float(c.env_r if c.env_c is not None else -1.0),
                    light=c.is_light,
                    an=[_an_rows(tracer, c.rows[li]) for li in an_slots],
                    sdf=[(np.asarray(c.sdf_leaves[li].m, np.float32),
                          np.asarray(c.sdf_leaves[li].m0, np.float32),
                          float(c.sdf_leaves[li].sdf_param))
                         for li, *_ in sslots],
                    rows=list(c.rows), oid=c.oid))
            sh = _Shape("cluster", proto.tree, len(proto.rows),
                        an_slots, sslots, len(members))
            self._fill(sh, members)
            shapes.append(sh)
            self.covered_solo_ids.update(id(c) for c in cluster)

        # -- all-analytic composite groups --------------------------------
        for members_g in tracer.comp_groups:
            mf = [c for c in members_g
                  if not (matter_only and c.is_light)]
            if not mf:
                continue
            proto = mf[0]
            Lc = len(proto.rows)
            # singleton analytic composites with a large crossing count
            # stay on the tracer's plain walk (as in the JAX package)
            if 2 * Lc > NC_CAP or Lc > LC_CAP \
                    or (len(mf) == 1 and 2 * Lc > 24):
                self.rest_groups.append(mf)
                continue
            members = []
            for c in mf:
                members.append(dict(
                    env_c=np.asarray(c.env_c if c.env_c is not None
                                     else np.zeros(3)),
                    env_r=float(c.env_r if c.env_c is not None else -1.0),
                    light=c.is_light,
                    an=[_an_rows(tracer, r) for r in c.rows],
                    sdf=[], rows=list(c.rows), oid=c.oid))
            sh = _Shape("cluster", proto.tree, Lc, list(range(Lc)), [],
                        len(members))
            self._fill(sh, members)
            shapes.append(sh)

        if len(shapes) > MAX_SHAPES:
            raise ValueError(f"{len(shapes)} shapes: winner codes hold a "
                             f"shape index below {MAX_SHAPES}")
        for sh in shapes:
            if sh.kind == "cluster":
                _check_sorted_walk(sh)
        self.shapes = shapes
        self._pack()
        self._dev: Dict[int, dict] = {}
        self._upload()

    def _fill(self, sh: _Shape, members):
        """Populate a shape's lane data + reconstruction tables from the
        per-member dicts."""
        Mpad = sh.mpad
        lanes = np.zeros((Mpad, HDR + AN_ROWS * len(sh.an_slots)
                          + SDF_ROWS * len(sh.sdf_slots)), np.float32)
        rows_flat = np.full((Mpad * sh.Lc,), -1, np.int32)
        oid = np.full((Mpad,), -1, np.int32)
        env_list = []
        for mi, m in enumerate(members):
            lanes[mi, 0] = 1.0
            lanes[mi, 1] = 1.0 if m["light"] else 0.0
            lanes[mi, 2:5] = m["env_c"]
            lanes[mi, 5] = m["env_r"]
            r = HDR
            for an in m["an"]:
                lanes[mi, r:r + AN_ROWS] = an
                r += AN_ROWS
            for mm, mm0, prm in m["sdf"]:
                lanes[mi, r:r + 9] = np.asarray(mm, np.float32).reshape(9)
                lanes[mi, r + 9:r + 12] = mm0
                lanes[mi, r + 12] = prm
                r += SDF_ROWS
            rows_flat[mi * sh.Lc:(mi + 1) * sh.Lc] = m["rows"]
            oid[mi] = m["oid"]
            sh.has_light = sh.has_light or m["light"]
            env_list.append((m["env_c"], m["env_r"]))
        sh.rows_flat = rows_flat
        sh.oid = oid
        for k, (li, *_rest) in enumerate(sh.sdf_slots):
            m_s = np.zeros((Mpad, 3, 3), np.float32)
            m0_s = np.zeros((Mpad, 3), np.float32)
            p_s = np.zeros((Mpad,), np.float32)
            for mi, m in enumerate(members):
                mm, mm0, prm = m["sdf"][k]
                m_s[mi] = mm
                m0_s[mi] = mm0
                p_s[mi] = prm
            sh.sdf_m[li] = m_s
            sh.sdf_m0[li] = m0_s
            sh.sdf_prm[li] = p_s
        sh._lanes = lanes
        sh._envs = env_list

    def _pack(self):
        """Concatenate all shape blocks into ONE [TOT, 128] table plus
        per-block bounding spheres [NB, 8]."""
        rows = []
        bounds = []
        off = 0
        bid = 0
        for sid, sh in enumerate(self.shapes):
            sh.shape_id = sid
            sh.row_off = off
            n_feat = (HDR + AN_ROWS * len(sh.an_slots)
                      + SDF_ROWS * len(sh.sdf_slots))
            sh.rows_per_block = n_feat
            sh.bid0 = bid
            lanes = sh._lanes                       # [Mpad, n_feat]
            for b in range(sh.n_blocks):
                rows.append(lanes[b * LB:(b + 1) * LB].T)  # [n_feat, 128]
                # block bound: merged member envelopes; unbounded when
                # any live member lacks one (r2 = -1 -> never skip)
                bound = None
                ok = True
                for mi in range(b * LB, min((b + 1) * LB, sh.M)):
                    ec, er = sh._envs[mi]
                    if er <= 0:
                        ok = False
                        break
                    bb = (np.asarray(ec, np.float64), float(er))
                    bound = bb if bound is None else _merge_bounds(bound,
                                                                   bb)
                brow = np.zeros((8,), np.float32)
                if ok and bound is not None:
                    brow[0:3] = bound[0]
                    brow[3] = (bound[1] + 2.0 * float(self.eps)) ** 2
                else:
                    brow[3] = -1.0
                bounds.append(brow)
                bid += 1
            off += sh.n_blocks * n_feat
            del sh._lanes, sh._envs
        # row-major, as the kernels read it (concatenating the transposed
        # blocks would keep their column-major order)
        self.table = (np.ascontiguousarray(np.concatenate(rows, axis=0))
                      if rows else np.zeros((1, LB), np.float32))
        self.bounds = (np.stack(bounds) if bounds
                       else np.zeros((1, 8), np.float32))
        # each member block's shape index (K4, K5 read it by bound id)
        self.block_shape = np.asarray(
            [sid for sid, sh in enumerate(self.shapes)
             for _ in range(sh.n_blocks)] or [0], np.int32)

    def descriptor(self) -> np.ndarray:
        """The int32 shape descriptor csrc/scene_kernels.cu reads: the
        shape count, one SH_SIZE record per shape, then each shape's
        analytic slots, SDF slots (li, kind, cycles, neg), postfix CSG
        program and sort-network comparator pairs."""
        recs = np.zeros((len(self.shapes), SH_SIZE), np.int64)
        tail: List[int] = []
        base = 1 + len(self.shapes) * SH_SIZE
        for k, sh in enumerate(self.shapes):
            r = recs[k]
            r[SH_KIND], r[SH_NBLK], r[SH_M] = KINDS[sh.kind], sh.n_blocks, sh.M
            r[SH_ROW0], r[SH_RPB], r[SH_BID0] = (sh.row_off,
                                                 sh.rows_per_block, sh.bid0)
            r[SH_ID], r[SH_LIGHT], r[SH_LC] = (sh.shape_id, sh.has_light,
                                               sh.Lc)
            r[SH_NAN], r[SH_NSDF] = len(sh.an_slots), len(sh.sdf_slots)
            r[SH_AUX] = base + len(tail)
            tail += sh.an_slots
            for li, kind, cycles, neg in sh.sdf_slots:
                tail += [li, kind, cycles, int(neg)]
            if sh.kind == "cluster":
                prog = kernels._postfix(sh.tree, [])
                pairs = _sort_network(sh.n_cols)
                r[SH_PROG], r[SH_PLEN] = base + len(tail), len(prog)
                tail += prog
                r[SH_PAIRS], r[SH_NPAIRS] = base + len(tail), len(pairs)
                tail += [x for pr in pairs for x in pr]
        return np.concatenate([[len(self.shapes)], recs.reshape(-1),
                               np.asarray(tail, np.int64)]).astype(np.int32)

    def _upload(self):
        dev = self.device
        self.table_t = torch.as_tensor(self.table, device=dev)
        self.bounds_t = torch.as_tensor(self.bounds, device=dev)
        self.block_shape_t = torch.as_tensor(self.block_shape, device=dev)
        self.desc_t = torch.as_tensor(self.descriptor(), device=dev)

    def device_arrays(self, sh: _Shape) -> dict:
        """A shape's reconstruction tables as device tensors (cached):
        rows_flat, oid (int64) and per SDF slot (m, m0, prm) in f32."""
        got = self._dev.get(sh.shape_id)
        if got is None:
            t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)
            got = dict(
                rows_flat=t(sh.rows_flat, torch.int64),
                oid=t(sh.oid, torch.int64),
                sdf={li: (t(sh.sdf_m[li], torch.float32),
                          t(sh.sdf_m0[li], torch.float32),
                          t(sh.sdf_prm[li], torch.float32))
                     for li, *_ in sh.sdf_slots})
            self._dev[sh.shape_id] = got
        return got

# ---------------------------------------------------------------------------
# plain versions: the kernels' math on [rays, 128 members] tensors


class _Work:
    """Counts of the work the plain versions do (chip_smoke.py turns them
    into the kernels' operation bound): block culls, member gates,
    analytic slots and SDF slot set-ups where the gate passes, march
    steps taken, comparator pairs and sweep steps over the finite
    crossings of the gated cluster lanes, blocks merged."""

    def __init__(self):
        self.culls = 0
        self.gates = 0
        self.analytic = 0
        self.sdf_setups = 0
        self.steps = 0
        self.comparators = 0
        self.sweeps = 0
        self.merges = 0


def _quad_lane(px, py, pz, dx, dy, dz, P):
    """(A, B, C) of the generalized quadric along the ray; P = 20 table
    rows (Tracer._quads with per-lane parameters)."""
    plv = [P[3 * i + 0] * px + P[3 * i + 1] * py + P[3 * i + 2] * pz
           + P[9 + i] for i in range(3)]
    dlv = [P[3 * i + 0] * dx + P[3 * i + 1] * dy + P[3 * i + 2] * dz
           for i in range(3)]
    c2, c1, rr = P[12:15], P[15:18], P[18]
    A = c2[0] * dlv[0] * dlv[0] + c2[1] * dlv[1] * dlv[1] \
        + c2[2] * dlv[2] * dlv[2]
    B = 2.0 * (c2[0] * dlv[0] * plv[0] + c2[1] * dlv[1] * plv[1]
               + c2[2] * dlv[2] * plv[2]) \
        + (c1[0] * dlv[0] + c1[1] * dlv[1] + c1[2] * dlv[2])
    C = (c2[0] * plv[0] * plv[0] + c2[1] * plv[1] * plv[1]
         + c2[2] * plv[2] * plv[2]) \
        + (c1[0] * plv[0] + c1[1] * plv[1] + c1[2] * plv[2]) + rr
    return A, B, C


def _policy_lane(kind_row, t0u, t1u, s, q, ok, eps):
    """Family root policy with a per-lane kind row (Tracer._policy)."""
    is_pl = kind_row == float(sir.PLANE)
    is_sp = kind_row == float(sir.SPHERE)
    a_pl = torch.where(t0u > 0, t0u - eps, INF)
    entering = (s < 0) & (q > 0)
    exiting = (s < 0) | (q < 0)
    a_sp = torch.where(entering, t0u, torch.where(exiting, t1u, INF))
    a_sp = torch.where(ok, a_sp - eps, INF)
    a_qu = torch.where(t0u >= 0, t0u, torch.where(t1u >= 0, t1u, INF))
    a_qu = torch.where(torch.isfinite(a_qu), a_qu - eps, INF)
    return torch.where(is_pl, a_pl, torch.where(is_sp, a_sp, a_qu))


def _env_interval_lane(px, py, pz, dx, dy, dz, ecx, ecy, ecz, er):
    """(gate, t_in, t_out) of per-lane envelope spheres; er <= 0 lanes
    gate True with the full line."""
    ex, ey, ez = px - ecx, py - ecy, pz - ecz
    # each multiply-add rounded once, as XLA's compiled CPU code rounds
    # the Pallas helper: fma(z, dz, fma(x, dx, y dy)), er er apart, then
    # fma(s, s, -q)
    s = _fma32(ez, dz, _fma32(ex, dx, ey * dy))
    q = _fma32(ez, ez, _fma32(ex, ex, ey * ey)) - er * er
    disc = _disc(s, q)
    hit = (disc >= 0) & ((s < 0) | (q < 0))
    no_env = er <= 0
    root = torch.sqrt(torch.where(disc > 0, disc, 0.0))
    t_in = torch.where(no_env, 0.0, torch.clamp(-s - root, min=0.0))
    t_out = torch.where(no_env, F32_BIG, -s + root)
    return no_env | hit, t_in, t_out


def _sdf_eval_lane(kind, prm, x, y, z):
    """The unit shape's signed distance on coordinate tiles."""
    if kind == sir.SDF_SPHERE:
        return torch.sqrt(x * x + y * y + z * z) - 1.0
    if kind == sir.SDF_TORUS:
        f = torch.sqrt(x * x + y * y)
        f_inv = torch.where(f > 0, 1.0 / torch.where(f > 0, f, 1.0), 1.0)
        xu, yu = x * f_inv - x, y * f_inv - y
        return torch.sqrt(xu * xu + yu * yu + z * z) - prm
    raise ValueError(kind)


class _Block:
    """One member block of one shape against n rays: the table rows as
    [1, 128] tensors and the rays as [n, 1] columns."""

    def __init__(self, st, sh, b, p, d, work):
        base = sh.row_off + b * sh.rows_per_block
        self.rows = st.table_t[base:base + sh.rows_per_block][:, None, :]
        self.px, self.py, self.pz = (p[:, k:k + 1] for k in range(3))
        self.dx, self.dy, self.dz = (d[:, k:k + 1] for k in range(3))
        self.eps = float(st.eps)
        self.work = work
        self.every = 1 if p.device.type == "cpu" else 8

    def row(self, i):
        return self.rows[i]

    def sdf_local(self, off):
        """(pl*, dl* unit, dn) of the SDF slot at feature offset off."""
        m = [self.row(off + i) for i in range(9)]
        m0 = [self.row(off + 9 + i) for i in range(3)]
        plv = [m[3 * i] * self.px + m[3 * i + 1] * self.py
               + m[3 * i + 2] * self.pz + m0[i] for i in range(3)]
        dl0 = [m[3 * i] * self.dx + m[3 * i + 1] * self.dy
               + m[3 * i + 2] * self.dz for i in range(3)]
        dn = torch.sqrt(dl0[0] * dl0[0] + dl0[1] * dl0[1] + dl0[2] * dl0[2])
        inv = torch.where(dn > 0, 1.0 / torch.where(dn > 0, dn, 1.0), 1.0)
        return plv, [v * inv for v in dl0], dn

    def march(self, kind, cycles, prm, plv, dl, offs0, dead, stop_total):
        """Bidirectional sphere march of at most `cycles` steps from local
        offset offs0; a lane stops when it crosses the surface or when its
        total offset passes stop_total (the envelope exit or the shadow
        limit: a crossing out there is rejected anyway).  Returns
        (offs_l, dist)."""
        eps = self.eps
        p0 = [plv[i] + dl[i] * offs0 for i in range(3)]
        dist = _sdf_eval_lane(kind, prm, *p0)
        forward = dist > 0
        shape = torch.broadcast_shapes(dist.shape, dead.shape,
                                       stop_total.shape)
        dist = dist.expand(shape)
        offs1 = torch.zeros(shape, dtype=dist.dtype, device=dist.device)
        act = ~dead.expand(shape)
        steps = torch.zeros(shape, dtype=torch.int32, device=dist.device)
        for i in range(int(cycles)):
            if i % self.every == 0 and not bool(act.any()):
                break
            steps += act
            step = torch.where(forward, dist + eps, -(dist - eps))
            offs1 = torch.where(act, offs1 + step, offs1)
            dnew = _sdf_eval_lane(kind, prm, p0[0] + dl[0] * offs1,
                                  p0[1] + dl[1] * offs1,
                                  p0[2] + dl[2] * offs1)
            dist = torch.where(act, dnew, dist)
            crossed = (forward & ((dist < 0) | (dist > 1e30))) \
                | (~forward & ((dist > 0) | (dist < -1e30)))
            crossed = crossed | (offs0 + offs1 > stop_total)
            act = act & ~crossed
        if self.work is not None:
            self.work.steps += int(steps.sum())
        return offs0 + offs1, dist


def _boundary(st, sh, b, p, d, lim, work):
    """(a [n,128] eps-backed and env-gated, leaf_loc [n,128] int64) of one
    shape block on n rays; lim [n] (any-hit only) bails marches past the
    shadow limit."""
    blk = _Block(st, sh, b, p, d, work)
    row = blk.row
    eps = blk.eps
    slack = float(np.float32(8.0 * eps))
    accept = float(np.float32(1.5 * eps))
    eps4 = float(np.float32(4.0 * eps))
    px, py, pz, dx, dy, dz = blk.px, blk.py, blk.pz, blk.dx, blk.dy, blk.dz
    gate, t_in_raw, t_out_raw = _env_interval_lane(
        px, py, pz, dx, dy, dz, row(2), row(3), row(4), row(5))
    gate = gate & (row(0) > 0)
    n_live = min(LB, sh.M - b * LB)
    limc = None if lim is None else lim[:, None]
    if work is not None:
        work.gates += p.shape[0] * n_live
    n_gate = int(gate.sum()) if work is not None else 0
    zeros_leaf = torch.zeros(gate.shape, dtype=torch.int64,
                             device=gate.device)

    if sh.kind == "singles":
        P = [row(HDR + i) for i in range(AN_ROWS)]
        A, B, C = _quad_lane(px, py, pz, dx, dy, dz, P)
        t0u, t1u, s, q, ok = Tracer._roots(A, B, C)
        a = _policy_lane(P[19], t0u, t1u, s, q, ok, eps)
        if work is not None:
            work.analytic += n_gate
        return torch.where(gate, a, INF), zeros_leaf

    if sh.kind == "sdfsingle":
        # envelope-clipped entry, ONE bidirectional march, |dist| <=
        # 1.5 eps accepts (Tracer._hit_sdf_leaf)
        _li, kind, cycles, _neg = sh.sdf_slots[0]
        plv, dl, dn = blk.sdf_local(HDR)
        stop_w = t_out_raw + slack
        if limc is not None:
            stop_w = torch.minimum(stop_w, limc + slack)
        offs_l, dist = blk.march(kind, cycles, row(HDR + 12), plv, dl,
                                 t_in_raw * dn, ~gate, stop_w * dn)
        if work is not None:
            work.sdf_setups += n_gate
        hit = gate & (torch.abs(dist) <= accept)
        dn_inv = torch.where(dn > 0, 1.0 / torch.where(dn > 0, dn, 1.0), 1.0)
        return torch.where(hit, offs_l * dn_inv - eps, INF), zeros_leaf

    # -- cluster: crossings + sorted toggle walk ----------------------------
    t_in = torch.clamp(t_in_raw - slack, min=0.0)
    t_out = t_out_raw + slack
    cross, col_leaf = [], []
    inside = [None] * sh.Lc
    off = HDR
    for li in sh.an_slots:
        P = [row(off + i) for i in range(AN_ROWS)]
        off += AN_ROWS
        A, B, C = _quad_lane(px, py, pz, dx, dy, dz, P)
        t0u, t1u, _, _, _ = Tracer._roots(A, B, C)
        cross += [torch.where(t0u > 0, t0u, INF),
                  torch.where(t1u > 0, t1u, INF)]
        col_leaf += [li, li]
        inside[li] = C <= 0
    for li, kind, cycles, _neg in sh.sdf_slots:
        plv, dl, dn = blk.sdf_local(off)
        prm = row(off + 12)
        off += SDF_ROWS
        dn_inv = 1.0 / torch.where(dn > 0, dn, 1.0)
        # SDF_CROSSINGS sequential marches clipped to the envelope
        # interval (Tracer._sdf_crossings)
        offs = t_in * dn
        dead = ~gate
        t_stop = t_out if limc is None else torch.minimum(t_out,
                                                          limc + slack)
        stop_l = t_stop * dn
        for _ in range(4):
            offs_l, dist = blk.march(kind, cycles, prm, plv, dl, offs, dead,
                                     stop_l)
            hit = ~dead & (torch.abs(dist) <= accept) & (offs_l <= stop_l)
            cross.append(torch.where(hit & (offs_l > 0), offs_l * dn_inv,
                                     INF))
            col_leaf.append(li)
            dead = dead | ~hit
            offs = offs_l + eps4
        # origin inside-ness at the TRUE ray origin
        inside[li] = _sdf_eval_lane(kind, prm, *plv) <= 0
    shape = gate.shape
    t_s = [c.expand(shape) for c in cross]
    lf_s = [torch.full(shape, li, dtype=torch.int64, device=gate.device)
            for li in col_leaf]
    pairs = _sort_network(len(t_s))
    for i, j in pairs:
        swap = t_s[i] > t_s[j]
        t_s[i], t_s[j] = (torch.where(swap, t_s[j], t_s[i]),
                          torch.where(swap, t_s[i], t_s[j]))
        lf_s[i], lf_s[j] = (torch.where(swap, lf_s[j], lf_s[i]),
                            torch.where(swap, lf_s[i], lf_s[j]))
    # one in-order sweep: each crossing toggles its leaf's inside bit;
    # coincident crossings flip jointly (the flip test fires only where a
    # tie run ends), and the first flip is the boundary
    state = [inside[li].expand(shape) for li in range(sh.Lc)]
    v_run = _tree_eval_mask(sh.tree, lambda li: state[li])
    found = torch.zeros(shape, dtype=torch.bool, device=gate.device)
    best = torch.full(shape, INF, dtype=t_s[0].dtype, device=gate.device)
    best_leaf = torch.zeros(shape, dtype=torch.int64, device=gate.device)
    NC = len(t_s)
    for j in range(NC):
        for li in range(sh.Lc):
            state[li] = state[li] ^ (lf_s[j] == li)
        v_new = _tree_eval_mask(sh.tree, lambda li: state[li])
        t_next = t_s[j + 1] if j + 1 < NC else INF
        run_end = t_s[j] != t_next
        flip = run_end & (v_new ^ v_run)
        win = flip & ~found
        found = found | flip
        best = torch.where(win, t_s[j], best)
        best_leaf = torch.where(win, lf_s[j], best_leaf)
        v_run = torch.where(run_end, v_new, v_run)
    if work is not None:
        work.analytic += n_gate * len(sh.an_slots)
        work.sdf_setups += n_gate * len(sh.sdf_slots)
        work.comparators += n_gate * len(pairs)
        nf = sum((torch.isfinite(c) & gate).to(torch.int64) for c in t_s)
        work.sweeps += int(nf.sum())
    a = torch.where(gate & (best < F32_BIG), best - eps, INF)
    return a, best_leaf


def _cull(st, bid, p, d, lim=None):
    """Rays [n] that may touch block `bid`'s bound (r2 < 0: unbounded,
    never culled).  With lim (any-hit) a block matters only to rays whose
    bound entry lies within their limit."""
    cx, cy, cz, r2 = (float(x) for x in st.bounds[bid, :4])
    if r2 < 0:
        return torch.ones((p.shape[0],), dtype=torch.bool, device=p.device)
    ex, ey, ez = cx - p[:, 0], cy - p[:, 1], cz - p[:, 2]
    s = _fma32(ez, d[:, 2], _fma32(ex, d[:, 0], ey * d[:, 1]))
    q = _fma32(ez, ez, _fma32(ex, ex, ey * ey)) - r2
    disc = _disc(s, q)
    hit = (disc >= 0) & ((s > 0) | (q < 0))
    if lim is None:
        return hit
    te = torch.clamp(s - torch.sqrt(torch.where(disc >= 0, disc, 0.0)),
                     min=0.0)
    return hit & (te <= lim)


def _blocks(st):
    for sh in st.shapes:
        for b in range(sh.n_blocks):
            yield sh, b


def scene_top2_plain(st: SceneTable, p, d, lane_matter, work=None):
    """Plain version of K4: (t [N,2] eps-backed, code [N,2] int32, -1 where
    t is not finite).  Per block that a ray does not cull: the block's
    best and second-best lanes (first lane on ties), then the merge
    formulas of the Pallas kernel; lanes of light members are masked
    where lane_matter > 0."""
    N, dev = p.shape[0], p.device
    t1 = torch.full((N,), INF, dtype=torch.float32, device=dev)
    t2 = t1.clone()
    c1 = torch.full((N,), -1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    lanes = torch.arange(LB, dtype=torch.int32, device=dev)
    for sh, b in _blocks(st):
        keep = _cull(st, sh.bid0 + b, p, d)
        if work is not None:
            work.culls += N
        idx = torch.nonzero(keep).squeeze(1)
        if idx.numel() == 0:
            continue
        a, leaf = _boundary(st, sh, b, p[idx], d[idx], None, work)
        if sh.has_light:
            light = st.table_t[sh.row_off + b * sh.rows_per_block + 1]
            a = torch.where((light > 0)[None, :]
                            & (lane_matter[idx] > 0)[:, None], INF, a)
        code = (sh.shape_id << 24) | ((b * LB + lanes[None, :]) << 8) \
            | leaf.to(torch.int32)
        b1, bi1 = torch.min(a, dim=1, keepdim=True)
        g1 = torch.gather(code, 1, bi1)
        b2, bi2 = torch.min(a.scatter(1, bi1, INF), dim=1, keepdim=True)
        g2 = torch.gather(code, 1, bi2)
        b1, g1, b2, g2 = b1[:, 0], g1[:, 0], b2[:, 0], g2[:, 0]
        o1, o2, i1, i2 = t1[idx], t2[idx], c1[idx], c2[idx]
        hi_t = torch.maximum(o1, b1)
        hi_i = torch.where(b1 < o1, i1, g1)
        w2 = torch.minimum(o2, b2)
        w2i = torch.where(b2 < o2, g2, i2)
        t1[idx] = torch.minimum(o1, b1)
        c1[idx] = torch.where(b1 < o1, g1, i1)
        t2[idx] = torch.minimum(hi_t, w2)
        c2[idx] = torch.where(hi_t <= w2, hi_i, w2i)
        if work is not None:
            work.merges += idx.numel()
    t = torch.stack([t1, t2], dim=1)
    c = torch.stack([c1, c2], dim=1)
    return t, torch.where(torch.isfinite(t), c, -1)


def scene_anyhit_plain(st: SceneTable, p, d, limit, work=None):
    """Plain version of K5: blocked [N] bool, any matter hit within
    (., limit] (a limit that is not finite reads as 3e38).  A ray stops
    at the block of its first hit."""
    N, dev = p.shape[0], p.device
    lim = torch.where(torch.isfinite(limit), limit,
                      torch.full_like(limit, F32_BIG))
    blocked = torch.zeros((N,), dtype=torch.bool, device=dev)
    for sh, b in _blocks(st):
        open_ = ~blocked
        if work is not None:
            work.culls += int(open_.sum())
        keep = open_ & _cull(st, sh.bid0 + b, p, d, lim)
        idx = torch.nonzero(keep).squeeze(1)
        if idx.numel() == 0:
            continue
        a, _ = _boundary(st, sh, b, p[idx], d[idx], lim[idx], work)
        hit = torch.min(a, dim=1).values <= lim[idx]
        blocked[idx] = blocked[idx] | hit
    return blocked


# ---------------------------------------------------------------------------
# the wrappers


def _launch(st: SceneTable, warps: int, stages: int) -> dict:
    """A warp kernel's launch geometry over the table st: threads and
    rays (one warp each) a thread block, and the dynamic shared memory
    that holds the descriptor, padded to 16 bytes, and `stages` stages of
    CHUNK bounds' (centre, r2) (csrc/scene_kernels.cu
    `top2_shared_bytes`); only the descriptor grows with the table."""
    words = kernels._pad4(st.desc_t.numel()) + stages * CHUNK * 4
    return dict(threads=32 * warps, rays_per_block=warps,
                shared_bytes=4 * words)


def top2_launch(st: SceneTable) -> dict:
    """K4's launch geometry over the full table st: two bound stages."""
    return _launch(st, TOP2_WARPS, 2)


def anyhit_launch(st: SceneTable) -> dict:
    """K5's launch geometry over the matter-only table st: the descriptor
    alone in shared memory (the bounds through L1); the grid is capped at
    the thread blocks the card holds at once, each warp striding over the
    rays."""
    return _launch(st, ANY_WARPS, 0)


def _check_shared(name, launch):
    if launch["shared_bytes"] > SHARED_MAX:
        raise ValueError(f"{name}: the descriptor (and bound stages) need "
                         f"{launch['shared_bytes']} bytes of shared memory, "
                         f"a thread block has {SHARED_MAX}")


def scene_top2(tr, p, d, lane_matter):
    """K4 over the tracer's full scene table: (t [N,2] f32, code [N,2]
    int32).  p, d [N,3] and lane_matter [N] f32.  Raises where the
    descriptor does not fit a thread block's shared memory beside the
    bound stages."""
    st, _ = tr._scene_tables()
    if p.device.type == "cpu":
        return scene_top2_plain(st, p, d, lane_matter)
    _check_shared("scene_top2", top2_launch(st))
    N = p.shape[0]
    kernels._check(p, (N, 3), torch.float32, "p")
    kernels._check(d, (N, 3), torch.float32, "d")
    kernels._check(lane_matter, (N,), torch.float32, "lane_matter")
    t = torch.empty((N, 2), dtype=torch.float32, device=p.device)
    c = torch.empty((N, 2), dtype=torch.int32, device=p.device)
    if N == 0:
        return t, c
    rc = kernels._lib().actinon_scene_top2(
        st.table_t.data_ptr(), st.bounds_t.data_ptr(),
        st.block_shape_t.data_ptr(), st.desc_t.data_ptr(), p.data_ptr(),
        d.data_ptr(), lane_matter.data_ptr(), t.data_ptr(), c.data_ptr(), N,
        float(st.eps), st.desc_t.numel(), kernels._stream())
    kernels._launched("scene_top2", rc)
    return t, c


def scene_anyhit(tr, p, d, limit):
    """K5 over the tracer's matter-only scene table: blocked [N] bool.
    p, d [N,3] and limit [N] f32 (a limit that is not finite reads as
    3e38 inside the kernel).  Raises where the descriptor does not fit a
    thread block's shared memory."""
    _, st = tr._scene_tables()
    if p.device.type == "cpu":
        return scene_anyhit_plain(st, p, d, limit)
    _check_shared("scene_anyhit", anyhit_launch(st))
    N = p.shape[0]
    kernels._check(p, (N, 3), torch.float32, "p")
    kernels._check(d, (N, 3), torch.float32, "d")
    kernels._check(limit, (N,), torch.float32, "limit")
    out = torch.empty((N,), dtype=torch.bool, device=p.device)
    if N == 0:
        return out
    rc = kernels._lib().actinon_scene_anyhit(
        st.table_t.data_ptr(), st.bounds_t.data_ptr(),
        st.block_shape_t.data_ptr(), st.desc_t.data_ptr(), p.data_ptr(),
        d.data_ptr(), limit.data_ptr(), out.data_ptr(), N, float(st.eps),
        st.desc_t.numel(), kernels._stream())
    kernels._launched("scene_anyhit", rc)
    return out
