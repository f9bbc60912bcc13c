"""The big-scene sphere kernels (K6 top-2, K7 any-hit), each beside its
plain PyTorch version.

Counterpart of the JAX package's `render/pallas_bigscene.py`.  Scenes with
large populations of single-leaf matter spheres (a 32,768-sphere fractal:
`tracer.big_rows`, at least `Tracer.BIG_MIN_ROWS`) keep those spheres in
one Morton-ordered block table: G blocks of LB = 128 spheres, each block
spatially compact, with a per-block bounding sphere that lets a ray skip
the whole block.  `SphereBlocks` is the JAX one value for value (the same
`rows` permutation, `table [G, 8, 128]` and `bounds [G, 8]`), so that the
block-local indices `gidx` compare directly between the packages.

  * `big_top2` (K6) — the running top-2 eps-backed sphere hits over the
    blocks: (t [N, 2], gidx [N, 2]), gidx indexing `SphereBlocks.rows`;
    replaces `pallas_bigscene.build_top2_kernel`;
  * `big_anyhit` (K7) — any sphere hit within (0, limit], with the
    limit-aware block cull; replaces `build_anyhit_kernel`.  Two designs
    of it, chosen by the block count G (`ANYHIT_WARP_MIN_BLOCKS`): a warp
    a ray over K6's staged bounds and ballot cull, or a thread a ray.

Both kernels live in `csrc/bigscene_kernels.cu` and build into the library
of `render/kernels.py`.  A wrapper takes the plain version when its
tensors lie on the CPU, and only then; on a CUDA tensor it launches its
kernel or raises, and each launch adds one to `kernels.LAUNCHES` (K7's
also to "big_anyhit_warp" or "big_anyhit_thread", by design).  The
plain versions compute what the kernels compute, block by block over
[rays, 128 lanes]: the per-ray block cull (the Pallas tile gate made per
ray), the sphere candidates in the expression order of the Pallas helper,
the block's best and second best (first lane on ties) and the Pallas merge
formulas where the block's best beats the ray's second best.  They also
count the work the bound charges (`_Work`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from actinon_tpu_torch.render import kernels
from actinon_tpu_torch.render.tracer import _disc, _fma32

INF = math.inf
F32_BIG = float(np.float32(3e38))
LB = 128          # spheres per block (lanes)
TR = 256          # rays per tile of the Pallas kernels; the CUDA kernels
                  # do not tile by it (K6: a warp a ray, K7: a thread)
# K6's launch, as kTop2Warps and kChunk of csrc/bigscene_kernels.cu set
# it: rays (one warp each) a thread block, block bounds a shared-memory
# stage holds, and two stages of (centre, r2) at 16 bytes a bound
TOP2_WARPS = 8
BOUND_CHUNK = 128
TOP2_LAUNCH = dict(threads=32 * TOP2_WARPS, rays_per_block=TOP2_WARPS,
                   shared_bytes=2 * BOUND_CHUNK * 16)
# K7's two designs (kAnyWarps, kBlock of the source): the warp design is
# K6's launch; the thread design takes 256 rays a thread block
ANYHIT_WARPS = 8
ANYHIT_LAUNCH = {"warp": dict(threads=32 * ANYHIT_WARPS,
                              rays_per_block=ANYHIT_WARPS,
                              shared_bytes=2 * BOUND_CHUNK * 16),
                 "thread": dict(threads=256, rays_per_block=256,
                                shared_bytes=0)}
# K7 takes the warp design from this many blocks up, the thread design
# below.  A warp a ray spreads a passed block's 128 lanes over the warp,
# but pays a ray's fixed work (its culls, the exit test) once per ray; a
# thread a ray shares that work among 32 rays and loses where its rays
# pass blocks and run their 128-lane loops in turn.  So what decides is
# how many blocks a ray passes, which the block count G only stands in
# for.  On an H100 (700 W; chip_smoke.py's "kernel big_anyhit" and "k7
# sweep" lines, both designs in turns on each render's largest K7 call,
# against its first G blocks): on lamp_row's shadow rays (0.25 passed
# blocks a ray) the thread design won at G = 5, its whole table, 0.062
# against 0.085 ms; on sphere_fractal's the warp design won at every G
# measured, 4 to 256 (G = 8: 0.025 against 0.092 ms; G = 256: 0.090
# against 0.397).  8 is the smallest G of the fractal's sweep above
# lamp_row's 5.
ANYHIT_WARP_MIN_BLOCKS = 8


# ---------------------------------------------------------------------------
# the block table (pallas_bigscene.py:46-108, numpy, value for value)


def _morton3(x, y, z, bits=10):
    """Interleaved Morton code of quantized coordinates [N]."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v
    return spread(x) | (spread(y) << np.uint64(1)) \
        | (spread(z) << np.uint64(2))


class SphereBlocks:
    """Static block tables of the kernels + the row permutation: `rows`
    [n] (the spheres' unified-table rows in Morton order), `table [G, 8,
    128]` f32 (rows 0..3 = cx, cy, cz, r2; dead pad lanes r2 = -1) and
    `bounds [G, 8]` f32 (member-mean centre, squared radius over the member
    surfaces widened by 2 eps), both C-contiguous."""

    def __init__(self, rows, centers, radii, eps):
        n = len(rows)
        lo = centers.min(axis=0)
        span = np.maximum(centers.max(axis=0) - lo, 1e-12)
        qc = np.clip(((centers - lo) / span) * 1023.0, 0, 1023).astype(
            np.uint32)
        order = np.argsort(_morton3(qc[:, 0], qc[:, 1], qc[:, 2]),
                           kind="stable")
        self.rows = np.asarray(rows, np.int32)[order]
        c = centers[order]
        r = radii[order]
        G = -(-n // LB)
        pad = G * LB - n
        if pad:
            c = np.concatenate([c, np.zeros((pad, 3))])
            r = np.concatenate([r, np.zeros(pad)])
        # dead pad lanes: r2 = -1 makes disc = s^2 - (|pp|^2 + 1) < 0
        r2 = r * r
        r2[n:] = -1.0
        # block bounds: center = member mean, radius covers member sphere
        # SURFACES (dead lanes excluded via weight)
        alive = np.zeros(G * LB)
        alive[:n] = 1.0
        cg = c.reshape(G, LB, 3)
        ag = alive.reshape(G, LB)
        w = ag[..., None] / np.maximum(ag.sum(1)[:, None, None], 1)
        bc = (cg * w).sum(axis=1)                        # [G,3]
        dist = np.linalg.norm(cg - bc[:, None, :], axis=-1) \
            + r.reshape(G, LB)
        br = (dist * ag).max(axis=1)                     # [G]
        self.n = n
        self.G = G
        tab = np.zeros((G, 8, LB), np.float32)
        tab[:, 0] = c[:, 0].reshape(G, LB)
        tab[:, 1] = c[:, 1].reshape(G, LB)
        tab[:, 2] = c[:, 2].reshape(G, LB)
        tab[:, 3] = r2.reshape(G, LB)
        self.table = np.ascontiguousarray(tab)
        bounds = np.zeros((G, 8), np.float32)
        bounds[:, 0:3] = bc
        # cull margin: the eps back-off means a hit at t-eps can sit just
        # outside the bound; widen by eps
        bounds[:, 3] = (br + 2.0 * eps) ** 2
        self.bounds = np.ascontiguousarray(bounds)
        self.eps = np.float32(eps)

    def upload(self, device):
        """(table, bounds) as tensors on `device`, the kernels' layout."""
        return (torch.as_tensor(self.table, device=device),
                torch.as_tensor(self.bounds, device=device))


# ---------------------------------------------------------------------------
# plain versions: the kernels' math on [rays, 128 lanes] tensors


class _Work:
    """Counts of the work the plain versions do (chip_smoke.py turns them
    into the kernels' operation bound): per-ray block tests, blocks
    evaluated (a ray that passes a block's test), live sphere lanes of
    those blocks, and K6's merges (a block whose best beats the ray's
    second best)."""

    def __init__(self):
        self.culls = 0
        self.blocks = 0
        self.lanes = 0
        self.merges = 0


def _sphere_cands(p, d, blk, eps):
    """[n, 128] sphere first-hit candidates of one block (the Pallas
    `_sphere_cands`, pallas_bigscene.py:111-138, in its order of
    operations): entry when outside and approaching, exit when inside,
    eps-backed, INF on a miss."""
    cx, cy, cz, r2 = (blk[k][None, :] for k in range(4))
    px, py, pz = (p[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    ppx = px - cx
    ppy = py - cy
    ppz = pz - cz
    # each multiply-add rounded once, as XLA's compiled CPU code rounds
    # the Pallas helper: fma(z, dz, fma(x, dx, y dy)), then fma(s, s, -q)
    s = _fma32(ppz, dz, _fma32(ppx, dx, ppy * dy))
    q = _fma32(ppz, ppz, _fma32(ppx, ppx, ppy * ppy)) - r2
    disc = _disc(s, q)
    ok = disc >= 0
    root = torch.sqrt(torch.where(ok, disc, 0.0))
    ta = -s - root
    tb = -s + root
    # cancellation-stable small root (tracer._roots with A = |d|^2 = 1)
    tb_nz = torch.abs(tb) > 0
    ta_nz = torch.abs(ta) > 0
    t0 = torch.where(s < 0,
                     torch.where(tb_nz, q / torch.where(tb_nz, tb, 1.0), ta),
                     ta)
    t1 = torch.where(s > 0,
                     torch.where(ta_nz, q / torch.where(ta_nz, ta, 1.0), tb),
                     tb)
    entering = (s < 0) & (q > 0)
    exiting = (s < 0) | (q < 0)
    a = torch.where(entering, t0, torch.where(exiting, t1, INF))
    return torch.where(ok, a - eps, INF)


def _cull(bounds, g, p, d, lim=None):
    """Rays [n] whose path may touch block g's bound (the Pallas
    `_env_hit`, pallas_bigscene.py:141-156: s on CENTER minus ORIGIN, so
    forward is s > 0).  With lim (any-hit), only rays whose entry into the
    bound lies within their limit (pallas_bigscene.py:276-291)."""
    bcx, bcy, bcz, br2 = (float(x) for x in bounds[g, :4])
    ex = bcx - p[:, 0]
    ey = bcy - p[:, 1]
    ez = bcz - p[:, 2]
    s = _fma32(ez, d[:, 2], _fma32(ex, d[:, 0], ey * d[:, 1]))
    q = _fma32(ez, ez, _fma32(ex, ex, ey * ey)) - br2
    disc = _disc(s, q)
    hit = (disc >= 0) & ((s > 0) | (q < 0))
    if lim is None:
        return hit
    te = torch.clamp(s - torch.sqrt(torch.where(disc >= 0, disc, 0.0)),
                     min=0.0)
    return hit & (te <= lim)


def big_top2_plain(blocks: SphereBlocks, p, d, work=None, table=None):
    """Plain version of K6: (t [N, 2] eps-backed, gidx [N, 2] int32).  Per
    block that a ray does not cull: the block's best and second-best
    lanes (first lane on ties); where the best beats the ray's second best,
    the Pallas merge formulas (pallas_bigscene.py:203-214).  A miss keeps
    t = INF and gidx 0.  `table` is the block table on p's device (the
    tracer's cached upload), made here when None."""
    N, dev = p.shape[0], p.device
    if table is None:
        table, _ = blocks.upload(dev)
    eps = float(blocks.eps)
    t1 = torch.full((N,), INF, dtype=torch.float32, device=dev)
    t2 = t1.clone()
    i1 = torch.zeros((N,), dtype=torch.int32, device=dev)
    i2 = i1.clone()
    for g in range(blocks.G):
        keep = _cull(blocks.bounds, g, p, d)
        idx = torch.nonzero(keep).squeeze(1)
        if work is not None:
            work.culls += N
            work.blocks += idx.numel()
            work.lanes += idx.numel() * min(LB, blocks.n - g * LB)
        if idx.numel() == 0:
            continue
        cand = _sphere_cands(p[idx], d[idx], table[g], eps)
        b1, bi1 = torch.min(cand, dim=1)
        b2, bi2 = torch.min(cand.scatter(1, bi1[:, None], INF), dim=1)
        o1, o2, j1, j2 = t1[idx], t2[idx], i1[idx], i2[idx]
        # the Pallas tile gate any(b1 < t2), made per ray
        upd = b1 < o2
        if work is not None:
            work.merges += int(upd.sum())
        gi1 = (g * LB + bi1).to(torch.int32)
        gi2 = (g * LB + bi2).to(torch.int32)
        hi_t = torch.maximum(o1, b1)
        hi_i = torch.where(b1 < o1, j1, gi1)
        w2 = torch.minimum(o2, b2)
        w2i = torch.where(b2 < o2, gi2, j2)
        t1[idx] = torch.where(upd, torch.minimum(o1, b1), o1)
        i1[idx] = torch.where(upd, torch.where(b1 < o1, gi1, j1), j1)
        t2[idx] = torch.where(upd, torch.minimum(hi_t, w2), o2)
        i2[idx] = torch.where(upd, torch.where(hi_t <= w2, hi_i, w2i), j2)
    return torch.stack([t1, t2], dim=1), torch.stack([i1, i2], dim=1)


def big_anyhit_plain(blocks: SphereBlocks, p, d, limit, work=None,
                     table=None):
    """Plain version of K7: blocked [N] bool, any sphere candidate within
    (0, limit] (a limit that is not finite reads as 3e38).  A ray stops at
    the block of its first hit; a block counts for a ray only where its
    bound entry lies within the ray's limit."""
    N, dev = p.shape[0], p.device
    if table is None:
        table, _ = blocks.upload(dev)
    eps = float(blocks.eps)
    lim = torch.where(torch.isfinite(limit), limit,
                      torch.full_like(limit, F32_BIG))
    blocked = torch.zeros((N,), dtype=torch.bool, device=dev)
    for g in range(blocks.G):
        open_ = ~blocked
        keep = open_ & _cull(blocks.bounds, g, p, d, lim)
        idx = torch.nonzero(keep).squeeze(1)
        if work is not None:
            work.culls += int(open_.sum())
            work.blocks += idx.numel()
            work.lanes += idx.numel() * min(LB, blocks.n - g * LB)
        if idx.numel() == 0:
            continue
        cand = _sphere_cands(p[idx], d[idx], table[g], eps)
        blocked[idx] = torch.min(cand, dim=1).values <= lim[idx]
    return blocked


# ---------------------------------------------------------------------------
# the wrappers


def big_top2(tr, p, d):
    """K6 over the tracer's sphere blocks: (t [N, 2] f32, gidx [N, 2]
    int32), gidx indexing `SphereBlocks.rows`.  p, d [N, 3] f32."""
    big = tr._bigscene()
    if p.device.type == "cpu":
        return big_top2_plain(big.blocks, p, d, table=big.table)
    N = p.shape[0]
    kernels._check(p, (N, 3), torch.float32, "p")
    kernels._check(d, (N, 3), torch.float32, "d")
    t = torch.empty((N, 2), dtype=torch.float32, device=p.device)
    gi = torch.empty((N, 2), dtype=torch.int32, device=p.device)
    if N == 0:
        return t, gi
    rc = kernels._lib().actinon_big_top2(
        big.table.data_ptr(), big.bounds.data_ptr(), big.blocks.G,
        p.data_ptr(), d.data_ptr(), t.data_ptr(), gi.data_ptr(), N,
        float(big.blocks.eps), kernels._stream())
    kernels._launched("big_top2", rc)
    return t, gi


def anyhit_design(G: int) -> str:
    """K7's design for a table of G blocks: "warp" or "thread"."""
    return "warp" if G >= ANYHIT_WARP_MIN_BLOCKS else "thread"


def big_anyhit(tr, p, d, limit, design=None):
    """K7 over the tracer's sphere blocks: blocked [N] bool.  p, d [N, 3]
    and limit [N] f32 (a limit that is not finite reads as 3e38 inside the
    kernel).  design: "warp" or "thread", by default `anyhit_design(G)`;
    both give the same booleans."""
    big = tr._bigscene()
    if p.device.type == "cpu":
        return big_anyhit_plain(big.blocks, p, d, limit, table=big.table)
    design = design or anyhit_design(big.blocks.G)
    N = p.shape[0]
    kernels._check(p, (N, 3), torch.float32, "p")
    kernels._check(d, (N, 3), torch.float32, "d")
    kernels._check(limit, (N,), torch.float32, "limit")
    out = torch.empty((N,), dtype=torch.bool, device=p.device)
    if N == 0:
        return out
    rc = kernels._lib().actinon_big_anyhit(
        big.table.data_ptr(), big.bounds.data_ptr(), big.blocks.G,
        p.data_ptr(), d.data_ptr(), limit.data_ptr(), out.data_ptr(), N,
        float(big.blocks.eps), int(design == "warp"), kernels._stream())
    kernels._launched("big_anyhit", rc)
    kernels.LAUNCHES[f"big_anyhit_{design}"] += 1
    return out
