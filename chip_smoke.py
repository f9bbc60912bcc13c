#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check what comes out.

    python3 chip_smoke.py            # every phase, on the first card
    python3 chip_smoke.py --profile  # where the renders' time goes
    python3 chip_smoke.py --ab-bigscene PATH   # K6/K7 against PATH's build

(`--mesh-worker` runs one rank of phase 16's two-rank world, which also
serves phase 17 (e); the script starts those itself.)

Phases, each printing one line of numbers:

  1. card    — torch's device name and nvidia-smi's name and power limit;
  2. build   — nvcc builds csrc/*.cu from this checkout, in one call, and
               one line per kernel of what ptxas reports (registers,
               stack, spills, static shared memory); the "cond" line:
               the check of CUDA-graph conditional nodes
               (render/cond.py `require`: a graph with an IF and a WHILE
               node replayed both ways), with the CUDA driver's and
               runtime's versions;
  3. kernels — each CUDA kernel against its plain PyTorch version on the
               same CUDA tensors (seeded rays over the smoke scene, the
               main path's shapes), with each kernel's device time per
               launch (a CUDA graph of 100 launches between CUDA events)
               and its plain version's time; K2's two designs (a warp a
               ray, a thread a ray) on the same rays, equal on every ray
               and timed in turns ("kernel shadow synthetic");
  4. headline render — the smoke scene at bench.py's headline shape
               (200x150, direct=10, path=0, depth=25, batch 1<<15)
               through render_scene, twice: equal fold hashes that repeat
               GLASS_HASH, and the NEE kernel launched; then K1 against
               its plain version on the inputs of the render's largest NEE
               call, with device time, plain time, the bound and K1's
               launch geometry (the synthetic lanes of phase 3 stay beside
               it), and the lanes outside rel 1e-2 dumped ("nee lane"
               lines: each lane's inputs, both values, and the sample that
               differs most, with its light hit a and dsq per light);
  4b. many-sample render — the smoke scene at 8x6 with 2 lights at
               direct=MANY_DIRECT samples: K1 launched (its samples pass
               the warp's shared slice in chunks), and K1 against its
               plain version on the render's largest NEE call;
  5. shipped-shape render — bench.py's TRUE_CFG shape (80x60,
               direct=200, path=500, depth=25, batch 1<<14);
  6. counter-mode render — seed_mode="counter" at 64x48: the shadow and
               object-hit kernels launched (K2 in both designs: 2 calls of
               40,960 rays and 20 of 5,120), and the image mean agrees
               with the same render with the kernels switched off, and
               with the port's plain render on the CPU at a small size;
               then K2's designs on the render's largest batch and on one
               of its most frequent size ("kernel shadow render_batch",
               "... render_small", with each batch's envelope-gate and
               blocked shares), and both designs on K2_SWEEP's sizes
               ("k2 sweep" lines: SHADOW_WARP_MAX_RAYS);
  7. lamp_row render — the composite-heavy smoke scene lamp_row.acn at
               bench.py's hanging_lamp shape (160x120, direct=6, path=0,
               depth=25, batch 1<<15), twice: equal fold hashes that
               repeat LAMP_HASH, and the scene kernels K4 and K5 launched;
  8. scene kernels — K4 and K5 against their plain versions on the inputs
               of the lamp_row render's largest calls (the drain batch for
               K4, one NEE chunk of flattened shadow rays for K5; the rays
               whose outcome differs, "differ", beside the count with the
               parent's twice-rounded plain arithmetic, "differ_before"), with
               device time, plain time, the bound and K4's and K5's launch
               geometry (threads and rays a thread block, shared bytes);
  9. counter-mode lamp_row — the image mean with the kernels and without
               them agrees within 5e-3, and the card's render agrees with
               the port's plain render on the CPU;
 10. fractal render — the big-scene smoke scene sphere_fractal.acn at
               bench.py's many_spheres shape (160x120, direct=10, path=0,
               depth=11, batch 1<<15), twice: equal fold hashes that
               repeat FRACTAL_HASH, at least 512 big-scene sphere rows, K6
               and K7 launched, K4 launched (the floor and the light), K1,
               K2 and K5 not;
 11. big-scene kernels — K6 and K7 against their plain versions on the
               inputs of the fractal render's largest calls (the drain
               batch for K6, one NEE chunk of flattened shadow rays for K7),
               and K7 again on the lamp_row render's largest K7 call (the
               beads' NEE chunk), with device time, plain time, the bound
               and the launch geometry; K7's two designs (a warp a ray, a
               thread a ray) give the same booleans on both batches and
               are timed in turns, and each render's launches are counted
               under the design its block count chose; then both designs
               on each batch against the first G of its blocks, G in
               K7_SWEEP, in turns ("k7 sweep" lines: which design wins
               where, ANYHIT_WARP_MIN_BLOCKS);
 12. counter-mode fractal — the image mean with the kernels and without
               them on the card (64x48 at the render's samples and depth),
               and the card against the port's plain render on the CPU
               (64x48 at direct=1, depth=3, which costs the CPU about what
               16x12 at the full depth would), each within 5e-3.  The
               image is 64x48 because a grazing hit on a sphere of 20 eps
               can flip between two roundings of one formula: a flipped
               pixel moves a 16x12 mean by up to 8e-3;
 13. ops     — the diagnostic kernels K8 (sin, cos, sqrt, rsqrt, exp) and
               K9 (a / b, a * b + c) through the diag_ops entry point, each
               op's bit-equal share and max ulp against torch's op (sqrt and
               division must be bit-equal), and the einsum check; then each
               op code's time against its own torch call, in turns over
               OP_ROUNDS rounds, with its spread;
 14. diff    — the differentiable renderer (render/diff.py) at bench.py's
               fwd_bwd leg: DiffRenderer.value_and_grad on the smoke scene
               at the headline shape, 8,192 camera samples of
               default_rng(3), balanced selection, 25 bounces, f32: the
               eager call (diff_graphs = False), one warm-up, then the
               median of 3 ("diff value_and_grad": wall seconds, fwd+bwd
               lane-bounces/s = 8,192 x 25 over the median, warm-up, peak
               memory), with no kernel launched (the replay runs the
               plain torch path, as the JAX package turns its Pallas
               kernels off under overrides and AD), a finite loss and
               finite gradients ("diff grad norms"); then the same call
               as the replay of one CUDA graph (render/graphs.py
               DiffGraphs; "diff graph": the warm-up that captures, the
               median of 3 replays and their spread, lane-bounces/s, the
               capture's seconds and pool, the peak memory), its loss and
               gradients bit for bit the eager call's and no kernel
               launched; a fit's traffic on that graph ("diff fit": 3
               calls at new parameter values each, passed as `params`
               and set by set_geom/set_mat, each a replay with no new
               capture, the last of each bit for bit the eager call at
               its values); the same first 256 lanes in f64 on the card (a
               graph call, bit for bit the eager call: "diff graph f64")
               and on the CPU (loss
               within rel 1e-6, each gradient within 1e-5 of its table's
               largest magnitude plus rel 1e-5); central differences in
               f64 on the card, uniform selection, for the sphere lamp's
               radiance and the goblet's outer bowl radius, at
               tests/test_diff.py's tolerances; one edge-aware call on 1,024
               lanes with finite gradients, bit for bit the eager call,
               and any EdgeCoverageWarning;
               the f32 forward lane by lane ("diff c3"): a finite loss and
               no lane at or above 1e3 (ROADMAP C3: far-floor lanes 898
               and 2084 took the NEE's 1e30 cap while the discriminants
               rounded twice), those two lanes printed beside the f64
               plain run on the card;
 15. oracle  — the recursive oracle (render/reference_oracle.py) in f64 on
               the card (the plain path): 12 camera samples of glass_table
               at 8x6, direct=4, depth=8, against run_device on the same
               rays, rtol 1e-6 and atol 1e-9;
 16. sharded — multi-device rendering (parallel/mesh.py): (a) a world of
               one over NCCL at the headline shape, ShardedIntegrator
               bit for bit run_device's image, with K1 launched; (c)
               ShardedDiffRenderer at world size 1 against value_and_grad
               at the fwd_bwd width (loss within 1e-5, gradients rtol
               2e-4 and atol 2e-5, tests/test_mesh.py), both through
               DiffGraphs (the seconds include each capture); (b) two ranks
               sharing the card (this script run twice as
               `--mesh-worker`, gloo over a FileStore, collectives through
               the host, the kernels on cuda:0 in both, killed at
               SHARD_LIMIT_S): __graft_entry__.py's dryrun_multichip shapes
               (draft 32x24, the mixed path drain 16x12, production
               200x150) each within 2e-5 of the single-device drain with
               its queries, the two ranks' images equal, and each
               shape's load balance beside MULTICHIP_r05.json's on 8 TPU
               devices; then ShardedDiffRenderer on the two ranks;
 17. queue   — the primary-queue entry points (RayQueue, run,
               run_device(primary, n), the host drain): (a) at the
               headline shape, run_device on the primaries of the port's
               device-precision raygen bit for bit run_device(None, n,
               pos_xy), through K1; (b) the host drain (device_drain =
               False) at that shape launches K1 and agrees with the device
               drain within tests/test_path_device.py's bounds (mean 1e-5,
               max 1e-2) with its queries, and again in counter mode (K2,
               K3); (c) lamp_row's host drain at LAMP_SHAPE launches K4-K7
               and agrees with its device drain; (d) the path configs of
               test_path_device.py on glass_table at 64x48: the host drain
               (its own path queue) against the mixed device drain; (e)
               phase 16's two ranks on the arbitrary-queue branch at the
               draft shape bit for bit a single run(); each drain's
               seconds, and the "queue c4" line: K4-K7's lanes that differ
               from their plain versions on the batches of phases 8 and
               11, the plain versions with the parent's twice-rounded
               arithmetic -> the once-rounded one (ROADMAP C4);
 18. graph   — the graph drain (render/graphs.py: each stage the replay
               of a CUDA graph whose WHILE node runs its trips, the NEE
               under an IF node, render/cond.py) against the same trips
               run eagerly, on one integrator per cell (GRAPH_CELLS: the
               headline, lamp_row, sphere_fractal, counter mode at 64x48,
               the path 8 config): one eager pass, then a graph pass that
               captures and one that only replays, each bit-equal to the
               eager one with equal trips, queries and launches and at
               most one host read and one graph launch a stage
               (host_reads, graph_launches; slots="while": a stage's
               trips are one WHILE node), with each pass's seconds, the
               captures, their seconds and the memory the allocator
               reserved for their pools; the two ranks of phase
               16 (b) run each shape both ways too ("graph world2"
               lines);
 19. wine_glass — the corpus scene at the headline shape, when the
               directory named by $ACTINON_CORPUS holds wine_glass.acn.

Every render runs the graph drain (`Integrator.drain_graphs`, True on a
card) unless a line says otherwise; the spies that must see every call
of a wrapper (the counter render's K2 calls, the shipped render's K1
calls) run the trips eagerly.

The glass_table phases hold slice 1 still: the headline hash repeats
GLASS_HASH, and no scene or big-scene kernel launches there.  lamp_row
(528 beads) crosses the big-scene gate, so its phases launch K4-K7.
--profile adds, per render, each kernel's launches and device time
(K2 and K7 by design), the device's busy share, the host's
cudaLaunchKernel and cudaGraphLaunch calls a trip (the headline and
lamp_row also with eager trips); the same for each phase-18 cell's
drain on a warm integrator, with graphs and eagerly; K1's device time
over the shipped render's calls, and one diff value_and_grad as a graph
replay ("profile diff") and eagerly ("profile diff eager"): busy share,
the host's cudaLaunchKernel and cudaGraphLaunch calls, device time by
op.
--ab-bigscene PATH builds PATH (another revision's
csrc/bigscene_kernels.cu) beside this checkout's kernels and holds K6
and K7 of the two to each other on the fractal's and lamp_row's render
batches, bit for bit and timed in turns.

Any failure exits non-zero.  The line before the last is one JSON object
with every kernel's numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "actinon_tpu_torch", "_build", "smoke")
SCENE = os.path.join(HERE, "actinon_tpu_torch", "scenes", "glass_table.acn")
LAMP = os.path.join(HERE, "actinon_tpu_torch", "scenes", "lamp_row.acn")
FRACTAL = os.path.join(HERE, "actinon_tpu_torch", "scenes",
                       "sphere_fractal.acn")
CORPUS = os.environ.get("ACTINON_CORPUS", "")   # the .acn corpus directory

HEADLINE = (200, 150, 10, 0, 25)   # bench.py:80 (w, h, direct, path, depth)
SHIPPED = (80, 60, 200, 500, 25)  # bench.py:90 TRUE_CFG, not cut
LAMP_SHAPE = (160, 120, 6, 0, 25)  # bench.py:84 hanging_lamp, not cut
LAMP_COUNTER = (16, 12)            # counter-mode A/B size of lamp_row
FRACTAL_SHAPE = (160, 120, 10, 0, 11)  # bench.py:82 many_spheres, not cut
FRACTAL_AB = (64, 48)              # counter-mode size, kernels vs none
FRACTAL_CPU = (64, 48, 1, 0, 3)    # counter-mode shape, card vs CPU
# the pinned fold hashes on the H100 (re-pinned when the f32 roots came to
# round their discriminants once, ROADMAP C3, and lamp_row's when its
# envelope gates and bound tests did, C4)
GLASS_HASH = 1838053121656986330   # glass_table headline hash on the H100
LAMP_HASH = 10893503699642244067   # lamp_row at LAMP_SHAPE on the H100
FRACTAL_HASH = 1924618234713347685  # sphere_fractal at FRACTAL_SHAPE
MANY_DIRECT = (8, 6, 8000, 0, 25)  # K1 at 2 lights x 8,000 samples

# H100 SXM peaks (NVIDIA's data sheet, 700 W): FP32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations per primitive, counted from csrc/trace_kernels.cu (adds,
# multiplies, divides, square roots and float compares; an FMA counts 2;
# sinf and cosf ~20 each).  The bound charges each only where this run's
# data needs it (see object_ops and nee_ops).
OPS_LEAF = 91          # a quadratic leaf: leaf_quads 71, roots + policy 20
OPS_LIN = 49           # a leaf with no quadratic terms (a plane): linear part
OPS_ENV = 19           # an envelope-sphere test
OPS_SAMPLE = 71        # RNG conversion, cap sample, frame and w of a sample
OPS_EST = 24           # the estimator term of a sample that reaches the light
OPS_ON = 35            # Oren-Nayar weighting of a sample
OPS_LIGHT = 60         # per-light cone and frame setup of a lane

# ... and per unit of work of the scene kernels (csrc/scene_kernels.cu),
# counted by their plain versions on this run's inputs (scene_kernels._Work)
OPS_CULL = 19          # a block-bound test (the limit-aware one: 23)
OPS_GATE = 30          # a member's envelope interval and alive test, and
                       # its compare against the block's best two
OPS_SDF = 53           # an SDF slot's local frame and march set-up
OPS_STEP = 30          # one march step (a torus: 17 for its distance)
OPS_CMP = 1            # one comparator of the sort network
OPS_SWEEP = 2          # one finite crossing of the toggle sweep
OPS_MERGE = 8          # the top-2 merge of one block into a ray's pair

# ... and of the big-scene kernels (csrc/bigscene_kernels.cu), counted by
# their plain versions on this run's inputs (bigscene._Work)
OPS_SPHERE = 33        # a sphere lane's candidate (31) and its compare
                       # against the block's best two (K7: against the
                       # limit, 32 in all)


# K1's contract.  A light whose sampling cone has a cap height 1 - cos_rs
# of at most 64 ulps of 1.0 (2^-18) lies past f32 resolution from the
# lane: r^2 / d^2 ~ 2 cyl, so one ulp of d^2 is about 2^-25 / cyl >= 2^-7
# of r^2, and the light hit's discriminant s^2 - (d^2 - r^2), hence the
# hit near the light's silhouette, dsq = |hit - centre|^2 and rad / dsq,
# carry rounding noise beyond the contract's 1e-2 in both versions (the
# FMA-contracted kernel and the twice-rounded plain version round it
# apart).  K1 holds rel < 1e-2 on >= 99 % of all lanes, and on >= 99.8 %
# of the lanes that see every light resolved.
CYL_F32 = 2.0 ** -18

SCENE_KEYS = ("scene_top2", "scene_anyhit", "big_top2", "big_anyhit")
# the CUDA kernels' symbols (csrc/*.cu), K1-K9
KERNEL_SYMS = ("nee_kernel", "shadow_warp_kernel", "shadow_kernel",
               "object_hit_kernel", "scene_top2_kernel",
               "scene_anyhit_kernel", "big_top2_kernel", "big_anyhit_kernel",
               "big_anyhit_warp_kernel", "diag_kernel")
K7_DESIGNS = ("warp", "thread")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(tag, **kw):
    print(f"{tag}: " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def load_scene(path, w, h, direct, path_s, depth):
    from actinon_tpu_torch.acn.interp import run_file
    cap = []
    run_file(path, render_fn=lambda sc, fn: cap.append(sc.clone()),
             args=["-f"])
    return sized(cap[0], w, h, direct, path_s, depth)


def sized(sc, w, h, direct, path_s, depth):
    """The scene sc (cloned) at another image size and sample counts."""
    sc = sc.clone()
    sc.cfg.image_width, sc.cfg.image_height = w, h
    sc.cfg.direct_samples = direct
    sc.cfg.path_samples = path_s
    sc.cfg.trace_depth = depth
    return sc


def _event_ms(run):
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    run()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def cuda_ms(fn, reps=20, warm=3):
    """CUDA-event time of one call of fn(): one pair of events around
    `reps` back-to-back calls, after warmup, divided by `reps`.  Host
    time between the calls counts (the plain versions are many small
    torch ops, and that is their cost)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    return _event_ms(lambda: [fn() for _ in range(reps)]) / reps


def graph_ms(fns, rounds=1, reps=100):
    """Device time of one launch of each of fns, in turns: `reps` calls
    of each wrapper captured in one CUDA graph, each graph replayed twice
    to warm the card up, then the graphs replayed in turn (fns[0],
    fns[1], ..., fns[0], ...) `rounds` times, each replay between a pair
    of CUDA events and divided by `reps`.  Returns one list of `rounds`
    times per fn.  No host time lies between the launches: a 5 us kernel
    behind a 30 us wrapper still reads 5 us."""
    import torch
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    out = [[] for _ in fns]
    for _ in range(rounds):
        for k, g in enumerate(graphs):
            out[k].append(_event_ms(g.replay) / reps)
    return out


def kernel_ms(fn, reps=100):
    """Device time of one kernel launch (graph_ms, one round)."""
    return graph_ms([fn], reps=reps)[0][0]


# ---------------------------------------------------------------------------
# work counts for the bound: what these inputs need, ray by ray


def leaf_ops(tr, row):
    """A leaf's quadratic and roots; its linear part alone where it has
    no quadratic terms (a plane)."""
    return OPS_LIN if np.all(tr.tables_np[2][row] == 0) else OPS_LEAF


def object_ops(tr, desc, p, d, lim=None):
    """FP32 operations [N] (float64) that one object's first hit needs on
    the rays p, d: the envelope test where the object has one and, only
    where the ray passes it, the leaves' roots and, for a composite, the
    parity walk over the crossing columns that are finite on that ray
    (2 nf^2 + nf compares for nf finite columns).  lim [N]: a shadow
    test's, whose walk takes only the columns with t - eps <= lim (two
    operations each to test)."""
    import torch
    kind, ref = desc
    if kind == "leaf":
        env_c, env_r = tr.tab.env_c[ref], float(tr.tab.env_r[ref])
        has_env = env_r > 0
        work = torch.full((p.shape[0],), float(leaf_ops(tr, ref)),
                          dtype=torch.float64, device=p.device)
    else:
        env_c, env_r = ref.env_c, ref.env_r
        has_env = env_c is not None and env_r > 0
        cross, _, _ = tr._composite_crossings(ref, p, d)
        keep = torch.isfinite(cross)
        if lim is not None:
            keep &= cross - tr.eps <= lim[:, None]
        nf = keep.sum(1).double()
        work = sum(leaf_ops(tr, r) for r in ref.rows) + 2 * nf * nf + nf
        if lim is not None:
            work = work + 2 * cross.shape[1]
    if not has_env:
        return work
    gate = tr._env_gate_one(env_c, env_r, p, d)
    return OPS_ENV + torch.where(gate, work, 0.0)


def shadow_ops(tr, p, d, lim):
    """FP32 operations [N] of a shadow any-hit over the kernel coverage:
    each covered object's first hit and its compare with the limit, a
    composite's walk over the columns within the limit only."""
    import torch
    from actinon_tpu_torch.render import kernels
    cov = kernels.coverage(tr)
    ops = torch.zeros((p.shape[0],), dtype=torch.float64, device=p.device)
    for r in cov.singles:
        ops += object_ops(tr, ("leaf", r), p, d) + 1
    for c in cov.comps:
        ops += object_ops(tr, ("comp", c), p, d, lim) + 2
    return ops


def nee_ops(integ, pos, sd, di, on_b, rv, ns):
    """FP32 operations the NEE kernel's inputs need.  Every lane with
    di > 0 sets up each light and draws its ns samples; a sample that
    leaves the surface (w > 0) needs the light's hit; one that reaches the
    light needs its shadow test, the estimator and, where on_b > 0, the
    Oren-Nayar weight.  The samples are drawn again here, as the kernel
    draws them."""
    import torch
    from actinon_tpu_torch import rng as argn
    from actinon_tpu_torch.render import kernels
    tr, cap, dev = integ.tr, integ.direct_cap, pos.device
    live = di > 0
    take = torch.arange(cap, device=dev)[None, :] \
        < ns[live].long()[:, None]
    lane, j = take.nonzero(as_tuple=True)
    p, sdn = pos[live][lane], sd[live][lane]
    ob, rvs = on_b[live][lane], argn.as_u32(rv)[live][lane]
    n_l = integ.n_lights
    ops = (float(live.sum()) * OPS_LIGHT + lane.numel() * OPS_SAMPLE) * n_l
    for li, oid in enumerate(integ.l_oid):
        d, _ = nee_sample_dirs(integ, p, rvs, li, j)
        up = (d * sdn).sum(-1) > 0
        pu, du = p[up], d[up].contiguous()
        desc = kernels.object_desc(tr, oid)
        ops += float(object_ops(tr, desc, pu, du).sum())
        a = kernels.object_hit_plain(tr, oid, pu, du)
        hit = torch.isfinite(a)
        ops += float(shadow_ops(tr, pu[hit], du[hit], a[hit]).sum())
        ops += int(hit.sum()) * OPS_EST
        ops += int((ob[up][hit] > 0).sum()) * OPS_ON
    return ops


def scene_ops(work, anyhit):
    """FP32 operations of K4 or K5 from the plain version's work counts;
    an analytic slot costs a leaf's roots (OPS_LEAF)."""
    cull = OPS_CULL + (4 if anyhit else 0)
    return (work.culls * cull + work.gates * OPS_GATE
            + work.analytic * OPS_LEAF + work.sdf_setups * OPS_SDF
            + work.steps * OPS_STEP + work.comparators * OPS_CMP
            + work.sweeps * OPS_SWEEP + work.merges * OPS_MERGE)


def big_ops(work, anyhit):
    """FP32 operations of K6 or K7 from the plain version's work counts."""
    cull = OPS_CULL + (4 if anyhit else 0)
    lane = OPS_SPHERE - (1 if anyhit else 0)
    return work.culls * cull + work.lanes * lane + work.merges * OPS_MERGE


def bound(n_bytes, n_ops):
    t_b = n_bytes / PEAK_BYTES
    t_o = n_ops / PEAK_FP32
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------


@contextlib.contextmanager
def twice_rounded():
    """The plain K4-K7 versions with the parent commit's arithmetic
    (before ROADMAP C4): every multiply-add of their envelope and bound
    tests and of the big-scene sphere roots rounded twice, s s - q too
    (the twice-rounded forms of tracer._fma32 and _disc in the two
    modules' names)."""
    from actinon_tpu_torch.render import bigscene, scene_kernels
    mods = (bigscene, scene_kernels)
    saved = [(m._fma32, m._disc) for m in mods]
    for m in mods:
        m._fma32 = lambda a, b, c: a * b + c
        m._disc = lambda s, q: s * s - q
    try:
        yield
    finally:
        for m, (fma, disc) in zip(mods, saved):
            m._fma32, m._disc = fma, disc


def top2_differ(got_t, got_c, want_t, want_c):
    """Rays whose top-2 outcome differs between kernel and plain: a slot
    finite on one side only, or finite on both with another winner."""
    import torch
    fin_g, fin_w = torch.isfinite(got_t), torch.isfinite(want_t)
    bad = (fin_g != fin_w) | (fin_g & fin_w & (got_c != want_c))
    return int(bad.any(1).sum())


def phase_card():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    say("card", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, line


def ptxas_usage(log):
    """{kernel: registers, stack, spill and shared bytes} from the
    `-Xptxas -v` lines of an nvcc log, for the kernels of KERNEL_SYMS."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for|$)", line)
        if m:
            cur = next((k for k in KERNEL_SYMS if k in m.group(1)), None)
            op = re.search(r"diag_kernelILi(\d+)E", m.group(1))
            if cur == "diag_kernel" and op:
                cur = f"diag_kernel<{op[1]}>"   # one instance per op code
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(
                registers=int(m[1]), smem=int(smem[1]) if smem else 0)
    return out


def phase_build():
    from actinon_tpu_torch.render import kernels
    nvcc = subprocess.run([kernels._nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    ver = nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 \
        else "unknown"
    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        path = kernels.build(verbose=True)
    print(log.getvalue(), end="", flush=True)
    kernels._lib()
    say("build", seconds=f"{time.time() - t0:.2f}", nvcc=repr(ver),
        lib=os.path.basename(path))
    for name, u in ptxas_usage(log.getvalue()).items():
        say(f"ptxas {name}", **u)
    # the captured paths' conditional nodes: raises where they fail
    import torch
    from actinon_tpu_torch.render import cond
    t0 = time.time()
    cond.require()
    driver, runtime = cond.versions()
    say("cond", check_s=f"{time.time() - t0:.3f}", driver=driver,
        runtime=runtime, torch=torch.__version__)


def phase_kernels(n_lanes):
    """Each kernel against its plain version at the main path's shapes:
    K1 on n_lanes NEE lanes, K2 and K3 on the n_lanes * direct rays the
    counter-mode NEE flattens one batch into."""
    import torch
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir

    sc = load_scene(SCENE, *HEADLINE)
    tr = Tracer(sir.compile_scene(sc), dtype=np.float32, device="cuda")
    integ = Integrator(tr, batch=n_lanes)
    dev = "cuda"
    rng = np.random.default_rng(2026)
    n_rays = n_lanes * integ.direct_cap
    p = rng.uniform(-5, 5, (n_rays, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2])
    d = rng.normal(0, 1, (n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lim = rng.uniform(0.1, 12.0, n_rays).astype(np.float32)
    pc, dc, lc = (torch.as_tensor(x, device=dev) for x in (p, d, lim))
    out = []

    # K2: shadow any-hit, both designs
    out.append(check_shadow("synthetic", tr, pc, dc, lc))

    # K3: object hit, on the lamp that is not a single sphere
    oid = next(o for o, ex in zip(integ.l_oid, integ.l_sphere_exact)
               if not ex)
    target = torch.as_tensor(integ.l_pos[integ.l_oid.index(oid)], device=dev)
    half = n_rays // 2
    aim = target - pc[:half]
    dc2 = dc.clone()
    dc2[:half] = aim / torch.linalg.norm(aim, dim=-1, keepdim=True)
    got = kernels.object_hit(tr, oid, pc, dc2)
    torch.cuda.synchronize()
    want = kernels.object_hit_plain(tr, oid, pc, dc2)
    fin_w, fin_g = torch.isfinite(want), torch.isfinite(got)
    fin_agree = float((fin_w == fin_g).float().mean())
    both = fin_w & fin_g
    err = torch.abs(got[both] - want[both])
    max_err = float(err.max()) if both.any() else 0.0
    t_ok = bool((err <= 1e-3 * (1 + want[both])).all())
    if not (fin_agree >= 0.998 and t_ok):
        fail(f"object-hit kernel: finite agreement {fin_agree}, "
             f"t within 1e-3(1+t): {t_ok}")
    ms = kernel_ms(lambda: kernels.object_hit(tr, oid, pc, dc2))
    plain_ms = cuda_ms(lambda: kernels.object_hit_plain(tr, oid, pc, dc2))
    b_ms, b_by = bound(n_rays * (6 * 4 + 4), float(object_ops(
        tr, kernels.object_desc(tr, oid), pc, dc2).sum()))
    say("kernel object_hit", n=n_rays, oid=oid, hits=int(fin_w.sum()),
        finite_agree=f"{fin_agree:.6f}", max_abs_err=f"{max_err:.3e}",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by)
    out.append(dict(name="object_hit", route="cuda",
                    source="actinon_tpu_torch/csrc/trace_kernels.cu",
                    replaces="actinon_tpu/render/pallas_kernels.py:695",
                    max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    agree=fin_agree, n=n_rays))

    # K1: the fused NEE loop, on lanes drawn as tests/test_pallas.py draws
    B = n_lanes
    cap = integ.direct_cap
    pos = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    pos[:, 2] = np.abs(pos[:, 2])
    sd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    di = rng.uniform(0, 1.2, B).astype(np.float32)
    di = np.where(rng.uniform(0, 1, B) > 0.3, di, 0.0).astype(np.float32)
    theta_i = rng.uniform(0, np.pi * 0.999, B).astype(np.float32)
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
    t = lambda x: torch.as_tensor(x, device=dev)
    args = (t(pos), t(sd), t(di), t(np.cos(theta_i)), t(on_a), t(on_b),
            t(prj), t(rv.view(np.int32)).view(torch.uint32),
            t(ns.astype(np.int32)))
    out.append(check_nee("nee", integ, args, "nee_synthetic"))
    ks = {k["name"]: k for k in out}
    ks["shadow_synthetic"] = ks.pop(out[0]["name"])
    return ks


K2_DESIGNS = ("warp", "thread")
K2_ROUNDS = 5   # turns of K2's designs in its timing and sweep
# batch sizes of K2's design sweep: rays spread evenly over a batch, the
# batch tiled past its end
K2_SWEEP = (1024, 2048, 5120, 10240, 20480, 30720, 40960, 81920, 163840,
            327680)


def shadow_shares(tr, p, d, want):
    """Each enveloped composite's gate-pass share over the rays and over
    32-ray groups (a warp of the thread design), and the blocked share."""
    from actinon_tpu_torch.render import kernels
    out = {}
    n32 = p.shape[0] // 32 * 32
    for c in kernels.coverage(tr).comps:
        if c.env_c is None or not c.env_r > 0:
            continue
        g = tr._env_gate_one(c.env_c, c.env_r, p, d)
        out[f"gate_{c.oid}"] = f"{float(g.float().mean()):.4f}"
        out[f"gate_warps_{c.oid}"] = \
            f"{float(g[:n32].view(-1, 32).any(1).float().mean()):.4f}"
    out["blocked"] = f"{float(want.float().mean()):.4f}"
    return out


def check_shadow(tag, tr, p, d, lim):
    """K2 on one batch: both designs against each other (every ray equal)
    and the chosen one against the plain version (>= 99.8 % equal), timed
    in turns over K2_ROUNDS rounds (median, spread), with the batch's
    gate-pass and blocked shares; the JSON entry of the design that the
    batch's size chooses."""
    import torch
    from actinon_tpu_torch.render import kernels
    n = p.shape[0]
    design = kernels.shadow_design(n)
    got = {k: kernels.shadow_any_hit(tr, p, d, lim, design=k)
           for k in K2_DESIGNS}
    torch.cuda.synchronize()
    if not torch.equal(got["warp"], got["thread"]):
        fail(f"shadow ({tag}): the designs differ on "
             f"{int((got['warp'] != got['thread']).sum())} rays")
    want = kernels.shadow_plain(tr, p, d, lim)
    agree = float((got[design] == want).float().mean())
    if not agree >= 0.998:
        fail(f"shadow kernel ({tag}) agreement {agree}")
    times = graph_ms([lambda k=k: kernels.shadow_any_hit(tr, p, d, lim,
                                                         design=k)
                      for k in K2_DESIGNS], rounds=K2_ROUNDS)
    ms = {k: float(np.median(t)) for k, t in zip(K2_DESIGNS, times)}
    spread = {f"spread_{k}": f"{min(t):.4f}-{max(t):.4f}"
              for k, t in zip(K2_DESIGNS, times)}
    plain_ms = cuda_ms(lambda: kernels.shadow_plain(tr, p, d, lim))
    b_ms, b_by = bound(n * (7 * 4 + 1), float(shadow_ops(tr, p, d,
                                                         lim).sum()))
    say(f"kernel shadow {tag}", n=n, agree=f"{agree:.6f}",
        designs_equal=True, **{f"ms_{k}": f"{v:.4f}" for k, v in ms.items()},
        rounds=K2_ROUNDS, **spread, plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b_ms:.6f}", bound_by=b_by,
        **shadow_shares(tr, p, d, want), **kernels.shadow_launch(tr, n))
    return dict(name=f"shadow_any_hit[{tag}, {design}]", route="cuda",
                source="actinon_tpu_torch/csrc/trace_kernels.cu",
                replaces="actinon_tpu/render/pallas_kernels.py:309",
                max_abs_err=float((got[design] != want).float().max()),
                ms=ms[design], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, agree=agree, n=n,
                design=design, batch=(tr, p, d, lim))


def k2_sweep(tag, tr, p, d, lim):
    """K2's designs on n rays of a batch, n in K2_SWEEP (rays spread
    evenly over the batch, so that each n keeps its mix; the batch tiled
    past its end): every ray equal in all, timed in turns over K2_ROUNDS
    rounds (median, spread), beside the design that
    `kernels.shadow_design` picks for n."""
    import torch
    from actinon_tpu_torch.render import kernels
    N = p.shape[0]
    for n in K2_SWEEP:
        k = torch.arange(n, device=p.device)
        idx = k * N // n if n <= N else k % N
        pn, dn, ln = (x[idx].contiguous() for x in (p, d, lim))
        out = {k: kernels.shadow_any_hit(tr, pn, dn, ln, design=k)
               for k in K2_DESIGNS}
        torch.cuda.synchronize()
        if not torch.equal(out["warp"], out["thread"]):
            fail(f"k2 sweep {tag} n={n}: the designs differ")
        times = graph_ms([lambda k=k: kernels.shadow_any_hit(
            tr, pn, dn, ln, design=k) for k in K2_DESIGNS],
            rounds=K2_ROUNDS)
        ms = {k: float(np.median(t)) for k, t in zip(K2_DESIGNS, times)}
        say(f"k2 sweep {tag} n={n}", blocked=int(out["warp"].sum()),
            **{f"ms_{k}": f"{ms[k]:.4f}" for k in K2_DESIGNS},
            **{f"spread_{k}": f"{min(t):.4f}-{max(t):.4f}"
               for k, t in zip(K2_DESIGNS, times)},
            faster=min(K2_DESIGNS, key=ms.get),
            chosen=kernels.shadow_design(n))


def check_nee(tag, integ, args, name="nee", dump=False):
    """K1 against its plain version on the NEE inputs args: radiance
    within rel 1e-2 on >= 99 % of lanes, and on >= 99.8 % of the lanes
    that see every light resolved in f32 (CYL_F32); its device time, its
    plain version's time and its bound on these inputs.  dump: print the
    lanes outside rel 1e-2 (nee_dump)."""
    import torch
    from actinon_tpu_torch.render import kernels
    got = kernels.nee(integ, *args)
    torch.cuda.synchronize()
    want = kernels.nee_plain(integ, *args)
    rel = torch.abs(got - want) / (torch.abs(want) + 1e-4)
    ok = rel.max(dim=1).values < 1e-2
    frac = float(ok.float().mean())
    max_err = float(torch.abs(got - want).max())
    # the narrowest light cone of each lane, and the lanes that see every
    # light resolved in f32 (CYL_F32)
    cyl_min = torch.stack([light_cone(integ, args[0], li)[1]
                           for li in range(integ.n_lights)], 1).min(1).values
    resolved = cyl_min > CYL_F32
    frac_resolved = float(ok[resolved].float().mean())
    if dump:
        nee_dump(integ, args, got, want, ~ok, cyl_min)
    if not (frac >= 0.99 and frac_resolved >= 0.998):
        fail(f"NEE kernel ({tag}): {frac} of lanes within rel 1e-2, "
             f"{frac_resolved} of the lanes whose lights are resolved")
    ms = kernel_ms(lambda: kernels.nee(integ, *args))
    plain_ms = cuda_ms(lambda: kernels.nee_plain(integ, *args), warm=1)
    B = args[0].shape[0]
    live = args[2] > 0
    b_ms, b_by = bound(B * (15 * 4 + 3 * 4),
                       nee_ops(integ, args[0], args[1], args[2], args[5],
                               args[7], args[8]))
    say(f"kernel {tag}", lanes=B, live=int(live.sum()),
        samples=int(args[8][live].sum()), lanes_agree=f"{frac:.6f}",
        lanes_resolved=int(resolved.sum()),
        lanes_agree_resolved=f"{frac_resolved:.6f}",
        max_abs_err=f"{max_err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.6f}", bound_by=b_by,
        **kernels.nee_launch(integ))
    return dict(name=name, route="cuda",
                source="actinon_tpu_torch/csrc/trace_kernels.cu",
                replaces="actinon_tpu/render/pallas_kernels.py:467",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, agree=frac, n=B)


def light_cone(integ, pos, li):
    """(cone axis [n, 3], cap height cyl [n]) of light li seen from pos
    [n, 3], as the kernel's light_frame computes them."""
    import torch
    as32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                     device=pos.device)
    if integ.l_fov[li] == "plane":
        fov = (-as32(integ.l_plane_n[li])).expand(pos.shape)
        cyl = torch.where(((as32(integ.l_pos[li]) - pos) * fov).sum(-1) > 0,
                          1.0, 0.0)
        return fov, cyl
    diff = as32(integ.l_cone_pos[li]) - pos
    dist2 = (diff * diff).sum(-1)
    r2 = float(np.float32(integ.l_radius[li]) ** 2)
    cyl = 1.0 - torch.where(dist2 > r2, torch.sqrt(torch.clamp(
        1.0 - r2 / dist2, min=0.0)), -1.0)
    return diff / torch.sqrt(dist2)[:, None], cyl


def nee_sample_dirs(integ, pos, rv, li, j):
    """(direction [n, 3], cap height [n]) of sample j [n] of light li
    from pos [n, 3] with stream ids rv [n], as the kernel draws it: the
    cap sample of counters 4 (li cap + j) in the con_z frame of the
    light's cone axis."""
    from actinon_tpu_torch import math3d as m3
    from actinon_tpu_torch import rng as argn
    from actinon_tpu_torch.render.integrator import _frame_apply
    fov, cyl = light_cone(integ, pos, li)
    ctr = 4 * (li * integ.direct_cap + j)
    local = m3.sphere_cap_sample(argn.uniform(rv, ctr),
                                 argn.uniform(rv, ctr + 1), cyl)
    return _frame_apply(m3.transposed(m3.con_z(fov)),
                        local[:, None, :])[:, 0], cyl


ULP1 = 2.0 ** -24   # the spacing of f32 just below 1.0


def nee_dump(integ, args, got, want, bad, cyl_min, show=12):
    """The lanes where K1 and its plain version differ by rel 1e-2 or
    more.  Each sum's prefix over the first k samples (k = 1 .. ns,
    through the wrappers) gives both versions' per-sample terms; a sample
    whose term is 0 in one and not in the other is a visibility flip (w,
    the light hit or the shadow test decided apart), one whose terms
    differ otherwise a value difference.  One "nee dump" summary line
    (bad lanes by the narrowest light cone's cap height in ulps of 1.0,
    cyl_min / ULP1, and by class), one "nee lane" line per bad lane
    (largest error first: di, ns, both values, the cone in ulps, its
    flips and value differences, the sample that differs most and both
    its terms) and, for the `show` largest, per light at that sample the
    direction's w = d . n, the light hit a, dsq = |hit - light
    position|^2 and whether the plain shadow test blocks it."""
    import torch
    from actinon_tpu_torch import rng as argn
    from actinon_tpu_torch.render import kernels
    tr = integ.tr
    err = torch.abs(got - want).max(dim=1).values
    live = args[2] > 0
    idx = torch.nonzero(bad).squeeze(1)
    idx = idx[torch.argsort(err[idx], descending=True)]
    ulps = cyl_min / ULP1
    buckets = {"le4": ulps <= 4, "le64": (ulps > 4) & (ulps <= 64),
               "le1024": (ulps > 64) & (ulps <= 1024), "gt1024": ulps > 1024}
    summary = dict(lanes=int(bad.sum()), of=bad.numel(),
                   live_lanes=int(live.sum()),
                   bad_dead=int((bad & ~live).sum()),
                   kernel_nonfinite=int((~torch.isfinite(got[bad])).any(1)
                                        .sum()),
                   plain_nonfinite=int((~torch.isfinite(want[bad])).any(1)
                                       .sum()),
                   max_abs_err=f"{float(err.max()):.3e}")
    for k, m in buckets.items():
        summary[f"cone_ulps_{k}"] = f"{int((bad & m).sum())}/{int(m.sum())}"
    if idx.numel() == 0:
        say("nee dump", **summary)
        return
    # (torch indexes no uint32 tensor on the card: rv goes as int32 bits)
    sub = tuple((a.view(torch.int32)[idx].view(torch.uint32)
                 if a.dtype == torch.uint32 else a[idx]).contiguous()
                for a in args)
    ns = sub[8].long()
    # prefix sums: lum at ns' = min(ns, k) times ns' is sum_l color_l
    # 2 cyl_l acc_l(k); successive differences are the k-th terms
    pre = {"kernel": [], "plain": []}
    for k in range(1, int(ns.max()) + 1):
        nk = torch.clamp(ns, max=k).to(torch.int32)
        a = sub[:8] + (nk,)
        pre["kernel"].append(kernels.nee(integ, *a) * nk[:, None])
        pre["plain"].append(kernels.nee_plain(integ, *a) * nk[:, None])
    terms = {}
    for side, xs in pre.items():
        cum = torch.stack(xs, 1)                          # [n, k, 3]
        terms[side] = torch.diff(cum, dim=1, prepend=torch.zeros_like(
            cum[:, :1])).sum(-1)                          # [n, k]
    tk, tp = terms["kernel"], terms["plain"]
    in_ns = torch.arange(tk.shape[1], device=tk.device)[None] < ns[:, None]
    flip = in_ns & ((tk == 0) != (tp == 0))
    value = in_ns & ~flip & (torch.abs(tk - tp) > 1e-2 * torch.abs(tp))
    summary.update(lanes_with_flip=int(flip.any(1).sum()),
                   lanes_value_only=int((value.any(1) & ~flip.any(1)).sum()),
                   lanes_neither=int((~value.any(1) & ~flip.any(1)).sum()))
    # the same estimator in f64 on the CPU arbitrates: which side lies
    # nearer, by the contract's measure
    ref = nee_f64(integ, sub).to(got.device)
    rel = lambda x: (torch.abs(x - ref) / (torch.abs(ref) + 1e-4)).max(1)
    e_k, e_p = rel(got[idx]).values, rel(want[idx]).values
    summary.update(kernel_nearer_f64=int((e_k < e_p).sum()),
                   plain_nearer_f64=int((e_p < e_k).sum()),
                   kernel_within_1e2_of_f64=int((e_k < 1e-2).sum()),
                   plain_within_1e2_of_f64=int((e_p < 1e-2).sum()))
    say("nee dump", **summary)
    j = torch.argmax(torch.abs(tk - tp), dim=1)
    for r in range(idx.numel()):
        say(f"nee lane {int(idx[r])}", di=f"{float(sub[2][r]):.6g}",
            ns=int(ns[r]), kernel=f"{float(got[idx[r]].sum()):.6g}",
            plain=f"{float(want[idx[r]].sum()):.6g}",
            f64=f"{float(ref[r].sum()):.6g}",
            cone_ulps=f"{float(ulps[idx[r]]):.4g}",
            flips=int(flip[r].sum()), values=int(value[r].sum()),
            sample=int(j[r]), term_kernel=f"{float(tk[r, j[r]]):.6g}",
            term_plain=f"{float(tp[r, j[r]]):.6g}")
    top = torch.arange(min(show, idx.numel()), device=j.device)
    rv, pos = argn.as_u32(sub[7])[top], sub[0][top]
    per_light = []
    for li, oid in enumerate(integ.l_oid):
        dvec, cyl = nee_sample_dirs(integ, pos, rv, li, j[top])
        dvec = dvec.contiguous()
        a = kernels.object_hit_plain(tr, oid, pos, dvec)
        a_safe = torch.where(torch.isfinite(a), a, 0.0)
        lpos = torch.as_tensor(np.asarray(integ.l_pos[li], np.float32),
                               device=pos.device)
        dsq = ((pos + dvec * a_safe[:, None] - lpos) ** 2).sum(-1)
        per_light.append(((dvec * sub[1][top]).sum(-1), a, dsq, cyl,
                          tr._shadow_plain(pos, dvec, a_safe)))
    for r in range(top.numel()):
        for li, (w, a, dsq, cyl, blocked) in enumerate(per_light):
            say(f"nee lane {int(idx[r])} light {li}",
                w=f"{float(w[r]):.6g}", a=f"{float(a[r]):.9g}",
                dsq=f"{float(dsq[r]):.6g}", cyl=f"{float(cyl[r]):.6g}",
                blocked=bool(blocked[r]))


def nee_f64(integ, args):
    """The plain NEE of args in f64 on the CPU, over the same scene (its
    f64 tracer's eps is 1e-6 where f32 takes 1e-4: the eps-backed light
    hit moves by 1e-4, far below the contract's 1e-2)."""
    import torch
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    tr = Tracer(integ.tr.ir, dtype=np.float64, device="cpu")
    i64 = Integrator(tr, batch=args[0].shape[0])
    cpu = tuple(a.cpu() if a.dtype in (torch.uint32, torch.int32)
                else a.cpu().double() for a in args)
    return kernels.nee_plain(i64, *cpu).float()


def render(tag, sc, batch, reps=1):
    """render_scene on the card; returns (stats of the last run, img)."""
    import torch
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.driver import render_scene
    os.makedirs(OUT, exist_ok=True)
    hashes, runs = [], []
    for k in range(reps):
        stats = {}
        kernels.reset_launches()
        img = render_scene(sc.clone(), os.path.join(OUT, f"{tag}.pnm"),
                           force=True, dtype=np.float32, batch=batch,
                           verbose=False, device="cuda", stats=stats)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if img.shape != (sc.cfg.image_height, sc.cfg.image_width, 3) \
                or not np.isfinite(img).all():
            fail(f"{tag}: image shape {img.shape} or non-finite values")
        qps = stats["rays_traced"] / stats["seconds"]
        w, h = sc.cfg.image_width, sc.cfg.image_height
        say(f"render {tag}", run=k, size=f"{w}x{h}",
            direct=sc.cfg.direct_samples, path=sc.cfg.path_samples,
            depth=sc.cfg.trace_depth, batch=batch,
            seconds=f"{stats['seconds']:.3f}",
            samples=stats["samples"], trips=stats["trips"],
            rays_traced=stats["rays_traced"], queries_per_s=f"{qps:.4g}",
            hash=stats["hash"], mean=f"{img.mean():.6f}",
            launches=json.dumps(launches, separators=(",", ":")))
        hashes.append(stats["hash"])
        runs.append(dict(stats, launches=launches, mean=float(img.mean()),
                         qps=qps))
    if len(set(hashes)) != 1:
        fail(f"{tag}: fold hashes differ between runs: {hashes}")
    return runs


def counter_render(sc, batch, use_kernels, device="cuda", graphs=True):
    """One pass over pixel centres, seed_mode="counter" (graphs=False:
    the drain's trips run eagerly)."""
    import torch
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    tr = Tracer(sir.compile_scene(sc), dtype=np.float32, device=device)
    tr.use_kernels = use_kernels
    integ = Integrator(tr, batch=batch)
    integ.seed_mode = "counter"
    integ.drain_graphs = integ.drain_graphs and graphs
    pos = pixel_centres(sc.cfg)
    kernels.reset_launches()
    t0 = time.time()
    acc = integ.run_samples(pos)
    if device == "cuda":
        torch.cuda.synchronize()
    return acc, time.time() - t0, dict(kernels.LAUNCHES), integ


def spied_counter(sc, batch):
    """counter_render with the kernels, its K2 calls spied on: the launch
    counts, and the inputs of the first call of each batch size (cloned),
    with the sizes of all the calls in order.  Its drain runs eagerly: a
    captured trip calls the wrappers only at its capture."""
    from actinon_tpu_torch.render import kernels
    orig = kernels.shadow_any_hit
    cap, sizes = {}, []

    def spy(tr, p, d, limit, design=None):
        n = p.shape[0]
        sizes.append(n)
        if n not in cap:
            cap[n] = (tr, p.clone(), d.clone(), limit.clone())
        return orig(tr, p, d, limit, design)

    kernels.shadow_any_hit = spy
    try:
        run = counter_render(sc, batch, True, graphs=False)
    finally:
        kernels.shadow_any_hit = orig
    return run, cap, sizes


def phase_counter(w, h):
    """The counter-mode render (K2 and K3 on its NEE), kernels against no
    kernels, and the card against the CPU; returns its launch counts and
    its K2 calls' inputs (spied_counter)."""
    sc = load_scene(SCENE, w, h, *HEADLINE[2:])
    (acc_k, s_k, launches, integ), k2_cap, k2_sizes = spied_counter(
        sc, 1 << 15)
    if launches["shadow"] <= 0 or launches["object_hit"] <= 0 \
            or any(launches[k] for k in SCENE_KEYS):
        fail(f"counter-mode render launched {launches}")
    sizes = {n: k2_sizes.count(n) for n in sorted(set(k2_sizes))}
    say("render counter k2 calls", calls=len(k2_sizes),
        rays=sum(k2_sizes), sizes=json.dumps(sizes, separators=(",", ":")))
    acc_p, s_p, off, _ = counter_render(sc, 1 << 15, False)
    if any(off.values()):
        fail(f"kernels switched off but launched: {off}")
    m_k, m_p = float(acc_k.mean()), float(acc_p.mean())
    rel = abs(m_k - m_p) / max(abs(m_p), 1e-12)
    if not (np.isfinite(acc_k).all() and rel <= 5e-3):
        fail(f"counter mode: kernel mean {m_k} vs plain {m_p} (rel {rel})")
    say("render counter", size=f"{w}x{h}", kernel_s=f"{s_k:.3f}",
        plain_s=f"{s_p:.3f}", mean_kernels=f"{m_k:.6f}",
        mean_plain=f"{m_p:.6f}", rel=f"{rel:.2e}",
        launches=json.dumps(launches, separators=(",", ":")))
    # the reference on a small input: the port's plain render on the CPU
    small = load_scene(SCENE, 24, 18, *HEADLINE[2:])
    acc_c, _, _, _ = counter_render(small, 1 << 12, True, device="cpu")
    acc_g, _, _, _ = counter_render(small, 1 << 12, True)
    m_c, m_g = float(acc_c.mean()), float(acc_g.mean())
    rel_c = abs(m_g - m_c) / max(abs(m_c), 1e-12)
    if not rel_c <= 5e-3:
        fail(f"card vs CPU reference: mean {m_g} vs {m_c} (rel {rel_c})")
    say("reference cpu", size="24x18", mean_card=f"{m_g:.6f}",
        mean_cpu=f"{m_c:.6f}", rel=f"{rel_c:.2e}")
    return launches, k2_cap, k2_sizes


@contextlib.contextmanager
def eager_drains():
    """render_scene's drains run their trips eagerly (drain_graphs =
    False), for spies that must see every wrapper call: a captured trip
    calls the wrappers only at its capture."""
    from actinon_tpu_torch.render import driver
    from actinon_tpu_torch.render.integrator import Integrator

    class Eager(Integrator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.drain_graphs = False

    driver.Integrator = Eager
    try:
        yield
    finally:
        driver.Integrator = Integrator


def spied_render(spies, tag, sc, reps, batch=1 << 15):
    """render() with the wrappers spied on: spies is a list of (module,
    names); the inputs of each wrapper's largest call are kept (cloned
    once) for the kernel phases, the shapes and rays the main path gives
    them.  A wrapper's first argument is the tracer or integrator, then
    its tensors.  The renders run the graph drain: the largest call of a
    wrapper comes in the first trip of the first stage, which runs
    eagerly before its capture."""
    cap = {}
    orig = {(m, n): getattr(m, n) for m, names in spies for n in names}

    def spy(key):
        name = key[1]

        def call(tr, p, d, *x):
            if name not in cap or p.shape[0] > cap[name][1].shape[0]:
                cap[name] = (tr, p.clone(), d.clone(),
                             *(v.clone() for v in x))
            return orig[key](tr, p, d, *x)
        return call

    for key in orig:
        setattr(key[0], key[1], spy(key))
    try:
        runs = render(tag, sc, batch, reps=reps)
    finally:
        for (m, n), fn in orig.items():
            setattr(m, n, fn)
    return runs, cap


def phase_lamp():
    """The lamp_row render at the hanging_lamp shape, twice, keeping the
    inputs of the largest K4, K5 and K7 calls.  Its 528 beads cross the
    big-scene gate: K6 and K7 launch beside K4 and K5."""
    from actinon_tpu_torch.render import bigscene
    from actinon_tpu_torch.render import scene_kernels as sk
    runs, cap = spied_render([(sk, ("scene_top2", "scene_anyhit")),
                              (bigscene, ("big_anyhit",))], "lamp_row",
                             load_scene(LAMP, *LAMP_SHAPE), reps=2)
    launches = runs[-1]["launches"]
    if min(launches[k] for k in ("scene_top2", "scene_anyhit", "big_top2",
                                 "big_anyhit")) <= 0:
        fail(f"lamp_row render launched {launches}")
    if int(runs[-1]["hash"]) != LAMP_HASH:
        fail(f"lamp_row hash {runs[-1]['hash']} (want {LAMP_HASH})")
    return runs, cap


def phase_scene_kernels(cap):
    """K4 and K5 against their plain versions on the lamp_row render's
    inputs.  The plain versions also count the work the bound charges."""
    import torch
    from actinon_tpu_torch.render import scene_kernels as sk
    out = {}

    tr, p, d, lm = cap["scene_top2"]
    st, stm = tr._scene_tables()
    n = p.shape[0]
    got_t, got_c = sk.scene_top2(tr, p, d, lm)
    torch.cuda.synchronize()
    work = sk._Work()
    want_t, want_c = sk.scene_top2_plain(st, p, d, lm, work=work)
    differ = top2_differ(got_t, got_c, want_t, want_c)
    with twice_rounded():
        differ_before = top2_differ(got_t, got_c,
                                    *sk.scene_top2_plain(st, p, d, lm))
    fin_g, fin_w = torch.isfinite(got_t), torch.isfinite(want_t)
    fin_agree = float((fin_g == fin_w).float().mean())
    both = fin_g & fin_w
    code_agree = float((got_c[both] == want_c[both]).float().mean())
    # t where the winners agree: a different winner is a near-tie
    same = both & (got_c == want_c)
    err = torch.abs(got_t[same] - want_t[same])
    max_err = float(err.max()) if same.any() else 0.0
    t_ok = bool((err <= 2e-4 + 2e-4 * torch.abs(want_t[same])).all())
    if not (fin_agree >= 0.998 and code_agree >= 0.99 and t_ok):
        fail(f"scene top-2 kernel: finite agreement {fin_agree}, codes "
             f"{code_agree}, t within 2e-4: {t_ok}")
    ms = kernel_ms(lambda: sk.scene_top2(tr, p, d, lm))
    plain_ms = cuda_ms(lambda: sk.scene_top2_plain(st, p, d, lm), reps=1,
                       warm=0)
    tables = st.table.nbytes + st.bounds.nbytes + 4 * st.desc_t.numel()
    b_ms, b_by = bound(n * (7 * 4 + 2 * 8) + tables,
                       scene_ops(work, anyhit=False))
    say("kernel scene_top2", n=n, hits=int(fin_w[:, 0].sum()),
        finite_agree=f"{fin_agree:.6f}", codes_agree=f"{code_agree:.6f}",
        max_abs_err=f"{max_err:.3e}", differ=differ,
        differ_before=differ_before, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.5f}", bound_by=b_by,
        steps=work.steps, sweeps=work.sweeps, **sk.top2_launch(st))
    out["scene_top2"] = dict(
        name="scene_top2", route="cuda",
        source="actinon_tpu_torch/csrc/scene_kernels.cu",
        replaces="actinon_tpu/render/pallas_scene.py:831",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, agree=code_agree, n=n,
        differ=differ, differ_before=differ_before)

    tr, p, d, lim = cap["scene_anyhit"]
    n = p.shape[0]
    got = sk.scene_anyhit(tr, p, d, lim)
    torch.cuda.synchronize()
    work = sk._Work()
    want = sk.scene_anyhit_plain(stm, p, d, lim, work=work)
    differ = int((got != want).sum())
    with twice_rounded():
        differ_before = int((got != sk.scene_anyhit_plain(
            stm, p, d, lim)).sum())
    agree = float((got == want).float().mean())
    if not agree >= 0.998:
        fail(f"scene any-hit kernel agreement {agree}")
    ms = kernel_ms(lambda: sk.scene_anyhit(tr, p, d, lim))
    plain_ms = cuda_ms(lambda: sk.scene_anyhit_plain(stm, p, d, lim),
                       reps=1, warm=0)
    tables = stm.table.nbytes + stm.bounds.nbytes + 4 * stm.desc_t.numel()
    b_ms, b_by = bound(n * (7 * 4 + 1) + tables, scene_ops(work, True))
    say("kernel scene_anyhit", n=n, blocked=int(want.sum()),
        agree=f"{agree:.6f}", differ=differ, differ_before=differ_before,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, steps=work.steps,
        **sk.anyhit_launch(stm))
    out["scene_anyhit"] = dict(
        name="scene_anyhit", route="cuda",
        source="actinon_tpu_torch/csrc/scene_kernels.cu",
        replaces="actinon_tpu/render/pallas_scene.py:892",
        max_abs_err=float((got != want).float().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        agree=agree, n=n, differ=differ, differ_before=differ_before)
    return out


def phase_lamp_counter(w, h):
    """Counter-mode lamp_row: kernels against no kernels on the card, and
    the card against the port's plain render on the CPU."""
    sc = load_scene(LAMP, w, h, *LAMP_SHAPE[2:])
    acc_k, s_k, launches, _ = counter_render(sc, 1 << 15, True)
    if min(launches[k] for k in ("scene_top2", "scene_anyhit", "big_top2",
                                 "big_anyhit")) <= 0:
        fail(f"counter-mode lamp_row launched {launches}")
    acc_p, s_p, off, _ = counter_render(sc, 1 << 15, False)
    if any(off.values()):
        fail(f"kernels switched off but launched: {off}")
    acc_c, s_c, _, _ = counter_render(sc, 1 << 12, True, device="cpu")
    m_k, m_p, m_c = (float(a.mean()) for a in (acc_k, acc_p, acc_c))
    rel = abs(m_k - m_p) / max(abs(m_p), 1e-12)
    rel_c = abs(m_k - m_c) / max(abs(m_c), 1e-12)
    if not (np.isfinite(acc_k).all() and rel <= 5e-3 and rel_c <= 5e-3):
        fail(f"counter-mode lamp_row: kernels {m_k}, plain {m_p} (rel "
             f"{rel}), CPU {m_c} (rel {rel_c})")
    say("render lamp_row counter", size=f"{w}x{h}", kernel_s=f"{s_k:.3f}",
        plain_s=f"{s_p:.3f}", cpu_s=f"{s_c:.3f}", mean_kernels=f"{m_k:.6f}",
        mean_plain=f"{m_p:.6f}", mean_cpu=f"{m_c:.6f}", rel=f"{rel:.2e}",
        rel_cpu=f"{rel_c:.2e}",
        launches=json.dumps(launches, separators=(",", ":")))


def k7_launches(entry, runs, tag):
    """K7's launches in a render, counted under the design its JSON entry
    names (the one its block count chose); the other design must not have
    launched there."""
    L = runs[-1]["launches"]
    design = entry["design"]
    other = next(k for k in K7_DESIGNS if k != design)
    entry["launches"] = L[f"big_anyhit_{design}"]
    if entry["launches"] <= 0 or L[f"big_anyhit_{other}"] \
            or entry["launches"] != L["big_anyhit"]:
        fail(f"{tag}: K7 launched {L}, want the {design} design only")


def phase_many_samples():
    """The smoke scene at 8x6 with 2 lights at MANY_DIRECT's samples
    (n_lights x direct = 16,000: whole per-lane sample slices would not
    fit a thread block's shared memory): the render goes through K1, and
    K1 meets its contract on the render's largest NEE call."""
    from actinon_tpu_torch.render import kernels
    runs, cap = spied_render([(kernels, ("nee",))], "many_samples",
                             load_scene(SCENE, *MANY_DIRECT), reps=1,
                             batch=1 << 12)
    L = runs[-1]["launches"]
    integ, *args = cap.pop("nee")
    if L["nee"] <= 0 or integ.n_lights != 2:
        fail(f"many-sample render: {integ.n_lights} lights, launched {L}")
    check_nee("nee many_samples", integ, tuple(args))


def phase_fractal(base):
    """The fractal render at the many_spheres shape, twice, keeping the
    inputs of the largest K6 and K7 calls."""
    from actinon_tpu_torch.render import bigscene
    runs, cap = spied_render([(bigscene, ("big_top2", "big_anyhit"))],
                             "sphere_fractal", sized(base, *FRACTAL_SHAPE),
                             reps=2)
    L = runs[-1]["launches"]
    if L["big_top2"] <= 0 or L["big_anyhit"] <= 0 or L["scene_top2"] <= 0 \
            or L["nee"] or L["shadow"] or L["scene_anyhit"]:
        fail(f"sphere_fractal render launched {L}")
    if int(runs[-1]["hash"]) != FRACTAL_HASH:
        fail(f"sphere_fractal hash {runs[-1]['hash']} (want {FRACTAL_HASH})")
    tr = cap["big_top2"][0]
    n_big = len(tr.big_rows)
    if n_big < tr.BIG_MIN_ROWS:
        fail(f"sphere_fractal has {n_big} big-scene rows")
    say("fractal", big_rows=n_big, leaves=len(tr.tab))
    return runs, cap


def phase_big_kernels(cap):
    """K6 and K7 against their plain versions on the fractal render's
    inputs.  The plain versions also count the work the bound charges."""
    import torch
    from actinon_tpu_torch.render import bigscene as bs
    out = {}

    tr, p, d = cap["big_top2"]
    big = tr._bigscene()
    blocks = big.blocks
    n = p.shape[0]
    tables = 4 * blocks.G * bs.LB * 4 + 4 * blocks.G * 4   # the rows read
    got_t, got_g = bs.big_top2(tr, p, d)
    torch.cuda.synchronize()
    work = bs._Work()
    want_t, want_g = bs.big_top2_plain(blocks, p, d, work=work,
                                       table=big.table)
    differ = top2_differ(got_t, got_g, want_t, want_g)
    with twice_rounded():
        differ_before = top2_differ(got_t, got_g, *bs.big_top2_plain(
            blocks, p, d, table=big.table))
    fin_g, fin_w = torch.isfinite(got_t), torch.isfinite(want_t)
    fin_agree = float((fin_g == fin_w).float().mean())
    both = fin_g & fin_w
    idx_agree = float((got_g[both] == want_g[both]).float().mean())
    same = both & (got_g == want_g)
    err = torch.abs(got_t[same] - want_t[same])
    max_err = float(err.max()) if same.any() else 0.0
    t_ok = bool((err <= 2e-4 + 2e-4 * torch.abs(want_t[same])).all())
    if not (fin_agree >= 0.998 and idx_agree >= 0.99 and t_ok):
        fail(f"big top-2 kernel: finite agreement {fin_agree}, indices "
             f"{idx_agree}, t within 2e-4: {t_ok}")
    ms = kernel_ms(lambda: bs.big_top2(tr, p, d))
    plain_ms = cuda_ms(lambda: bs.big_top2_plain(blocks, p, d,
                                                 table=big.table),
                       reps=1, warm=0)
    b_ms, b_by = bound(n * (6 * 4 + 2 * 8) + tables, big_ops(work, False))
    say("kernel big_top2", n=n, blocks=blocks.G,
        hits=int(fin_w[:, 0].sum()), finite_agree=f"{fin_agree:.6f}",
        idx_agree=f"{idx_agree:.6f}", max_abs_err=f"{max_err:.3e}",
        differ=differ, differ_before=differ_before,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, block_tests=work.culls, blocks_evaluated=work.blocks,
        lanes=work.lanes, merges=work.merges, **bs.TOP2_LAUNCH)
    out["big_top2"] = dict(
        name="big_top2", route="cuda",
        source="actinon_tpu_torch/csrc/bigscene_kernels.cu",
        replaces="actinon_tpu/render/pallas_bigscene.py:159",
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, agree=idx_agree, n=n,
        differ=differ, differ_before=differ_before)

    out["big_anyhit"] = check_big_anyhit("sphere_fractal",
                                         cap["big_anyhit"])
    return out


K7_ROUNDS = 5   # turns of (warp, thread) in K7's timing


def check_big_anyhit(tag, entry):
    """K7 on one render's largest K7 call (entry: the spied inputs): both
    designs against the plain version (booleans >= 99.8 % equal) and
    against each other (every ray equal), timed in turns over K7_ROUNDS
    rounds (median, spread); the JSON entry of the design that the
    table's block count chooses."""
    import torch
    from actinon_tpu_torch.render import bigscene as bs
    tr, p, d, lim = entry
    big = tr._bigscene()
    blocks = big.blocks
    n = p.shape[0]
    design = bs.anyhit_design(blocks.G)
    got = {k: bs.big_anyhit(tr, p, d, lim, design=k) for k in K7_DESIGNS}
    torch.cuda.synchronize()
    if not torch.equal(got["warp"], got["thread"]):
        fail(f"big any-hit ({tag}): the designs differ on "
             f"{int((got['warp'] != got['thread']).sum())} rays")
    work = bs._Work()
    want = bs.big_anyhit_plain(blocks, p, d, lim, work=work,
                               table=big.table)
    differ = int((got[design] != want).sum())
    with twice_rounded():
        differ_before = int((got[design] != bs.big_anyhit_plain(
            blocks, p, d, lim, table=big.table)).sum())
    agree = float((got[design] == want).float().mean())
    if not agree >= 0.998:
        fail(f"big any-hit kernel ({tag}) agreement {agree}")
    times = graph_ms([lambda k=k: bs.big_anyhit(tr, p, d, lim, design=k)
                      for k in K7_DESIGNS], rounds=K7_ROUNDS)
    ms = {k: float(np.median(t)) for k, t in zip(K7_DESIGNS, times)}
    spread = {k: f"{min(t):.4f}-{max(t):.4f}"
              for k, t in zip(K7_DESIGNS, times)}
    plain_ms = cuda_ms(lambda: bs.big_anyhit_plain(blocks, p, d, lim,
                                                   table=big.table),
                       reps=1, warm=0)
    tables = 4 * blocks.G * bs.LB * 4 + 4 * blocks.G * 4   # the rows read
    b_ms, b_by = bound(n * (7 * 4 + 1) + tables, big_ops(work, True))
    say(f"kernel big_anyhit {tag}", n=n, blocks=blocks.G, design=design,
        blocked=int(want.sum()), agree=f"{agree:.6f}", differ=differ,
        differ_before=differ_before, designs_equal=True,
        ms_warp=f"{ms['warp']:.4f}", spread_warp=spread["warp"],
        ms_thread=f"{ms['thread']:.4f}", spread_thread=spread["thread"],
        rounds=K7_ROUNDS, plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, block_tests=work.culls,
        blocks_evaluated=work.blocks, lanes=work.lanes,
        **bs.ANYHIT_LAUNCH[design])
    return dict(
        name=f"big_anyhit[{tag}, {design}]", route="cuda",
        source="actinon_tpu_torch/csrc/bigscene_kernels.cu",
        replaces="actinon_tpu/render/pallas_bigscene.py:260",
        max_abs_err=float((got[design] != want).float().max()),
        ms=ms[design], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, agree=agree, n=n, design=design, differ=differ,
        differ_before=differ_before)


# block counts of K7's design sweep, on each render's largest K7 call
K7_SWEEP = {"lamp_row": (1, 2, 3, 4), "sphere_fractal": (4, 8, 16, 32, 64,
                                                        128)}


def k7_sweep(tag, entry):
    """K7's two designs on a render's largest K7 call (entry) against the
    first G of its table's Morton blocks (a compact part of it), for each
    G of K7_SWEEP[tag]: both give every ray the same boolean, and they are
    timed in turns over K7_ROUNDS rounds (median, spread), beside the
    design that `bigscene.anyhit_design` picks for G.  It calls the C
    launcher directly: a table of G blocks is the prefix of the render's,
    and these launches stay out of LAUNCHES."""
    import torch
    from actinon_tpu_torch.render import bigscene as bs
    from actinon_tpu_torch.render import kernels
    tr, p, d, lim = entry
    big = tr._bigscene()
    n = p.shape[0]
    for G in K7_SWEEP[tag]:
        out = {k: torch.empty((n,), dtype=torch.bool, device=p.device)
               for k in K7_DESIGNS}

        def run(k, G=G, out=out):
            rc = kernels._lib().actinon_big_anyhit(
                big.table.data_ptr(), big.bounds.data_ptr(), G,
                p.data_ptr(), d.data_ptr(), lim.data_ptr(),
                out[k].data_ptr(), n, float(big.blocks.eps),
                int(k == "warp"), kernels._stream())
            if rc != 0:
                fail(f"k7 sweep {tag} G={G} {k}: CUDA error {rc}")
        for k in K7_DESIGNS:
            run(k)
        torch.cuda.synchronize()
        if not torch.equal(out["warp"], out["thread"]):
            fail(f"k7 sweep {tag} G={G}: the designs differ")
        times = graph_ms([lambda k=k: run(k) for k in K7_DESIGNS],
                         rounds=K7_ROUNDS)
        ms = {k: float(np.median(t)) for k, t in zip(K7_DESIGNS, times)}
        say(f"k7 sweep {tag} G={G}", n=n, blocked=int(out["warp"].sum()),
            ms_warp=f"{ms['warp']:.4f}",
            spread_warp=f"{min(times[0]):.4f}-{max(times[0]):.4f}",
            ms_thread=f"{ms['thread']:.4f}",
            spread_thread=f"{min(times[1]):.4f}-{max(times[1]):.4f}",
            faster=min(ms, key=ms.get), chosen=bs.anyhit_design(G))


def phase_fractal_counter(base):
    """Counter-mode fractal: kernels against no kernels on the card, and
    the card against the port's plain render on the CPU."""
    sc = sized(base, *FRACTAL_AB, *FRACTAL_SHAPE[2:])
    acc_k, s_k, launches, _ = counter_render(sc, 1 << 15, True)
    if launches["big_top2"] <= 0 or launches["big_anyhit"] <= 0:
        fail(f"counter-mode fractal launched {launches}")
    acc_p, s_p, off, _ = counter_render(sc, 1 << 15, False)
    if any(off.values()):
        fail(f"kernels switched off but launched: {off}")
    ref = sized(base, *FRACTAL_CPU)
    acc_g, _, _, _ = counter_render(ref, 1 << 12, True)
    acc_c, s_c, _, _ = counter_render(ref, 1 << 12, True, device="cpu")
    m_k, m_p, m_g, m_c = (float(a.mean()) for a in (acc_k, acc_p, acc_g,
                                                    acc_c))
    rel = abs(m_k - m_p) / max(abs(m_p), 1e-12)
    rel_c = abs(m_g - m_c) / max(abs(m_c), 1e-12)
    # the share of pixels that agree (the rest are grazing flips)
    px = lambda a, b: float(np.isclose(a, b, rtol=1e-3, atol=1e-4).all(
        axis=1).mean())
    if not (np.isfinite(acc_k).all() and rel <= 5e-3 and rel_c <= 5e-3):
        fail(f"counter-mode fractal: kernels {m_k}, plain {m_p} (rel "
             f"{rel}); card {m_g}, CPU {m_c} (rel {rel_c})")
    say("render fractal counter", size=f"{FRACTAL_AB[0]}x{FRACTAL_AB[1]}",
        kernel_s=f"{s_k:.3f}", plain_s=f"{s_p:.3f}",
        mean_kernels=f"{m_k:.6f}", mean_plain=f"{m_p:.6f}", rel=f"{rel:.2e}",
        pixels_agree=f"{px(acc_k, acc_p):.4f}",
        cpu_shape="x".join(map(str, FRACTAL_CPU)), cpu_s=f"{s_c:.3f}",
        mean_card=f"{m_g:.6f}", mean_cpu=f"{m_c:.6f}", rel_cpu=f"{rel_c:.2e}",
        pixels_agree_cpu=f"{px(acc_g, acc_c):.4f}",
        launches=json.dumps(launches, separators=(",", ":")))


OP_ROUNDS = 5   # turns of (kernel, torch call) per op in phase_ops


def phase_ops():
    """K8 and K9 through the diag_ops entry point (its comparisons and the
    einsum check are the path whose launches count), then each op code
    against its own torch call (torch.sin, cos, sqrt, rsqrt, exp;
    torch.div for a / b; torch.addcmul for a * b + c): one CUDA graph of
    100 launches each, replayed in turns (kernel, call, kernel, ...)
    OP_ROUNDS times; each op's median and spread (min, max) over the
    rounds.  plain is torch's op with host time."""
    import torch
    from actinon_tpu_torch import diag_ops
    from actinon_tpu_torch.render import kernels
    kernels.reset_launches()
    rows = diag_ops.compare("cuda")
    ein = diag_ops.einsum_check("cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    inp = diag_ops.tool_inputs("cuda")
    lib = {"div": torch.div, "mul_add": lambda a, b, c: torch.addcmul(c, a,
                                                                       b)}
    per = {"diag_unary": [], "diag_expr": []}
    for r in rows:
        name = r["name"]
        if r["kind"] == "unary":
            args = (inp["x"][name],)
            run = lambda: diag_ops.unary(name, *args)
            plain = lambda: diag_ops.unary_plain(name, *args)
            libf = lambda: getattr(torch, name)(*args)
            key = "diag_unary"
        else:
            args = inp["args"][name]
            run = lambda: diag_ops.expr(name, *args)
            plain = lambda: diag_ops.expr_plain(name, *args)
            libf = lambda: lib[name](*args)
            key = "diag_expr"
        if name in ("sqrt", "div") and r["bit_equal"] != 1.0:
            fail(f"op {name}: {r['bit_equal']} bit-equal to torch's, "
                 f"where both are IEEE-rounded")
        k_ms, l_ms = graph_ms([run, libf], rounds=OP_ROUNDS)
        t = dict(r, ms=float(np.median(k_ms)), plain_ms=cuda_ms(plain),
                 library_ms=float(np.median(l_ms)), n=args[0].numel(),
                 n_in=len(args))
        per[key].append(t)
        spread = lambda x: f"{min(x):.5f}-{max(x):.5f}"
        say(f"op {name}", bit_equal=f"{r['bit_equal']:.4f}",
            max_ulp=r["max_ulp"], mean_ulp=f"{r['mean_ulp']:.3f}",
            max_abs_err=f"{r['max_abs_err']:.3e}",
            ms=f"{t['ms']:.5f}", ms_spread=spread(k_ms),
            library_ms=f"{t['library_ms']:.5f}",
            library_spread=spread(l_ms),
            library_call=("torch.addcmul" if name == "mul_add" else
                          f"torch.{name}"), rounds=OP_ROUNDS,
            plain_ms=f"{t['plain_ms']:.5f}")
    for name, r in ein.items():
        say(f"op {name}", max_rel=f"{r['max_rel']:.3e}",
            mean_rel=f"{r['mean_rel']:.3e}")
    out = {}
    for key, num, line in (("diag_unary", "K8", 18), ("diag_expr", "K9", 73)):
        ts = per[key]
        mean = lambda k: float(np.mean([t[k] for t in ts]))
        # bytes: each input read once and the output written once
        b_ms, b_by = bound(float(np.mean([4 * t["n"] * (t["n_in"] + 1)
                                          for t in ts])), 0.0)
        # the JSON line keeps one number a kernel: the mean over its ops
        # of the per-op medians (the "op" lines above give each op)
        out[key] = dict(name=key, route="cuda",
                        source="actinon_tpu_torch/csrc/diag_ops.cu",
                        replaces=f"tools/diag_tpu_ops.py:{line}",
                        launches=launches[key],
                        max_abs_err=max(t["max_abs_err"] for t in ts),
                        ms=mean("ms"), plain_ms=mean("plain_ms"),
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=mean("library_ms"))
        if launches[key] <= 0:
            fail(f"the diag_ops entry point never launched {num}")
    return out


# the differentiable renderer (render/diff.py) at bench.py:159's fwd_bwd
# leg: value_and_grad of the mean radiance of DIFF_LANES camera samples
# (default_rng(3), bench.py:169-171) over the scene's 25 bounces
DIFF_LANES = 8192
DIFF_REPS = 3
DIFF_CHECK = 256    # lanes of the card-against-CPU and FD checks, in f64
DIFF_EDGE = 1024    # lanes of the edge-aware call
C3_LANES = (898, 2084)   # far-floor lanes that took the NEE's cap (C3)


def diff_renderer(sc, dtype, device, **kw):
    """A DiffRenderer over scene sc; f64 on the card takes the plain
    path (use_kernels=False), which is all the differentiable renderer
    runs."""
    from actinon_tpu_torch.render.diff import DiffRenderer
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    tr = Tracer(sir.compile_scene(sc), dtype=dtype, device=device,
                use_kernels=dtype == np.float32)
    return DiffRenderer(Integrator(tr, batch=DIFF_LANES), **kw)


def diff_positions(cfg, n):
    rng = np.random.default_rng(3)
    return np.stack([rng.uniform(0, cfg.image_width, n),
                     rng.uniform(0, cfg.image_height, n)], -1)


def grads_np(grads):
    return {f"{g}.{k}": v.detach().double().cpu().numpy()
            for g, grp in grads.items() for k, v in grp.items()}


def diff_fd(dr, q0, group, key, idx, delta, rtol, atol=1e-9):
    """Central differences of the loss against its autograd entry
    (tests/test_diff.py:fd_check)."""
    import torch
    _, grads = dr.value_and_grad(q0)
    params = dr.params()
    g_ad = float(grads[group][key].reshape(-1)[idx])
    leaf = params[group][key]

    def at(eps):
        pert = leaf.clone().reshape(-1)
        pert[idx] += eps
        ps = {g: dict(v) for g, v in params.items()}
        ps[group][key] = pert.reshape(leaf.shape)
        with torch.no_grad():
            return float(dr.render_loss(ps, q0))

    g_fd = (at(delta) - at(-delta)) / (2 * delta)
    ok = abs(g_ad - g_fd) <= atol + rtol * max(abs(g_ad), abs(g_fd))
    say(f"diff fd {key}[{idx}]", g_autograd=f"{g_ad:.9g}",
        g_fd=f"{g_fd:.9g}", delta=delta, rtol=rtol)
    if not ok or g_ad == 0:
        fail(f"diff: {key}[{idx}] autograd {g_ad} against central "
             f"differences {g_fd}")


def phase_diff():
    """The differentiable renderer on the card (module docstring, phase
    14); returns the replay's numbers."""
    import warnings
    import torch
    from actinon_tpu_torch.render import kernels
    from actinon_tpu_torch.render.diff import EdgeCoverageWarning
    sc = load_scene(SCENE, *HEADLINE)
    pos = diff_positions(sc.cfg, DIFF_LANES)
    dr = diff_renderer(sc, np.float32, "cuda")
    q0 = dr.primary(pos)
    before = dict(kernels.LAUNCHES)
    # the eager call first: PR 8-11's figure, and the graph's reference
    dr.diff_graphs = False
    loss, grads, warm, secs, peak = timed_value_and_grad(dr, q0)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    if launched:
        fail(f"diff: value_and_grad launched kernels {launched}")
    g = grads_np(grads)
    bad = sorted(k for k, v in g.items() if not np.isfinite(v).all())
    if not np.isfinite(float(loss)) or bad:
        fail(f"diff: loss {float(loss)}, non-finite gradients {bad}")
    med = float(np.median(secs))
    out = dict(lanes=DIFF_LANES, steps=dr.n_steps, steps_run=dr.steps_run,
               warmup_s=warm, seconds=med,
               lane_bounces_per_s=DIFF_LANES * dr.n_steps / med,
               peak_bytes=peak, loss=float(loss))
    say("diff value_and_grad", scene="glass_table", size="200x150",
        direct=sc.cfg.direct_samples, depth=sc.cfg.trace_depth,
        lanes=DIFF_LANES, sel_mode=dr.sel_mode, steps=dr.n_steps,
        steps_run=dr.steps_run, warmup_s=f"{warm:.3f}",
        seconds=f"{med:.4f}",
        spread=f"{min(secs):.4f}-{max(secs):.4f}",
        lane_bounces_per_s=f"{out['lane_bounces_per_s']:.6g}",
        peak_mib=f"{peak / 2**20:.1f}", loss=f"{float(loss):.6f}",
        launches=json.dumps(launched))
    say("diff grad norms", norms=json.dumps(
        {k: float(f"{np.linalg.norm(v):.4g}") for k, v in g.items()},
        separators=(",", ":")))
    out["graph"] = diff_graph_line(dr, q0, (loss, grads))
    dr.diff_graphs = False
    phase_c3(sc, pos, dr, q0, float(loss))
    out["fit"] = diff_fit_line(dr, q0)
    del grads, dr, q0

    # the card against the CPU in f64 on the first DIFF_CHECK lanes
    # (the card's call a graph replay, held bit for bit to the eager call)
    got = {}
    for dev in ("cuda", "cpu"):
        d64 = diff_renderer(sc, np.float64, dev)
        q64 = d64.primary(pos[:DIFF_CHECK])
        t0 = time.perf_counter()
        loss, grads = d64.value_and_grad(q64)
        got[dev] = (float(loss), grads_np(grads), time.perf_counter() - t0)
        if dev == "cuda":
            d64.diff_graphs = False
            same, worst = vg_bit_equal(d64.value_and_grad(q64),
                                       (loss, grads))
            say("diff graph f64", lanes=DIFF_CHECK, bit_equal=same,
                differs=worst, captures=d64._graphs.captures)
            if not same:
                fail(f"diff graph f64: the graph call against the eager "
                     f"call differs in {worst}")
    (lc, gc, sc_), (lh, gh, sh) = got["cuda"], got["cpu"]
    rel = abs(lc - lh) / abs(lh)
    worst = max((np.max(np.abs(gc[k] - gh[k])
                        / (1e-5 * np.abs(gh[k]).max(initial=0.0)
                           + 1e-5 * np.abs(gh[k]) + 1e-300)), k)
                for k in gh)
    say("diff card vs cpu f64", lanes=DIFF_CHECK, loss_card=f"{lc:.15g}",
        loss_cpu=f"{lh:.15g}", rel=f"{rel:.2e}",
        worst_grad_over_tol=f"{worst[0]:.3g}", worst_key=worst[1],
        card_s=f"{sc_:.3f}", cpu_s=f"{sh:.3f}")
    if not (rel <= 1e-6 and worst[0] <= 1.0):
        fail(f"diff: card and CPU disagree in f64: loss rel {rel}, "
             f"{worst[1]} at {worst[0]} of its tolerance")

    # central differences on the card, f64, uniform selection: the sphere
    # lamp's radiance and the goblet's outer bowl radius (CSG leaf c0_l0)
    d64 = diff_renderer(sc, np.float64, "cuda", sel_mode="uniform")
    q64 = d64.primary(pos[:DIFF_CHECK])
    diff_fd(d64, q64, "mat", "l_rad", 0, 1e-3, 1e-5)
    diff_fd(d64, q64, "geom", "c0_l0_r", 0, 1e-5, 3e-2)
    del d64, q64

    # the edge-aware NEE terms: one call, finite gradients
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always", EdgeCoverageWarning)
        de = diff_renderer(sc, np.float32, "cuda", edge_aware=True)
    gaps = [str(w.message) for w in ws
            if issubclass(w.category, EdgeCoverageWarning)]
    before = dict(kernels.LAUNCHES)
    qe = de.primary(pos[:DIFF_EDGE])
    t0 = time.perf_counter()
    loss, grads = de.value_and_grad(qe)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    g = grads_np(grads)
    bad = sorted(k for k, v in g.items() if not np.isfinite(v).all())
    if not np.isfinite(float(loss)) or bad:
        fail(f"diff edge: loss {float(loss)}, non-finite gradients {bad}")
    # the graph call (its capture's K3 launches counted at the replay)
    # against the eager call
    de.diff_graphs = False
    same, worst = vg_bit_equal(de.value_and_grad(qe), (loss, grads))
    say("diff edge_aware", lanes=DIFF_EDGE, seconds=f"{secs:.3f}",
        loss=f"{float(loss):.6f}", coverage_warnings=json.dumps(gaps),
        launches=json.dumps(launched), graph_bit_equal=same,
        differs=worst,
        norm_qua_m0=f"{np.linalg.norm(g['geom.qua_m0']):.4g}",
        norm_c0_l0_c=f"{np.linalg.norm(g['geom.c0_l0_c']):.4g}")
    if not same:
        fail(f"diff edge: the graph call against the eager call differs "
             f"in {worst}")
    return out


def timed_value_and_grad(dr, q0):
    """dr.value_and_grad(q0) once as the warm-up (with graphs: the
    capture), then DIFF_REPS times: (loss, grads of the last call, the
    warm-up's seconds, each call's seconds, the peak of
    max_memory_allocated over all of them)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dr.value_and_grad(q0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    secs = []
    for _ in range(DIFF_REPS):
        t0 = time.perf_counter()
        loss, grads = dr.value_and_grad(q0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return loss, grads, warm, secs, torch.cuda.max_memory_allocated()


def vg_bit_equal(a, b):
    """Two (loss, grads) bit for bit: (all equal, the keys that differ)."""
    import torch
    bad = [] if torch.equal(a[0], b[0]) else ["loss"]
    bad += [f"{g}.{k}" for g, grp in b[1].items() for k, v in grp.items()
            if not torch.equal(a[1][g][k], v)]
    return not bad, bad


def diff_graph_line(dr, q0, eager):
    """The fwd_bwd cell through DiffGraphs ("diff graph"): the warm-up
    that captures, DIFF_REPS replays (median and spread), lane-bounces/s,
    the capture's seconds and pool, the peak memory, each replay bit for
    bit the eager call `eager`, and no kernel launched."""
    from actinon_tpu_torch.render import kernels
    dr.diff_graphs = True
    before = dict(kernels.LAUNCHES)
    loss, grads, warm, secs, peak = timed_value_and_grad(dr, q0)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    same, worst = vg_bit_equal((loss, grads), eager)
    g = dr._graphs
    med = float(np.median(secs))
    out = dict(seconds=med, warmup_s=warm, capture_s=g.capture_s,
               pool_bytes=g.pool_bytes, peak_bytes=peak,
               lane_bounces_per_s=DIFF_LANES * dr.n_steps / med)
    say("diff graph", lanes=DIFF_LANES, steps=dr.n_steps,
        steps_run=dr.steps_run, bit_equal=same, differs=worst,
        warmup_s=f"{warm:.3f}", seconds=f"{med:.4f}",
        spread=f"{min(secs):.4f}-{max(secs):.4f}",
        lane_bounces_per_s=f"{out['lane_bounces_per_s']:.6g}",
        captures=g.captures, capture_s=f"{g.capture_s:.3f}",
        pool_mib=f"{g.pool_bytes / 2**20:.1f}",
        peak_mib=f"{peak / 2**20:.1f}", loss=f"{float(loss):.6f}",
        launches=json.dumps(launched))
    if not same or launched or g.captures != 1:
        fail(f"diff graph: bit-equal to the eager call {same} (differs "
             f"{worst}), launches {launched}, captures {g.captures}")
    return out


FIT_STEPS = 3


def diff_fit_line(dr, q0):
    """A fit's traffic at the fwd_bwd cell ("diff fit"): FIT_STEPS calls,
    each at new parameter values (the spheres moved and the lamps
    brighter, as a step of a fit moves them), passed to value_and_grad
    ("params") or set by set_geom and set_mat ("set"): each call the
    replay of the graph that diff_graph_line captured, with no capture
    and no kernel launched; the last call of each route bit for bit the
    eager call at its values.  The scene's own values are set back at
    the end."""
    import torch
    from actinon_tpu_torch.render import kernels
    dr.diff_graphs = True
    tr, ig, g = dr.tr, dr.integ, dr._graphs
    captures, capture_s = g.captures, g.capture_s
    geom0, mat0 = tr.geom_params(), ig.mat_params()
    before = dict(kernels.LAUNCHES)
    got, secs = {}, {}
    for route in ("params", "set"):
        secs[route] = []
        for step in range(1, FIT_STEPS + 1):
            moved = {"geom": {"sph_c": geom0["sph_c"]
                              + np.float32(0.05 * step)},
                     "mat": {"l_rad": mat0["l_rad"]
                             * np.float32(1 + 0.1 * step)}}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "params":
                got[route] = dr.value_and_grad(q0, params=moved)
            else:
                tr.set_geom(geom0 | moved["geom"])
                ig.set_mat(mat0 | moved["mat"])
                got[route] = dr.value_and_grad(q0)
            torch.cuda.synchronize()
            secs[route].append(time.perf_counter() - t0)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    recaptured = g.captures != captures or g.capture_s != capture_s
    # the scene is at the last values of both routes
    dr.diff_graphs = False
    eager = dr.value_and_grad(q0)
    tr.set_geom(geom0)
    ig.set_mat(mat0)
    same = {r: vg_bit_equal(got[r], eager) for r in got}
    med = {r: float(np.median(v)) for r, v in secs.items()}
    say("diff fit", lanes=DIFF_LANES, steps=FIT_STEPS,
        params_s=f"{med['params']:.4f}",
        params_spread=f"{min(secs['params']):.4f}-"
                      f"{max(secs['params']):.4f}",
        set_s=f"{med['set']:.4f}",
        set_spread=f"{min(secs['set']):.4f}-{max(secs['set']):.4f}",
        captures=g.captures, recaptured=recaptured,
        bit_equal=json.dumps({r: v[0] for r, v in same.items()}),
        differs=json.dumps({r: v[1] for r, v in same.items()}),
        launches=json.dumps(launched))
    if recaptured or launched or not all(v[0] for v in same.values()):
        fail(f"diff fit: recaptured {recaptured}, launches {launched}, "
             f"bit-equal to the eager call {same}")
    return dict(params_s=med["params"], set_s=med["set"])


def phase_c3(sc, pos, dr, q0, loss):
    """ROADMAP C3 on the card: the f32 forward of the fwd_bwd lanes, lane
    by lane, stays below 1e3 (the NEE's 1e30 cap took lanes 898 and 2084
    to 9.5e19 and 1.1e20 when the discriminants rounded twice), with the
    two lanes beside the f64 plain run on the card."""
    import torch
    with torch.no_grad():
        lane = dr.radiance(dr.params(), q0).max(dim=1).values
    n_big = int((lane >= 1e3).sum())
    d64 = diff_renderer(sc, np.float64, "cuda")
    q64 = d64.primary(pos)
    idx = torch.tensor(C3_LANES, device=q64["p"].device)
    with torch.no_grad():
        lane64 = d64.radiance(d64.params(), {k: v[idx] for k, v in
                                             q64.items()}).max(dim=1).values
    f32 = lane[idx.to(lane.device)].double().cpu().numpy()
    f64 = lane64.cpu().numpy()
    rel = np.abs(f32 - f64) / np.abs(f64)
    say("diff c3", loss_f32=f"{loss:.9g}", lanes_ge_1e3=n_big,
        max_lane=f"{float(lane.max()):.6g}",
        **{f"lane{k}_f32": f"{a:.6g}" for k, a in zip(C3_LANES, f32)},
        **{f"lane{k}_f64": f"{a:.6g}" for k, a in zip(C3_LANES, f64)},
        **{f"lane{k}_rel": f"{r:.3g}" for k, r in zip(C3_LANES, rel)})
    if not (np.isfinite(loss) and n_big == 0 and np.isfinite(f32).all()):
        fail(f"diff c3: f32 loss {loss}, {n_big} lanes at or above 1e3, "
             f"lanes {C3_LANES} {f32}")


# the recursive oracle (render/reference_oracle.py) on the card: glass_table
# cut to ORACLE_SHAPE, in f64 (the plain path), ORACLE_N camera samples of
# default_rng(3) against run_device at tests/test_integrator.py's bounds
ORACLE_SHAPE = (8, 6, 4, 0, 8)
ORACLE_N = 12


def phase_oracle(card):
    import torch
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.reference_oracle import RecursiveOracle
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    sc = load_scene(SCENE, *ORACLE_SHAPE)
    integ = Integrator(Tracer(sir.compile_scene(sc), dtype=np.float64,
                              device="cuda", use_kernels=False), batch=64)
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(0, sc.cfg.image_width, ORACLE_N),
                    rng.uniform(0, sc.cfg.image_height, ORACLE_N)], -1)
    t0 = time.perf_counter()
    got = integ.run_device(None, len(pos), pos_xy=pos)
    t_w = time.perf_counter() - t0
    # run_device's own rays: the same padded position block
    pad = torch.zeros((64, 2), dtype=torch.float64, device="cuda")
    pad[:ORACLE_N] = torch.as_tensor(pos, device="cuda")
    p, d = (x[:ORACLE_N].cpu().numpy() for x in integ._camera_rays_dev(pad))
    oracle = RecursiveOracle(integ)
    t0 = time.perf_counter()
    want = np.stack([oracle.sample(p[i], d[i]) for i in range(ORACLE_N)])
    t_o = time.perf_counter() - t0
    err = np.abs(got - want) / (1e-9 + 1e-6 * np.abs(want))
    say("oracle", scene="glass_table", size="8x6", direct=4, depth=8,
        samples=ORACLE_N, dtype="f64", wavefront_s=f"{t_w:.3f}",
        oracle_s=f"{t_o:.3f}", worst_over_tol=f"{err.max():.3g}",
        mean=f"{want.mean():.9g}", card=repr(card))
    if not (np.isfinite(got).all() and err.max() <= 1.0
            and want.max() > 0):
        fail(f"oracle: run_device against the recursion, worst "
             f"{err.max()} of rtol 1e-6 / atol 1e-9")


# multi-device rendering (parallel/mesh.py), __graft_entry__.py's
# dryrun_multichip shapes on glass_table: name -> ((w, h, direct, path,
# depth), batch)
SHARD_SHAPES = {"draft": ((32, 24, 4, 0, 8), 1 << 12),
                "mixed": ((16, 12, 2, 2, 12), 1 << 12),
                "production": (HEADLINE, 1 << 15)}
# MULTICHIP_r05.json's load balance of the JAX package over 8 TPU devices,
# printed beside the card's (not compared: another device count)
TPU_BALANCE = {"draft": 0.855, "mixed": 0.658, "production": 0.976}
SHARD_RANKS = 2
SHARD_LIMIT_S = 420   # the two-rank world's time limit


def pixel_centres(cfg):
    ys, xs = np.mgrid[0:cfg.image_height, 0:cfg.image_width]
    return np.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                    -1).astype(np.float64)


def grad_worst(got, want):
    """The worst gradient entry over its bound (rtol 2e-4, atol 2e-5,
    tests/test_mesh.py:103), and its key."""
    return max((float(np.max(np.abs(got[k] - want[k])
                             / (2e-5 + 2e-4 * np.abs(want[k])),
                             initial=0.0)), k) for k in want)


def sharded_drain(shape, batch, mesh, device, graphs=True):
    """One ShardedIntegrator pass over the pixel centres of glass_table at
    `shape` (graphs=False: each rank's trips run eagerly): (acc,
    rays_traced, last_balance, wall seconds)."""
    import torch
    from actinon_tpu_torch.parallel.mesh import ShardedIntegrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    sc = load_scene(SCENE, *shape)
    sh = ShardedIntegrator(Tracer(sir.compile_scene(sc), dtype=np.float32,
                                  device=device), mesh, batch=batch)
    sh.drain_graphs = graphs
    pos = pixel_centres(sc.cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = sh.run_samples(pos)
    return acc, sh.rays_traced, sh.last_balance, time.perf_counter() - t0


def single_drain(shape, batch):
    """The single-device drain of the same pass: (acc, rays_traced,
    seconds)."""
    import torch
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    sc = load_scene(SCENE, *shape)
    integ = Integrator(Tracer(sir.compile_scene(sc), dtype=np.float32,
                              device="cuda"), batch=batch)
    pos = pixel_centres(sc.cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = integ.run_device(None, len(pos), pos_xy=pos)
    return acc, integ.rays_traced, time.perf_counter() - t0


def sharded_diff(mesh):
    """ShardedDiffRenderer.value_and_grad at the fwd_bwd width: (loss and
    grads as numpy, wall seconds)."""
    import torch
    from actinon_tpu_torch.parallel.mesh import ShardedDiffRenderer
    sc = load_scene(SCENE, *HEADLINE)
    dr = diff_renderer(sc, np.float32, "cuda")
    q0 = dr.primary(diff_positions(sc.cfg, DIFF_LANES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = ShardedDiffRenderer(dr, mesh).value_and_grad(q0)
    torch.cuda.synchronize()
    return dict(grads_np(grads), loss=float(loss)), time.perf_counter() - t0


def mesh_worker(rank, n, store, out):
    """One rank of the two-rank world (`chip_smoke.py --mesh-worker`):
    gloo over a FileStore, the kernels on cuda:0 beside the other rank;
    every SHARD_SHAPES pass with the graph drain and again eagerly
    (phase 18), the sharded fwd_bwd, then the arbitrary-queue branch at
    QUEUE_DRAFT (phase 17 (e)), saved to `out`."""
    import torch
    import torch.distributed as dist
    from actinon_tpu_torch.parallel.mesh import make_mesh
    rank, n = int(rank), int(n)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    mesh = make_mesh(n, device="cuda:0", backend="gloo")
    res = {}
    for name, (shape, batch) in SHARD_SHAPES.items():
        acc, rays, bal, secs = sharded_drain(shape, batch, mesh, "cuda:0")
        res.update({f"{name}/acc": acc, f"{name}/rays": rays,
                    f"{name}/balance": bal, f"{name}/seconds": secs})
        acc, rays, _, secs = sharded_drain(shape, batch, mesh, "cuda:0",
                                           graphs=False)
        res.update({f"{name}/eager_acc": acc, f"{name}/eager_rays": rays,
                    f"{name}/eager_seconds": secs})
    got, secs = sharded_diff(mesh)
    res.update({f"diff/{k}": v for k, v in got.items()})
    res["diff/seconds"] = secs
    acc, rays, secs = sharded_queue(QUEUE_DRAFT, mesh)
    res.update({"queue/acc": acc, "queue/rays": rays,
                "queue/seconds": secs})
    np.savez(out, **res)
    dist.destroy_process_group()
    return 0


def launch_mesh_workers(n, limit_s):
    """The two-rank world as n processes of this script: each rank's
    results, or a failure when a worker fails or outlives limit_s (the
    others are killed)."""
    import tempfile
    os.makedirs(OUT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=OUT)
    store = os.path.join(tmp, "store")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker",
         str(r), str(n), store, os.path.join(tmp, f"rank{r}.npz")],
        cwd=HERE, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.time() + limit_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
            fail(f"sharded: rank {r} of {n} exited {p.returncode} (killed "
                 f"at the {limit_s} s limit if negative)\n{tail}")
    out = []
    for r in range(n):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def phase_sharded(card):
    """Multi-device rendering on the card (module docstring, phase 16)."""
    import torch
    from actinon_tpu_torch.parallel.mesh import make_mesh
    # (a) a world of one over NCCL at the headline width: bit for bit
    # run_device's image, through K1
    from actinon_tpu_torch.render import kernels
    mesh = make_mesh(1, device="cuda")
    acc_1, rays_1, s_1 = single_drain(HEADLINE, 1 << 15)
    before = dict(kernels.LAUNCHES)
    acc_s, rays_s, bal, s_s = sharded_drain(HEADLINE, 1 << 15, mesh, "cuda")
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    same = bool(np.array_equal(acc_s, acc_1))
    say("sharded world1 headline", backend=mesh.backend,
        size="x".join(map(str, HEADLINE[:2])),
        batch=1 << 15, sharded_s=f"{s_s:.3f}", single_s=f"{s_1:.3f}",
        bit_equal=same, rays_traced=rays_s, balance=bal,
        launches=json.dumps(launched, separators=(",", ":")),
        card=repr(card))
    if not same or rays_s != rays_1 or launched.get("nee", 0) <= 0:
        fail(f"sharded world of one: bit-equal {same}, rays {rays_s} "
             f"against {rays_1}, launches {launched}")
    # (c) at world size 1: ShardedDiffRenderer against value_and_grad
    sc = load_scene(SCENE, *HEADLINE)
    dr = diff_renderer(sc, np.float32, "cuda")
    q0 = dr.primary(diff_positions(sc.cfg, DIFF_LANES))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = dr.value_and_grad(q0)
    torch.cuda.synchronize()
    s_vg = time.perf_counter() - t0
    want = dict(grads_np(grads), loss=float(loss))
    del dr, q0, grads
    got, s_d = sharded_diff(mesh)
    check_sharded_diff("world1", got, want, s_d, s_vg, card)

    # (b) two ranks sharing the card (gloo, collectives through the host)
    singles = {name: single_drain(shape, batch)
               for name, (shape, batch) in SHARD_SHAPES.items()}
    t0 = time.perf_counter()
    ranks = launch_mesh_workers(SHARD_RANKS, SHARD_LIMIT_S)
    say("sharded world2 launch", ranks=SHARD_RANKS, backend="gloo",
        wall_s=f"{time.perf_counter() - t0:.1f}", card=repr(card))
    for name, (shape, batch) in SHARD_SHAPES.items():
        acc_1, rays_1, s_1 = singles[name]
        acc = ranks[0][f"{name}/acc"]
        err = float(np.abs(acc - acc_1).max())
        agree = all(np.array_equal(r[f"{name}/acc"], acc) for r in ranks)
        rays = [int(r[f"{name}/rays"]) for r in ranks]
        say(f"sharded world2 {name}", size="x".join(map(str, shape[:2])),
            direct=shape[2], path=shape[3], depth=shape[4], batch=batch,
            sharded_s=f"{max(float(r[f'{name}/seconds']) for r in ranks):.3f}",
            single_s=f"{s_1:.3f}", max_err=f"{err:.3g}",
            ranks_agree=agree, rays_traced=rays[0], rays_single=rays_1,
            balance=f"{float(ranks[0][f'{name}/balance']):.4f}",
            tpu_balance_8dev=TPU_BALANCE[name], card=repr(card))
        if not (np.isfinite(acc).all() and err < 2e-5 and agree
                and rays == [rays_1] * SHARD_RANKS):
            fail(f"sharded world2 {name}: max err {err} (bound 2e-5), "
                 f"ranks agree {agree}, rays {rays} against {rays_1}")
        # phase 18's two-rank cell: each rank's graph drain against the
        # same rank's eager drain
        same = [bool(np.array_equal(r[f"{name}/acc"], r[f"{name}/eager_acc"]))
                and int(r[f"{name}/rays"]) == int(r[f"{name}/eager_rays"])
                for r in ranks]
        say(f"graph world2 {name}", ranks=SHARD_RANKS, bit_equal=same,
            eager_s=f"{max(float(r[f'{name}/eager_seconds']) for r in ranks):.3f}",
            graph_s=f"{max(float(r[f'{name}/seconds']) for r in ranks):.3f}",
            card=repr(card))
        if not all(same):
            fail(f"graph world2 {name}: the graph drain against the eager "
                 f"drain, bit-equal with equal queries per rank: {same}")
    for r in ranks[1:]:
        if r["diff/loss"] != ranks[0]["diff/loss"]:
            fail("sharded diff: the ranks' losses differ")
    got = {k[5:]: v for k, v in ranks[0].items() if k.startswith("diff/")
           and k != "diff/seconds"}
    check_sharded_diff("world2", got, want,
                       max(float(r["diff/seconds"]) for r in ranks), s_vg,
                       card)
    return ranks


# ---------------------------------------------------------------------------
# phase 17: the primary-queue entry points (RayQueue, run, run_device with
# a queue, the host drain)

QUEUE_PATHS = {"path20": (64, 48, 4, 20, 12), "path8": (64, 48, 4, 8, 22)}
QUEUE_PATH_BATCH = 1 << 12
QUEUE_DRAFT = SHARD_SHAPES["draft"]


def queue_integ(path, shape, batch, seed_mode="position", integ_cls=None,
                **kw):
    """An f32 integrator of the scene at `path` at `shape` on cuda:0 (kw
    to the class: the mesh of a ShardedIntegrator) and its pixel
    centres."""
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    sc = load_scene(path, *shape)
    integ = (integ_cls or Integrator)(
        Tracer(sir.compile_scene(sc), dtype=np.float32, device="cuda:0"),
        batch=batch, **kw)
    integ.seed_mode = seed_mode
    return integ, pixel_centres(sc.cfg)


def camera_queue(integ, pos):
    """The primaries of pos as a RayQueue, from the port's device-precision
    raygen on the position block padded to run_device's power of two (the
    block that run_device(None, n, pos_xy) builds its own rays from)."""
    import torch
    from actinon_tpu_torch.render.integrator import RayQueue
    n, dt = len(pos), integ.dtype
    blk = np.zeros((1 << int(np.ceil(np.log2(max(n, 64)))), 2))
    blk[:n] = pos
    p, d = integ._camera_rays_dev(torch.as_tensor(
        blk, dtype=integ.tdtype, device=integ.device))
    return RayQueue(p[:n].cpu().numpy(), d[:n].cpu().numpy(),
                    np.ones(n, dt), np.ones((n, 3), dt),
                    np.full(n, integ.cfg.trace_depth, np.int32),
                    np.arange(n, dtype=np.int32))


def drain(integ, fn):
    """One drain: (acc, its queries, its launches, wall seconds), the
    launch counts set to 0 just before it and read just after."""
    import torch
    from actinon_tpu_torch.render import kernels
    rays0 = integ.rays_traced
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    acc = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return acc, integ.rays_traced - rays0, dict(kernels.LAUNCHES), secs


def sharded_queue(shape, mesh):
    """ShardedIntegrator.run_device(primary, n) at `shape` (one rank of
    the two-rank world): (acc, rays_traced, wall seconds)."""
    from actinon_tpu_torch.parallel.mesh import ShardedIntegrator
    sh, pos = queue_integ(SCENE, *shape, integ_cls=ShardedIntegrator,
                          mesh=mesh)
    acc, rays, _, secs = drain(sh, lambda: sh.run_device(
        camera_queue(sh, pos), len(pos)))
    return acc, rays, secs


def agree_bounds(tag, host, dev, rays_h, rays_d):
    """tests/test_path_device.py's bounds (mean within 1e-5, max within
    1e-2) and test_accounting.py's equal queries; fails otherwise."""
    d_mean = abs(float(host.mean()) - float(dev.mean()))
    d_max = float(np.abs(host - dev).max())
    ok = (np.isfinite(host).all() and np.isfinite(dev).all()
          and d_mean < 1e-5 and d_max < 1e-2 and rays_h == rays_d)
    if not ok:
        fail(f"queue {tag}: host drain against device drain mean off by "
             f"{d_mean}, max {d_max}, queries {rays_h} against {rays_d}")
    return dict(d_mean=f"{d_mean:.3g}", d_max=f"{d_max:.3g}")


def phase_queue(card, ranks, ks):
    """The primary-queue entry points on the card (module docstring,
    phase 17)."""
    t_phase = time.perf_counter()
    lj = lambda L: json.dumps({k: v for k, v in L.items() if v},
                              separators=(",", ":"))
    # (a) run_device(primary, n) on the device-precision primaries against
    # run_device(None, n, pos_xy): bit for bit, through K1 (the second
    # call, the queue's, finds the tables built: its seconds are the
    # device drain's)
    integ, pos = queue_integ(SCENE, HEADLINE, 1 << 15)
    n = len(pos)
    q = camera_queue(integ, pos)
    acc_p, rays_p, L_p, s_p = drain(
        integ, lambda: integ.run_device(None, n, pos_xy=pos))
    acc_q, rays_q, L_q, s_q = drain(integ, lambda: integ.run_device(q, n))
    same = bool(np.array_equal(acc_q, acc_p))
    say("queue run_device headline", n=n, batch=integ.batch,
        queue_s=f"{s_q:.3f}", positions_s=f"{s_p:.3f}", bit_equal=same,
        rays_traced=rays_q, launches=lj(L_q), card=repr(card))
    if not same or rays_q != rays_p or min(L_q["nee"], L_p["nee"]) <= 0:
        fail(f"queue (a): bit-equal {same}, queries {rays_q} against "
             f"{rays_p}, launches {L_q} / {L_p}")
    # (b) the host drain at the same width, through K1; then both drains
    # in counter mode
    integ.device_drain = False
    acc_h, rays_h, L_h, s_h = drain(integ, lambda: integ.run(q, n))
    if L_h["nee"] <= 0:
        fail(f"queue (b): the host drain launched {L_h}")
    say("queue host headline", n=n, batch=integ.batch, host_s=f"{s_h:.3f}",
        device_s=f"{s_q:.3f}", rays_traced=rays_h, launches=lj(L_h),
        **agree_bounds("headline", acc_h, acc_p, rays_h, rays_p),
        card=repr(card))
    ks["nee"]["host_launches"] = L_h["nee"]
    integ_c, _ = queue_integ(SCENE, HEADLINE, 1 << 15, seed_mode="counter")
    for _ in range(2):     # the first call builds the tables: time the second
        acc_cd, rays_cd, L_cd, s_cd = drain(
            integ_c, lambda: integ_c.run_device(q, n))
    integ_c.device_drain = False
    acc_ch, rays_ch, L_ch, s_ch = drain(integ_c, lambda: integ_c.run(q, n))
    say("queue host headline counter", n=n, host_s=f"{s_ch:.3f}",
        device_s=f"{s_cd:.3f}", rays_traced=rays_ch, launches=lj(L_ch),
        **agree_bounds("headline counter", acc_ch, acc_cd, rays_ch,
                       rays_cd), card=repr(card))
    for k, name in (("shadow_any_hit", "shadow"), ("object_hit",
                                                   "object_hit")):
        ks[k]["host_launches"] = L_ch[name]
    del integ, integ_c
    # (c) lamp_row's host drain at its bench shape: K4-K7
    integ, pos = queue_integ(LAMP, LAMP_SHAPE, 1 << 15)
    n = len(pos)
    q = camera_queue(integ, pos)
    for _ in range(2):
        acc_d, rays_d, _, s_d = drain(integ,
                                      lambda: integ.run_device(q, n))
    integ.device_drain = False
    acc_h, rays_h, L_h, s_h = drain(integ, lambda: integ.run(q, n))
    say("queue host lamp_row", n=n, batch=integ.batch, host_s=f"{s_h:.3f}",
        device_s=f"{s_d:.3f}", rays_traced=rays_h, launches=lj(L_h),
        **agree_bounds("lamp_row", acc_h, acc_d, rays_h, rays_d),
        card=repr(card))
    if min(L_h[k] for k in SCENE_KEYS) <= 0:
        fail(f"queue (c): lamp_row's host drain launched {L_h}")
    for k in ("scene_top2", "scene_anyhit", "big_top2"):
        ks[k]["host_launches"] = L_h[k]
    ks["big_anyhit_lamp"]["host_launches"] = L_h["big_anyhit"]
    del integ
    # (d) the path configs: the host drain (its own path queue) against
    # the mixed device drain
    for name, shape in QUEUE_PATHS.items():
        integ, pos = queue_integ(SCENE, shape, QUEUE_PATH_BATCH)
        n = len(pos)
        q = camera_queue(integ, pos)
        for _ in range(2):
            acc_d, rays_d, L_d, s_d = drain(
                integ, lambda: integ.run_device(q, n))
        acc_h, rays_h, L_h, s_h = drain(integ, lambda: integ.run(q, n))
        say(f"queue host {name}", size="x".join(map(str, shape[:2])),
            direct=shape[2], path=shape[3], depth=shape[4],
            batch=QUEUE_PATH_BATCH, host_s=f"{s_h:.3f}",
            device_s=f"{s_d:.3f}", rays_traced=rays_h, launches=lj(L_h),
            **agree_bounds(name, acc_h, acc_d, rays_h, rays_d),
            card=repr(card))
    # (e) two ranks sharing the card (phase 16's world) on the arbitrary-
    # queue branch, against a single run() of the host drain
    integ, pos = queue_integ(SCENE, *QUEUE_DRAFT)
    integ.device_drain = False
    acc_1, rays_1, _, s_1 = drain(integ, lambda: integ.run(
        camera_queue(integ, pos), len(pos)))
    acc = ranks[0]["queue/acc"]
    same = all(np.array_equal(r["queue/acc"], acc_1) for r in ranks)
    rays = [int(r["queue/rays"]) for r in ranks]
    say("queue sharded world2 draft",
        size="x".join(map(str, QUEUE_DRAFT[0][:2])), batch=QUEUE_DRAFT[1],
        sharded_s=f"{max(float(r['queue/seconds']) for r in ranks):.3f}",
        single_s=f"{s_1:.3f}", bit_equal=same,
        max_err=f"{float(np.abs(acc - acc_1).max()):.3g}",
        rays_traced=rays[0], rays_single=rays_1, card=repr(card))
    if not same or rays != [rays_1] * len(ranks):
        fail(f"queue (e): bit-equal {same}, queries {rays} against "
             f"{rays_1}")
    # ROADMAP C4: K4-K7's lanes that differ from their plain versions,
    # the plain versions with the parent's twice-rounded arithmetic and
    # with the once-rounded arithmetic, on the same captured batches
    say("queue c4", **{k: f"{ks[k]['differ_before']}->{ks[k]['differ']}"
                       f"/{ks[k]['n']}" for k in (
                           "scene_top2", "scene_anyhit", "big_top2",
                           "big_anyhit", "big_anyhit_lamp")},
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def check_sharded_diff(tag, got, want, secs, single_s, card):
    """ShardedDiffRenderer against value_and_grad: loss within 1e-5,
    every gradient within rtol 2e-4 and atol 2e-5 (test_mesh.py:98-103)."""
    d_loss = abs(float(got["loss"]) - want["loss"])
    worst = grad_worst({k: v for k, v in got.items() if k != "loss"},
                       {k: v for k, v in want.items() if k != "loss"})
    say(f"sharded diff {tag}", lanes=DIFF_LANES, sharded_s=f"{secs:.3f}",
        single_s=f"{single_s:.3f}", loss=f"{float(got['loss']):.9g}",
        loss_single=f"{want['loss']:.9g}", d_loss=f"{d_loss:.3g}",
        worst_grad_over_tol=f"{worst[0]:.3g}", worst_key=worst[1],
        card=repr(card))
    if set(got) != set(want) or not (d_loss < 1e-5 and worst[0] <= 1.0):
        fail(f"sharded diff {tag}: loss off by {d_loss}, {worst[1]} at "
             f"{worst[0]} of its bound")


# ---------------------------------------------------------------------------
# phase 18: the graph drain (render/graphs.py): each stage the replay of a
# CUDA graph whose WHILE node runs its trips, against the same trips run
# eagerly

# cells: name -> (scene, shape, batch, seed mode)
GRAPH_CELLS = {
    "headline": (SCENE, HEADLINE, 1 << 15, "position"),
    "lamp_row": (LAMP, LAMP_SHAPE, 1 << 15, "position"),
    "sphere_fractal": (FRACTAL, FRACTAL_SHAPE, 1 << 15, "position"),
    "counter": (SCENE, (64, 48) + HEADLINE[2:], 1 << 15, "counter"),
    "path8": (SCENE, QUEUE_PATHS["path8"], QUEUE_PATH_BATCH, "position"),
}


def graph_integ(path, shape, batch, mode, fractal):
    """A cell's integrator and pixel centres (queue_integ; the fractal
    from its loaded scene)."""
    if path != FRACTAL:
        return queue_integ(path, shape, batch, seed_mode=mode)
    from actinon_tpu_torch.render.integrator import Integrator
    from actinon_tpu_torch.render.tracer import Tracer
    from actinon_tpu_torch.scene import ir as sir
    sc = sized(fractal, *shape)
    integ = Integrator(Tracer(sir.compile_scene(sc), dtype=np.float32,
                              device="cuda:0"), batch=batch)
    integ.seed_mode = mode
    return integ, pixel_centres(sc.cfg)


def graph_cell(integ, pos):
    """One pass over pos eagerly, then twice as graph replays (the first
    captures, the second only replays), on one integrator: each drain's
    acc, queries, trips, launches, seconds, host reads of the stage loop
    and graph launches, and the captures."""
    out = []
    for graphs in (False, True, True):
        integ.drain_graphs = graphs
        replays = integ._graphs.replays if integ._graphs else 0
        acc, rays, launches, secs = drain(
            integ, lambda: integ.run_device(None, len(pos), pos_xy=pos))
        out.append(dict(acc=acc, rays=rays, launches=launches, secs=secs,
                        trips=integ.last_trips,
                        host_reads=integ.last_host_reads,
                        graph_launches=(integ._graphs.replays - replays
                                        if graphs else 0)))
    g = integ._graphs
    return out, dict(captures=g.captures, capture_s=g.capture_s,
                     pool_bytes=g.pool_bytes)


def phase_graph(fractal, card):
    """The graph drain against the eager drain on one integrator per
    cell (module docstring, phase 18)."""
    for name, (path, shape, batch, mode) in GRAPH_CELLS.items():
        integ, pos = graph_integ(path, shape, batch, mode, fractal)
        (e, g1, g2), cap = graph_cell(integ, pos)
        same = [bool(np.array_equal(g["acc"], e["acc"])) for g in (g1, g2)]
        stages = len(integ._stages(batch))
        say(f"graph {name}", size="x".join(map(str, shape[:2])),
            direct=shape[2], path=shape[3], depth=shape[4], batch=batch,
            seed=mode, eager_s=f"{e['secs']:.4f}",
            graph_capture_s=f"{g1['secs']:.4f}",
            graph_s=f"{g2['secs']:.4f}", bit_equal=same, trips=e["trips"],
            rays_traced=e["rays"], captures=cap["captures"],
            captures_s=f"{cap['capture_s']:.3f}",
            pool_bytes=cap["pool_bytes"], stages=stages, slots="while",
            host_reads=[g["host_reads"] for g in (g1, g2)],
            eager_host_reads=e["host_reads"],
            graph_launches=[g["graph_launches"] for g in (g1, g2)],
            launches=json.dumps(e["launches"], separators=(",", ":")),
            card=repr(card))
        for g in (g1, g2):
            if not (np.array_equal(g["acc"], e["acc"])
                    and g["trips"] == e["trips"] and g["rays"] == e["rays"]
                    and g["launches"] == e["launches"]):
                fail(f"graph {name}: against the eager drain: bit-equal "
                     f"{same}, trips {g['trips']} / {e['trips']}, queries "
                     f"{g['rays']} / {e['rays']}, launches {g['launches']} "
                     f"/ {e['launches']}")
            if g["host_reads"] > stages \
                    or g["graph_launches"] != g["host_reads"]:
                fail(f"graph {name}: {g['host_reads']} host reads and "
                     f"{g['graph_launches']} graph launches a pass, want "
                     f"one each a stage (at most {stages})")
        if not cap["captures"]:
            fail(f"graph {name}: no trip was captured")
        del integ


def phase_ab_bigscene(other):
    """K6 and K7 of this checkout against the same kernels built from
    another revision's bigscene_kernels.cu (`--ab-bigscene PATH`), on the
    inputs of the fractal render's largest K6 and K7 calls and of
    lamp_row's largest K7 call: outputs compared bit for bit, and device
    times in turns (graph_ms, AB_ROUNDS rounds; median and spread)."""
    import ctypes
    import hashlib
    import torch
    from actinon_tpu_torch.render import bigscene as bs
    from actinon_tpu_torch.render import kernels
    src = os.path.abspath(other)
    h = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    lib_path = os.path.join(kernels.BUILD_DIR, f"ab_bigscene_{h}.so")
    if not os.path.exists(lib_path):
        res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                              lib_path, src], capture_output=True, text=True)
        if res.returncode:
            fail(f"ab: nvcc failed on {src}:\n{res.stderr[-2000:]}")
    libs = {"head": kernels._lib(), "other": ctypes.CDLL(lib_path)}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["other"].actinon_big_top2.argtypes = [P, P, I, P, P, P, P, I, F, P]
    libs["other"].actinon_big_anyhit.argtypes = [P, P, I, P, P, P, P, I, F,
                                                 I, P]
    _, frac = spied_render([(bs, ("big_top2", "big_anyhit"))], "ab_fractal",
                           load_scene(FRACTAL, *FRACTAL_SHAPE), reps=1)
    _, lamp = spied_render([(bs, ("big_anyhit",))], "ab_lamp_row",
                           load_scene(LAMP, *LAMP_SHAPE), reps=1)

    def top2(lib, tr, p, d, out):
        big = tr._bigscene()
        rc = lib.actinon_big_top2(
            big.table.data_ptr(), big.bounds.data_ptr(), big.blocks.G,
            p.data_ptr(), d.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), p.shape[0], float(big.blocks.eps),
            kernels._stream())
        if rc:
            fail(f"ab: big_top2 launch failed ({rc})")

    def anyhit(lib, tr, p, d, lim, out):
        big = tr._bigscene()
        warp = bs.anyhit_design(big.blocks.G) == "warp"
        rc = lib.actinon_big_anyhit(
            big.table.data_ptr(), big.bounds.data_ptr(), big.blocks.G,
            p.data_ptr(), d.data_ptr(), lim.data_ptr(), out[0].data_ptr(),
            p.shape[0], float(big.blocks.eps), int(warp), kernels._stream())
        if rc:
            fail(f"ab: big_anyhit launch failed ({rc})")

    cases = [("big_top2 sphere_fractal", top2, frac["big_top2"]),
             ("big_anyhit sphere_fractal", anyhit, frac["big_anyhit"]),
             ("big_anyhit lamp_row", anyhit, lamp["big_anyhit"])]
    for tag, call, (tr, *args) in cases:
        n = args[0].shape[0]
        outs = {}
        for k in libs:
            if call is top2:
                outs[k] = (torch.empty((n, 2), dtype=torch.float32,
                                       device="cuda"),
                           torch.empty((n, 2), dtype=torch.int32,
                                       device="cuda"))
            else:
                outs[k] = (torch.empty((n,), dtype=torch.bool,
                                       device="cuda"),)
            call(libs[k], tr, *args, outs[k])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["head"],
                                                     outs["other"]))
        ms = graph_ms([lambda k=k: call(libs[k], tr, *args, outs[k])
                       for k in libs], rounds=AB_ROUNDS)
        med = {k: float(np.median(m)) for k, m in zip(libs, ms)}
        spread = {k: f"{min(m):.4f}-{max(m):.4f}" for k, m in zip(libs, ms)}
        say(f"ab {tag}", n=n, other=os.path.relpath(src, HERE),
            bit_equal=same, head_ms=f"{med['head']:.4f}",
            other_ms=f"{med['other']:.4f}", head_spread=spread["head"],
            other_spread=spread["other"])
        if not same:
            fail(f"ab {tag}: the two builds' outputs differ")


AB_ROUNDS = 7   # turns of (head, other) in phase_ab_bigscene


def phase_profile():
    """Under torch.profiler: phase 3 again, with each kernel's device time
    per launch beside its CUDA-graph time; then the headline,
    many_samples, lamp_row, sphere_fractal and counter-mode glass_table
    renders' device time by kernel and the device's busy share of the
    wall time (the profiler itself adds host time, so the share is a
    lower bound) and the host's launch calls a trip (the headline and
    lamp_row again with eager trips); then each graph-phase cell's drain
    on its own (profile_graph_drains), K1's device time in the shipped
    render (shipped_nee) and one diff value_and_grad (profile_diff)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    dev = lambda e: e.self_device_time_total
    with profile(activities=acts) as prof:
        ks = phase_kernels(1 << 15)
    shadow_sym = {"warp": "shadow_warp_kernel", "thread": "shadow_kernel"}
    for name, sym in (("nee_synthetic", "nee_kernel"),
                      ("shadow_synthetic",
                       shadow_sym[ks["shadow_synthetic"]["design"]]),
                      ("object_hit", "object_hit_kernel")):
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and sym in e.key]
        launches = sum(e.count for e in ev)
        per_launch = sum(map(dev, ev)) / launches / 1e3
        say(f"profile kernel {name}", launches=launches,
            device_ms_per_launch=f"{per_launch:.4f}",
            graph_ms_under_profiler=f"{ks[name]['ms']:.4f}")
    def eager(tag, sc, b):
        with eager_drains():
            return render(tag, sc, b)

    # each run returns its drains' trips
    runs = [(tag, lambda tag, sc=sc, b=b, fn=fn: fn(tag, sc, b)[-1]["trips"])
            for tag, sc, b, fn in (
                ("headline", load_scene(SCENE, *HEADLINE), 1 << 15, render),
                ("headline_eager", load_scene(SCENE, *HEADLINE), 1 << 15,
                 eager),
                ("many_samples", load_scene(SCENE, *MANY_DIRECT), 1 << 12,
                 render),
                ("lamp_row", load_scene(LAMP, *LAMP_SHAPE), 1 << 15, render),
                ("lamp_row_eager", load_scene(LAMP, *LAMP_SHAPE), 1 << 15,
                 eager),
                ("sphere_fractal", load_scene(FRACTAL, *FRACTAL_SHAPE),
                 1 << 15, render))]
    # the counter-mode glass_table render of phase 6: K2 and K3's renders
    counter = load_scene(SCENE, 64, 48, *HEADLINE[2:])
    runs.append(("counter", lambda tag: counter_render(
        counter, 1 << 15, True)[3].last_trips))
    for tag, run in runs:
        run(f"profile_warmup_{tag}")
        with profile(activities=acts) as prof:
            t0 = time.time()
            trips = run(f"profile_{tag}")
            wall = time.time() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(dev(e) for e in kern) / 1e6
        # the host's launch calls a trip: kernels one by one against
        # graph replays (the hand-written kernels launch through nvcc's
        # static runtime, which the profiler may not see)
        api = {e.key: e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaGraphLaunch")}
        say(f"profile {tag}", wall_s=f"{wall:.3f}",
            device_busy_s=f"{busy:.4f}", busy_share=f"{busy / wall:.4f}",
            kernel_names=len(kern), launches=sum(e.count for e in kern),
            trips=trips,
            launch_kernel_per_trip=f"{api.get('cudaLaunchKernel', 0) / trips:.1f}",
            graph_launch_per_trip=f"{api.get('cudaGraphLaunch', 0) / trips:.2f}")
        for e in sorted(kern, key=dev, reverse=True)[:12]:
            print(f"  device_ms={dev(e) / 1e3:.3f} calls={e.count} "
                  f"name={e.key[:90]!r}", flush=True)
        for sym in KERNEL_SYMS:
            ev = [e for e in kern if sym in e.key]
            if ev:
                say(f"profile {tag} {sym}", launches=sum(e.count for e in ev),
                    device_ms=f"{sum(map(dev, ev)) / 1e3:.3f}")
    profile_graph_drains(acts)
    shipped_nee()
    profile_diff()


@contextlib.contextmanager
def replay_spans():
    """Every CUDAGraph.replay within, bracketed by CUDA events: yields the
    list of (start, end) event pairs.  The profiler misses kernels that
    run inside conditional nodes (the counts and device time it reported
    for the same graph drain varied from run to run), so a graph's device
    time is its replays' spans."""
    import torch
    spans, orig = [], torch.cuda.CUDAGraph.replay

    def replay(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(graph)
        b.record()
        spans.append((a, b))

    torch.cuda.CUDAGraph.replay = replay
    try:
        yield spans
    finally:
        torch.cuda.CUDAGraph.replay = orig


def span_s(spans):
    """The summed device seconds of replay_spans' pairs (synchronises)."""
    import torch
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / 1e3


def profile_graph_drains(acts):
    """Each GRAPH_CELLS drain under torch.profiler on an integrator whose
    stages are captured already (one graph pass before): wall and busy
    seconds, busy share, the stage loop's host reads, and the host's
    cudaLaunchKernel and cudaGraphLaunch calls a trip; before it the same
    pass without the profiler, its wall and its graph replays' device
    span (replay_spans); then both with eager trips."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    fractal = load_scene(FRACTAL, *FRACTAL_SHAPE)
    for name, (path, shape, batch, mode) in GRAPH_CELLS.items():
        integ, pos = graph_integ(path, shape, batch, mode, fractal)
        for graphs in (True, False):
            integ.drain_graphs = graphs
            drain(integ, lambda: integ.run_device(None, len(pos),
                                                  pos_xy=pos))
            with replay_spans() as spans:
                _, _, _, wall_np = drain(integ, lambda: integ.run_device(
                    None, len(pos), pos_xy=pos))
            graph_dev = span_s(spans)
            with profile(activities=acts) as prof:
                _, _, _, wall = drain(integ, lambda: integ.run_device(
                    None, len(pos), pos_xy=pos))
            ev = prof.key_averages()
            busy = sum(e.self_device_time_total for e in ev
                       if e.device_type == DeviceType.CUDA) / 1e6
            api = {e.key: e.count for e in ev if e.key in (
                "cudaLaunchKernel", "cudaGraphLaunch")}
            trips = integ.last_trips
            say(f"profile graph {name}", graphs=graphs, wall_s=f"{wall:.4f}",
                device_busy_s=f"{busy:.4f}", busy_share=f"{busy / wall:.4f}",
                unprofiled_wall_s=f"{wall_np:.4f}",
                graph_device_s=f"{graph_dev:.4f}",
                trips=trips, host_reads=integ.last_host_reads,
                launch_kernel_per_trip=f"{api.get('cudaLaunchKernel', 0) / trips:.2f}",
                graph_launch_per_trip=f"{api.get('cudaGraphLaunch', 0) / trips:.2f}")
        del integ


def profile_diff():
    """One value_and_grad of phase 14 under torch.profiler (after one
    untraced call, which captures the graph), as a graph replay ("profile
    diff") and eagerly ("profile diff eager"): wall and device busy
    seconds, the host's cudaLaunchKernel and cudaGraphLaunch calls, and
    the device time of its largest op kinds; before it one call without
    the profiler, its wall and its graph replay's device span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sc = load_scene(SCENE, *HEADLINE)
    dr = diff_renderer(sc, np.float32, "cuda")
    q0 = dr.primary(diff_positions(sc.cfg, DIFF_LANES))
    for tag, graphs in (("profile diff", True),
                        ("profile diff eager", False)):
        dr.diff_graphs = graphs
        dr.value_and_grad(q0)
        with replay_spans() as spans:
            t0 = time.time()
            dr.value_and_grad(q0)
            torch.cuda.synchronize()
            wall_np = time.time() - t0
        graph_dev = span_s(spans)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            dr.value_and_grad(q0)
            torch.cuda.synchronize()
            wall = time.time() - t0
        ev = prof.key_averages()
        kern = [e for e in ev if e.device_type == DeviceType.CUDA]
        dev = lambda e: e.self_device_time_total
        busy = sum(dev(e) for e in kern) / 1e6
        api = {e.key: e.count for e in ev
               if e.key in ("cudaLaunchKernel", "cudaGraphLaunch")}
        say(tag, graphs=graphs, wall_s=f"{wall:.3f}",
            device_busy_s=f"{busy:.4f}", busy_share=f"{busy / wall:.4f}",
            unprofiled_wall_s=f"{wall_np:.4f}",
            graph_device_s=f"{graph_dev:.4f}",
            kernel_names=len(kern), launches=sum(e.count for e in kern),
            launch_kernel_per_call=api.get("cudaLaunchKernel", 0),
            graph_launch_per_call=api.get("cudaGraphLaunch", 0))
        for e in sorted(kern, key=dev, reverse=True)[:12]:
            print(f"  device_ms={dev(e) / 1e3:.3f} calls={e.count} "
                  f"name={e.key[:90]!r}", flush=True)


def shipped_nee():
    """K1's device time in the shipped render, whose 1,849 trips launch
    more kernels than the profiler can trace in the time limit: the
    render's K1 calls captured (inputs cloned), then replayed in one CUDA
    graph (graph_ms, 3 rounds)."""
    from actinon_tpu_torch.render import kernels
    calls, orig = [], kernels.nee

    def spy(integ, *a):
        calls.append((integ, tuple(x.clone() for x in a)))
        return orig(integ, *a)

    kernels.nee = spy
    try:
        with eager_drains():
            render("profile_shipped", load_scene(SCENE, *SHIPPED), 1 << 14)
    finally:
        kernels.nee = orig
    ms = graph_ms([lambda: [kernels.nee(i, *a) for i, a in calls]],
                  rounds=3, reps=1)[0]
    say("profile shipped nee_kernel", launches=len(calls),
        lanes=sum(a[0].shape[0] for _, a in calls),
        device_ms=f"{np.median(ms):.3f}",
        spread=f"{min(ms):.3f}-{max(ms):.3f}")


def main(argv):
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    sys.path.insert(0, HERE)
    try:
        import actinon_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not in this checkout ({e})", flush=True)
        return 2

    if argv[:1] == ["--mesh-worker"]:
        return mesh_worker(*argv[1:])
    t_all = time.time()
    kind, card = phase_card()
    phase_build()
    if "--profile" in argv:
        phase_profile()
        return 0
    if argv[:1] == ["--ab-bigscene"]:
        phase_ab_bigscene(argv[1])
        return 0
    ks = phase_kernels(1 << 15)

    from actinon_tpu_torch.render import kernels
    runs, cap = spied_render([(kernels, ("nee",))], "headline",
                             load_scene(SCENE, *HEADLINE), reps=2)
    hl = runs[-1]["launches"]
    integ, *args = cap.pop("nee")
    ks["nee"] = check_nee("nee render_batch", integ, tuple(args), dump=True)
    ks["nee"]["launches"] = hl["nee"]
    if int(runs[-1]["hash"]) != GLASS_HASH \
            or any(hl[k] for k in SCENE_KEYS):
        fail(f"slice 1 moved: headline hash {runs[-1]['hash']} (want "
             f"{GLASS_HASH}), launches {hl}")
    phase_many_samples()
    render("shipped", load_scene(SCENE, *SHIPPED), 1 << 14)
    cl, k2_cap, k2_sizes = phase_counter(64, 48)
    # K2 on the counter render's largest batch and its most frequent size
    big = max(k2_cap)
    small = max(set(k2_sizes), key=lambda n: (k2_sizes.count(n), -n))
    ks["shadow_any_hit"] = check_shadow("render_batch", *k2_cap[big])
    ks["shadow_small"] = check_shadow("render_small", *k2_cap[small])
    k2_sweep("render_batch", *k2_cap[big])
    k2_sweep("synthetic", *ks["shadow_synthetic"]["batch"])
    lamp_runs, cap = phase_lamp()
    ks.update(phase_scene_kernels(cap))
    for k in ("scene_top2", "scene_anyhit"):
        ks[k]["launches"] = lamp_runs[-1]["launches"][k]
    ks["big_anyhit_lamp"] = check_big_anyhit("lamp_row", cap["big_anyhit"])
    k7_sweep("lamp_row", cap["big_anyhit"])
    k7_launches(ks["big_anyhit_lamp"], lamp_runs, "lamp_row")
    phase_lamp_counter(*LAMP_COUNTER)
    t0 = time.time()
    fractal = load_scene(FRACTAL, *FRACTAL_SHAPE)
    say("load sphere_fractal", seconds=f"{time.time() - t0:.1f}")
    frac_runs, cap = phase_fractal(fractal)
    ks.update(phase_big_kernels(cap))
    ks["big_top2"]["launches"] = frac_runs[-1]["launches"]["big_top2"]
    k7_launches(ks["big_anyhit"], frac_runs, "sphere_fractal")
    k7_sweep("sphere_fractal", cap["big_anyhit"])
    phase_fractal_counter(fractal)
    phase_graph(fractal, card)
    ks.update(phase_ops())
    phase_diff()
    phase_oracle(card)
    ranks = phase_sharded(card)
    phase_queue(card, ranks, ks)
    wine = os.path.join(CORPUS, "wine_glass.acn")
    if CORPUS and os.path.exists(wine):
        render("wine_glass", load_scene(wine, *HEADLINE), 1 << 15)
    else:
        print(f"wine_glass: no wine_glass.acn in ACTINON_CORPUS="
              f"{CORPUS!r}; not rendered", flush=True)
    if ks["nee"]["launches"] <= 0:
        fail("the headline render never launched the NEE kernel")
    # K2's entries: the counter render's launches of each batch's design
    # (the synthetic batch, which no render issues, stays out of the line)
    for k in ("shadow_any_hit", "shadow_small"):
        ks[k]["launches"] = cl[f"shadow_{ks[k]['design']}"]
    if cl["shadow_warp"] + cl["shadow_thread"] != cl["shadow"] \
            or min(cl["shadow_warp"], cl["shadow_thread"]) <= 0:
        fail(f"counter-mode render: K2 launches {cl}, want both designs")
    ks["object_hit"]["launches"] = cl["object_hit"]
    print(f"total seconds {time.time() - t_all:.1f}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: ks[n][k] for k in keys} for n in (
        "nee", "shadow_any_hit", "shadow_small", "object_hit", "scene_top2", "scene_anyhit", "big_top2",
        "big_anyhit", "big_anyhit_lamp", "diag_unary", "diag_expr")]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
