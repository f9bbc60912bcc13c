// Packed scene kernels, hand-written for Hopper (sm_90a).
//
//   scene_top2_kernel   (K4) replaces actinon_tpu/render/pallas_scene.py
//                       build_kernels -> kernel_top2: the global top-2
//                       eps-backed candidates over the packed table —
//                       singles, standalone SDFs, solo clusters, analytic
//                       groups — as packed winner codes
//                       shape << 24 | member << 8 | leaf.
//   scene_anyhit_kernel (K5) replaces build_kernels -> kernel_anyhit: any
//                       matter hit within (., limit] over the matter-only
//                       table.
//
// The table is the JAX package's, value for value (built by
// render/scene_kernels.py): [TOT, 128] f32 rows, one block of 128 member
// lanes per row group, feature-major; [NB, 8] block bounding spheres; and
// an int32 shape descriptor (SH_* records, then slots, postfix CSG
// programs and the host's Batcher comparator pairs).
//
// Per member, the f32 expressions of the Pallas helpers: the
// generalized-quadric roots and root policy, the envelope interval, the
// bidirectional sphere march (a loop of at most `cycles` steps that ends
// at the crossing, at the envelope exit, or at the shadow limit), 4
// sequential marches per SDF slot of a cluster, and the sorted incremental
// toggle walk: the host's comparator pairs sort up to 64 crossings in a
// local array, then one sweep toggles a 32-bit inside mask and evaluates
// the postfix CSG program until the first flip.  Each ray walks the shapes
// in table order and each shape's member blocks of 128; a block whose
// bound the ray misses (per ray: exact, because every member's envelope
// lies inside the bound) is skipped.  No atomics: results are
// deterministic.
//
// Both kernels: one warp per ray, the 128 member lanes of a block across
// the warp, as the TPU kernel lays them across the vector lanes of a
// [rays, 128] tile; 4 warps (rays) a thread block.  Each thread block
// first copies the int32 descriptor into shared memory, so every
// descriptor field, slot record, postfix program and comparator pair that
// member_boundary reads comes from there; only the descriptor must fit,
// so the block count has no limit.  Per 32 blocks, lane j tests block
// c * 32 + j against the ray, and a ballot gives the warp the passed
// blocks in ascending order, which is the table's order: shape by shape,
// each shape's blocks in turn.  Lane j evaluates members j, j + 32,
// j + 64, j + 96 of a block (each feature row read as 32 neighbouring
// floats).  What this does not do: a warp still waits for its longest
// march while its gated-out lanes idle, and a cluster member's 64
// crossings still sort in local memory (the ts/lf arrays of
// member_boundary).
//
// K4 passes the block bounds' (centre, r2) through shared memory kChunk
// at a time with cp.async, the next chunk in flight while the warps test
// the current one (the staging of csrc/bigscene_kernels.cu); a warp past
// the last ray still stages and meets the barriers.  It keeps a local
// top-2 of (t, code) per lane; five xor shuffles combine the 32 local
// pairs into the block's best two, then every lane runs the Pallas merge
// (pallas_scene.py:870-881).  The tie rule is the serial one (members in
// order, strict compares, first lane on ties), bit for bit: see
// csrc/bigscene_kernels.cu, whose argument holds here with the code for
// the lane index (a code grows with its lane within a block) and
// (INF, -1) for the pad; a light member masked for a matter ray is no
// candidate, as in the serial walk.  The blocks merge in table order, as
// the serial walk merges them.
//
// K5 reads the bounds through L1 (__ldg): its warps stride over the rays
// with no barrier of the thread block.  Staging the bounds in shared
// memory, for the thread block or for each warp, measured slower on an
// H100 (lamp_row's largest shadow batch: 0.58 and 0.60 ms against 0.51),
// with more spills in the member test (40/56 bytes against 24/36).  It
// tests each member's boundary against the limit with the one-thread
// design's expression, and the warp stops at the first round of 32
// members in which any lane is blocked (__any_sync).  The result is an
// OR, so any order and any exit point give the same boolean: the warp
// kernel's booleans are the one-thread kernel's on every input.  Its
// grid is capped at the thread blocks the card holds at once, and each
// warp strides over the rays, so a large batch of shadow rays copies the
// descriptor once per resident block, not once per 4 rays.
//
// Both read a passed block's shape index (the table's block_shape)
// through L1.
//
// What bounds them on this card: FP32 operations — the march steps and the
// walk — not bytes (a ray reads 28 bytes and writes at most 16, the table
// stays in L2).  The design keeps the work to what each ray needs: per-ray
// block culls, member envelope gates before any root or march, early-exit
// marches with the envelope-exit and limit bails, and a sweep that ends at
// the first flip.
//
// Numerics: f32, no fast-math.  Interface: plain C functions, loaded with
// ctypes.  Each launches on the stream it is given and returns
// cudaGetLastError().  The kernels' helpers compile as host C++ too
// (tests/test_torch_scene_kernels.py runs them there); the warp kernel,
// which needs the card's shuffles and shared memory, does not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- descriptor layout (must match render/scene_kernels.py) ----
enum {
    SH_KIND = 0, SH_NBLK = 1, SH_M = 2, SH_ROW0 = 3, SH_RPB = 4,
    SH_BID0 = 5, SH_ID = 6, SH_LIGHT = 7, SH_LC = 8, SH_NAN = 9,
    SH_NSDF = 10, SH_AUX = 11, SH_PROG = 12, SH_PLEN = 13, SH_PAIRS = 14,
    SH_NPAIRS = 15, SH_SIZE = 16
};
enum { K_SINGLES = 0, K_SDFSINGLE = 1, K_CLUSTER = 2 };
enum { SDF_SPHERE = 0, SDF_TORUS = 1 };
enum { OP_AND = -1, OP_OR = -2, OP_NOT = -3 };
constexpr int LB = 128;
constexpr int HDR = 6;
constexpr int AN_ROWS = 20;
constexpr int SDF_ROWS = 13;
constexpr int NC_CAP = 64;
constexpr int N_CROSS = 4;
constexpr float F32_BIG = 3e38f;

__device__ __forceinline__ float finf() { return __int_as_float(0x7f800000); }

// false for +-INF and NaN, as jnp.isfinite
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < finf(); }

struct Ray {
    float px, py, pz, dx, dy, dz;
};

// The feature column of one member lane: feature f lies LB floats after
// feature f-1.
struct Lane {
    const float* __restrict__ base;
    __device__ __forceinline__ float operator[](int f) const {
        return __ldg(base + f * LB);
    }
};

// Per-launch constants: eps and the shells derived from it, rounded to
// f32 as pallas_scene.build_kernels rounds them.
struct Eps {
    float eps, eps4, slack, accept;
};

// ---- per-member math (pallas_scene.py:379-463) ----

// (A, B, C) of the generalized quadric of the 20 rows at `off`.
__device__ __forceinline__ void quad_lane(const Lane& L, int off,
                                          const Ray& r, float& A, float& B,
                                          float& C) {
    float pl[3], dl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float m0 = L[off + 3 * i], m1 = L[off + 3 * i + 1],
                    m2 = L[off + 3 * i + 2];
        pl[i] = ((m0 * r.px + m1 * r.py) + m2 * r.pz) + L[off + 9 + i];
        dl[i] = (m0 * r.dx + m1 * r.dy) + m2 * r.dz;
    }
    const float c2x = L[off + 12], c2y = L[off + 13], c2z = L[off + 14];
    const float c1x = L[off + 15], c1y = L[off + 16], c1z = L[off + 17];
    A = ((c2x * dl[0]) * dl[0] + (c2y * dl[1]) * dl[1])
        + (c2z * dl[2]) * dl[2];
    B = 2.0f * (((c2x * dl[0]) * pl[0] + (c2y * dl[1]) * pl[1])
                + (c2z * dl[2]) * pl[2])
        + ((c1x * dl[0] + c1y * dl[1]) + c1z * dl[2]);
    C = ((((c2x * pl[0]) * pl[0] + (c2y * pl[1]) * pl[1])
          + (c2z * pl[2]) * pl[2])
         + ((c1x * pl[0] + c1y * pl[1]) + c1z * pl[2]))
        + L[off + 18];
}

// Both roots, INF-padded (tracer._roots); s, q and ok for the policy.
__device__ __forceinline__ void roots_lane(float A, float B, float C,
                                           float& t0u, float& t1u, float& s,
                                           float& q, bool& ok) {
    const float inf = finf();
    const bool is_quad = A != 0.0f;
    const float safe_A = is_quad ? A : 1.0f;
    s = (B * 0.5f) / safe_A;
    q = C / safe_A;
    const float disc = fmaf(s, s, -q);   // rounded once, as tracer._disc
    ok = is_quad && (disc >= 0.0f);
    const float root = sqrtf(ok ? disc : 0.0f);
    const float ta = -s - root;
    const float tb = -s + root;
    float t0 = ta, t1 = tb;
    if (s < 0.0f) t0 = fabsf(tb) > 0.0f ? q / tb : ta;
    if (s > 0.0f) t1 = fabsf(ta) > 0.0f ? q / ta : tb;
    const float t_lin = B != 0.0f ? -C / B : inf;
    t0u = is_quad ? (ok ? t0 : inf) : t_lin;
    t1u = is_quad ? (ok ? t1 : inf) : inf;
}

// Family root policy with the lane's kind (tracer._policy), eps-backed.
__device__ __forceinline__ float policy_lane(float kind, float t0u,
                                             float t1u, float s, float q,
                                             bool ok, float eps) {
    const float inf = finf();
    if (kind == 0.0f) return t0u > 0.0f ? t0u - eps : inf;       // plane
    if (kind == 1.0f) {                                           // sphere
        const bool entering = (s < 0.0f) && (q > 0.0f);
        const bool exiting = (s < 0.0f) || (q < 0.0f);
        const float a = entering ? t0u : (exiting ? t1u : inf);
        return ok ? a - eps : inf;
    }
    const float a = t0u >= 0.0f ? t0u : (t1u >= 0.0f ? t1u : inf);
    return is_finite(a) ? a - eps : inf;
}

// (gate, t_in, t_out) of the lane's envelope sphere; no envelope (r <= 0)
// gates True with the whole line.
__device__ __forceinline__ bool env_interval_lane(const Lane& L,
                                                  const Ray& r, float& t_in,
                                                  float& t_out) {
    const float er = L[5];
    const float ex = r.px - L[2], ey = r.py - L[3], ez = r.pz - L[4];
    // each multiply-add rounded once, er er apart, as
    // scene_kernels._env_interval_lane and XLA's compiled Pallas helper
    // round them
    const float s = fmaf(ez, r.dz, fmaf(ex, r.dx, ey * r.dy));
    const float q = fmaf(ez, ez, fmaf(ex, ex, ey * ey)) - __fmul_rn(er, er);
    const float disc = fmaf(s, s, -q);
    const bool hit = (disc >= 0.0f) && ((s < 0.0f) || (q < 0.0f));
    const bool no_env = er <= 0.0f;
    const float root = sqrtf(disc > 0.0f ? disc : 0.0f);
    t_in = no_env ? 0.0f : fmaxf(-s - root, 0.0f);
    t_out = no_env ? F32_BIG : -s + root;
    return no_env || hit;
}

__device__ __forceinline__ float sdf_eval(int kind, float prm, float x,
                                          float y, float z) {
    if (kind == SDF_SPHERE) return sqrtf((x * x + y * y) + z * z) - 1.0f;
    const float f = sqrtf(x * x + y * y);
    const float f_inv = f > 0.0f ? 1.0f / f : 1.0f;
    const float xu = x * f_inv - x, yu = y * f_inv - y;
    return sqrtf((xu * xu + yu * yu) + z * z) - prm;
}

// The ray in the SDF slot's unit frame: local origin, unit local
// direction, and the direction's local norm dn.
__device__ __forceinline__ void sdf_local(const Lane& L, int off,
                                          const Ray& r, float pl[3],
                                          float dl[3], float& dn) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float m0 = L[off + 3 * i], m1 = L[off + 3 * i + 1],
                    m2 = L[off + 3 * i + 2];
        pl[i] = ((m0 * r.px + m1 * r.py) + m2 * r.pz) + L[off + 9 + i];
        dl[i] = (m0 * r.dx + m1 * r.dy) + m2 * r.dz;
    }
    dn = sqrtf((dl[0] * dl[0] + dl[1] * dl[1]) + dl[2] * dl[2]);
    const float inv = dn > 0.0f ? 1.0f / dn : 1.0f;
    dl[0] *= inv;
    dl[1] *= inv;
    dl[2] *= inv;
}

// Bidirectional sphere march from local offset offs0 (tracer._sdf_march):
// at most `cycles` steps; stops at the crossing or once the total offset
// passes stop_total (the envelope exit or the shadow limit, local units).
__device__ __forceinline__ void march(int kind, int cycles, float prm,
                                      const float pl[3], const float dl[3],
                                      float offs0, float stop_total,
                                      float eps, float& offs_l,
                                      float& dist) {
    const float p0x = pl[0] + dl[0] * offs0, p0y = pl[1] + dl[1] * offs0,
                p0z = pl[2] + dl[2] * offs0;
    float dd = sdf_eval(kind, prm, p0x, p0y, p0z);
    const bool forward = dd > 0.0f;
    float o1 = 0.0f;
    for (int i = 0; i < cycles; ++i) {
        o1 += forward ? dd + eps : -(dd - eps);
        dd = sdf_eval(kind, prm, p0x + dl[0] * o1, p0y + dl[1] * o1,
                      p0z + dl[2] * o1);
        const bool crossed = forward ? ((dd < 0.0f) || (dd > 1e30f))
                                     : ((dd > 0.0f) || (dd < -1e30f));
        if (crossed || offs0 + o1 > stop_total) break;
    }
    offs_l = offs0 + o1;
    dist = dd;
}

// Postfix CSG program on one inside-bit set (bit l = local leaf l).
__device__ __forceinline__ bool tree_eval(const int* __restrict__ prog,
                                          int n, uint32_t bits) {
    uint64_t st = 0;   // bit stack, top at bit 0
    for (int k = 0; k < n; ++k) {
        const int op = prog[k];
        if (op >= 0) {
            st = (st << 1) | ((bits >> op) & 1u);
        } else if (op == OP_NOT) {
            st ^= 1u;
        } else {
            const uint64_t a0 = st & 1u, a1 = (st >> 1) & 1u;
            const uint64_t v = op == OP_AND ? (a0 & a1) : (a0 | a1);
            st = ((st >> 2) << 1) | v;
        }
    }
    return (st & 1u) != 0;
}

// Eps-backed, envelope-gated boundary of one member (shape_boundary,
// pallas_scene.py:546-803) and its winning local leaf.  has_lim: the
// any-hit query, whose marches also bail past the shadow limit.
__device__ float member_boundary(const int* __restrict__ desc,
                                 const int* __restrict__ sh, const Lane& L,
                                 const Ray& r, bool has_lim, float lim,
                                 const Eps& E, int& leaf) {
    const float inf = finf();
    leaf = 0;
    float t_in_raw, t_out_raw;
    const bool gate = env_interval_lane(L, r, t_in_raw, t_out_raw)
                      && L[0] > 0.0f;
    if (!gate) return inf;
    const int kind = sh[SH_KIND];
    const int* aux = desc + sh[SH_AUX];

    if (kind == K_SINGLES) {
        float A, B, C, t0u, t1u, s, q;
        bool ok;
        quad_lane(L, HDR, r, A, B, C);
        roots_lane(A, B, C, t0u, t1u, s, q, ok);
        return policy_lane(L[HDR + 19], t0u, t1u, s, q, ok, E.eps);
    }

    if (kind == K_SDFSINGLE) {
        // envelope-clipped entry, ONE bidirectional march
        const int sk = aux[1], cycles = aux[2];
        float pl[3], dl[3], dn;
        sdf_local(L, HDR, r, pl, dl, dn);
        float stop_w = t_out_raw + E.slack;
        if (has_lim) stop_w = fminf(stop_w, lim + E.slack);
        float offs_l, dist;
        march(sk, cycles, L[HDR + 12], pl, dl, t_in_raw * dn, stop_w * dn,
              E.eps, offs_l, dist);
        const float dn_inv = dn > 0.0f ? 1.0f / dn : 1.0f;
        return fabsf(dist) <= E.accept ? offs_l * dn_inv - E.eps : inf;
    }

    // -- cluster: crossings, then the sorted incremental toggle walk --
    const float t_in = fmaxf(t_in_raw - E.slack, 0.0f);
    const float t_out = t_out_raw + E.slack;
    float ts[NC_CAP];
    uint8_t lf[NC_CAP];
    int nc = 0;
    uint32_t inside = 0;
    int off = HDR;
    const int n_an = sh[SH_NAN], n_sdf = sh[SH_NSDF];
    for (int k = 0; k < n_an; ++k, off += AN_ROWS) {
        const int li = aux[k];
        float A, B, C, t0u, t1u, s, q;
        bool ok;
        quad_lane(L, off, r, A, B, C);
        roots_lane(A, B, C, t0u, t1u, s, q, ok);
        ts[nc] = t0u > 0.0f ? t0u : inf;
        lf[nc++] = (uint8_t)li;
        ts[nc] = t1u > 0.0f ? t1u : inf;
        lf[nc++] = (uint8_t)li;
        if (C <= 0.0f) inside |= 1u << li;
    }
    for (int k = 0; k < n_sdf; ++k, off += SDF_ROWS) {
        const int* slot = aux + n_an + 4 * k;
        const int li = slot[0], sk = slot[1], cycles = slot[2];
        float pl[3], dl[3], dn;
        sdf_local(L, off, r, pl, dl, dn);
        const float prm = L[off + 12];
        const float dn_inv = 1.0f / (dn > 0.0f ? dn : 1.0f);
        // N_CROSS sequential marches clipped to the envelope interval
        float offs = t_in * dn;
        const float stop_l = (has_lim ? fminf(t_out, lim + E.slack)
                                      : t_out) * dn;
        bool dead = false;
        for (int c = 0; c < N_CROSS; ++c) {
            float t_world = inf;
            if (!dead) {
                float offs_l, dist;
                march(sk, cycles, prm, pl, dl, offs, stop_l, E.eps, offs_l,
                      dist);
                const bool hit = fabsf(dist) <= E.accept && offs_l <= stop_l;
                if (hit && offs_l > 0.0f) t_world = offs_l * dn_inv;
                dead = !hit;
                offs = offs_l + E.eps4;
            }
            ts[nc] = t_world;
            lf[nc++] = (uint8_t)li;
        }
        // origin inside-ness at the TRUE ray origin
        if (sdf_eval(sk, prm, pl[0], pl[1], pl[2]) <= 0.0f)
            inside |= 1u << li;
    }
    // Batcher network (the host's comparator pairs): ascending, INF last
    const int* pairs = desc + sh[SH_PAIRS];
    const int npairs = sh[SH_NPAIRS];
    for (int k = 0; k < npairs; ++k) {
        const int i = pairs[2 * k], j = pairs[2 * k + 1];
        if (ts[i] > ts[j]) {
            const float tt = ts[i];
            ts[i] = ts[j];
            ts[j] = tt;
            const uint8_t ll = lf[i];
            lf[i] = lf[j];
            lf[j] = ll;
        }
    }
    // one sweep: each crossing toggles its leaf's bit; coincident
    // crossings flip jointly (the test fires where a tie run ends); the
    // first flip is the boundary
    const int* prog = desc + sh[SH_PROG];
    const int plen = sh[SH_PLEN];
    uint32_t state = inside;
    bool v_run = tree_eval(prog, plen, state);
    float best = inf;
    for (int j = 0; j < nc && is_finite(ts[j]); ++j) {
        state ^= 1u << lf[j];
        const bool v_new = tree_eval(prog, plen, state);
        const float t_next = j + 1 < nc ? ts[j + 1] : inf;
        if (ts[j] != t_next) {
            if (v_new != v_run) {
                best = ts[j];
                leaf = lf[j];
                break;
            }
            v_run = v_new;
        }
    }
    return best < F32_BIG ? best - E.eps : inf;
}

// The ray may touch the bound of centre (bx, by, bz) and squared radius r2
// (r2 < 0: unbounded).  has_lim: the any-hit test, where the bound's entry
// must lie within the limit.
__device__ __forceinline__ bool bound_hit(float bx, float by, float bz,
                                          float r2, const Ray& r,
                                          bool has_lim, float lim) {
    if (r2 < 0.0f) return true;
    const float ex = bx - r.px, ey = by - r.py, ez = bz - r.pz;
    const float s = fmaf(ez, r.dz, fmaf(ex, r.dx, ey * r.dy));
    const float q = fmaf(ez, ez, fmaf(ex, ex, ey * ey)) - r2;
    const float disc = fmaf(s, s, -q);
    const bool hit = (disc >= 0.0f) && ((s > 0.0f) || (q < 0.0f));
    if (!has_lim) return hit;
    const float te = fmaxf(s - sqrtf(disc >= 0.0f ? disc : 0.0f), 0.0f);
    return hit && (te <= lim);
}

__device__ __forceinline__ Eps make_eps(float eps) {
    return Eps{eps, 4.0f * eps, 8.0f * eps, 1.5f * eps};
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ p,
                                        const float* __restrict__ d, int i) {
    return Ray{p[3 * i], p[3 * i + 1], p[3 * i + 2],
               d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// ---- K4's top-2 helpers (the tie rule: csrc/bigscene_kernels.cu) ----

// Two (t, code) candidates, t1 before t2: a block's best two members, or
// a ray's best two.
struct Top2 {
    float t1, t2;
    int i1, i2;
};

__device__ __forceinline__ Top2 top2_empty() {
    return Top2{finf(), finf(), -1, -1};
}

// (a, ia) comes before (b, ib) under the order (t, code).
__device__ __forceinline__ bool top2_before(float a, int ia, float b,
                                            int ib) {
    return a < b || (a == b && ia < ib);
}

// One step of the serial rule: candidate a of code i, pushed after every
// member that v already saw, with strict compares.
__device__ __forceinline__ void top2_push(Top2& v, float a, int i) {
    if (a < v.t1) {
        v.t2 = v.t1;
        v.i2 = v.i1;
        v.t1 = a;
        v.i1 = i;
    } else if (a < v.t2) {
        v.t2 = a;
        v.i2 = i;
    }
}

// The best two of the union of two disjoint candidate sets, under
// (t, code): what each xor-shuffle step applies.
__device__ __forceinline__ Top2 top2_combine(const Top2& x, const Top2& y) {
    if (top2_before(y.t1, y.i1, x.t1, x.i1)) {
        const bool xs = top2_before(x.t1, x.i1, y.t2, y.i2);
        return Top2{y.t1, xs ? x.t1 : y.t2, y.i1, xs ? x.i1 : y.i2};
    }
    const bool ys = top2_before(y.t1, y.i1, x.t2, x.i2);
    return Top2{x.t1, ys ? y.t1 : x.t2, x.i1, ys ? y.i1 : x.i2};
}

// Lane j's local best two of member block b of shape sh: members j,
// j + 32, j + 64, j + 96 below the block's member count, in ascending
// order; a light member is skipped where mask_light.
__device__ __forceinline__ Top2 lane_top2(const int* __restrict__ desc,
                                          const int* __restrict__ sh,
                                          const float* __restrict__ blk,
                                          int b, int j, const Ray& r,
                                          bool mask_light, const Eps& E) {
    Top2 v = top2_empty();
    const int n_lanes = min(LB, sh[SH_M] - b * LB);
    for (int lane = j; lane < n_lanes; lane += 32) {
        const Lane L{blk + lane};
        if (mask_light && L[1] > 0.0f) continue;
        int leaf;
        const float a = member_boundary(desc, sh, L, r, false, 0.0f, E,
                                        leaf);
        top2_push(v, a, (sh[SH_ID] << 24) | ((b * LB + lane) << 8) | leaf);
    }
    return v;
}

// The Pallas merge (pallas_scene.py:870-881) of a block's best two b into
// the ray's pair.
__device__ __forceinline__ void top2_merge(Top2& ray, const Top2& b) {
    const float hi_t = fmaxf(ray.t1, b.t1);
    const int hi_i = b.t1 < ray.t1 ? ray.i1 : b.i1;
    const float w2 = fminf(ray.t2, b.t2);
    const int w2i = b.t2 < ray.t2 ? b.i2 : ray.i2;
    ray.i1 = b.t1 < ray.t1 ? b.i1 : ray.i1;
    ray.t1 = fminf(ray.t1, b.t1);
    ray.t2 = fminf(hi_t, w2);
    ray.i2 = hi_t <= w2 ? hi_i : w2i;
}

// K5's test of member m of a block: a matter hit within (., lim].
__device__ __forceinline__ bool member_blocks(const int* __restrict__ desc,
                                              const int* __restrict__ sh,
                                              const float* __restrict__ blk,
                                              int m, const Ray& r, float lim,
                                              const Eps& E) {
    int leaf;
    return member_boundary(desc, sh, Lane{blk + m}, r, true, lim, E, leaf)
           <= lim;
}

// ---- kernels ----

constexpr int kTop2Warps = 4;   // K4: rays (one warp each) a thread block
constexpr int kAnyWarps = 4;    // K5: rays (one warp each) a thread block

constexpr int kChunk = 128;      // K4: block bounds a shared-memory
                                 // stage holds

// The descriptor's words in shared memory, padded to 16 bytes.
__host__ __device__ __forceinline__ int desc_words(int n_desc) {
    return (n_desc + 3) / 4 * 4;
}

// K4's dynamic shared memory: the descriptor, padded, then two stages of
// kChunk bounds' (centre, r2).  K5's: the descriptor alone.
inline size_t top2_shared_bytes(int n_desc) {
    return 4 * ((size_t)desc_words(n_desc) + 2 * kChunk * 4);
}

// The member blocks of all shapes: the bounds they own, in shape order.
__device__ __forceinline__ int table_blocks(const int* desc) {
    if (desc[0] == 0) return 0;
    const int* last = desc + 1 + (desc[0] - 1) * SH_SIZE;
    return last[SH_BID0] + last[SH_NBLK];
}

// The ray may touch block bid's bound (K5 reads it through L1).
__device__ __forceinline__ bool block_cull(const float* __restrict__ bounds,
                                           int bid, const Ray& r,
                                           bool has_lim, float lim) {
    const float* b = bounds + 8 * bid;
    return bound_hit(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), r,
                     has_lim, lim);
}

// The table rows of member block b of shape sh.
__device__ __forceinline__ const float* block_rows(
    const float* __restrict__ table, const int* sh, int b) {
    return table + (size_t)(sh[SH_ROW0] + b * sh[SH_RPB]) * LB;
}

#ifdef __CUDACC__

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ Top2 shfl_xor(const Top2& v, int m) {
    return Top2{__shfl_xor_sync(kFull, v.t1, m),
                __shfl_xor_sync(kFull, v.t2, m),
                __shfl_xor_sync(kFull, v.i1, m),
                __shfl_xor_sync(kFull, v.i2, m)};
}

// Stage bounds [g0, g0 + m): the first four words (centre, r2) of each
// 32-byte row, one 16-byte cp.async a bound, as one commit group (as
// csrc/bigscene_kernels.cu stages its bounds).
__device__ __forceinline__ void stage_bounds(float (*dst)[4],
                                             const float* __restrict__ bounds,
                                             int g0, int m) {
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(dst[k]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(bounds + 8 * (size_t)(g0 + k)));
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void stage_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Waits for chunk c of n_chunks (starting chunk c + 1's copy into the
// other stage first) and meets the barrier that makes it visible.
__device__ __forceinline__ void stage_next(float (*stage)[kChunk][4],
                                           const float* __restrict__ bounds,
                                           int c, int n_chunks, int n_blk) {
    if (c + 1 < n_chunks) {
        const int g1 = (c + 1) * kChunk;
        stage_bounds(stage[(c + 1) & 1], bounds, g1,
                     min(kChunk, n_blk - g1));
        stage_wait<1>();
    } else {
        stage_wait<0>();
    }
    __syncthreads();
}

// Copies the descriptor to the start of the thread block's dynamic shared
// memory (every thread of the block meets the barrier) and returns the
// bound stages that follow it, laid out as top2_shared_bytes counts
// them.
__device__ __forceinline__ float (*stage_desc(int* shared,
                                              const int* __restrict__ desc,
                                              int n_desc))[kChunk][4] {
    for (int k = threadIdx.x; k < n_desc; k += blockDim.x)
        shared[k] = desc[k];
    __syncthreads();
    return reinterpret_cast<float (*)[kChunk][4]>(shared
                                                  + desc_words(n_desc));
}

__global__ void __launch_bounds__(kTop2Warps * 32)
scene_top2_kernel(const float* __restrict__ table,
                  const float* __restrict__ bounds,
                  const int* __restrict__ bshape,
                  const int* __restrict__ desc, const float* __restrict__ p,
                  const float* __restrict__ d, const float* __restrict__ lm,
                  float* __restrict__ t_out, int* __restrict__ c_out, int n,
                  float eps, int n_desc) {
    extern __shared__ __align__(16) int shared[];
    const int* sdesc = shared;
    float(*stage)[kChunk][4] = stage_desc(shared, desc, n_desc);
    const int n_blk = table_blocks(sdesc);
    const int i = blockIdx.x * kTop2Warps + (threadIdx.x >> 5);
    // a warp past the last ray still stages and meets the barriers
    const bool live = i < n;
    const int lane = threadIdx.x & 31;
    const Ray r = load_ray(p, d, live ? i : 0);
    const bool lane_matter = live && lm[i] > 0.0f;
    const Eps E = make_eps(eps);
    Top2 ray = top2_empty();
    const int n_chunks = (n_blk + kChunk - 1) / kChunk;
    if (n_chunks > 0) stage_bounds(stage[0], bounds, 0, min(kChunk, n_blk));
    for (int c = 0; c < n_chunks; ++c) {
        stage_next(stage, bounds, c, n_chunks, n_blk);
        const int g0 = c * kChunk, m = min(kChunk, n_blk - g0);
        if (live) {
            const float(*sb)[4] = stage[c & 1];
            for (int s0 = 0; s0 < m; s0 += 32) {
                const int j = s0 + lane;
                const bool pass = j < m && bound_hit(sb[j][0], sb[j][1],
                                                     sb[j][2], sb[j][3], r,
                                                     false, 0.0f);
                for (unsigned mask = __ballot_sync(kFull, pass); mask;
                     mask &= mask - 1) {
                    const int bid = g0 + s0 + __ffs(mask) - 1;
                    const int* sh = sdesc + 1 + __ldg(bshape + bid) * SH_SIZE;
                    const int b = bid - sh[SH_BID0];
                    const bool mask_light = sh[SH_LIGHT] && lane_matter;
                    Top2 v = lane_top2(sdesc, sh, block_rows(table, sh, b),
                                       b, lane, r, mask_light, E);
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        v = top2_combine(v, shfl_xor(v, o));
                    top2_merge(ray, v);
                }
            }
        }
        // the stage just read is refilled by the next chunk's prefetch
        __syncthreads();
    }
    if (live && lane == 0) {
        t_out[2 * i] = ray.t1;
        t_out[2 * i + 1] = ray.t2;
        c_out[2 * i] = is_finite(ray.t1) ? ray.i1 : -1;
        c_out[2 * i + 1] = is_finite(ray.t2) ? ray.i2 : -1;
    }
}

__global__ void __launch_bounds__(kAnyWarps * 32)
scene_anyhit_kernel(const float* __restrict__ table,
                    const float* __restrict__ bounds,
                    const int* __restrict__ bshape,
                    const int* __restrict__ desc,
                    const float* __restrict__ p, const float* __restrict__ d,
                    const float* __restrict__ lim_in,
                    uint8_t* __restrict__ out, int n, float eps, int n_desc) {
    extern __shared__ __align__(16) int shared[];
    for (int k = threadIdx.x; k < n_desc; k += blockDim.x)
        shared[k] = desc[k];
    __syncthreads();
    const int* sdesc = shared;
    const int n_blk = table_blocks(sdesc);
    const int lane = threadIdx.x & 31;
    const Eps E = make_eps(eps);
    for (int i = blockIdx.x * kAnyWarps + (threadIdx.x >> 5); i < n;
         i += gridDim.x * kAnyWarps) {
        const Ray r = load_ray(p, d, i);
        // a limit that is not finite reads as 3e38, as in the Pallas kernel
        const float l = lim_in[i];
        const float lim = is_finite(l) ? l : F32_BIG;
        // blocked and pass are the same on every lane (they come from
        // __any_sync and __ballot_sync), so every loop is uniform
        bool blocked = false;
        for (int c0 = 0; c0 < n_blk && !blocked; c0 += 32) {
            unsigned pass = __ballot_sync(
                kFull, c0 + lane < n_blk
                           && block_cull(bounds, c0 + lane, r, true, lim));
            while (pass != 0u && !blocked) {
                const int bid = c0 + __ffs(pass) - 1;
                pass &= pass - 1u;
                const int* sh = sdesc + 1 + __ldg(bshape + bid) * SH_SIZE;
                const int b = bid - sh[SH_BID0];
                const float* blk = block_rows(table, sh, b);
                const int n_lanes = min(LB, sh[SH_M] - b * LB);
                for (int m0 = 0; m0 < n_lanes && !blocked; m0 += 32) {
                    const int m = m0 + lane;
                    blocked = __any_sync(
                        kFull, m < n_lanes && member_blocks(sdesc, sh, blk, m,
                                                            r, lim, E));
                }
            }
        }
        if (lane == 0) out[i] = blocked ? 1 : 0;
    }
}

constexpr size_t kMaxShared = 232448;   // what a thread block may have

inline int grid_of(int n, int per_block) {
    return (n + per_block - 1) / per_block;
}

// Sets the kernel's dynamic shared memory above the default 48 KB where
// it needs more; refuses (cudaErrorInvalidValue) more than a thread block
// may have.  Each kernel's setting is made once per device and size, so a
// launch captured into a CUDA graph after its first launch calls nothing
// but cudaGetDevice here.
template <class Kernel>
int shared_ok(Kernel kernel, size_t shared) {
    if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
    if (shared <= 48 * 1024) return 0;
    struct Set { const void* fn; int dev; size_t bytes; };
    static Set set[16];
    static int n_set = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* fn = (const void*)kernel;
    int at = -1;
    for (int i = 0; i < n_set; ++i)
        if (set[i].fn == fn && set[i].dev == dev) at = i;
    if (at >= 0 && set[at].bytes >= shared) return 0;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
    if (at < 0 && n_set < 16) at = n_set++;
    if (at >= 0) set[at] = Set{fn, dev, shared};
    return 0;
}

// Caps *grid at the thread blocks the card holds at once, so that a
// large batch stages its tables once per resident block and each warp
// strides over the rays.  The count is queried once per kernel, device,
// block size and shared size, so a captured launch queries nothing.
template <class Kernel>
int resident_grid(Kernel kernel, int threads, size_t shared, int* grid) {
    struct Seen { const void* fn; int dev, threads; size_t shared;
                  int resident; };
    static Seen seen[16];
    static int n_seen = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const void* fn = (const void*)kernel;
    int resident = -1;
    for (int i = 0; i < n_seen; ++i)
        if (seen[i].fn == fn && seen[i].dev == dev
                && seen[i].threads == threads && seen[i].shared == shared)
            resident = seen[i].resident;
    if (resident < 0) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, shared);
        if (e != cudaSuccess) return (int)e;
        resident = sms * per_sm;
        if (n_seen < 16)
            seen[n_seen++] = Seen{fn, dev, threads, shared, resident};
    }
    if (resident > 0 && *grid > resident) *grid = resident;
    return 0;
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

// bshape: each member block's shape index; n_desc: the descriptor's
// int32 words.  Each refuses
// (cudaErrorInvalidValue) a descriptor that does not fit a thread block's
// shared memory (K4: beside its two bound stages), and K4
// (cudaErrorMisalignedAddress) bounds that cp.async cannot copy in
// 16-byte rows.
int actinon_scene_top2(const float* table, const float* bounds,
                       const int* bshape, const int* desc, const float* p,
                       const float* d, const float* lm, float* t_out,
                       int* c_out, int n, float eps, int n_desc,
                       void* stream) {
    if ((uintptr_t)bounds % 16 != 0) return (int)cudaErrorMisalignedAddress;
    const size_t shared = top2_shared_bytes(n_desc);
    const int rc = shared_ok(scene_top2_kernel, shared);
    if (rc != 0) return rc;
    scene_top2_kernel<<<grid_of(n, kTop2Warps), kTop2Warps * 32, shared,
                        (cudaStream_t)stream>>>(
        table, bounds, bshape, desc, p, d, lm, t_out, c_out, n, eps,
        n_desc);
    return (int)cudaGetLastError();
}

int actinon_scene_anyhit(const float* table, const float* bounds,
                         const int* bshape, const int* desc, const float* p,
                         const float* d, const float* lim, uint8_t* out,
                         int n, float eps, int n_desc, void* stream) {
    const size_t shared = 4 * (size_t)desc_words(n_desc);
    int rc = shared_ok(scene_anyhit_kernel, shared);
    if (rc != 0) return rc;
    int grid = grid_of(n, kAnyWarps);
    rc = resident_grid(scene_anyhit_kernel, kAnyWarps * 32, shared, &grid);
    if (rc != 0) return rc;
    scene_anyhit_kernel<<<grid, kAnyWarps * 32, shared,
                          (cudaStream_t)stream>>>(
        table, bounds, bshape, desc, p, d, lim, out, n, eps, n_desc);
    return (int)cudaGetLastError();
}

}  // extern "C"
