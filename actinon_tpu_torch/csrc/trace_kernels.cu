// Trace kernels of the main render path, hand-written for Hopper (sm_90a).
//
// Four __global__ entry points over shared __device__ code:
//
//   nee_kernel         (K1) replaces actinon_tpu/render/pallas_kernels.py
//                      build_nee_kernel: the whole per-light NEE loop of a
//                      lane — counter-RNG cap sample in the con_z frame,
//                      true light-geometry hit, trig-free Oren-Nayar,
//                      inline matter shadow any-hit, 2*cyl/ns estimator.
//   shadow_warp_kernel (K2) replace build_shadow_kernel: any matter hit
//   shadow_kernel      within (., limit] over the single-leaf objects
//                      (envelope-gated) and the analytic composites; two
//                      designs, a warp a ray and a thread a ray.
//   object_hit_kernel  (K3) replaces build_object_hit_kernel: the
//                      eps-backed first hit of ONE object, INF on a miss.
//
// Design.  The Pallas kernels were generated per scene, with every leaf
// baked in as an immediate.  Here ONE source serves every scene: the
// geometry is a read-only table (leaf records, composite records with
// their CSG tree as postfix byte-code, light records) built by
// render/kernels.py; a View holds its header's offsets, resolved once.
// A composite's crossing walk is O(NC^2) in its NC crossing columns, as
// in pallas_kernels.py:258-302, and every walk tests the composite's
// envelope first.  The shadow test stops at the first object that
// blocks: its result is an OR, so the boolean is the same.  Its walk
// (comp_blocks) drops the columns past the limit first and stops at the
// first flip (the argument is at comp_blocks_sorted); up to kRegCols
// columns live in registers, and a wider composite takes comp_boundary.
//
// K2 has two designs, which OR the same per-object tests with the same
// arithmetic and so give every ray the same boolean; the wrapper picks one
// by the ray count (render/kernels.py SHADOW_WARP_MAX_RAYS).  Both copy
// the flat scene table into shared memory once per thread block
// (stage_scene), one block per kShadowWarps or kShadowThreads rays (a
// grid capped at the resident blocks, the rays striding over it,
// measured slower: its last partial wave idles most threads).
//   * A warp a ray (shadow_warp_kernel), for the render's small batches
//     (5,120 rays), where a thread a ray leaves most SMs idle and a launch
//     lasts as long as one thread's serial walk: lanes take the
//     single-leaf objects 32 at a time (__any_sync), then the composites'
//     envelope gates (a ballot); for each composite that passes, lane c
//     takes crossing column c (and c + 32), the parities come from
//     __shfl_sync over the kept columns, each lane runs the CSG program
//     on its own column, and a ballot answers.
//   * A thread a ray (shadow_kernel), for larger batches, where the
//     warp design's 32 lanes a ray cost more instruction slots than
//     they save.
// K3: one thread per ray, the table read from global memory; every
// thread of a warp reads the same table entry at the same time, so the
// read-only cache serves each read as one broadcast.
//
// K1: one warp per NEE lane, 4 lanes a thread block.  Each thread block
// first copies the flat scene table and the light table into dynamic
// shared memory, so every table read of the samples' light hits and
// shadow tests comes from there.  A lane's samples go through the warp
// kNeeChunk at a time: the chunk's n_lights * m (light, sample) pairs
// (m <= kNeeChunk) go across the warp's 32 threads in strides of 32; each
// thread computes its pair's contribution with nee_sample, the
// per-sample arithmetic of the one-thread design, and writes it to the
// warp's slice of shared memory; thread li then adds light li's m terms
// to its running sum in sample order, chunk after chunk.  Thread 0 adds
// the lights in light order with the same `acc * (color * fac)` steps:
// the sums are those of a serial loop, in the same order, so the result
// is the one-thread kernel's bit for bit, whatever the sample count.
// Shared memory: the kernels cover at most 192 leaves (MAX_KERNEL_LEAVES
// of render/tracer.py, the Pallas kernels' limit), lights included, so
// the tables take at most about 50 KB and the four warps' slices
// (n_lights * kNeeChunk terms and n_lights (sum, factor) pairs each) at
// most 104,448 bytes: about 155 KB of the 227 KB a thread block may have.
// A dead lane (di <= 0) is a warp that writes zeros and stops.  What this
// does not do: a warp waits for its longest sample (a shadow ray that
// walks every composite), and a lane with fewer than 32 pairs leaves
// threads idle (12 of 32 at the headline's 2 lights x 10 samples);
// packing two lanes a warp is not done.
//
// What bounds them on this card.  K1 and the walk are FP32-ALU bound:
// about 72 bytes of I/O per lane against thousands of flops (per sample:
// the RNG, sinf/cosf, the light hit and a shadow test over every matter
// object).  K2 and K3 move 24-32 bytes per ray against a few hundred to a
// few thousand flops.  No tensor cores.
//
// Numerics: f32, no fast-math; sinf, cosf, sqrtf and 1.0f/sqrtf, as the
// Pallas kernels compute in exact f32.
//
// Interface: plain C functions, loaded with ctypes.  Each launches on the
// stream it is given and returns cudaGetLastError().  The helpers compile
// as host C++ too (tests/test_torch_kernels.py runs them there, the warp
// helpers lane by lane); the kernels that stage the table in shared
// memory or use warp intrinsics (K1, K2) do not.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- table layout (must match render/kernels.py) ----
enum {
    H_NLEAF = 0, H_NCOMP = 1, H_NSS = 2, H_NSC = 3, H_LEAF_F = 4,
    H_COMP_F = 5, H_LEAF_I = 6, H_COMP_I = 7, H_ROWS = 8, H_PROG = 9,
    H_SS = 10, H_SC = 11
};
enum {
    LF_M = 0, LF_M0 = 9, LF_C2 = 12, LF_C1 = 15, LF_RR = 18, LF_EC = 19,
    LF_ER = 22, LF_ER2 = 23, LF_SIZE = 24
};
enum { LI_KIND = 0, LI_LIN = 1, LI_ENV = 2, LI_SIZE = 4 };
enum { CF_EC = 0, CF_ER = 3, CF_ER2 = 4, CF_SIZE = 8 };
enum { CI_ROWS = 0, CI_N = 1, CI_PROG = 2, CI_PLEN = 3, CI_SIZE = 4 };
enum {
    LT_PN = 0, LT_CONE = 3, LT_POS = 6, LT_R2 = 9, LT_RAD = 10,
    LT_COLOR = 11, LT_SIZE = 16
};
enum { LTI_FOV = 0, LTI_HKIND = 1, LTI_HIDX = 2, LTI_SIZE = 4 };
enum { OP_AND = -1, OP_OR = -2, OP_NOT = -3 };
enum { PLANE = 0, SPHERE = 1, QUADRIC = 2 };
constexpr int MAX_COLS = 64;
constexpr int kRegCols = 16;   // a shadow walk sorts at most this many
                               // crossing columns in registers

struct Scene {
    const float* __restrict__ f;
    const int* __restrict__ i;
};

// The table's header resolved once: the records and lists a query reads.
struct View {
    const float* __restrict__ leaf_f;
    const int* __restrict__ leaf_i;
    const float* __restrict__ comp_f;
    const int* __restrict__ comp_i;
    const int* __restrict__ rows;
    const int* __restrict__ prog;
    const int* __restrict__ ss;
    const int* __restrict__ sc;
    int nss, nsc;
};

__device__ __forceinline__ View view_of(const Scene& S) {
    const int* h = S.i;
    return View{S.f + h[H_LEAF_F], S.i + h[H_LEAF_I], S.f + h[H_COMP_F],
                S.i + h[H_COMP_I], S.i + h[H_ROWS], S.i + h[H_PROG],
                S.i + h[H_SS], S.i + h[H_SC], h[H_NSS], h[H_NSC]};
}

__device__ __forceinline__ float finf() { return __int_as_float(0x7f800000); }

// false for +-INF and NaN, as jnp.isfinite
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < finf(); }

struct Ray {
    float px, py, pz, dx, dy, dz;
};

// ---- per-leaf generalized-quadric math (pallas_kernels.py:63-194) ----

// (A, B, C) of the leaf's quadratic along the ray; side(p) = C.
__device__ __forceinline__ void leaf_quads(const float* __restrict__ L,
                                           const Ray& r, float& A, float& B,
                                           float& C) {
    float pl[3], dl[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float* m = L + LF_M + 3 * k;
        pl[k] = L[LF_M0 + k] + ((m[0] * r.px + m[1] * r.py) + m[2] * r.pz);
        dl[k] = (m[0] * r.dx + m[1] * r.dy) + m[2] * r.dz;
    }
    const float* c2 = L + LF_C2;
    const float* c1 = L + LF_C1;
    A = (c2[0] * (dl[0] * dl[0]) + c2[1] * (dl[1] * dl[1]))
        + c2[2] * (dl[2] * dl[2]);
    B = 2.0f * ((c2[0] * (dl[0] * pl[0]) + c2[1] * (dl[1] * pl[1]))
                + c2[2] * (dl[2] * pl[2]))
        + ((c1[0] * dl[0] + c1[1] * dl[1]) + c1[2] * dl[2]);
    C = ((c2[0] * (pl[0] * pl[0]) + c2[1] * (pl[1] * pl[1]))
         + c2[2] * (pl[2] * pl[2]))
        + ((c1[0] * pl[0] + c1[1] * pl[1]) + c1[2] * pl[2]) + L[LF_RR];
}

// Both roots, cancellation-stable (tracer._roots / _stable_roots).
__device__ __forceinline__ void stable_roots(float A, float B, float C,
                                             float& t0, float& t1, float& s,
                                             float& q, bool& ok) {
    const float safe_A = A != 0.0f ? A : 1.0f;
    s = (B * 0.5f) / safe_A;
    q = C / safe_A;
    const float disc = fmaf(s, s, -q);   // rounded once, as tracer._disc
    ok = (A != 0.0f) && (disc >= 0.0f);
    const bool pos = ok && (disc > 0.0f);
    const float root = pos ? sqrtf(disc) : 0.0f;
    const float ta = -s - root;
    const float tb = -s + root;
    float r0 = ta, r1 = tb;
    if (s < 0.0f) r0 = fabsf(tb) > 0.0f ? q / tb : ta;
    if (s > 0.0f) r1 = fabsf(ta) > 0.0f ? q / ta : tb;
    t0 = ok ? r0 : finf();
    t1 = ok ? r1 : finf();
}

__device__ __forceinline__ float lin_root(float B, float C) {
    return B != 0.0f ? -C / B : finf();
}

// Family root policy (tracer._policy), eps-backed.
__device__ float leaf_first_hit(const float* __restrict__ L, int kind,
                                bool lin, const Ray& r, float eps) {
    float A, B, C;
    leaf_quads(L, r, A, B, C);
    if (kind == PLANE) {
        const float t = lin_root(B, C);
        return t > 0.0f ? t - eps : finf();
    }
    float t0, t1, s, q;
    bool ok;
    stable_roots(A, B, C, t0, t1, s, q, ok);
    if (kind == SPHERE) {
        const bool entering = (s < 0.0f) && (q > 0.0f);
        const bool exiting = (s < 0.0f) || (q < 0.0f);
        const float a = entering ? t0 : (exiting ? t1 : finf());
        return ok ? a - eps : finf();
    }
    if (lin || A == 0.0f) {   // runtime-degenerate quadric: linear root
        t0 = lin_root(B, C);
        t1 = finf();
    }
    const float a = t0 >= 0.0f ? t0 : (t1 >= 0.0f ? t1 : finf());
    return is_finite(a) ? a - eps : finf();
}

// Envelope-sphere hit-exists test (envelope_s_ray_hits): the dots and
// s s - q each rounded once, as the tracer's envelope gates and XLA's
// compiled jnp.sum(a * b, -1) round them.
__device__ __forceinline__ bool env_gate(const float* __restrict__ c,
                                         float r2, const Ray& r) {
    const float ex = r.px - c[0], ey = r.py - c[1], ez = r.pz - c[2];
    const float s = fmaf(ez, r.dz, fmaf(ey, r.dy, ex * r.dx));
    const float q = fmaf(ez, ez, fmaf(ey, ey, ex * ex)) - r2;
    return (fmaf(s, s, -q) >= 0.0f) && ((s < 0.0f) || (q < 0.0f));
}

// First hit of a single-leaf object, its envelope gate applied.
__device__ float single_hit(const View& V, int row, const Ray& r,
                            float eps) {
    const float* L = V.leaf_f + row * LF_SIZE;
    const int* LI = V.leaf_i + row * LI_SIZE;
    float a = leaf_first_hit(L, LI[LI_KIND], LI[LI_LIN] != 0, r, eps);
    if (LI[LI_ENV] && !env_gate(L + LF_EC, L[LF_ER2], r)) a = finf();
    return a;
}

// Postfix CSG program on two inside-bit sets at once.
__device__ __forceinline__ void tree_eval2(const int* __restrict__ prog,
                                           int n, uint32_t ba, uint32_t bb,
                                           bool& va, bool& vb) {
    uint64_t sa = 0, sb = 0;   // bit stacks, top at bit 0
    for (int k = 0; k < n; ++k) {
        const int op = prog[k];
        if (op >= 0) {
            sa = (sa << 1) | ((ba >> op) & 1u);
            sb = (sb << 1) | ((bb >> op) & 1u);
        } else if (op == OP_NOT) {
            sa ^= 1u;
            sb ^= 1u;
        } else {
            const uint64_t a0 = sa & 1u, a1 = (sa >> 1) & 1u;
            const uint64_t b0 = sb & 1u, b1 = (sb >> 1) & 1u;
            const uint64_t ra = op == OP_AND ? (a0 & a1) : (a0 | a1);
            const uint64_t rb = op == OP_AND ? (b0 & b1) : (b0 | b1);
            sa = ((sa >> 2) << 1) | ra;
            sb = ((sb >> 2) << 1) | rb;
        }
    }
    va = (sa & 1u) != 0;
    vb = (sb & 1u) != 0;
}

// A composite's envelope test: true where it has no envelope or the ray
// meets it (envelope_s_ray_hits).
__device__ __forceinline__ bool comp_gate(const View& V, int ci,
                                          const Ray& r) {
    const float* CF = V.comp_f + ci * CF_SIZE;
    return !(CF[CF_ER] > 0.0f) || env_gate(CF + CF_EC, CF[CF_ER2], r);
}

// The two crossing columns of a composite's leaf `row`: its forward
// roots, un-backed, INF where not ahead (never NaN: NaN > 0 is false);
// inside: the ray's origin lies in the leaf (C <= 0).
__device__ __forceinline__ void leaf_crossings(const View& V, int row,
                                               const Ray& r, float& x0,
                                               float& x1, bool& inside) {
    const float* L = V.leaf_f + row * LF_SIZE;
    const bool lin = V.leaf_i[row * LI_SIZE + LI_LIN] != 0;
    const float inf = finf();
    float A, B, C;
    leaf_quads(L, r, A, B, C);
    inside = C <= 0.0f;
    float c0, c1;
    if (lin) {
        c0 = lin_root(B, C);
        c1 = inf;
    } else {
        float s, q;
        bool ok;
        stable_roots(A, B, C, c0, c1, s, q, ok);
        if (A == 0.0f) {
            c0 = lin_root(B, C);
            c1 = inf;
        }
    }
    x0 = c0 > 0.0f ? c0 : inf;
    x1 = c1 > 0.0f ? c1 : inf;
}

// Nearest boundary flip of one composite: crossing-parity walk over its
// leaves' crossings (pallas_kernels._comp_boundary), envelope-gated (the
// gate first: it returns INF exactly where the walk's result would be
// thrown away).  Returns the un-backed crossing offset, INF when there is
// none.
__device__ float comp_boundary(const View& V, int ci, const Ray& r) {
    const float inf = finf();
    if (!comp_gate(V, ci, r)) return inf;
    const int* CI = V.comp_i + ci * CI_SIZE;
    const int* rows = V.rows + CI[CI_ROWS];
    const int nl = CI[CI_N];
    const int nc = 2 * nl;
    float cross[MAX_COLS];
    uint32_t inside = 0;
    for (int l = 0; l < nl; ++l) {
        bool in;
        leaf_crossings(V, rows[l], r, cross[2 * l], cross[2 * l + 1], in);
        if (in) inside |= 1u << l;
    }
    const int* prog = V.prog + CI[CI_PROG];
    const int plen = CI[CI_PLEN];
    float best = inf;
    for (int j = 0; j < nc; ++j) {
        const float tj = cross[j];
        if (!is_finite(tj)) continue;
        // per-leaf parity at-or-before / strictly-before t_j
        uint32_t pa = 0, pb = 0;
        for (int c = 0; c < nc; ++c) {
            const float tc = cross[c];
            if (!is_finite(tc)) continue;
            const uint32_t bit = 1u << (c >> 1);
            if (tc <= tj) pa ^= bit;
            if (tc < tj) pb ^= bit;
        }
        bool va, vb;
        tree_eval2(prog, plen, inside ^ pa, inside ^ pb, va, vb);
        if (va != vb && tj < best) best = tj;
    }
    return best;
}

// A crossing column that can block within lim: comp_boundary's shadow
// test `t - eps <= lim` on the column itself.
__device__ __forceinline__ bool column_kept(float t, float lim, float eps) {
    return is_finite(t) && t - eps <= lim;
}

// Postfix CSG program on one inside-bit set.
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

// Whether composite ci (its envelope already passed) blocks the ray
// within lim: comp_boundary's answer, `is_finite(t*) && t* - eps <= lim`
// for the nearest flip t*, from the kept columns alone (column_kept).
//
// Why the kept columns suffice.  f32 rounding is monotone, so tc <= tj
// implies fl(tc - eps) <= fl(tj - eps): a column at or before a kept one
// is kept, so a dropped column never counts in a kept column's state, and
// each kept column's states before and after are comp_boundary's.  Where
// fl(t* - eps) <= lim, t* is kept and flips; where a kept column flips,
// t* lies at or before it and so passes the test too.
//
// Up to kRegCols columns (comp_blocks_sorted): the kept columns sorted in
// registers by a bitonic network, then one sweep in which each column
// toggles its leaf's bit and a tie run of equal t flips jointly (the
// test fires where the run ends), as member_boundary walks in
// csrc/scene_kernels.cu: the state after a run is comp_boundary's state
// at-or-before t_j (<=), the state before it the strictly-before one (<),
// so coincident crossings flip together, as there.  The sweep stops at
// the first flip.  It measured faster on this card than comp_boundary's
// O(NC^2) parity walk with the columns in registers (PERF.md §6).  More
// columns: comp_boundary itself, and the limit on its nearest flip.
__device__ bool comp_blocks_sorted(const View& V, int ci, const Ray& r,
                                   float lim, float eps) {
    constexpr int N = kRegCols;
    const int* CI = V.comp_i + ci * CI_SIZE;
    const int* rows = V.rows + CI[CI_ROWS];
    const int nl = CI[CI_N];
    const float inf = finf();
    float cross[N];
    int col[N];
    uint32_t inside = 0;
    bool any = false;
#pragma unroll
    for (int l = 0; l < N / 2; ++l) {
        cross[2 * l] = cross[2 * l + 1] = inf;
        col[2 * l] = 2 * l;
        col[2 * l + 1] = 2 * l + 1;
        if (l < nl) {
            float x0, x1;
            bool in;
            leaf_crossings(V, rows[l], r, x0, x1, in);
            if (in) inside |= 1u << l;
            const bool k0 = column_kept(x0, lim, eps);
            const bool k1 = column_kept(x1, lim, eps);
            cross[2 * l] = k0 ? x0 : inf;
            cross[2 * l + 1] = k1 ? x1 : inf;
            any = any || k0 || k1;
        }
    }
    if (!any) return false;
    // ascending, INF last; the stage loops count exponents, so that every
    // loop unrolls and the arrays stay in registers
#pragma unroll
    for (int kk = 1; (1 << kk) <= N; ++kk)
#pragma unroll
        for (int jj = kk - 1; jj >= 0; --jj)
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const int k = 1 << kk, l = i ^ (1 << jj);
                if (l <= i) continue;
                const bool up = (i & k) == 0;
                if (up ? cross[i] > cross[l] : cross[i] < cross[l]) {
                    const float tt = cross[i];
                    cross[i] = cross[l];
                    cross[l] = tt;
                    const int cc = col[i];
                    col[i] = col[l];
                    col[l] = cc;
                }
            }
    const int* prog = V.prog + CI[CI_PROG];
    const int plen = CI[CI_PLEN];
    uint32_t state = inside;
    bool v_run = tree_eval(prog, plen, state);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        if (!is_finite(cross[j])) break;
        state ^= 1u << (col[j] >> 1);
        const bool v_new = tree_eval(prog, plen, state);
        const float t_next = j + 1 < N ? cross[j + 1] : inf;
        if (cross[j] != t_next) {
            if (v_new != v_run) return true;
            v_run = v_new;
        }
    }
    return false;
}

__device__ __forceinline__ bool comp_blocks(const View& V, int ci,
                                            const Ray& r, float lim,
                                            float eps) {
    return 2 * V.comp_i[ci * CI_SIZE + CI_N] <= kRegCols
               ? comp_blocks_sorted(V, ci, r, lim, eps)
               : column_kept(comp_boundary(V, ci, r), lim, eps);
}

// Any covered matter hit within (., lim]: true at the first object that
// blocks (an OR: any order and any exit point give the same boolean).
__device__ bool shadow_blocked(const View& V, const Ray& r, float lim,
                               float eps) {
    for (int k = 0; k < V.nss; ++k)
        if (single_hit(V, V.ss[k], r, eps) <= lim) return true;
    for (int k = 0; k < V.nsc; ++k) {
        const int ci = V.sc[k];
        if (comp_gate(V, ci, r) && comp_blocks(V, ci, r, lim, eps))
            return true;
    }
    return false;
}

// First hit of a leaf (kind 0) or composite (kind 1) object, eps-backed.
__device__ __forceinline__ float object_first_hit(const View& V, int kind,
                                                  int idx, const Ray& r,
                                                  float eps) {
    if (kind == 0) return single_hit(V, idx, r, eps);
    const float t = comp_boundary(V, idx, r);
    return is_finite(t) ? t - eps : finf();
}

// One ray of a query's inputs, and its shadow limit: a limit that is not
// finite reads as 3e38, as in the Pallas kernel (a miss, INF, never
// blocks).
__device__ __forceinline__ Ray load_ray(const float* __restrict__ p,
                                        const float* __restrict__ d, int i) {
    return Ray{p[3 * i], p[3 * i + 1], p[3 * i + 2],
               d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

__device__ __forceinline__ float read_limit(const float* __restrict__ lim,
                                            int i) {
    const float l = lim[i];
    return is_finite(l) ? l : 3e38f;
}

// ---- K2's warp design: the per-lane steps (the kernel adds the ballots
// and shuffles; tests/test_torch_kernels.py runs them lane by lane) ----

// Bits 0, 2, 4, ... of b packed into bits 0 .. 15: the leaves' inside
// bits from a ballot over the columns (column 2l holds leaf l's).
__host__ __device__ __forceinline__ uint32_t even_bits(uint32_t b) {
    b &= 0x55555555u;
    b = (b | (b >> 1)) & 0x33333333u;
    b = (b | (b >> 2)) & 0x0f0f0f0fu;
    b = (b | (b >> 4)) & 0x00ff00ffu;
    return (b | (b >> 8)) & 0x0000ffffu;
}

// Crossing column c of a composite of nc columns (rows: its leaves): the
// column's offset (INF past nc) and its leaf's inside bit.
__device__ __forceinline__ void warp_column(const View& V,
                                            const int* __restrict__ rows,
                                            int nc, int c, const Ray& r,
                                            float& t, bool& inside) {
    t = finf();
    inside = false;
    if (c >= nc) return;
    float x0, x1;
    leaf_crossings(V, rows[c >> 1], r, x0, x1, inside);
    t = (c & 1) ? x1 : x0;
}

// Column s, at tc, in the parities of a column at tj.
__device__ __forceinline__ void parity_step(float tc, int s, float tj,
                                            uint32_t& pa, uint32_t& pb) {
    const uint32_t bit = 1u << (s >> 1);
    if (tc <= tj) pa ^= bit;
    if (tc < tj) pb ^= bit;
}

// Whether a column with these parities flips the composite.
__device__ __forceinline__ bool column_flips(const int* __restrict__ prog,
                                             int plen, uint32_t inside,
                                             uint32_t pa, uint32_t pb) {
    bool va, vb;
    tree_eval2(prog, plen, inside ^ pa, inside ^ pb, va, vb);
    return va != vb;
}

// ---- counter RNG (rng.py: murmur3 finalizer) ----

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

__device__ __forceinline__ float uniform(uint32_t rv, uint32_t ctr) {
    const uint32_t c = fmix32(ctr * 0x9E3779B9u + 1u);
    const uint32_t bits = fmix32(rv ^ c);
    return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
    const float ln2 = (x * x + y * y) + z * z;
    const float inv = ln2 > 0.0f ? 1.0f / sqrtf(ln2) : 1.0f;
    x *= inv;
    y *= inv;
    z *= inv;
}

// ---- K1's helpers ----

// One NEE lane's inputs.
struct NeeLane {
    float px, py, pz, sx, sy, sz, qx, qy, qz, cos_ti, on_a, on_b, di;
    uint32_t rv;
    int ns;
};

__device__ __forceinline__ NeeLane load_nee_lane(
    int i, const float* __restrict__ pos, const float* __restrict__ surf_d,
    const float* __restrict__ di_in, const float* __restrict__ cos_ti_in,
    const float* __restrict__ on_a_in, const float* __restrict__ on_b_in,
    const float* __restrict__ ray_prj, const uint32_t* __restrict__ rv_in,
    const int* __restrict__ ns_in) {
    return NeeLane{pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                   surf_d[3 * i], surf_d[3 * i + 1], surf_d[3 * i + 2],
                   ray_prj[3 * i], ray_prj[3 * i + 1], ray_prj[3 * i + 2],
                   cos_ti_in[i], on_a_in[i], on_b_in[i], di_in[i], rv_in[i],
                   ns_in[i]};
}

// The samples a lane draws of each light: ns, within the cap (the
// integrator clamps ns to [1, cap]; the plain version never draws past
// the cap either).
__device__ __forceinline__ int nee_samples(const NeeLane& N, int cap) {
    return max(0, min(N.ns, cap));
}

// A light's sampling cone at the lane's position: the cone axis f, the
// cap height cyl, and the transposed con_z(f) frame (columns mx, my, f).
struct LightFrame {
    float fx, fy, fz, cyl, mxx, mxy, mxz, myx, myy, myz;
};

__device__ __forceinline__ LightFrame light_frame(const float* lt,
                                                  const int* lti,
                                                  const NeeLane& N) {
    LightFrame F;
    // fov cone: sphere / envelope cone, or plane half-space
    float cos_rs;
    if (lti[LTI_FOV] == 1) {
        const float* nn = lt + LT_PN;
        F.fx = -nn[0];
        F.fy = -nn[1];
        F.fz = -nn[2];
        const float dside = ((lt[LT_POS] - N.px) * (-nn[0])
                             + (lt[LT_POS + 1] - N.py) * (-nn[1]))
                            + (lt[LT_POS + 2] - N.pz) * (-nn[2]);
        cos_rs = dside > 0.0f ? 0.0f : 1.0f;
    } else {
        F.fx = lt[LT_CONE] - N.px;
        F.fy = lt[LT_CONE + 1] - N.py;
        F.fz = lt[LT_CONE + 2] - N.pz;
        const float dist2 = (F.fx * F.fx + F.fy * F.fy) + F.fz * F.fz;
        norm3(F.fx, F.fy, F.fz);
        const float r2 = lt[LT_R2];
        const float q = 1.0f - r2 / (dist2 > 0.0f ? dist2 : 1.0f);
        cos_rs = dist2 > r2 ? sqrtf(q > 0.0f ? q : 0.0f) : -1.0f;
    }
    F.cyl = 1.0f - cos_rs;
    // transposed(con_z(fov_d)) frame: columns mx, my, mz = fov_d
    const float fx = F.fx, fy = F.fy, fz = F.fz;
    const float xx = fx * fx, yy = fy * fy, zz = fz * fz;
    const float exm = (xx <= yy && xx <= zz) ? 1.0f : 0.0f;
    const float eym = (yy <= xx && yy <= zz) ? 1.0f - exm : 0.0f;
    const float ezm = fmaxf(1.0f - exm - eym, 0.0f);
    const float cdot = (exm * fx + eym * fy) + ezm * fz;
    F.mxx = exm - fx * cdot;
    F.mxy = eym - fy * cdot;
    F.mxz = ezm - fz * cdot;
    norm3(F.mxx, F.mxy, F.mxz);
    F.myx = fy * F.mxz - fz * F.mxy;
    F.myy = fz * F.mxx - fx * F.mxz;
    F.myz = fx * F.mxy - fy * F.mxx;
    return F;
}

// Sample j of light li: its estimator term (loc * w) * di where the
// sample leaves the surface, reaches the light and is not shadowed, else
// 0.  The RNG counters are 4 (li cap + j) and 4 (li cap + j) + 1.
__device__ float nee_sample(const View& V, const float* lt, const int* lti,
                            const LightFrame& F, const NeeLane& N, int li,
                            int j, int cap, float eps) {
    const float two_pi = 6.283185307179586f;
    const uint32_t ctr = 4u * (uint32_t)(li * cap + j);
    const float u1 = uniform(N.rv, ctr);
    const float u2 = uniform(N.rv, ctr + 1u);
    const float phi = two_pi * u1;
    const float z = 1.0f - u2 * F.cyl;
    const float sc2 = 1.0f - z * z;
    const float sc = sqrtf(sc2 > 0.0f ? sc2 : 0.0f);
    const float lx = sinf(phi) * sc;
    const float ly = cosf(phi) * sc;
    Ray r;
    r.px = N.px;
    r.py = N.py;
    r.pz = N.pz;
    r.dx = (F.mxx * lx + F.myx * ly) + F.fx * z;
    r.dy = (F.mxy * lx + F.myy * ly) + F.fy * z;
    r.dz = (F.mxz * lx + F.myz * ly) + F.fz * z;
    float w = (r.dx * N.sx + r.dy * N.sy) + r.dz * N.sz;
    const float a = object_first_hit(V, lti[LTI_HKIND], lti[LTI_HIDX], r,
                                     eps);
    const bool fin = is_finite(a);
    bool ok = (w > 0.0f) && fin;
    if (N.on_b > 0.0f) {
        // Oren-Nayar, trig-free: sin(max(ti, tr)) and tan(min(ti, tr))
        // from the cosines
        const float wc = fminf(fmaxf(w, -1.0f), 1.0f);
        float prx = r.dx - N.sx * w, pry = r.dy - N.sy * w,
              prz = r.dz - N.sz * w;
        norm3(prx, pry, prz);
        const float cos_phi = -((prx * N.qx + pry * N.qy) + prz * N.qz);
        const float cmin = fminf(N.cos_ti, wc);
        const float sin_max = sqrtf(fmaxf(1.0f - cmin * cmin, 0.0f));
        const float cmax = fmaxf(fmaxf(N.cos_ti, wc), 1e-6f);
        const float tan_min = sqrtf(fmaxf(1.0f - cmax * cmax, 0.0f)) / cmax;
        w = w * (N.on_a + ((N.on_b * fmaxf(cos_phi, 0.0f)) * sin_max)
                              * tan_min);
    }
    const float lim = fin ? a : 0.0f;
    ok = ok && !shadow_blocked(V, r, lim, eps);
    const float a_safe = fin ? a : 0.0f;
    const float hx = N.px + r.dx * a_safe - lt[LT_POS];
    const float hy = N.py + r.dy * a_safe - lt[LT_POS + 1];
    const float hz = N.pz + r.dz * a_safe - lt[LT_POS + 2];
    const float dsq = (hx * hx + hy * hy) + hz * hz;
    const float loc = dsq > 0.0f ? lt[LT_RAD] / dsq : 1e30f;
    return ok ? (loc * w) * N.di : 0.0f;
}

// Light li's running sum acc, continued over the n terms of its next
// samples in sample order (term j at terms[j]), as the serial loop
// accumulates it: from acc = 0, chunk after chunk, the same additions as
// one pass over all the samples.
__device__ __forceinline__ float nee_light_sum(float acc, const float* terms,
                                               int n) {
    for (int j = 0; j < n; ++j) acc += terms[j];
    return acc;
}

// The lane's radiance: each light's sum acc[li] times its colour and
// 2 cyl / ns, added in light order.
__device__ __forceinline__ void nee_lum(const float* LF, const float* acc,
                                        const float* fac, int n_lights,
                                        float lum[3]) {
    lum[0] = lum[1] = lum[2] = 0.0f;
    for (int li = 0; li < n_lights; ++li) {
        const float* lt = LF + li * LT_SIZE;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
            lum[ch] += acc[li] * (lt[LT_COLOR + ch] * fac[li]);
    }
}

__host__ __device__ __forceinline__ int pad4(int words) {
    return (words + 3) / 4 * 4;
}

// The flat scene table in shared memory, as stage_scene lays it out: its
// floats, then its ints, each padded to 16 bytes.
inline size_t scene_shared_bytes(int n_f, int n_i) {
    return 4 * ((size_t)pad4(n_f) + pad4(n_i));
}

// K1's dynamic shared memory: the scene table, the light table's floats
// and ints, each padded to 16 bytes, then per warp a slice of n_lights *
// kNeeChunk sample terms and n_lights (sum, factor) pairs.  It does not
// depend on the sample count.
constexpr int kNeeWarps = 4;   // K1: NEE lanes (one warp each) a block
constexpr int kNeeChunk = 32;  // K1: samples of each light a warp's slice
                               // holds at a time
// K1: thread blocks an SM must hold by registers (64 a thread).  Left
// free, ptxas gives comp_blocks' sort network 92 registers and 5 blocks
// an SM; held to 8 it spills a little, and on an H100 every K1 batch of
// the main path ran faster so, bit for bit the same (PERF.md §6).
constexpr int kNeeMinBlocks = 8;

__host__ __device__ __forceinline__ int nee_warp_words(int n_lights) {
    return pad4(n_lights * kNeeChunk + 2 * n_lights);
}

inline size_t nee_shared_bytes(int n_f, int n_i, int n_lights) {
    return scene_shared_bytes(n_f, n_i)
           + 4 * ((size_t)pad4(n_lights * LT_SIZE) + pad4(n_lights * LTI_SIZE)
                  + (size_t)kNeeWarps * nee_warp_words(n_lights));
}

// K2's launch: rays (one warp each) a block in the warp design, rays (one
// thread each) a block in the thread design.
constexpr int kShadowWarps = 4;
constexpr int kShadowThreads = 128;

// ---- kernels ----

__global__ void object_hit_kernel(Scene S, int kind, int idx,
                                  const float* __restrict__ p,
                                  const float* __restrict__ d,
                                  float* __restrict__ out, int n,
                                  float eps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float a = object_first_hit(view_of(S), kind, idx, load_ray(p, d, i),
                                     eps);
    out[i] = is_finite(a) ? a : finf();
}

#ifdef __CUDACC__

constexpr unsigned kFull = 0xffffffffu;

// The thread block copies the flat scene table (n_f floats, n_i ints) into
// shared memory, laid out as scene_shared_bytes counts it, and meets the
// barrier that makes it visible.  Every thread of the block must call it.
__device__ __forceinline__ Scene stage_scene(const float* __restrict__ sf,
                                             const int* __restrict__ si,
                                             int n_f, int n_i,
                                             float* shared) {
    float* s_f = shared;
    int* s_i = reinterpret_cast<int*>(s_f + pad4(n_f));
    for (int k = threadIdx.x; k < n_f; k += blockDim.x) s_f[k] = sf[k];
    for (int k = threadIdx.x; k < n_i; k += blockDim.x) s_i[k] = si[k];
    __syncthreads();
    return Scene{s_f, s_i};
}

__global__ void __launch_bounds__(kNeeWarps * 32, kNeeMinBlocks)
nee_kernel(const float* __restrict__ sf, const int* __restrict__ si,
           int n_f, int n_i, const float* __restrict__ LF,
           const int* __restrict__ LI, int n_lights, int cap,
           const float* __restrict__ pos, const float* __restrict__ surf_d,
           const float* __restrict__ di_in,
           const float* __restrict__ cos_ti_in,
           const float* __restrict__ on_a_in,
           const float* __restrict__ on_b_in,
           const float* __restrict__ ray_prj,
           const uint32_t* __restrict__ rv_in,
           const int* __restrict__ ns_in, float* __restrict__ out, int n,
           float eps) {
    extern __shared__ __align__(16) float nee_shared[];
    float* s_lf = nee_shared + pad4(n_f) + pad4(n_i);   // past the scene
    int* s_li = reinterpret_cast<int*>(s_lf + pad4(n_lights * LT_SIZE));
    float* s_warps = reinterpret_cast<float*>(
        s_li + pad4(n_lights * LTI_SIZE));
    for (int k = threadIdx.x; k < n_lights * LT_SIZE; k += blockDim.x)
        s_lf[k] = LF[k];
    for (int k = threadIdx.x; k < n_lights * LTI_SIZE; k += blockDim.x)
        s_li[k] = LI[k];
    const View V = view_of(stage_scene(sf, si, n_f, n_i, nee_shared));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i = blockIdx.x * kNeeWarps + warp;
    if (i >= n) return;   // the whole warp: no block barrier follows
    const NeeLane N = load_nee_lane(i, pos, surf_d, di_in, cos_ti_in,
                                    on_a_in, on_b_in, ray_prj, rv_in, ns_in);
    if (!(N.di > 0.0f)) {
        if (lane == 0) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = 0.0f;
        return;
    }
    const int ns = nee_samples(N, cap);
    float* terms = s_warps + warp * nee_warp_words(n_lights);
    float* acc = terms + n_lights * kNeeChunk;
    float* fac = acc + n_lights;
    for (int li = lane; li < n_lights; li += 32) acc[li] = 0.0f;
    for (int j0 = 0; j0 < ns; j0 += kNeeChunk) {
        const int m = min(kNeeChunk, ns - j0);
        // the previous chunk's sums have read their terms
        __syncwarp();
        // the chunk's (light, sample) pairs across the warp: term li m + j
        for (int k = lane; k < n_lights * m; k += 32) {
            const int li = k / m, j = k - li * m;
            const float* lt = s_lf + li * LT_SIZE;
            const int* lti = s_li + li * LTI_SIZE;
            terms[k] = nee_sample(V, lt, lti, light_frame(lt, lti, N), N,
                                  li, j0 + j, cap, eps);
        }
        __syncwarp();
        for (int li = lane; li < n_lights; li += 32)
            acc[li] = nee_light_sum(acc[li], terms + li * m, m);
    }
    for (int li = lane; li < n_lights; li += 32) {
        const float* lt = s_lf + li * LT_SIZE;
        const int* lti = s_li + li * LTI_SIZE;
        fac[li] = 2.0f * light_frame(lt, lti, N).cyl / (float)N.ns;
    }
    __syncwarp();
    if (lane == 0) {
        float lum[3];
        nee_lum(s_lf, acc, fac, n_lights, lum);
        out[3 * i] = lum[0];
        out[3 * i + 1] = lum[1];
        out[3 * i + 2] = lum[2];
    }
}

// K2, thread design: one thread a ray, shadow_blocked's walk.
__global__ void __launch_bounds__(kShadowThreads)
shadow_kernel(const float* __restrict__ sf, const int* __restrict__ si,
              int n_f, int n_i, const float* __restrict__ p,
              const float* __restrict__ d, const float* __restrict__ lim,
              uint8_t* __restrict__ out, int n, float eps) {
    extern __shared__ __align__(16) float shadow_shared[];
    const View V = view_of(stage_scene(sf, si, n_f, n_i, shadow_shared));
    const int i = blockIdx.x * kShadowThreads + threadIdx.x;
    if (i < n)
        out[i] = shadow_blocked(V, load_ray(p, d, i), read_limit(lim, i),
                                eps) ? 1 : 0;
}

// K2, warp design: whether composite ci (its envelope passed) blocks the
// ray within lim, comp_blocks' answer.  Every lane calls it with the same
// arguments and gets the answer.  Lane j holds columns j and j + 32 (the
// second only where the composite has more than 32); the inside bits and
// the kept columns are ballots, and the parities of each lane's columns
// come from shuffles over the kept columns alone (comp_blocks' argument:
// a dropped column never counts in a kept one's parity).
__device__ bool comp_blocks_warp(const View& V, int ci, const Ray& r,
                                 float lim, float eps, int lane) {
    const int* CI = V.comp_i + ci * CI_SIZE;
    const int* rows = V.rows + CI[CI_ROWS];
    const int nc = 2 * CI[CI_N];
    const bool two = nc > 32;
    float t0, t1 = finf();
    bool in0, in1 = false;
    warp_column(V, rows, nc, lane, r, t0, in0);
    if (two) warp_column(V, rows, nc, lane + 32, r, t1, in1);
    const bool k0 = column_kept(t0, lim, eps);
    const bool k1 = column_kept(t1, lim, eps);
    const uint32_t kept0 = __ballot_sync(kFull, k0);
    const uint32_t kept1 = __ballot_sync(kFull, k1);
    if ((kept0 | kept1) == 0) return false;
    const uint32_t inside =
        even_bits(__ballot_sync(kFull, in0 && !(lane & 1)))
        | (even_bits(__ballot_sync(kFull, in1 && !(lane & 1))) << 16);
    uint32_t pa0 = 0, pb0 = 0, pa1 = 0, pb1 = 0;
    for (uint32_t m = kept0; m; m &= m - 1) {
        const int s = __ffs(m) - 1;
        const float tc = __shfl_sync(kFull, t0, s);
        parity_step(tc, s, t0, pa0, pb0);
        parity_step(tc, s, t1, pa1, pb1);
    }
    for (uint32_t m = kept1; m; m &= m - 1) {
        const int s = __ffs(m) - 1;
        const float tc = __shfl_sync(kFull, t1, s);
        parity_step(tc, s + 32, t0, pa0, pb0);
        parity_step(tc, s + 32, t1, pa1, pb1);
    }
    const int* prog = V.prog + CI[CI_PROG];
    const int plen = CI[CI_PLEN];
    const bool flip = (k0 && column_flips(prog, plen, inside, pa0, pb0))
                      || (k1 && column_flips(prog, plen, inside, pa1, pb1));
    return __any_sync(kFull, flip);
}

// K2, warp design: shadow_blocked's answer for one ray, every lane of the
// warp calling it.  Lanes take the single-leaf objects 32 at a time, then
// the composites' envelope gates 32 at a time; each composite that passes
// goes to comp_blocks_warp, in order.  The warp leaves at the first round
// or composite that blocks.
__device__ bool shadow_blocked_warp(const View& V, const Ray& r, float lim,
                                    float eps, int lane) {
    for (int k0 = 0; k0 < V.nss; k0 += 32) {
        const int k = k0 + lane;
        const bool hit = k < V.nss && single_hit(V, V.ss[k], r, eps) <= lim;
        if (__any_sync(kFull, hit)) return true;
    }
    for (int k0 = 0; k0 < V.nsc; k0 += 32) {
        const int k = k0 + lane;
        for (uint32_t pass = __ballot_sync(
                 kFull, k < V.nsc && comp_gate(V, V.sc[k], r));
             pass; pass &= pass - 1)
            if (comp_blocks_warp(V, V.sc[k0 + __ffs(pass) - 1], r, lim, eps,
                                 lane))
                return true;
    }
    return false;
}

__global__ void __launch_bounds__(kShadowWarps * 32)
shadow_warp_kernel(const float* __restrict__ sf, const int* __restrict__ si,
                   int n_f, int n_i, const float* __restrict__ p,
                   const float* __restrict__ d,
                   const float* __restrict__ lim, uint8_t* __restrict__ out,
                   int n, float eps) {
    extern __shared__ __align__(16) float shadow_shared[];
    const View V = view_of(stage_scene(sf, si, n_f, n_i, shadow_shared));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the ray index is the warp's: every branch below is uniform
    const int i = blockIdx.x * kShadowWarps + warp;
    if (i >= n) return;   // the whole warp: no block barrier follows
    const bool b = shadow_blocked_warp(V, load_ray(p, d, i),
                                       read_limit(lim, i), eps, lane);
    if (lane == 0) out[i] = b ? 1 : 0;
}

#endif  // __CUDACC__

constexpr int kBlock = 128;     // K3: rays (one thread each) a block
constexpr size_t kMaxShared = 232448;   // what a thread block may have

inline int grid_of(int n, int per_block) {
    return (n + per_block - 1) / per_block;
}

#ifdef __CUDACC__

// 0 when a kernel may take `shared` bytes of dynamic shared memory (the
// attribute set above 48 KB), else the error; refuses
// (cudaErrorInvalidValue) more than a thread block may have.  Each
// kernel's setting is made once per device and size, so a launch captured
// into a CUDA graph after its first launch calls nothing but
// cudaGetDevice here.
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

#endif  // __CUDACC__

}  // namespace

extern "C" {

// n_f, n_i: the scene table's float and int32 words; warp: the design (1
// a warp a ray, 0 a thread a ray).  Refuses (cudaErrorInvalidValue) a
// table that does not fit a thread block's shared memory: within 192
// leaves it always fits.
int actinon_shadow(const float* sf, const int* si, int n_f, int n_i,
                   const float* p, const float* d, const float* lim,
                   uint8_t* out, int n, float eps, int warp, void* stream) {
    const size_t shared = scene_shared_bytes(n_f, n_i);
    const int rc = warp ? shared_ok(shadow_warp_kernel, shared)
                        : shared_ok(shadow_kernel, shared);
    if (rc != 0) return rc;
    if (warp)
        shadow_warp_kernel<<<grid_of(n, kShadowWarps), kShadowWarps * 32,
                             shared, (cudaStream_t)stream>>>(
            sf, si, n_f, n_i, p, d, lim, out, n, eps);
    else
        shadow_kernel<<<grid_of(n, kShadowThreads), kShadowThreads, shared,
                        (cudaStream_t)stream>>>(
            sf, si, n_f, n_i, p, d, lim, out, n, eps);
    return (int)cudaGetLastError();
}

int actinon_object_hit(const float* sf, const int* si, int kind, int idx,
                       const float* p, const float* d, float* out, int n,
                       float eps, void* stream) {
    object_hit_kernel<<<grid_of(n, kBlock), kBlock, 0,
                        (cudaStream_t)stream>>>(
        Scene{sf, si}, kind, idx, p, d, out, n, eps);
    return (int)cudaGetLastError();
}

// n_f, n_i: the scene table's float and int32 words.  Refuses
// (cudaErrorInvalidValue) tables that do not fit a thread block's shared
// memory beside the sample slices; within 192 leaves they always fit, at
// any sample count.
int actinon_nee(const float* sf, const int* si, int n_f, int n_i,
                const float* lf, const int* li, int n_lights, int cap,
                const float* pos, const float* surf_d, const float* di,
                const float* cos_ti, const float* on_a, const float* on_b,
                const float* ray_prj, const uint32_t* rv, const int* ns,
                float* out, int n, float eps, void* stream) {
    const size_t shared = nee_shared_bytes(n_f, n_i, n_lights);
    const int rc = shared_ok(nee_kernel, shared);
    if (rc != 0) return rc;
    nee_kernel<<<grid_of(n, kNeeWarps), kNeeWarps * 32, shared,
                 (cudaStream_t)stream>>>(
        sf, si, n_f, n_i, lf, li, n_lights, cap, pos, surf_d, di, cos_ti,
        on_a, on_b, ray_prj, rv, ns, out, n, eps);
    return (int)cudaGetLastError();
}

}  // extern "C"
