// Big-scene sphere kernels, hand-written for Hopper (sm_90a).
//
//   big_top2_kernel   (K6) replaces actinon_tpu/render/pallas_bigscene.py
//                     build_top2_kernel: the running top-2 eps-backed sphere
//                     hits over Morton blocks of 128 spheres, as (t, gidx)
//                     pairs, gidx indexing SphereBlocks.rows.
//   big_anyhit_kernel (K7) replaces build_anyhit_kernel: any sphere hit
//                     within (0, limit], with the limit-aware block cull.
//
// The tables are the JAX package's, value for value (built by
// render/bigscene.py): table [G, 8, 128] f32, rows 0..3 = cx, cy, cz, r2 of
// the block's 128 lanes (dead pad lanes r2 = -1, which never hit); bounds
// [G, 8] f32, rows 0..3 = the block's bounding-sphere centre and squared
// radius (member surfaces + 2 eps).
//
// K6 design: one warp per ray, the 128 sphere lanes of a block across the
// warp, as the TPU kernel lays them across the vector lanes of a
// [rays, 128] tile.  8 warps (rays) a thread block.  The block bounds are
// staged in shared memory, kChunk at a time with cp.async, the next chunk
// in flight while the warps test the current one; G has no limit.  Per 32
// blocks, lane j tests block c * 32 + j against the ray, and a ballot gives
// the warp the passed blocks, visited in ascending (Morton) order.  From
// there on the warp is uniform: lane j evaluates sphere lanes j, j + 32,
// j + 64, j + 96 (each table row read as 32 neighbouring floats), keeps a
// local top-2, and five xor shuffles combine the 32 local pairs into the
// block's best two.  The Pallas merge (pallas_bigscene.py:205-214) then
// runs on every lane, applied where the block's best beats the ray's
// second best (the tile gate any(b1 < t2) of pallas_bigscene.py:192, made
// per ray; the cull per ray is exact and tighter than the TPU's tile-wide
// pl.when).  No atomics: results are deterministic.
//
// The tie rule.  The serial rule walks a block's lanes in order and keeps
// (b1, l1), (b2, l2) with strict compares from (INF, 0), (INF, 0): the
// first lane wins a tie for b1, the best of the other lanes is b2.  That
// is the two smallest of the candidates below INF under the total order
// (t, lane), padded with (INF, 0); INF and NaN candidates never enter.
// Each lane's local pair comes from the same strict insertion over its
// four lanes in ascending order.  top2_combine takes the two smallest of
// two such pairs under (t, lane).  Lane indices are distinct and every
// real candidate lies below the pad, so equal entries are identical pads:
// the combine is associative and commutative, every lane ends with the
// same pair, and that pair is the serial rule's bit for bit, INF slots and
// their index 0 included.  (An INF slot's index could not reach the
// output anyway: the merge takes gi2 only where b2 < t2, and a miss keeps
// gidx 0.)
//
// K7 comes in two designs over the same helpers, chosen by the wrapper
// from G (render/bigscene.py `ANYHIT_WARP_MIN_BLOCKS`, with its measured
// reason):
//   big_anyhit_warp_kernel: K6's layout.  One warp per ray, 8 rays a
//     thread block, the bounds staged in chunks of kChunk with cp.async,
//     the next chunk in flight; per 32 blocks a ballot of the limit-aware
//     culls, the passed blocks in ascending (Morton) order; lane j tests
//     sphere lanes j, j + 32, j + 64, j + 96 against the limit
//     (lane_anyhit), and the warp leaves with __any_sync after the first
//     passed block that holds a hit.  A warp whose ray is answered (or
//     dead) still stages and meets the barriers, and the thread block
//     stops staging once all its rays are answered (__syncthreads_and).
//   big_anyhit_kernel: one thread per ray, 256 threads a block, the G
//     blocks in Morton order, the limit-aware cull per ray, the 128 lanes
//     of a passed block one after another, a thread returning at its
//     ray's first hit.  A warp runs the union of its rays' loops: cheap
//     where few rays pass a block, and there the warp design pays a ray's
//     fixed work (its culls, a barrier, the exit test) 32 times over.
// Both test the same (block, lane) pairs with the same arithmetic
// (bound_hit with the limit, sphere_cand against it), and the result is
// an OR, so the two give every ray the same boolean bit for bit.
//
// What bounds them on this card: FP32 operations (about 40 a sphere lane,
// 19 a block test), not bytes: a ray reads 24 (K7: 28) bytes and writes 16
// (K7: 1), and the 4 rows read of the table (2 KB a block, 512 KB at G =
// 256) stay in L2.  K6 reads a passed block once per (ray, block) from
// L2; staging table blocks in shared memory would pay only where several
// warps of a thread block pass the same block, which is not measured yet.
// Why not the tensor cores: over a tile of rays x spheres, s and q are
// rank-4 products and could be a GEMM, but in f32 that GEMM runs as TF32,
// which moves roots near eps and flips hits; the repo keeps f32
// contractions exact (ROADMAP "Numerics", actinon_tpu/__init__.py:21-27).
//
// Numerics: f32, no fast-math, the expression order of the Pallas helpers
// (nvcc contracts to FMA, so results agree with the plain version at f32
// tolerance, not bit for bit).  Interface: plain C functions, loaded with
// ctypes.  Each launches on the stream it is given and returns
// cudaGetLastError().  The kernels' helpers compile as host C++ too
// (tests/test_torch_bigscene.py runs them there); the warp kernel, which
// needs the card's shuffles and shared memory, does not.
// (tests/test_torch_bigscene.py drives K6's and K7's warp helpers as the
// warp kernels do, lane by lane.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LB = 128;
constexpr float F32_BIG = 3e38f;

__device__ __forceinline__ float finf() { return __int_as_float(0x7f800000); }

// false for +-INF and NaN, as jnp.isfinite
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < finf(); }

struct Ray {
    float px, py, pz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ p,
                                        const float* __restrict__ d, int i) {
    return Ray{p[3 * i], p[3 * i + 1], p[3 * i + 2],
               d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// The eps-backed first-hit candidate of one sphere lane
// (pallas_bigscene.py:111-138): entry when outside and approaching, exit
// when inside, INF on a miss.
__device__ __forceinline__ float sphere_cand(const float* __restrict__ blk,
                                             int lane, const Ray& r,
                                             float eps) {
    const float inf = finf();
    const float ppx = r.px - __ldg(blk + lane);
    const float ppy = r.py - __ldg(blk + LB + lane);
    const float ppz = r.pz - __ldg(blk + 2 * LB + lane);
    const float r2 = __ldg(blk + 3 * LB + lane);
    // each multiply-add rounded once, as bigscene._sphere_cands and XLA's
    // compiled Pallas helper round them
    const float s = fmaf(ppz, r.dz, fmaf(ppx, r.dx, ppy * r.dy));
    const float q = fmaf(ppz, ppz, fmaf(ppx, ppx, ppy * ppy)) - r2;
    const float disc = fmaf(s, s, -q);
    if (!(disc >= 0.0f)) return inf;
    const float root = sqrtf(disc);
    const float ta = -s - root;
    const float tb = -s + root;
    // cancellation-stable small root (tracer._roots with A = |d|^2 = 1)
    float t0 = ta, t1 = tb;
    if (s < 0.0f) t0 = fabsf(tb) > 0.0f ? q / tb : ta;
    if (s > 0.0f) t1 = fabsf(ta) > 0.0f ? q / ta : tb;
    const bool entering = (s < 0.0f) && (q > 0.0f);
    const bool exiting = (s < 0.0f) || (q < 0.0f);
    const float a = entering ? t0 : (exiting ? t1 : inf);
    return a - eps;
}

// The ray may touch the bound of centre (bx, by, bz) and squared radius
// br2 (pallas_bigscene.py:141-156): s on CENTER minus ORIGIN, so forward
// is s > 0.  has_lim: the any-hit test, where the bound's entry must lie
// within the limit (280-291).
__device__ __forceinline__ bool bound_hit(float bx, float by, float bz,
                                          float br2, const Ray& r,
                                          bool has_lim, float lim) {
    const float ex = bx - r.px, ey = by - r.py, ez = bz - r.pz;
    const float s = fmaf(ez, r.dz, fmaf(ex, r.dx, ey * r.dy));
    const float q = fmaf(ez, ez, fmaf(ex, ex, ey * ey)) - br2;
    const float disc = fmaf(s, s, -q);
    const bool hit = (disc >= 0.0f) && ((s > 0.0f) || (q < 0.0f));
    if (!has_lim) return hit;
    const float te = fmaxf(s - sqrtf(disc >= 0.0f ? disc : 0.0f), 0.0f);
    return hit && (te <= lim);
}

// The ray may touch block g's bound.
__device__ __forceinline__ bool block_cull(const float* __restrict__ bounds,
                                           int g, const Ray& r, bool has_lim,
                                           float lim) {
    const float* b = bounds + 8 * g;
    return bound_hit(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), r,
                     has_lim, lim);
}

// The any-hit limit of ray i: one that is not finite reads as 3e38, as in
// the Pallas kernel.
__device__ __forceinline__ float read_limit(const float* __restrict__ lim,
                                            int i) {
    const float l = lim[i];
    return is_finite(l) ? l : F32_BIG;
}

// K7 warp design: any of the sphere lanes j, j + 32, j + 64, j + 96 of a
// block is hit within lim.
__device__ __forceinline__ bool lane_anyhit(const float* __restrict__ blk,
                                            int j, const Ray& r, float eps,
                                            float lim) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < LB / 32; ++k)
        hit |= sphere_cand(blk, j + 32 * k, r, eps) <= lim;
    return hit;
}

// ---- K6's top-2 helpers (see "The tie rule" above) ----

// Two (t, index) candidates, t1 before t2: a block's best two lanes, or a
// ray's best two sphere hits (index = gidx).
struct Top2 {
    float t1, t2;
    int i1, i2;
};

__device__ __forceinline__ Top2 top2_empty() {
    return Top2{finf(), finf(), 0, 0};
}

// (a, ia) comes before (b, ib) under the order (t, index).
__device__ __forceinline__ bool top2_before(float a, int ia, float b,
                                            int ib) {
    return a < b || (a == b && ia < ib);
}

// One step of the serial rule: candidate a of index i, pushed after every
// index that v already saw, with strict compares.
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
// (t, index): what each xor-shuffle step applies.
__device__ __forceinline__ Top2 top2_combine(const Top2& x, const Top2& y) {
    if (top2_before(y.t1, y.i1, x.t1, x.i1)) {
        const bool xs = top2_before(x.t1, x.i1, y.t2, y.i2);
        return Top2{y.t1, xs ? x.t1 : y.t2, y.i1, xs ? x.i1 : y.i2};
    }
    const bool ys = top2_before(y.t1, y.i1, x.t2, x.i2);
    return Top2{x.t1, ys ? y.t1 : x.t2, x.i1, ys ? y.i1 : x.i2};
}

// Lane j's local best two of one block: sphere lanes j, j + 32, j + 64,
// j + 96, in ascending order.
__device__ __forceinline__ Top2 lane_top2(const float* __restrict__ blk,
                                          int j, const Ray& r, float eps) {
    Top2 v = top2_empty();
#pragma unroll
    for (int k = 0; k < LB / 32; ++k)
        top2_push(v, sphere_cand(blk, j + 32 * k, r, eps), j + 32 * k);
    return v;
}

// The Pallas merge (pallas_bigscene.py:205-214) of block g's best two b
// (lane indices) into the ray's pair, where b's best beats the ray's
// second best.
__device__ __forceinline__ void top2_merge(Top2& ray, const Top2& b, int g) {
    if (!(b.t1 < ray.t2)) return;
    const int gi1 = g * LB + b.i1, gi2 = g * LB + b.i2;
    const float hi_t = fmaxf(ray.t1, b.t1);
    const int hi_i = b.t1 < ray.t1 ? ray.i1 : gi1;
    const float w2 = fminf(ray.t2, b.t2);
    const int w2i = b.t2 < ray.t2 ? gi2 : ray.i2;
    ray.i1 = b.t1 < ray.t1 ? gi1 : ray.i1;
    ray.t1 = fminf(ray.t1, b.t1);
    ray.t2 = fminf(hi_t, w2);
    ray.i2 = hi_t <= w2 ? hi_i : w2i;
}

// ---- kernels ----

constexpr int kTop2Warps = 8;   // K6: rays (one warp each) a thread block
constexpr int kAnyWarps = 8;    // K7 warp design: the same
constexpr int kChunk = 128;     // K6, K7 warp: block bounds a shared-memory
                                // stage holds

#ifdef __CUDACC__

constexpr unsigned kFull = 0xffffffffu;

// Stage bounds [g0, g0 + m): the first four words (centre, r2) of each
// 32-byte row, one 16-byte cp.async a bound, as one commit group.
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

__device__ __forceinline__ Top2 shfl_xor(const Top2& v, int m) {
    return Top2{__shfl_xor_sync(kFull, v.t1, m),
                __shfl_xor_sync(kFull, v.t2, m),
                __shfl_xor_sync(kFull, v.i1, m),
                __shfl_xor_sync(kFull, v.i2, m)};
}

__global__ void __launch_bounds__(kTop2Warps * 32)
big_top2_kernel(const float* __restrict__ table,
                const float* __restrict__ bounds, int G,
                const float* __restrict__ p, const float* __restrict__ d,
                float* __restrict__ t_out, int* __restrict__ i_out, int n,
                float eps) {
    __shared__ __align__(16) float stage[2][kChunk][4];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * kTop2Warps + (threadIdx.x >> 5);
    // a warp past the last ray still stages and meets the barriers
    const bool live = i < n;
    const Ray r = load_ray(p, d, live ? i : 0);
    Top2 ray = top2_empty();
    const int n_chunks = (G + kChunk - 1) / kChunk;
    stage_bounds(stage[0], bounds, 0, min(kChunk, G));
    for (int c = 0; c < n_chunks; ++c) {
        const int g0 = c * kChunk, m = min(kChunk, G - g0);
        if (c + 1 < n_chunks) {
            stage_bounds(stage[(c + 1) & 1], bounds, g0 + kChunk,
                         min(kChunk, G - g0 - kChunk));
            stage_wait<1>();
        } else {
            stage_wait<0>();
        }
        __syncthreads();
        if (live) {
            const float(*sb)[4] = stage[c & 1];
            for (int s = 0; s < m; s += 32) {
                const int j = s + lane;
                const bool pass = j < m && bound_hit(sb[j][0], sb[j][1],
                                                     sb[j][2], sb[j][3], r,
                                                     false, 0.0f);
                for (unsigned mask = __ballot_sync(kFull, pass); mask;
                     mask &= mask - 1) {
                    const int g = g0 + s + __ffs(mask) - 1;
                    Top2 v = lane_top2(table + (size_t)g * 8 * LB, lane, r,
                                       eps);
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        v = top2_combine(v, shfl_xor(v, o));
                    top2_merge(ray, v, g);
                }
            }
        }
        // the stage just read is refilled by the next chunk's prefetch
        __syncthreads();
    }
    if (live && lane == 0) {
        t_out[2 * i] = ray.t1;
        t_out[2 * i + 1] = ray.t2;
        i_out[2 * i] = ray.i1;
        i_out[2 * i + 1] = ray.i2;
    }
}

__global__ void __launch_bounds__(kAnyWarps * 32)
big_anyhit_warp_kernel(const float* __restrict__ table,
                       const float* __restrict__ bounds, int G,
                       const float* __restrict__ p,
                       const float* __restrict__ d,
                       const float* __restrict__ lim_in,
                       uint8_t* __restrict__ out, int n, float eps) {
    __shared__ __align__(16) float stage[2][kChunk][4];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * kAnyWarps + (threadIdx.x >> 5);
    // a warp past the last ray still stages and meets the barriers
    const bool live = i < n;
    const Ray r = load_ray(p, d, live ? i : 0);
    const float lim = live ? read_limit(lim_in, i) : 0.0f;
    bool hit = false;   // uniform across the warp
    const int n_chunks = (G + kChunk - 1) / kChunk;
    stage_bounds(stage[0], bounds, 0, min(kChunk, G));
    for (int c = 0; c < n_chunks; ++c) {
        const int g0 = c * kChunk, m = min(kChunk, G - g0);
        if (c + 1 < n_chunks) {
            stage_bounds(stage[(c + 1) & 1], bounds, g0 + kChunk,
                         min(kChunk, G - g0 - kChunk));
            stage_wait<1>();
        } else {
            stage_wait<0>();
        }
        __syncthreads();
        if (live && !hit) {
            const float(*sb)[4] = stage[c & 1];
            for (int s = 0; s < m && !hit; s += 32) {
                const int j = s + lane;
                const bool pass = j < m && bound_hit(sb[j][0], sb[j][1],
                                                     sb[j][2], sb[j][3], r,
                                                     true, lim);
                for (unsigned mask = __ballot_sync(kFull, pass);
                     mask && !hit; mask &= mask - 1) {
                    const int g = g0 + s + __ffs(mask) - 1;
                    hit = __any_sync(kFull,
                                     lane_anyhit(table + (size_t)g * 8 * LB,
                                                 lane, r, eps, lim));
                }
            }
        }
        // the stage just read is refilled by the next chunk's prefetch;
        // once every ray of the thread block is answered, nothing is
        // left to stage
        if (__syncthreads_and(!live || hit)) {
            stage_wait<0>();
            break;
        }
    }
    if (live && lane == 0) out[i] = hit ? 1 : 0;
}

#endif  // __CUDACC__

__global__ void __launch_bounds__(256)
big_anyhit_kernel(const float* __restrict__ table,
                  const float* __restrict__ bounds, int G,
                  const float* __restrict__ p, const float* __restrict__ d,
                  const float* __restrict__ lim_in,
                  uint8_t* __restrict__ out, int n, float eps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = load_ray(p, d, i);
    const float lim = read_limit(lim_in, i);
    for (int g = 0; g < G; ++g) {
        if (!block_cull(bounds, g, r, true, lim)) continue;
        const float* blk = table + (size_t)g * 8 * LB;
        for (int lane = 0; lane < LB; ++lane) {
            if (sphere_cand(blk, lane, r, eps) <= lim) {
                out[i] = 1;
                return;
            }
        }
    }
    out[i] = 0;
}

constexpr int kBlock = 256;     // K7 thread design: rays (one thread each)
                                // a thread block

inline int grid_of(int n, int per_block) {
    return (n + per_block - 1) / per_block;
}

}  // namespace

extern "C" {

int actinon_big_top2(const float* table, const float* bounds, int G,
                     const float* p, const float* d, float* t_out,
                     int* i_out, int n, float eps, void* stream) {
    // cp.async copies 16-byte bound rows
    if ((uintptr_t)bounds % 16 != 0) return (int)cudaErrorMisalignedAddress;
    big_top2_kernel<<<grid_of(n, kTop2Warps), kTop2Warps * 32, 0,
                      (cudaStream_t)stream>>>(table, bounds, G, p, d, t_out,
                                              i_out, n, eps);
    return (int)cudaGetLastError();
}

// warp: 1 for the warp design, 0 for the thread design (the wrapper
// chooses by G).
int actinon_big_anyhit(const float* table, const float* bounds, int G,
                       const float* p, const float* d, const float* lim,
                       uint8_t* out, int n, float eps, int warp,
                       void* stream) {
    if (warp) {
        // cp.async copies 16-byte bound rows
        if ((uintptr_t)bounds % 16 != 0)
            return (int)cudaErrorMisalignedAddress;
        big_anyhit_warp_kernel<<<grid_of(n, kAnyWarps), kAnyWarps * 32, 0,
                                 (cudaStream_t)stream>>>(
            table, bounds, G, p, d, lim, out, n, eps);
    } else {
        big_anyhit_kernel<<<grid_of(n, kBlock), kBlock, 0,
                            (cudaStream_t)stream>>>(table, bounds, G, p, d,
                                                    lim, out, n, eps);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
