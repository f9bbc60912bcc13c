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
// Design.  One thread per ray, 256 threads a block; each thread walks the
// G blocks in Morton order.  The TPU kernel tiles 256 rays and skips a
// block only when no ray of the tile touches its bound (a tile-wide
// pl.when); here the cull is per ray, which is exact and tighter: the
// bound covers every member's surface plus 2 eps.  K6 keeps the Pallas
// merge order: per block the best lane b1 (first lane on ties) and the
// second best b2 with that lane masked out, then the merge formulas of
// pallas_bigscene.py:205-214, applied where b1 beats the ray's second best
// (the tile gate any(b1 < t2) of pallas_bigscene.py:192, made per ray;
// where b1 == t2 exactly the TPU can swap the second index, the port keeps
// it).  K7 culls with the limit-aware entry test and a thread returns as
// soon as its ray is blocked.  Table reads: a thread that passes a block
// reads its four rows x 128 lanes from global memory; threads of a warp
// that pass the same block read the same addresses, a broadcast through
// L1.  No atomics: results are deterministic.
//
// What bounds it on this card: FP32 operations (about 40 a sphere lane, 19
// a block test), not bytes: a ray reads 24 (K7: 28) bytes and writes 16
// (K7: 1), and the table (16 KB a block of the 4 rows read) stays in L2.
// Not done yet: staging blocks in shared memory, and grouping rays so that
// the threads of a warp pass the same blocks.
//
// Numerics: f32, no fast-math, the expression order of the Pallas helpers
// (nvcc contracts to FMA, so results agree with the plain version at f32
// tolerance, not bit for bit).  Interface: plain C functions, loaded with
// ctypes.  Each launches on the stream it is given and returns
// cudaGetLastError().

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
    const float s = (ppx * r.dx + ppy * r.dy) + ppz * r.dz;
    const float q = ((ppx * ppx + ppy * ppy) + ppz * ppz) - r2;
    const float disc = s * s - q;
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

// The ray may touch block g's bound (pallas_bigscene.py:141-156): s on
// CENTER minus ORIGIN, so forward is s > 0.  has_lim: the any-hit test,
// where the bound's entry must lie within the limit (280-291).
__device__ __forceinline__ bool block_cull(const float* __restrict__ bounds,
                                           int g, const Ray& r, bool has_lim,
                                           float lim) {
    const float* b = bounds + 8 * g;
    const float ex = __ldg(b) - r.px, ey = __ldg(b + 1) - r.py,
                ez = __ldg(b + 2) - r.pz;
    const float s = (ex * r.dx + ey * r.dy) + ez * r.dz;
    const float q = ((ex * ex + ey * ey) + ez * ez) - __ldg(b + 3);
    const float disc = s * s - q;
    const bool hit = (disc >= 0.0f) && ((s > 0.0f) || (q < 0.0f));
    if (!has_lim) return hit;
    const float te = fmaxf(s - sqrtf(disc >= 0.0f ? disc : 0.0f), 0.0f);
    return hit && (te <= lim);
}

// ---- kernels ----

__global__ void __launch_bounds__(256)
big_top2_kernel(const float* __restrict__ table,
                const float* __restrict__ bounds, int G,
                const float* __restrict__ p, const float* __restrict__ d,
                float* __restrict__ t_out, int* __restrict__ i_out, int n,
                float eps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float inf = finf();
    const Ray r = load_ray(p, d, i);
    float t1 = inf, t2 = inf;
    int i1 = 0, i2 = 0;
    for (int g = 0; g < G; ++g) {
        if (!block_cull(bounds, g, r, false, 0.0f)) continue;
        const float* blk = table + (size_t)g * 8 * LB;
        // the block's best and second-best lanes, first lane on ties
        float b1 = inf, b2 = inf;
        int l1 = 0, l2 = 0;
        for (int lane = 0; lane < LB; ++lane) {
            const float a = sphere_cand(blk, lane, r, eps);
            if (a < b1) {
                b2 = b1;
                l2 = l1;
                b1 = a;
                l1 = lane;
            } else if (a < b2) {
                b2 = a;
                l2 = lane;
            }
        }
        if (!(b1 < t2)) continue;
        // the Pallas merge (pallas_bigscene.py:205-214)
        const int gi1 = g * LB + l1, gi2 = g * LB + l2;
        const float hi_t = fmaxf(t1, b1);
        const int hi_i = b1 < t1 ? i1 : gi1;
        const float w2 = fminf(t2, b2);
        const int w2i = b2 < t2 ? gi2 : i2;
        i1 = b1 < t1 ? gi1 : i1;
        t1 = fminf(t1, b1);
        t2 = fminf(hi_t, w2);
        i2 = hi_t <= w2 ? hi_i : w2i;
    }
    t_out[2 * i] = t1;
    t_out[2 * i + 1] = t2;
    i_out[2 * i] = i1;
    i_out[2 * i + 1] = i2;
}

__global__ void __launch_bounds__(256)
big_anyhit_kernel(const float* __restrict__ table,
                  const float* __restrict__ bounds, int G,
                  const float* __restrict__ p, const float* __restrict__ d,
                  const float* __restrict__ lim_in,
                  uint8_t* __restrict__ out, int n, float eps) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = load_ray(p, d, i);
    // a limit that is not finite reads as 3e38, as in the Pallas kernel
    const float l = lim_in[i];
    const float lim = is_finite(l) ? l : F32_BIG;
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

constexpr int kBlock = 256;

inline int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

int actinon_big_top2(const float* table, const float* bounds, int G,
                     const float* p, const float* d, float* t_out,
                     int* i_out, int n, float eps, void* stream) {
    big_top2_kernel<<<grid_of(n), kBlock, 0, (cudaStream_t)stream>>>(
        table, bounds, G, p, d, t_out, i_out, n, eps);
    return (int)cudaGetLastError();
}

int actinon_big_anyhit(const float* table, const float* bounds, int G,
                       const float* p, const float* d, const float* lim,
                       uint8_t* out, int n, float eps, void* stream) {
    big_anyhit_kernel<<<grid_of(n), kBlock, 0, (cudaStream_t)stream>>>(
        table, bounds, G, p, d, lim, out, n, eps);
    return (int)cudaGetLastError();
}

}  // extern "C"
