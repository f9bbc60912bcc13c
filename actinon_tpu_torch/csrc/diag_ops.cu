// Elementwise diagnostic kernel, hand-written for Hopper (sm_90a).
//
//   diag_kernel<op> with a unary op code (K8) replaces
//       tools/diag_tpu_ops.py pallas_unary: sin, cos, sqrt, rsqrt or exp of
//       every element;
//   diag_kernel<op> with an expression op code (K9) replaces the inline
//       kernel of tools/diag_tpu_ops.py main: a / b, or a * b + c.
//
// The TPU tool ran each op inside a Pallas kernel and against XLA's own
// lowering of it, to find where a hand-written kernel's arithmetic departs
// from the framework's.  This kernel does the same for CUDA C++ built with
// the port's flags (no fast-math: sqrtf and division IEEE-rounded, sinf,
// cosf, expf the accurate library versions, rsqrtf the hardware
// approximation, and a * b + c contracted to one FMA, as nvcc contracts
// it) against torch's ops on the same tensors.
//
// Design: one kernel instance per op code (a template on the op, picked by
// the host), so no op switch runs per element and an instance reads only
// the inputs its op takes; one element a thread, 128 threads a block (32
// blocks at the tool's 4,096 elements).  What bounds it on this card:
// bytes (8 to 16 per element), and at the tool's [32, 128] shape the
// launch itself, which takes longer than moving its 32 to 64 KB.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// stream it is given and returns cudaGetLastError(); it refuses op codes
// it does not know.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// op codes: must match actinon_tpu_torch/diag_ops.py
enum { OP_SIN = 0, OP_COS = 1, OP_SQRT = 2, OP_RSQRT = 3, OP_EXP = 4,
       OP_DIV = 5, OP_MUL_ADD = 6 };

constexpr int kDiagThreads = 128;   // threads a block, one element each

template <int OP>
__global__ void __launch_bounds__(kDiagThreads)
diag_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, float* __restrict__ out, int n) {
    const int i = blockIdx.x * kDiagThreads + threadIdx.x;
    if (i >= n) return;
    const float x = a[i];
    if constexpr (OP == OP_SIN) out[i] = sinf(x);
    else if constexpr (OP == OP_COS) out[i] = cosf(x);
    else if constexpr (OP == OP_SQRT) out[i] = sqrtf(x);
    else if constexpr (OP == OP_RSQRT) out[i] = rsqrtf(x);
    else if constexpr (OP == OP_EXP) out[i] = expf(x);
    else if constexpr (OP == OP_DIV) out[i] = x / b[i];
    else out[i] = fmaf(x, b[i], c[i]);   // a * b + c, contracted to one FMA
}

template <int OP>
cudaError_t launch(const float* a, const float* b, const float* c,
                   float* out, int n, cudaStream_t stream) {
    diag_kernel<OP><<<(n + kDiagThreads - 1) / kDiagThreads, kDiagThreads,
                      0, stream>>>(a, b, c, out, n);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int actinon_diag_op(int op, const float* a, const float* b, const float* c,
                    float* out, int n, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case OP_SIN: return (int)launch<OP_SIN>(a, b, c, out, n, s);
        case OP_COS: return (int)launch<OP_COS>(a, b, c, out, n, s);
        case OP_SQRT: return (int)launch<OP_SQRT>(a, b, c, out, n, s);
        case OP_RSQRT: return (int)launch<OP_RSQRT>(a, b, c, out, n, s);
        case OP_EXP: return (int)launch<OP_EXP>(a, b, c, out, n, s);
        case OP_DIV: return (int)launch<OP_DIV>(a, b, c, out, n, s);
        case OP_MUL_ADD: return (int)launch<OP_MUL_ADD>(a, b, c, out, n, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
