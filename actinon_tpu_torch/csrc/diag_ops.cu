// Elementwise diagnostic kernel, hand-written for Hopper (sm_90a).
//
//   diag_kernel with a unary op code (K8) replaces
//       tools/diag_tpu_ops.py pallas_unary: sin, cos, sqrt, rsqrt or exp of
//       every element;
//   diag_kernel with an expression op code (K9) replaces the inline kernel
//       of tools/diag_tpu_ops.py main: a / b, or a * b + c.
//
// The TPU tool ran each op inside a Pallas kernel and against XLA's own
// lowering of it, to find where a hand-written kernel's arithmetic departs
// from the framework's.  This kernel does the same for CUDA C++ built with
// the port's flags (no fast-math: sqrtf and division IEEE-rounded, sinf,
// cosf, expf the accurate library versions, rsqrtf the hardware
// approximation, and a * b + c contracted to one FMA by nvcc) against
// torch's ops on the same tensors.
//
// Design: one thread per element, 256 threads a block, one launch per op
// (the op code is a kernel argument, the switch is uniform across the
// grid).  What bounds it on this card: bytes (4 to 16 per element), and at
// the tool's [32, 128] shape the launch itself, which takes longer than
// moving its 32 to 64 KB.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

// op codes: must match actinon_tpu_torch/diag_ops.py
enum { OP_SIN = 0, OP_COS = 1, OP_SQRT = 2, OP_RSQRT = 3, OP_EXP = 4,
       OP_DIV = 5, OP_MUL_ADD = 6 };

__global__ void __launch_bounds__(256)
diag_kernel(int op, const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float x = a[i];
    float y;
    switch (op) {
        case OP_SIN: y = sinf(x); break;
        case OP_COS: y = cosf(x); break;
        case OP_SQRT: y = sqrtf(x); break;
        case OP_RSQRT: y = rsqrtf(x); break;
        case OP_EXP: y = expf(x); break;
        case OP_DIV: y = x / b[i]; break;
        default: y = x * b[i] + c[i]; break;
    }
    out[i] = y;
}

constexpr int kBlock = 256;

}  // namespace

extern "C" {

int actinon_diag_op(int op, const float* a, const float* b, const float* c,
                    float* out, int n, void* stream) {
    diag_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                  (cudaStream_t)stream>>>(op, a, b, c, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
