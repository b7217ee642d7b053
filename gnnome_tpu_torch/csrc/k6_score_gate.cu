// K6: the score predictor's first layer, fused, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k6_score_gate (body _k6_kernel).
// Per edge slot s with flip-resolved endpoints u, v and hidden width H:
//
//   z[s] = relu(pu[u] + pv[v] + be[s])
//
// where puv rows are [pu | pv] = [h @ W1[:d] | h @ W1[d:2d]] (the endpoint
// parts of the first predictor matmul, computed in node space by the caller)
// and be = e @ W1[2d:] + b1.
//
// Bound on the card: bytes.  It reads be and writes z (2 x H floats per
// edge) plus two H-float row gathers from the [N, 2H] node table, which
// stays in L2; two adds and a max per element.
//
// Design.  One thread per (slot, feature): neighbouring threads touch
// neighbouring features of one edge, so the be/z streams and the two row
// gathers are coalesced.  The TPU kernel's windowed one-hot selects become
// plain loads.  A grid-stride loop covers any E * H.  Explicit
// round-to-nearest adds keep the plain PyTorch version's per-op rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void k6_score_gate_kernel(int64_t n_elems, int h,
                                     const int* __restrict__ u_idx,
                                     const int* __restrict__ v_idx,
                                     const float* __restrict__ puv,
                                     const float* __restrict__ be,
                                     float* __restrict__ z) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_elems; i += stride) {
        const int64_t s = i / h;
        const int f = (int)(i - s * h);
        const float a = puv[(int64_t)u_idx[s] * 2 * h + f];
        const float b = puv[(int64_t)v_idx[s] * 2 * h + h + f];
        z[i] = fmaxf(__fadd_rn(__fadd_rn(a, b), be[i]), 0.0f);
    }
}

}  // namespace

extern "C" int gn_k6_score_gate(int64_t n_edges, int h, const int* u_idx,
                                const int* v_idx, const float* puv,
                                const float* be, float* z, void* stream) {
    const int64_t n = n_edges * h;
    if (n <= 0) return (int)cudaSuccess;
    const int block = 256;
    const int64_t want = (n + block - 1) / block;
    const int grid = (int)(want < (1 << 30) ? want : (1 << 30));
    k6_score_gate_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        n, h, u_idx, v_idx, puv, be, z);
    return (int)cudaGetLastError();
}
