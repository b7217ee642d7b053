// K9: the adjoint of K6, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k9_aggregate_packed (body
// _k9_kernel).  K6 gathers pu[u] and pv[v] per edge slot; its adjoint sums
// one per-edge cotangent p [E, H] (the caller's dz * (z > 0)) into both
// endpoints:
//
//   sum_u[i] = sum over slots s with u(s) = i of p[s]      ([N, H])
//   sum_v[i] = sum over slots s with v(s) = i of p[s]      ([N, H])
//
// Bound on the card: bytes.  It must read p once (H floats per edge) and
// write the two [N, H] sums; one add per element and endpoint.
//
// Design.  The TPU kernel scattered p into per-block window partials with
// one-hot matmuls.  Here each sum walks its sorted-segment CSR (as K3 does):
// one warp per node adds that node's slots in slot order, lanes on the H
// features, and writes its row once.  No atomics, so the sums are bitwise
// reproducible.  flip=False: v = dst, whose slot list is the identity, so
// that pass streams p in order; the u pass reads it through the stable src
// permutation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace {

using gn::kWarpsPerBlock;

template <int FPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k9_pass(int n_nodes, int h, const int* __restrict__ ptr,
        const int* __restrict__ perm, const float* __restrict__ pay,
        float* __restrict__ out) {
    const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (node >= n_nodes) return;
    float acc[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k) acc[k] = 0.0f;
    const int beg = ptr[node], end = ptr[node + 1];
    for (int i = beg; i < end; ++i) {
        const int64_t row = (int64_t)(perm ? perm[i] : i) * h;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = lane + 32 * k;
            if (f < h) acc[k] = __fadd_rn(acc[k], pay[row + f]);
        }
    }
    float* o = out + (int64_t)node * h;
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        if (f < h) o[f] = acc[k];
    }
}

template <int FPL>
int launch(int n_nodes, int h, const int* v_ptr, const int* v_perm,
           const int* u_ptr, const int* u_perm, const float* pay,
           float* sum_u, float* sum_v, cudaStream_t st) {
    const dim3 block(32 * kWarpsPerBlock);
    const dim3 grid((n_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock);
    k9_pass<FPL><<<grid, block, 0, st>>>(n_nodes, h, v_ptr, v_perm, pay,
                                          sum_v);
    k9_pass<FPL><<<grid, block, 0, st>>>(n_nodes, h, u_ptr, u_perm, pay,
                                          sum_u);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gn_k9_aggregate(int n_nodes, int h, const int* v_ptr,
                               const int* v_perm, const int* u_ptr,
                               const int* u_perm, const float* pay,
                               float* sum_u, float* sum_v, void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (h <= 32)
        return launch<1>(n_nodes, h, v_ptr, v_perm, u_ptr, u_perm, pay,
                         sum_u, sum_v, st);
    if (h <= 64)
        return launch<2>(n_nodes, h, v_ptr, v_perm, u_ptr, u_perm, pay,
                         sum_u, sum_v, st);
    if (h <= 128)
        return launch<4>(n_nodes, h, v_ptr, v_perm, u_ptr, u_perm, pay,
                         sum_u, sum_v, st);
    return (int)cudaErrorInvalidValue;
}
