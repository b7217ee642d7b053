// Sorted-segment node sums of K2 (the unfused path's aggregation, and the
// model zoo's one-sided sums), one launch per endpoint side.  (K9 walks both
// sides of a node in one launch: csrc/k9_aggregate.cu.)
//
// out[i] = sum over k in [ptr[i], ptr[i+1]) of pay[row(k)], row(k) =
// perm[k] (or k where perm is null), for every node i < n_nodes.  The CSR
// is one side of DeviceGraph.roles: its slot list per node is in slot
// order, so each sum adds its terms in slot order.
//
// Payload elements S are float or bfloat16; the sums are float32 either
// way: a bf16 element widens exactly and every add is a float32
// __fadd_rn, so a bf16 payload's sums are those of its float32 copy.  (The
// JAX package's Pallas K2 keeps its per-block partials in the payload dtype
// and rounds each chunk's sum to bf16, to halve its HBM bytes on the TPU,
// pallas_kernels.py:140-146; that is a TPU byte saving and not ported: the
// port's sums follow the JAX XLA path, which sums the bf16 payloads in
// float32, message.py:780-791, and its callers round where JAX casts.)
//
// One warp per node and column chunk of up to kMaxWidth features (blockIdx.y
// picks the chunk, so any width is taken), lanes striding the chunk: the
// warp walks the node's slots, keeps the sums in registers and writes its
// part of the node's row once.  A node with no slots writes zeros.  No
// atomics, so the sums are bitwise reproducible.  Payload rows are ld
// elements apart (a column slice of a wider array is read in place); output
// rows are dense.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace gn {
namespace {   // internal linkage: every kernel source includes this

template <int FPL, class S>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_row_sum(int n_nodes, int width, const int* __restrict__ ptr,
            const int* __restrict__ perm, const S* __restrict__ pay,
            int64_t ld, float* __restrict__ out) {
    const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int c0 = blockIdx.y * 32 * FPL;
    if (node >= n_nodes) return;
    float acc[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k) acc[k] = 0.0f;
    const int beg = ptr[node], end = ptr[node + 1];
    for (int i = beg; i < end; ++i) {
        const S* row = pay + (int64_t)(perm ? perm[i] : i) * ld;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = c0 + lane + 32 * k;
            if (f < width) acc[k] = __fadd_rn(acc[k], elem_f32(row[f]));
        }
    }
    float* o = out + (int64_t)node * width;
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = c0 + lane + 32 * k;
        if (f < width) o[f] = acc[k];
    }
}

// Launches csr_row_sum on st; returns the launch's cudaGetLastError.
template <class S>
int launch_csr_row_sum(int n_nodes, int width, const int* ptr,
                       const int* perm, const S* pay, int64_t ld,
                       float* out, cudaStream_t st) {
    const dim3 block(32 * kWarpsPerBlock);
    const int blocks = (n_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (width <= 32)
        csr_row_sum<1, S><<<dim3(blocks), block, 0, st>>>(
            n_nodes, width, ptr, perm, pay, ld, out);
    else if (width <= 64)
        csr_row_sum<2, S><<<dim3(blocks), block, 0, st>>>(
            n_nodes, width, ptr, perm, pay, ld, out);
    else
        csr_row_sum<4, S><<<dim3(blocks, col_chunks(width, kMaxWidth)),
                            block, 0, st>>>(n_nodes, width, ptr, perm, pay,
                                            ld, out);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gn
