// Per-element arithmetic of the SymGatedGCN edge stage, shared by K3 (the
// forward), K7 (its batch statistics) and K8 (its adjoint), so that K8's
// recomputed gate, relu mask and sigmoid are bit for bit K3's.  Every
// operation uses an explicit round-to-nearest intrinsic: nvcc then cannot
// contract a multiply and an add into an FMA, and each result carries the
// per-op rounding of the plain PyTorch versions in ops/kernels.py.
//
// Also the fixed-order reductions of the global float64 sums: each block of
// K7 and K8 adds its rows into one partial row (block_partials); K8 adds the
// block rows in a fixed order by one more launch (reduce_partials), K7 in
// its own last blocks (k7_gate_stats.cu).  No float atomics, so the sums
// are bitwise reproducible.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {
namespace {   // internal linkage: every kernel source includes this

constexpr int kWarpsPerBlock = 8;
// column-chunk width of the warp-per-row kernels (csr_sum.cuh: 32 lanes x
// FPL <= 4 features); wider rows take more chunks (blockIdx.y)
constexpr int kMaxWidth = 128;

// Column chunks of width cw that cover d features.
inline int col_chunks(int d, int cw) { return (d + cw - 1) / cw; }

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// x = B1h[u] + B2h[v] + B3e, added in that order
__device__ __forceinline__ float gate_x(float b1u, float b2v, float b3e) {
    return __fadd_rn(__fadd_rn(b1u, b2v), b3e);
}

// y = ((x - mean) * inv_std) * gamma + beta, never folded into x * s + t
// (see k3_edge_stage.cu)
__device__ __forceinline__ float bn_apply(float x, float mu, float rs,
                                          float ga, float be) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rs), ga), be);
}

// Fixed-order block reduction of float64 rows for the [sum_a | sum_b] ([2d])
// global sums: red holds `rows` rows (one per warp or team) of 2 * cw
// values, [sum_a | sum_b] over the block's column chunk, features c0 ..
// c0 + cw - 1.  The rows are added in row order and written to
// partials[blockIdx.x * 2d + half * d + c0 + j] for c0 + j < d.  Call from
// every thread of the block.
__device__ __forceinline__ void block_partials(const double* red, int rows,
                                               int cw, int c0, int d,
                                               double* partials) {
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * cw; j += blockDim.x) {
        const int half = j >= cw ? 1 : 0;
        const int f = c0 + j - half * cw;
        if (f >= d) continue;
        double acc = 0.0;
        for (int r = 0; r < rows; ++r) acc += red[r * 2 * cw + j];
        partials[(int64_t)blockIdx.x * 2 * d + half * d + f] = acc;
    }
}

// out[j] = sum over b of partials[b * width + j], in a fixed order: a block
// of 8 x 32 threads per 32 columns; row r adds b = r, r + 8, ... in order
// (unrolled, so eight loads are in flight; the adds keep their order), then
// the 8 row sums are added in row order.
__global__ void __launch_bounds__(256)
reduce_partials(int n_parts, int width, const double* __restrict__ partials,
                double* __restrict__ out) {
    __shared__ double red[8][32];
    const int c = threadIdx.x & 31, r = threadIdx.x >> 5;
    const int j = blockIdx.x * 32 + c;
    double acc = 0.0;
    if (j < width) {
#pragma unroll 8
        for (int b = r; b < n_parts; b += 8)
            acc += partials[(int64_t)b * width + j];
    }
    red[r][c] = acc;
    __syncthreads();
    if (r == 0 && j < width) {
        double s = 0.0;
        for (int k = 0; k < 8; ++k) s += red[k][c];
        out[j] = s;
    }
}

void launch_reduce_partials(int n_parts, int width, const double* partials,
                            double* out, cudaStream_t st) {
    reduce_partials<<<(width + 31) / 32, 256, 0, st>>>(n_parts, width,
                                                       partials, out);
}

}  // namespace
}  // namespace gn
