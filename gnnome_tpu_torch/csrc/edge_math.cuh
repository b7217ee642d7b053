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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The value of x in element type S, as a float: x itself for float, x
// rounded to the nearest bf16 (ties to even) for __nv_bfloat16.  The bf16
// kernels round at the points of the JAX package's bf16 mode, where its
// operation on bf16 arrays returns a bf16 (one rnd per such operation); the
// plain PyTorch versions do the same operations on bf16 tensors, which
// compute in float32 and round each result the same way.
template <class S>
__device__ __forceinline__ float rnd(float x) {
    if constexpr (std::is_same<S, __nv_bfloat16>::value)
        return __bfloat162float(__float2bfloat16_rn(x));
    else
        return x;
}

// One stored element as a float (exact), and a float stored as element type
// S (bf16: rounded to nearest even; callers round at the contract's points
// first, so the store is exact).
__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <class S>
__device__ __forceinline__ S f32_elem(float x) {
    if constexpr (std::is_same<S, __nv_bfloat16>::value)
        return __float2bfloat16_rn(x);
    else
        return x;
}

// x = B1h[u] + B2h[v] + B3e, added in that order (in bf16: the endpoint sum
// rounded, then the sum with B3e rounded)
template <class S = float>
__device__ __forceinline__ float gate_x(float b1u, float b2v, float b3e) {
    return rnd<S>(__fadd_rn(rnd<S>(__fadd_rn(b1u, b2v)), b3e));
}

// y = ((x - mean) * inv_std) * gamma + beta, never folded into x * s + t
// (see k3_edge_stage.cu), each operation rounded to S.  The bf16 mode passes
// the JAX package's folded affine as mean = 0, inv_std = 1, gamma = scale,
// beta = bias: the first two steps are exact, so y = (x * scale) + bias
// with both results rounded to bf16, as JAX computes it.
template <class S = float>
__device__ __forceinline__ float bn_apply(float x, float mu, float rs,
                                          float ga, float be) {
    return rnd<S>(__fadd_rn(
        rnd<S>(__fmul_rn(rnd<S>(__fmul_rn(rnd<S>(__fsub_rn(x, mu)), rs)),
                         ga)),
        be));
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
