// K7: the BatchNorm batch statistics of the training gate, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k7_gate_stats (body _k7_kernel).
// Per edge slot s with flip-resolved endpoints u, v:
//
//   x[s]  = B1h[u] + B2h[v] + B3e[s]        (csrc/edge_math.cuh, as K3)
//   out   = [sum_s x | sum_s x * x]          ([2d], float64)
//
// x is never written.  bu rows are B1h (row stride ldu), bv rows B2h (ldv):
// the gate columns of the [N, 4d] training projection, read in place.
//
// Bound on the card: bytes.  It streams b3e (d floats per edge) and two
// d-float row gathers from node tables that stay in the 50 MB L2 at E. coli
// scale; four flops per element.
//
// Design.  The TPU kernel built per-tile partial sums with a masked one-hot
// matmul and the caller added the tiles.  Here each warp walks a contiguous
// run of slots (lanes on features, so every row read is coalesced) and
// accumulates in float64: x * x of a float32 x is exact in float64, and the
// float64 sums keep the caller's one-pass variance sum(x^2)/n - mean^2 from
// cancelling where |mean| >> std.  Warps add into a per-block row in warp
// order, and a second launch adds the block rows in a fixed order: the
// result is bitwise reproducible, with no atomics.  The partition into warps
// depends on E only.  Rows wider than 128 features take several column
// chunks (blockIdx.y), each with its own shared-memory rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace {

using gn::kWarpsPerBlock;
constexpr int kEdgesPerWarp = 32;
constexpr int kMaxBlocks = 2048;

// Blocks for E edges: about kEdgesPerWarp slots per warp, at most kMaxBlocks.
int num_blocks(int64_t n_edges) {
    const int64_t warps = (n_edges + kEdgesPerWarp - 1) / kEdgesPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    return (int)(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

template <int FPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k7_partials(int64_t n_edges, int d, int64_t chunk,
            const int* __restrict__ u_idx, const int* __restrict__ v_idx,
            const float* __restrict__ bu, int64_t ldu,
            const float* __restrict__ bv, int64_t ldv,
            const float* __restrict__ b3e, double* __restrict__ partials) {
    constexpr int CW = 32 * FPL;          // column chunk: blockIdx.y
    __shared__ double red[kWarpsPerBlock * 2 * CW];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int c0 = blockIdx.y * CW;
    const int64_t beg = ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * chunk;
    const int64_t end = beg + chunk < n_edges ? beg + chunk : n_edges;
    double s1[FPL], s2[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        s1[k] = 0.0;
        s2[k] = 0.0;
    }
    for (int64_t s = beg; s < end; ++s) {
        const float* pu = bu + (int64_t)u_idx[s] * ldu;
        const float* pv = bv + (int64_t)v_idx[s] * ldv;
        const float* pb = b3e + s * d;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = c0 + lane + 32 * k;
            if (f < d) {
                const float x = gn::gate_x(pu[f], pv[f], pb[f]);
                s1[k] += (double)x;
                s2[k] += (double)x * (double)x;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        red[warp * 2 * CW + lane + 32 * k] = s1[k];
        red[warp * 2 * CW + CW + lane + 32 * k] = s2[k];
    }
    gn::block_partials(red, kWarpsPerBlock, CW, c0, d, partials);
}

template <int FPL>
int launch(int64_t n_edges, int d, const int* u_idx, const int* v_idx,
           const float* bu, int64_t ldu, const float* bv, int64_t ldv,
           const float* b3e, double* partials, double* out,
           cudaStream_t st) {
    const int blocks = num_blocks(n_edges);
    const int64_t all = (int64_t)blocks * kWarpsPerBlock;
    const int64_t chunk = (n_edges + all - 1) / all;
    const dim3 grid(blocks, gn::col_chunks(d, 32 * FPL));
    k7_partials<FPL><<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        n_edges, d, chunk, u_idx, v_idx, bu, ldu, bv, ldv, b3e, partials);
    gn::launch_reduce_partials(blocks, 2 * d, partials, out, st);
    return (int)cudaGetLastError();
}

}  // namespace

// Blocks the launch uses for E edges: the caller sizes ``partials`` as
// [gn_k7_num_blocks(E), 2d] float64.
extern "C" int gn_k7_num_blocks(int64_t n_edges) {
    return num_blocks(n_edges);
}

extern "C" int gn_k7_gate_stats(int64_t n_edges, int d, const int* u_idx,
                                const int* v_idx, const float* bu,
                                int64_t ldu, const float* bv, int64_t ldv,
                                const float* b3e, double* partials,
                                double* out, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 32)
        return launch<1>(n_edges, d, u_idx, v_idx, bu, ldu, bv, ldv, b3e,
                         partials, out, st);
    if (d <= 64)
        return launch<2>(n_edges, d, u_idx, v_idx, bu, ldu, bv, ldv, b3e,
                         partials, out, st);
    return launch<4>(n_edges, d, u_idx, v_idx, bu, ldu, bv, ldv, b3e,
                     partials, out, st);
}
