// K1: the unfused path's endpoint gathers and gate, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k1_gather_gate (body
// _k1_kernel).  Per edge slot s with flip-resolved endpoints u, v:
//
//   out[s] = [ (B1h[u] + B2h[v]) + B3e[s] | A2h[u] | A3h[v] ]   ([E, 3d])
//
// where proj_u rows are [B1h | A2h] and proj_v rows are [B2h | A3h] (row
// strides ldu, ldv: column slices of the layer's [N, 5d] projection are read
// in place).  The layer- and norm-free SymGatedGCN normalises the gate and
// takes the two gathered messages into the gated mean (K2).
//
// Bound on the card: bytes.  It reads b3e (d floats per edge), gathers
// two 2d-float rows and writes 3d floats per edge; two adds per edge and
// feature.  The node tables ([N, 2d] each, ~5 MB at E. coli scale) stay in
// the 50 MB L2, so the b3e and output streams set the floor.
//
// Design.  The TPU kernel selected rows with one-hot matmuls against node
// windows; here a row gather is a plain load.  One thread per (slot, four
// features): each thread loads one float4 of each operand and stores three,
// so neighbouring threads touch neighbouring 16-byte words of one edge's
// rows.  When d is not a multiple of 4 or a pointer or row stride is not
// 16-byte aligned, the same kernel runs one thread per (slot, feature).
// The gate adds in the plain version's order with round-to-nearest
// intrinsics (edge_math.cuh), so no FMA contraction: results are bit-equal
// to it.  A grid-stride loop covers any E * d.
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace {

using gn::gate_x;

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

// VEC: one item = 4 features (d % 4 == 0, every row 16-byte aligned);
// otherwise one item = 1 feature
template <bool VEC>
__global__ void k1_gather_gate_kernel(int64_t n_items, int d,
                                      const int* __restrict__ u_idx,
                                      const int* __restrict__ v_idx,
                                      const float* __restrict__ proj_u,
                                      int64_t ldu,
                                      const float* __restrict__ proj_v,
                                      int64_t ldv,
                                      const float* __restrict__ b3e,
                                      float* __restrict__ out) {
    const int per_slot = VEC ? d / 4 : d;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_items; i += stride) {
        const int64_t s = i / per_slot;
        const int f = (VEC ? 4 : 1) * (int)(i - s * per_slot);
        const float* pu = proj_u + (int64_t)u_idx[s] * ldu;
        const float* pv = proj_v + (int64_t)v_idx[s] * ldv;
        const float* b3 = b3e + s * d;
        float* o = out + s * 3 * d;
        if constexpr (VEC) {
            const float4 b1 = ld4(pu + f), b2 = ld4(pv + f), e3 = ld4(b3 + f);
            float4 x;
            x.x = gate_x(b1.x, b2.x, e3.x);
            x.y = gate_x(b1.y, b2.y, e3.y);
            x.z = gate_x(b1.z, b2.z, e3.z);
            x.w = gate_x(b1.w, b2.w, e3.w);
            st4(o + f, x);
            st4(o + d + f, ld4(pu + d + f));
            st4(o + 2 * d + f, ld4(pv + d + f));
        } else {
            o[f] = gate_x(pu[f], pv[f], b3[f]);
            o[d + f] = pu[d + f];
            o[2 * d + f] = pv[d + f];
        }
    }
}

}  // namespace

extern "C" int gn_k1_gather_gate(int64_t n_edges, int d, const int* u_idx,
                                 const int* v_idx, const float* proj_u,
                                 int64_t ldu, const float* proj_v,
                                 int64_t ldv, const float* b3e, float* out,
                                 void* stream) {
    if (n_edges <= 0 || d <= 0) return (int)cudaSuccess;
    const uintptr_t addr = (uintptr_t)proj_u | (uintptr_t)proj_v
                           | (uintptr_t)b3e | (uintptr_t)out;
    const bool vec = d % 4 == 0 && ldu % 4 == 0 && ldv % 4 == 0
                     && addr % 16 == 0;
    const int64_t n = n_edges * (vec ? d / 4 : d);
    const int block = 256;
    const int64_t want = (n + block - 1) / block;
    const int grid = (int)(want < (1 << 30) ? want : (1 << 30));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
        k1_gather_gate_kernel<true><<<grid, block, 0, st>>>(
            n, d, u_idx, v_idx, proj_u, ldu, proj_v, ldv, b3e, out);
    else
        k1_gather_gate_kernel<false><<<grid, block, 0, st>>>(
            n, d, u_idx, v_idx, proj_u, ldu, proj_v, ldv, b3e, out);
    return (int)cudaGetLastError();
}
