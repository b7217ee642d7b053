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
// Element types: float32, or bfloat16 (the JAX package's compute.dtype=
// bfloat16).  Every operand and the output are of one type.  In bf16 the
// gate is computed in float32 and rounded to bf16 twice, after the endpoint
// sum and after the add of B3e: rnd(rnd(B1h[u] + B2h[v]) + B3e), the JAX
// kernel's (gu + gv).astype(dt) + b3e (pallas_kernels.py:193) and the XLA
// bf16 sum g_u + g_v + b3e (message.py:107).  The A2h and A3h columns are
// exact copies.
//
// Bound on the card: bytes.  It reads b3e (d elements per edge), gathers
// two 2d-element rows and writes 3d elements per edge; two adds per edge and
// feature.  The node tables ([N, 2d] each, ~5 MB in float32 at E. coli
// scale) stay in the 50 MB L2, so the b3e and output streams set the floor;
// bf16 halves them.
//
// Design.  The TPU kernel selected rows with one-hot matmuls against node
// windows; here a row gather is a plain load.  One thread per (slot, V
// features), each operand loaded and each output stored as one word of
// V elements: 16 bytes (four floats or eight bf16) where d, the row strides
// and every pointer allow it, else (bf16) 8 bytes of four, else one element
// per thread.  Neighbouring threads touch neighbouring words of one edge's
// rows.  The gate adds in the plain version's order with round-to-nearest
// intrinsics (edge_math.cuh), so no FMA contraction: results are bit-equal
// to it.  A grid-stride loop covers any E * d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace {

using gn::elem_f32;
using gn::f32_elem;
using gn::gate_x;

// V consecutive elements of S, loaded and stored as one word
template <class S, int V>
struct alignas(sizeof(S) * V) Pack {
    S x[V];
};

template <class S, int V>
__device__ __forceinline__ Pack<S, V> ld(const S* p) {
    return *reinterpret_cast<const Pack<S, V>*>(p);
}

template <class S, int V>
__device__ __forceinline__ void st(S* p, const Pack<S, V>& x) {
    *reinterpret_cast<Pack<S, V>*>(p) = x;
}

// one item = V features of one slot (d % V == 0, every row aligned to V
// elements)
template <class S, int V>
__global__ void k1_gather_gate_kernel(int64_t n_items, int d,
                                      const int* __restrict__ u_idx,
                                      const int* __restrict__ v_idx,
                                      const S* __restrict__ proj_u,
                                      int64_t ldu,
                                      const S* __restrict__ proj_v,
                                      int64_t ldv,
                                      const S* __restrict__ b3e,
                                      S* __restrict__ out) {
    const int per_slot = d / V;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_items; i += stride) {
        const int64_t s = i / per_slot;
        const int f = V * (int)(i - s * per_slot);
        const S* pu = proj_u + (int64_t)u_idx[s] * ldu;
        const S* pv = proj_v + (int64_t)v_idx[s] * ldv;
        S* o = out + s * 3 * d;
        const Pack<S, V> b1 = ld<S, V>(pu + f), b2 = ld<S, V>(pv + f),
                         e3 = ld<S, V>(b3e + s * d + f);
        Pack<S, V> x;
#pragma unroll
        for (int k = 0; k < V; ++k)
            x.x[k] = f32_elem<S>(gate_x<S>(elem_f32(b1.x[k]),
                                           elem_f32(b2.x[k]),
                                           elem_f32(e3.x[k])));
        st<S, V>(o + f, x);
        st<S, V>(o + d + f, ld<S, V>(pu + d + f));
        st<S, V>(o + 2 * d + f, ld<S, V>(pv + d + f));
    }
}

template <class S, int V>
int launch(int64_t n_edges, int d, const int* u_idx, const int* v_idx,
           const S* proj_u, int64_t ldu, const S* proj_v, int64_t ldv,
           const S* b3e, S* out, cudaStream_t st) {
    const int64_t n = n_edges * (d / V);
    const int block = 256;
    const int64_t want = (n + block - 1) / block;
    const int grid = (int)(want < (1 << 30) ? want : (1 << 30));
    k1_gather_gate_kernel<S, V><<<grid, block, 0, st>>>(
        n, d, u_idx, v_idx, proj_u, ldu, proj_v, ldv, b3e, out);
    return (int)cudaGetLastError();
}

// the widest word that d, both row strides and every pointer allow
template <class S>
int dispatch(int64_t n_edges, int d, const int* u_idx, const int* v_idx,
             const S* proj_u, int64_t ldu, const S* proj_v, int64_t ldv,
             const S* b3e, S* out, cudaStream_t st) {
    const uintptr_t addr = (uintptr_t)proj_u | (uintptr_t)proj_v
                           | (uintptr_t)b3e | (uintptr_t)out;
    auto fits = [&](int v) {
        return d % v == 0 && ldu % v == 0 && ldv % v == 0
               && addr % (v * sizeof(S)) == 0;
    };
    constexpr int kWide = 16 / sizeof(S);        // 16 bytes
    if (fits(kWide))
        return launch<S, kWide>(n_edges, d, u_idx, v_idx, proj_u, ldu,
                                proj_v, ldv, b3e, out, st);
    if constexpr (kWide > 4) {                   // bf16: 8 bytes
        if (fits(4))
            return launch<S, 4>(n_edges, d, u_idx, v_idx, proj_u, ldu,
                                proj_v, ldv, b3e, out, st);
    }
    return launch<S, 1>(n_edges, d, u_idx, v_idx, proj_u, ldu, proj_v, ldv,
                        b3e, out, st);
}

}  // namespace

// bf16 != 0: every row and the output are __nv_bfloat16, else float
extern "C" int gn_k1_gather_gate(int64_t n_edges, int d, const int* u_idx,
                                 const int* v_idx, const void* proj_u,
                                 int64_t ldu, const void* proj_v,
                                 int64_t ldv, const void* b3e, void* out,
                                 int bf16, void* stream) {
    if (n_edges <= 0 || d <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16) {
        using B = __nv_bfloat16;
        return dispatch<B>(n_edges, d, u_idx, v_idx,
                           static_cast<const B*>(proj_u), ldu,
                           static_cast<const B*>(proj_v), ldv,
                           static_cast<const B*>(b3e), static_cast<B*>(out),
                           st);
    }
    return dispatch<float>(n_edges, d, u_idx, v_idx,
                           static_cast<const float*>(proj_u), ldu,
                           static_cast<const float*>(proj_v), ldv,
                           static_cast<const float*>(b3e),
                           static_cast<float*>(out), st);
}
