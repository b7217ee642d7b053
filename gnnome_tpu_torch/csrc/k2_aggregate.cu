// K2: the unfused path's two-sided aggregation, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k2_aggregate (body _k2_kernel).
// Per edge slot s with flip-resolved endpoints u, v and two payloads
// pay_u, pay_v [E, Dp]:
//
//   sum_u[i] = sum over slots s with u(s) = i of pay_u[s]   ([N, Dp])
//   sum_v[i] = sum over slots s with v(s) = i of pay_v[s]   ([N, Dp])
//
// It carries the gated mean of the layer- and norm-free SymGatedGCN
// (payloads [sigma * A2h[u] | sigma] and [sigma * A3h[v] | sigma], Dp = 2d),
// the adjoint of K1 (Dp = 2d) and the adjoint of the predictor's endpoint
// gathers (Dp = d).  Any Dp: rows wider than 128 take several column chunks.
//
// Payloads are float32 or bfloat16 (both of one type; the JAX package's
// compute.dtype=bfloat16); the sums are float32 [N, Dp] either way, added
// in float32 in slot order (csr_sum.cuh), the contract K9 keeps too.  The
// JAX Pallas kernel's bf16 partials are a TPU byte saving and are not
// ported (csr_sum.cuh says why); its callers round the float32 sums where
// the JAX package casts (ops/message.py).
//
// gn_k2_side_sum is one side of the same walk as its own entry, float32
// only (the zoo ignores the compute dtype, as in JAX):
//
//   out[i] = sum over slots s with side(s) = i of pay[s]       ([N, D])
//
// with side = dst (identity slot list) or src (the src-sorted permutation).
// It carries the model zoo's reductions into nodes (the forward of
// ops/message.py sum_into, the adjoint of gather_rows): GCN and SAGE node
// sums (D = d), GAT's softmax denominators (D = heads) and messages
// (D = heads x d), GatedGCN's gated sums (D = 2d).
//
// Bound on the card: bytes.  It must read both payloads once (2 x Dp
// elements per edge) and write the two float32 [N, Dp] sums; one add per
// element.
//
// Design.  The TPU kernel scattered into per-block window partials with
// one-hot matmuls, combined afterwards.  Here each sum walks its
// sorted-segment CSR, one warp per node, and writes every row once
// (csrc/csr_sum.cuh).  No atomics, so the sums are bitwise
// reproducible, and a node with no edges on a side gets zeros.  Payload rows
// are ldu / ldv elements apart, so a column slice of a wider cotangent (K1's
// [E, 3d]) is read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_sum.cuh"

namespace {

template <class S>
int aggregate(int n_nodes, int width, const int* v_ptr, const int* v_perm,
              const int* u_ptr, const int* u_perm, const void* pay_u,
              int64_t ldu, const void* pay_v, int64_t ldv, float* sum_u,
              float* sum_v, cudaStream_t st) {
    const int rc = gn::launch_csr_row_sum(n_nodes, width, v_ptr, v_perm,
                                          static_cast<const S*>(pay_v), ldv,
                                          sum_v, st);
    if (rc != (int)cudaSuccess) return rc;
    return gn::launch_csr_row_sum(n_nodes, width, u_ptr, u_perm,
                                  static_cast<const S*>(pay_u), ldu, sum_u,
                                  st);
}

}  // namespace

// bf16 != 0: both payloads are __nv_bfloat16, else float; sums float
extern "C" int gn_k2_aggregate(int n_nodes, int width, const int* v_ptr,
                               const int* v_perm, const int* u_ptr,
                               const int* u_perm, const void* pay_u,
                               int64_t ldu, const void* pay_v, int64_t ldv,
                               float* sum_u, float* sum_v, int bf16,
                               void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16)
        return aggregate<__nv_bfloat16>(n_nodes, width, v_ptr, v_perm, u_ptr,
                                        u_perm, pay_u, ldu, pay_v, ldv,
                                        sum_u, sum_v, st);
    return aggregate<float>(n_nodes, width, v_ptr, v_perm, u_ptr, u_perm,
                            pay_u, ldu, pay_v, ldv, sum_u, sum_v, st);
}

extern "C" int gn_k2_side_sum(int n_nodes, int width, const int* ptr,
                              const int* perm, const float* pay, int64_t ld,
                              float* out, void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    return gn::launch_csr_row_sum(n_nodes, width, ptr, perm, pay, ld, out,
                                  static_cast<cudaStream_t>(stream));
}
