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
// Bound on the card: bytes.  It must read both payloads once (2 x Dp floats
// per edge) and write the two [N, Dp] sums; one add per element.
//
// Design.  The TPU kernel scattered into per-block window partials with
// one-hot matmuls, combined afterwards.  Here K2 is K9 with one payload per
// side: each sum walks its sorted-segment CSR, one warp per node, and writes
// every row once (csrc/csr_sum.cuh).  No atomics, so the sums are bitwise
// reproducible, and a node with no edges on a side gets zeros.  Payload rows
// are ldu / ldv floats apart, so a column slice of a wider cotangent (K1's
// [E, 3d]) is read in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_sum.cuh"

extern "C" int gn_k2_aggregate(int n_nodes, int width, const int* v_ptr,
                               const int* v_perm, const int* u_ptr,
                               const int* u_perm, const float* pay_u,
                               int64_t ldu, const float* pay_v, int64_t ldv,
                               float* sum_u, float* sum_v, void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rc = gn::launch_csr_row_sum(n_nodes, width, v_ptr, v_perm,
                                          pay_v, ldv, sum_v, st);
    if (rc != (int)cudaSuccess) return rc;
    return gn::launch_csr_row_sum(n_nodes, width, u_ptr, u_perm, pay_u, ldu,
                                  sum_u, st);
}
