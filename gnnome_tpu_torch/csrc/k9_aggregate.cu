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
// features, and writes its row once (csrc/csr_sum.cuh, shared with K2).  No
// atomics, so the sums are bitwise reproducible.  flip=False: v = dst, whose
// slot list is the identity, so that pass streams p in order; the u pass
// reads it through the stable src permutation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_sum.cuh"

extern "C" int gn_k9_aggregate(int n_nodes, int h, const int* v_ptr,
                               const int* v_perm, const int* u_ptr,
                               const int* u_perm, const float* pay,
                               float* sum_u, float* sum_v, void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rc = gn::launch_csr_row_sum(n_nodes, h, v_ptr, v_perm, pay, h,
                                          sum_v, st);
    if (rc != (int)cudaSuccess) return rc;
    return gn::launch_csr_row_sum(n_nodes, h, u_ptr, u_perm, pay, h, sum_u,
                                  st);
}
