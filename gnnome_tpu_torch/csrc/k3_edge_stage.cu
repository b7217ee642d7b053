// K3: the SymGatedGCN eval-mode edge stage, fused, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k3_fused_edge_stage (body
// _k3_kernel).  Per edge slot s with flip-resolved endpoints u, v:
//
//   x      = B1h[u] + B2h[v] + B3e[s]
//   y      = ((x - mean) * inv_std) * gamma + beta   (eval BatchNorm)
//   e_out  = relu(y) + e_in[s]
//   sigma  = sigmoid(e_out)                          (float32)
//   sum_v[v] += [sigma * A2h[u] | sigma]             (forward gated mean)
//   sum_u[u] += [sigma * A3h[v] | sigma]             (backward gated mean)
//
// proj_u rows are [B1h | A2h], proj_v rows are [B2h | A3h] (row strides ldu,
// ldv: they may be column slices of one [N, 5d] projection).  bn is [4, d]:
// rows mean, rsqrt(var + eps), gamma, beta.  The BatchNorm is deliberately
// not folded into one affine x * s + t: with t = beta - mean * s the two
// terms cancel where x is near the mean, which took the shipped model's
// logits outside the parity tolerance against the unfolded reference
// arithmetic.  An affine a, b is the special case mean = 0, inv_std = 1,
// gamma = a, beta = b (exact).
//
// Bound on the card: bytes.  Per edge it reads b3e and e_in, writes e_out
// (3 x d floats) and gathers one 2d-float row of proj_u; a handful of flops
// per byte.  The node tables ([N, 2d] f32, ~5 MB at E. coli scale) stay in
// the 50 MB L2, so the edge streams set the floor.
//
// Design.  The TPU kernel selected rows with one-hot matmuls and scattered
// into per-block window partials because the MXU has no row gather; here a
// row gather is a plain load, and the reductions run over sorted segments
// instead, so no atomics and bitwise-reproducible sums:
//   pass 1: a team of lanes per v node walks that node's edge slots in slot
//           order (the v-side CSR): it computes the whole edge stage, writes
//           e_out once, keeps B2h[v] and the [sigma*A2h[u] | sigma]
//           accumulators in registers and writes sum_v[v] once;
//   pass 2: a team per u node walks the u-side CSR (slots stably sorted, so
//           again in slot order), recomputes sigma from e_out and writes
//           sum_u[u] once.
// The first port gave each node a warp that walked its slots one at a time,
// each waiting on a chain of loads (slot number, partner index, rows), so
// it was latency-bound at 20-40% of the card's memory rate.  Now both
// passes run the walk of csrc/csr_walk.cuh: teams of 8, 16 or 32 lanes
// with a 16-byte vector of features each (two nodes per warp at d = 64),
// slot numbers and partner indices loaded in chunks and shuffled to the
// team, each slot's rows (pass 1: B1h[u], A2h[u], b3e, e_in; pass 2:
// e_out, A3h[v]) copied with cp.async through a shared-memory ring two
// slots ahead of their use.  Each node still adds its slots in slot order,
// so the sums are what the first port computed.
// Column chunks (blockIdx.y) take any d; widths not divisible by 4 or rows
// not 16-byte aligned run the same code one float per lane.  Nodes with no
// edges write zeros.  flip=False: v = dst, whose slot list is the identity
// (slots are dst-sorted), so v_perm is null; flip=True swaps the two CSRs.
// Arithmetic uses explicit round-to-nearest intrinsics so the compiler does
// not contract into FMAs: results match the plain PyTorch version's per-op
// rounding (csrc/edge_math.cuh, shared with K7 and K8).
//
// bf16 (the JAX package's compute.dtype=bfloat16, pallas_kernels.py:339-352,
// message.py:443-448): every row is bf16 and bn holds the folded affine
// [0, 1, scale, bias] in bf16.  The arithmetic stays float32, rounded to
// bf16 where JAX's operation returns a bf16: the endpoint sum, the gate,
// each affine step, the residual, sigma (computed in float32), and each
// gated product; the node sums add those products in float32 in slot order
// and are written once as bf16.  Rows are 8 bytes a lane (V = 4), so the
// bytes of the edge streams halve.
//
// The passes and their launch are templates in k3_edge_stage.cuh, shared
// with the cost-split probe (csrc/probes/k3_ablate.cu); this file
// instantiates K3 itself: K3Part::full at the ring depth gn::kStages.
#include <cuda_runtime.h>
#include <stdint.h>

#include "k3_edge_stage.cuh"

namespace {

// The team size and vector path for element type S, then the launch.
template <class S>
int dispatch(int n_nodes, int d, const int* v_ptr, const int* v_perm,
             const int* v_nbr, const int* u_ptr, const int* u_perm,
             const int* u_nbr, const void* proj_u, int64_t ldu,
             const void* proj_v, int64_t ldv, const void* b3e,
             const void* e_in, const void* bn, void* e_out, void* sum_v,
             void* sum_u, cudaStream_t st) {
    const bool vec = d % 4 == 0
                     && gn::rows_vec<S>({proj_u, proj_v, b3e, e_in, bn, e_out,
                                         sum_v, sum_u}, {ldu, ldv});
#define GN_K3_LAUNCH(T, V)                                                     \
    return launch<K3Part::full, gn::kStages, T, V, S>(                        \
        n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr,               \
        static_cast<const S*>(proj_u), ldu, static_cast<const S*>(proj_v),    \
        ldv, static_cast<const S*>(b3e), static_cast<const S*>(e_in),         \
        static_cast<const S*>(bn), static_cast<S*>(e_out),                    \
        static_cast<S*>(sum_v), static_cast<S*>(sum_u), st)
    const int t = gn::team_size(d, vec ? 4 : 1);
    if (vec) {
        if (t == 8) GN_K3_LAUNCH(8, 4);
        if (t == 16) GN_K3_LAUNCH(16, 4);
        GN_K3_LAUNCH(32, 4);
    }
    if (t == 8) GN_K3_LAUNCH(8, 1);
    if (t == 16) GN_K3_LAUNCH(16, 1);
    GN_K3_LAUNCH(32, 1);
#undef GN_K3_LAUNCH
}

}  // namespace

// bf16 = 0: every row float32; bf16 = 1: every row __nv_bfloat16.
extern "C" int gn_k3_edge_stage(
    int n_nodes, int d, const int* v_ptr, const int* v_perm,
    const int* v_nbr, const int* u_ptr, const int* u_perm, const int* u_nbr,
    const void* proj_u, int64_t ldu, const void* proj_v, int64_t ldv,
    const void* b3e, const void* e_in, const void* bn, void* e_out,
    void* sum_v, void* sum_u, int bf16, void* stream) {
    if (n_nodes <= 0 || d <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? dispatch<__nv_bfloat16> : dispatch<float>)(
        n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr, proj_u, ldu,
        proj_v, ldv, b3e, e_in, bn, e_out, sum_v, sum_u, st);
}

extern "C" const char* gn_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
