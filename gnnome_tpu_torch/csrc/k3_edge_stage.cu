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
//   pass 1: one warp per v node walks that node's edge slots in slot order
//           (the v-side CSR), lanes striding the d features: it computes the
//           whole edge stage, writes e_out once, keeps B2h[v] and the
//           [sigma*A2h[u] | sigma] accumulators in registers and writes
//           sum_v[v] once;
//   pass 2: one warp per u node walks the u-side CSR (slots stably sorted,
//           so again in slot order), recomputes sigma from e_out and writes
//           sum_u[u] once.
// Nodes with no edges write zeros.  flip=False: v = dst, whose slot list is
// the identity (slots are dst-sorted), so v_perm is null; flip=True swaps
// the two CSRs.  Arithmetic uses explicit round-to-nearest intrinsics so the
// compiler does not contract into FMAs: results match the plain PyTorch
// version's per-op rounding (csrc/edge_math.cuh, shared with K7 and K8).
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace {

using gn::kWarpsPerBlock;
using gn::sigmoid_f32;

// FPL = features per lane: handles any d <= 32 * FPL.
template <int FPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k3_pass_v(int n_nodes, int d, const int* __restrict__ v_ptr,
          const int* __restrict__ v_perm, const int* __restrict__ u_idx,
          const float* __restrict__ proj_u, int64_t ldu,
          const float* __restrict__ proj_v, int64_t ldv,
          const float* __restrict__ b3e, const float* __restrict__ e_in,
          const float* __restrict__ bn, float* __restrict__ e_out,
          float* __restrict__ sum_v) {
    const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (v >= n_nodes) return;
    float b2[FPL], mu[FPL], rs[FPL], ga[FPL], be[FPL], acc_m[FPL], acc_s[FPL];
    const float* pv = proj_v + (int64_t)v * ldv;
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        const bool on = f < d;
        b2[k] = on ? pv[f] : 0.0f;
        mu[k] = on ? bn[f] : 0.0f;
        rs[k] = on ? bn[d + f] : 0.0f;
        ga[k] = on ? bn[2 * d + f] : 0.0f;
        be[k] = on ? bn[3 * d + f] : 0.0f;
        acc_m[k] = 0.0f;
        acc_s[k] = 0.0f;
    }
    const int beg = v_ptr[v], end = v_ptr[v + 1];
    for (int i = beg; i < end; ++i) {
        const int s = v_perm ? v_perm[i] : i;
        const float* pu = proj_u + (int64_t)u_idx[s] * ldu;
        const int64_t row = (int64_t)s * d;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = lane + 32 * k;
            if (f < d) {
                const float x = gn::gate_x(pu[f], b2[k], b3e[row + f]);
                const float y = gn::bn_apply(x, mu[k], rs[k], ga[k], be[k]);
                const float eo = __fadd_rn(fmaxf(y, 0.0f), e_in[row + f]);
                e_out[row + f] = eo;
                const float sg = sigmoid_f32(eo);
                acc_m[k] = __fadd_rn(acc_m[k], __fmul_rn(sg, pu[d + f]));
                acc_s[k] = __fadd_rn(acc_s[k], sg);
            }
        }
    }
    float* out = sum_v + (int64_t)v * 2 * d;
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        if (f < d) {
            out[f] = acc_m[k];
            out[d + f] = acc_s[k];
        }
    }
}

template <int FPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k3_pass_u(int n_nodes, int d, const int* __restrict__ u_ptr,
          const int* __restrict__ u_perm, const int* __restrict__ v_idx,
          const float* __restrict__ proj_v, int64_t ldv,
          const float* __restrict__ e_out, float* __restrict__ sum_u) {
    const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (u >= n_nodes) return;
    float acc_m[FPL], acc_s[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        acc_m[k] = 0.0f;
        acc_s[k] = 0.0f;
    }
    const int beg = u_ptr[u], end = u_ptr[u + 1];
    for (int i = beg; i < end; ++i) {
        const int s = u_perm ? u_perm[i] : i;
        const float* pv = proj_v + (int64_t)v_idx[s] * ldv;
        const int64_t row = (int64_t)s * d;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = lane + 32 * k;
            if (f < d) {
                const float sg = sigmoid_f32(e_out[row + f]);
                acc_m[k] = __fadd_rn(acc_m[k], __fmul_rn(sg, pv[d + f]));
                acc_s[k] = __fadd_rn(acc_s[k], sg);
            }
        }
    }
    float* out = sum_u + (int64_t)u * 2 * d;
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        if (f < d) {
            out[f] = acc_m[k];
            out[d + f] = acc_s[k];
        }
    }
}

template <int FPL>
void launch(int n_nodes, int d, const int* v_ptr, const int* v_perm,
            const int* u_ptr, const int* u_perm, const int* u_idx,
            const int* v_idx, const float* proj_u, int64_t ldu,
            const float* proj_v, int64_t ldv, const float* b3e,
            const float* e_in, const float* bn, float* e_out, float* sum_v,
            float* sum_u, cudaStream_t st) {
    const dim3 block(32 * kWarpsPerBlock);
    const dim3 grid((n_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock);
    k3_pass_v<FPL><<<grid, block, 0, st>>>(
        n_nodes, d, v_ptr, v_perm, u_idx, proj_u, ldu, proj_v, ldv, b3e,
        e_in, bn, e_out, sum_v);
    k3_pass_u<FPL><<<grid, block, 0, st>>>(
        n_nodes, d, u_ptr, u_perm, v_idx, proj_v, ldv, e_out, sum_u);
}

}  // namespace

extern "C" int gn_k3_edge_stage(
    int n_nodes, int d, const int* v_ptr, const int* v_perm,
    const int* u_ptr, const int* u_perm, const int* u_idx, const int* v_idx,
    const float* proj_u, int64_t ldu, const float* proj_v, int64_t ldv,
    const float* b3e, const float* e_in, const float* bn, float* e_out,
    float* sum_v, float* sum_u, void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d <= 32)
        launch<1>(n_nodes, d, v_ptr, v_perm, u_ptr, u_perm, u_idx, v_idx,
                  proj_u, ldu, proj_v, ldv, b3e, e_in, bn, e_out, sum_v,
                  sum_u, st);
    else if (d <= 64)
        launch<2>(n_nodes, d, v_ptr, v_perm, u_ptr, u_perm, u_idx, v_idx,
                  proj_u, ldu, proj_v, ldv, b3e, e_in, bn, e_out, sum_v,
                  sum_u, st);
    else if (d <= 128)
        launch<4>(n_nodes, d, v_ptr, v_perm, u_ptr, u_perm, u_idx, v_idx,
                  proj_u, ldu, proj_v, ldv, b3e, e_in, bn, e_out, sum_v,
                  sum_u, st);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" const char* gn_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
