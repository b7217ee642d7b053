// K8: the adjoint of the training edge stage, fused, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k8_train_layer_bwd (body
// _k8_kernel, with_xsum=True).  Per edge slot s with flip-resolved endpoints
// u, v it recomputes the forward of K3 (csrc/edge_math.cuh, the same
// operations, so the relu mask and sigma are K3's bit for bit):
//
//   x     = B1h[u] + B2h[v] + B3e[s]
//   y     = ((x - mean) * inv_std) * gamma + beta     (batch statistics)
//   e_out = relu(y) + e_in[s],  sigma = sigmoid(e_out)
//
// and runs the chain back from the cotangents d_sum_u = [du_m | du_s],
// d_sum_v = [dv_m | dv_s] (of K3's node sums) and d_e_out:
//
//   d_sigma = dv_m * A2h[u] + dv_s + du_m * A3h[v] + du_s
//   d_eo    = d_e_out + d_sigma * sigma * (1 - sigma)     (= d_e_in)
//   d_y     = d_eo where y > 0, else 0
//
// Outputs: x[s] and d_eo[s]; node_u[u] += [d_y*scale | sigma*dv_m | x] and
// node_v[v] += [d_y*scale | sigma*du_m | x] with scale = gamma * inv_std
// ([N, 3d] each: the d_proj sums and the node x-sums of the batch-statistics
// chain); and [sum d_y | sum d_y * x] over all edges in float64 ([2d]).
//
// Bound on the card: bytes.  It must read b3e, e_in and d_e_out and write x
// and d_eo (five d-float streams per edge) plus the [N, 2d] node tables,
// which stay in L2; a few tens of flops per element.
//
// Design.  The TPU kernel scattered into per-block window partials with
// one-hot matmuls.  Here, as in K3, the node sums walk the two sorted-segment
// CSRs, so there are no atomics and the results are bitwise reproducible:
//   pass 1: one warp per v node walks its slots (v-side CSR), recomputes the
//           forward, writes x and d_eo once, keeps [d_y*scale | sigma*du_m |
//           x] for the node in registers, and adds d_y and d_y * x into
//           float64 registers for the global sums (per-block rows, added in
//           a fixed order by a last launch);
//   pass 2: one warp per u node walks its slots (u-side CSR), reads x and
//           d_eo back, recomputes y and sigma from them and writes node_u.
// Lanes stride the d features, so every row access is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_math.cuh"

namespace {

using gn::kWarpsPerBlock;
using gn::sigmoid_f32;

template <int FPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k8_pass_v(int n_nodes, int d, const int* __restrict__ v_ptr,
          const int* __restrict__ v_perm, const int* __restrict__ u_idx,
          const float* __restrict__ proj_u, int64_t ldu,
          const float* __restrict__ proj_v, int64_t ldv,
          const float* __restrict__ d_sum_u, const float* __restrict__ d_sum_v,
          const float* __restrict__ b3e, const float* __restrict__ e_in,
          const float* __restrict__ d_e_out, const float* __restrict__ bn,
          float* __restrict__ x_out, float* __restrict__ deo_out,
          float* __restrict__ node_v, double* __restrict__ partials) {
    __shared__ double red[kWarpsPerBlock][2 * gn::kMaxWidth];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int v = blockIdx.x * kWarpsPerBlock + warp;
    double st_dy[FPL], st_dyx[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        st_dy[k] = 0.0;
        st_dyx[k] = 0.0;
    }
    if (v < n_nodes) {
        float b2[FPL], a3[FPL], dvm[FPL], dvs[FPL], mu[FPL], rs[FPL], ga[FPL],
            be[FPL], sc[FPL], acc_dy[FPL], acc_sg[FPL], acc_x[FPL];
        const float* pv = proj_v + (int64_t)v * ldv;
        const float* dv = d_sum_v + (int64_t)v * 2 * d;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = lane + 32 * k;
            const bool on = f < d;
            b2[k] = on ? pv[f] : 0.0f;
            a3[k] = on ? pv[d + f] : 0.0f;
            dvm[k] = on ? dv[f] : 0.0f;
            dvs[k] = on ? dv[d + f] : 0.0f;
            mu[k] = on ? bn[f] : 0.0f;
            rs[k] = on ? bn[d + f] : 0.0f;
            ga[k] = on ? bn[2 * d + f] : 0.0f;
            be[k] = on ? bn[3 * d + f] : 0.0f;
            sc[k] = __fmul_rn(ga[k], rs[k]);
            acc_dy[k] = 0.0f;
            acc_sg[k] = 0.0f;
            acc_x[k] = 0.0f;
        }
        const int beg = v_ptr[v], end = v_ptr[v + 1];
        for (int i = beg; i < end; ++i) {
            const int s = v_perm ? v_perm[i] : i;
            const int u = u_idx[s];
            const float* pu = proj_u + (int64_t)u * ldu;
            const float* du = d_sum_u + (int64_t)u * 2 * d;
            const int64_t row = (int64_t)s * d;
#pragma unroll
            for (int k = 0; k < FPL; ++k) {
                const int f = lane + 32 * k;
                if (f < d) {
                    const float x = gn::gate_x(pu[f], b2[k], b3e[row + f]);
                    const float y = gn::bn_apply(x, mu[k], rs[k], ga[k], be[k]);
                    const float eo = __fadd_rn(fmaxf(y, 0.0f), e_in[row + f]);
                    const float sg = sigmoid_f32(eo);
                    const float dum = du[f];
                    const float dsig = __fadd_rn(
                        __fadd_rn(__fadd_rn(__fmul_rn(dvm[k], pu[d + f]), dvs[k]),
                                  __fmul_rn(dum, a3[k])),
                        du[d + f]);
                    const float deo = __fadd_rn(
                        d_e_out[row + f],
                        __fmul_rn(__fmul_rn(dsig, sg), __fsub_rn(1.0f, sg)));
                    const float dy = y > 0.0f ? deo : 0.0f;
                    x_out[row + f] = x;
                    deo_out[row + f] = deo;
                    acc_dy[k] = __fadd_rn(acc_dy[k], __fmul_rn(dy, sc[k]));
                    acc_sg[k] = __fadd_rn(acc_sg[k], __fmul_rn(sg, dum));
                    acc_x[k] = __fadd_rn(acc_x[k], x);
                    st_dy[k] += (double)dy;
                    st_dyx[k] += (double)dy * (double)x;
                }
            }
        }
        float* out = node_v + (int64_t)v * 3 * d;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = lane + 32 * k;
            if (f < d) {
                out[f] = acc_dy[k];
                out[d + f] = acc_sg[k];
                out[2 * d + f] = acc_x[k];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        if (f < d) {
            red[warp][f] = st_dy[k];
            red[warp][d + f] = st_dyx[k];
        }
    }
    gn::block_partials(red, 2 * d, partials);
}

template <int FPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
k8_pass_u(int n_nodes, int d, const int* __restrict__ u_ptr,
          const int* __restrict__ u_perm, const int* __restrict__ v_idx,
          const float* __restrict__ d_sum_v, const float* __restrict__ x_in,
          const float* __restrict__ deo_in, const float* __restrict__ e_in,
          const float* __restrict__ bn, float* __restrict__ node_u) {
    const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (u >= n_nodes) return;
    float mu[FPL], rs[FPL], ga[FPL], be[FPL], sc[FPL], acc_dy[FPL],
        acc_sg[FPL], acc_x[FPL];
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        const bool on = f < d;
        mu[k] = on ? bn[f] : 0.0f;
        rs[k] = on ? bn[d + f] : 0.0f;
        ga[k] = on ? bn[2 * d + f] : 0.0f;
        be[k] = on ? bn[3 * d + f] : 0.0f;
        sc[k] = __fmul_rn(ga[k], rs[k]);
        acc_dy[k] = 0.0f;
        acc_sg[k] = 0.0f;
        acc_x[k] = 0.0f;
    }
    const int beg = u_ptr[u], end = u_ptr[u + 1];
    for (int i = beg; i < end; ++i) {
        const int s = u_perm ? u_perm[i] : i;
        const float* dv = d_sum_v + (int64_t)v_idx[s] * 2 * d;
        const int64_t row = (int64_t)s * d;
#pragma unroll
        for (int k = 0; k < FPL; ++k) {
            const int f = lane + 32 * k;
            if (f < d) {
                const float x = x_in[row + f];
                const float y = gn::bn_apply(x, mu[k], rs[k], ga[k], be[k]);
                const float eo = __fadd_rn(fmaxf(y, 0.0f), e_in[row + f]);
                const float sg = sigmoid_f32(eo);
                const float dy = y > 0.0f ? deo_in[row + f] : 0.0f;
                acc_dy[k] = __fadd_rn(acc_dy[k], __fmul_rn(dy, sc[k]));
                acc_sg[k] = __fadd_rn(acc_sg[k], __fmul_rn(sg, dv[f]));
                acc_x[k] = __fadd_rn(acc_x[k], x);
            }
        }
    }
    float* out = node_u + (int64_t)u * 3 * d;
#pragma unroll
    for (int k = 0; k < FPL; ++k) {
        const int f = lane + 32 * k;
        if (f < d) {
            out[f] = acc_dy[k];
            out[d + f] = acc_sg[k];
            out[2 * d + f] = acc_x[k];
        }
    }
}

int grid_for(int n_nodes) {
    return (n_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

template <int FPL>
int launch(int n_nodes, int d, const int* v_ptr, const int* v_perm,
           const int* u_ptr, const int* u_perm, const int* u_idx,
           const int* v_idx, const float* proj_u, int64_t ldu,
           const float* proj_v, int64_t ldv, const float* d_sum_u,
           const float* d_sum_v, const float* b3e, const float* e_in,
           const float* d_e_out, const float* bn, float* x_out,
           float* deo_out, float* node_u, float* node_v, double* partials,
           double* stats, cudaStream_t st) {
    const int grid = grid_for(n_nodes);
    const int block = 32 * kWarpsPerBlock;
    k8_pass_v<FPL><<<grid, block, 0, st>>>(
        n_nodes, d, v_ptr, v_perm, u_idx, proj_u, ldu, proj_v, ldv, d_sum_u,
        d_sum_v, b3e, e_in, d_e_out, bn, x_out, deo_out, node_v, partials);
    k8_pass_u<FPL><<<grid, block, 0, st>>>(
        n_nodes, d, u_ptr, u_perm, v_idx, d_sum_v, x_out, deo_out, e_in, bn,
        node_u);
    gn::launch_reduce_partials(grid, 2 * d, partials, stats, st);
    return (int)cudaGetLastError();
}

}  // namespace

// Blocks of pass 1 for N nodes: the caller sizes ``partials`` as
// [gn_k8_num_blocks(N), 2d] float64.
extern "C" int gn_k8_num_blocks(int n_nodes) { return grid_for(n_nodes); }

extern "C" int gn_k8_train_layer_bwd(
    int n_nodes, int d, const int* v_ptr, const int* v_perm,
    const int* u_ptr, const int* u_perm, const int* u_idx, const int* v_idx,
    const float* proj_u, int64_t ldu, const float* proj_v, int64_t ldv,
    const float* d_sum_u, const float* d_sum_v, const float* b3e,
    const float* e_in, const float* d_e_out, const float* bn, float* x_out,
    float* deo_out, float* node_u, float* node_v, double* partials,
    double* stats, void* stream) {
    if (n_nodes <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_K8_LAUNCH(FPL)                                                     \
    return launch<FPL>(n_nodes, d, v_ptr, v_perm, u_ptr, u_perm, u_idx, v_idx, \
                       proj_u, ldu, proj_v, ldv, d_sum_u, d_sum_v, b3e, e_in,  \
                       d_e_out, bn, x_out, deo_out, node_u, node_v, partials,  \
                       stats, st)
    if (d <= 32) GN_K8_LAUNCH(1);
    if (d <= 64) GN_K8_LAUNCH(2);
    if (d <= 128) GN_K8_LAUNCH(4);
#undef GN_K8_LAUNCH
    return (int)cudaErrorInvalidValue;
}
