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
//   pass 1: a team of lanes per v node walks its slots (v-side CSR),
//           recomputes the forward, writes x and d_eo once, keeps [d_y*scale
//           | sigma*du_m | x] for the node in registers, and adds d_y and
//           d_y * x into float64 registers for the global sums (one row per
//           team, added in team order into one row per block, and the block
//           rows in a fixed order by a last launch: an order set by N and
//           the team size alone);
//   pass 2: a team per u node walks its slots (u-side CSR), reads x, d_eo
//           and e_in back, recomputes y and sigma from them and writes
//           node_u.
// The walk is K3's (csrc/csr_walk.cuh): teams of 8, 16 or 32 lanes with a
// 16-byte vector of features each (two nodes per warp at d = 64), slot and
// partner indices loaded in chunks and shuffled to the team, each slot's
// rows (pass 1: B1h[u], A2h[u], d_sum_u[u] and the b3e, e_in, d_e_out rows;
// pass 2: x, d_eo, e_in and d_sum_v[v]) copied with cp.async through a
// shared-memory ring two slots ahead of their use, column chunks
// (blockIdx.y) for any d, one float per lane for widths not divisible by 4.
// Each node adds its slots in slot order, as the first port did; the
// float64 global sums add in another fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::kTeamThreads;
using gn::Team;
using gn::Vec;
using gn::vld;
using gn::vst;
using gn::vzero;
using gn::sigmoid_f32;

constexpr int kRowsV = 7, kRowsU = 4;     // rows a slot copies, per pass

template <int T, int V>
__global__ void __launch_bounds__(kTeamThreads)
k8_pass_v(int n_nodes, int d, const int* __restrict__ v_ptr,
          const int* __restrict__ v_perm, const int* __restrict__ v_nbr,
          const float* __restrict__ proj_u, int64_t ldu,
          const float* __restrict__ proj_v, int64_t ldv,
          const float* __restrict__ d_sum_u, const float* __restrict__ d_sum_v,
          const float* __restrict__ b3e, const float* __restrict__ e_in,
          const float* __restrict__ d_e_out, const float* __restrict__ bn,
          float* __restrict__ x_out, float* __restrict__ deo_out,
          float* __restrict__ node_v, double* __restrict__ partials) {
    constexpr int W = T * V;
    __shared__ double red[(kTeamThreads / T) * 2 * W];
    extern __shared__ __align__(16) unsigned char smem[];
    const gn::Ring<V, kRowsV> ring(smem);
    const Team<T> tm;
    const int c0 = blockIdx.y * W;
    const int f = c0 + tm.lane * V;
    const bool on = f < d;
    Vec<V> mu = vzero<V>(), rs = vzero<V>(), ga = vzero<V>(),
           be = vzero<V>();
    if (on) {
        mu = vld<V>(bn + f);
        rs = vld<V>(bn + d + f);
        ga = vld<V>(bn + 2 * d + f);
        be = vld<V>(bn + 3 * d + f);
    }
    double st_dy[V], st_dyx[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        st_dy[i] = 0.0;
        st_dyx[i] = 0.0;
    }
    const int v = tm.node;
    if (v < n_nodes) {      // no return: every thread joins block_partials
        Vec<V> b2 = vzero<V>(), a3 = vzero<V>(), dvm = vzero<V>(),
               dvs = vzero<V>();
        if (on) {
            const float* pv = proj_v + (int64_t)v * ldv + f;
            const float* dv = d_sum_v + (int64_t)v * 2 * d + f;
            b2 = vld<V>(pv);
            a3 = vld<V>(pv + d);
            dvm = vld<V>(dv);
            dvs = vld<V>(dv + d);
        }
        Vec<V> acc_dy = vzero<V>(), acc_sg = vzero<V>(), acc_x = vzero<V>();
        gn::walk_slots<T, gn::kStages>(
            tm, v_ptr[v], v_ptr[v + 1], v_perm, v_nbr,
            [&](int st, int s, int u) {
                if (!on) return;
                const float* pu = proj_u + (int64_t)u * ldu + f;
                const float* du = d_sum_u + (int64_t)u * 2 * d + f;
                const int64_t row = (int64_t)s * d + f;
                ring.fetch(st, 0, pu);
                ring.fetch(st, 1, pu + d);
                ring.fetch(st, 2, du);
                ring.fetch(st, 3, du + d);
                ring.fetch(st, 4, b3e + row);
                ring.fetch(st, 5, e_in + row);
                ring.fetch(st, 6, d_e_out + row);
            },
            [&](int st, int s) {
                if (!on) return;
                const Vec<V> b1 = ring.read(st, 0), a2 = ring.read(st, 1),
                             dum = ring.read(st, 2), dus = ring.read(st, 3),
                             b3 = ring.read(st, 4), ei = ring.read(st, 5),
                             dout = ring.read(st, 6);
                Vec<V> xo, dd;
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const float x = gn::gate_x(b1.a[i], b2.a[i], b3.a[i]);
                    const float y = gn::bn_apply(x, mu.a[i], rs.a[i], ga.a[i],
                                                 be.a[i]);
                    const float eo = __fadd_rn(fmaxf(y, 0.0f), ei.a[i]);
                    const float sg = sigmoid_f32(eo);
                    const float dsig = __fadd_rn(
                        __fadd_rn(__fadd_rn(__fmul_rn(dvm.a[i], a2.a[i]),
                                            dvs.a[i]),
                                  __fmul_rn(dum.a[i], a3.a[i])),
                        dus.a[i]);
                    const float deo = __fadd_rn(
                        dout.a[i],
                        __fmul_rn(__fmul_rn(dsig, sg), __fsub_rn(1.0f, sg)));
                    const float dy = y > 0.0f ? deo : 0.0f;
                    xo.a[i] = x;
                    dd.a[i] = deo;
                    acc_dy.a[i] = __fadd_rn(
                        acc_dy.a[i],
                        __fmul_rn(dy, __fmul_rn(ga.a[i], rs.a[i])));
                    acc_sg.a[i] = __fadd_rn(acc_sg.a[i],
                                            __fmul_rn(sg, dum.a[i]));
                    acc_x.a[i] = __fadd_rn(acc_x.a[i], x);
                    st_dy[i] += (double)dy;
                    st_dyx[i] += (double)dy * (double)x;
                }
                const int64_t row = (int64_t)s * d + f;
                vst<V>(x_out + row, xo);
                vst<V>(deo_out + row, dd);
            });
        if (on) {
            float* out = node_v + (int64_t)v * 3 * d + f;
            vst<V>(out, acc_dy);
            vst<V>(out + d, acc_sg);
            vst<V>(out + 2 * d, acc_x);
        }
    }
    const int team = threadIdx.x / T;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        red[team * 2 * W + tm.lane * V + i] = st_dy[i];
        red[team * 2 * W + W + tm.lane * V + i] = st_dyx[i];
    }
    gn::block_partials(red, kTeamThreads / T, W, c0, d, partials);
}

template <int T, int V>
__global__ void __launch_bounds__(kTeamThreads)
k8_pass_u(int n_nodes, int d, const int* __restrict__ u_ptr,
          const int* __restrict__ u_perm, const int* __restrict__ u_nbr,
          const float* __restrict__ d_sum_v, const float* __restrict__ x_in,
          const float* __restrict__ deo_in, const float* __restrict__ e_in,
          const float* __restrict__ bn, float* __restrict__ node_u) {
    extern __shared__ __align__(16) unsigned char smem[];
    const gn::Ring<V, kRowsU> ring(smem);
    const Team<T> tm;
    const int f = blockIdx.y * (T * V) + tm.lane * V;
    const bool on = f < d;
    Vec<V> mu = vzero<V>(), rs = vzero<V>(), ga = vzero<V>(),
           be = vzero<V>();
    if (on) {
        mu = vld<V>(bn + f);
        rs = vld<V>(bn + d + f);
        ga = vld<V>(bn + 2 * d + f);
        be = vld<V>(bn + 3 * d + f);
    }
    const int u = tm.node;
    if (u >= n_nodes) return;
    Vec<V> acc_dy = vzero<V>(), acc_sg = vzero<V>(), acc_x = vzero<V>();
    gn::walk_slots<T, gn::kStages>(
        tm, u_ptr[u], u_ptr[u + 1], u_perm, u_nbr,
        [&](int st, int s, int v) {
            if (!on) return;
            const int64_t row = (int64_t)s * d + f;
            ring.fetch(st, 0, x_in + row);
            ring.fetch(st, 1, deo_in + row);
            ring.fetch(st, 2, e_in + row);
            ring.fetch(st, 3, d_sum_v + (int64_t)v * 2 * d + f);
        },
        [&](int st, int) {
            if (!on) return;
            const Vec<V> xs = ring.read(st, 0), dd = ring.read(st, 1),
                         ei = ring.read(st, 2), dv = ring.read(st, 3);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                const float x = xs.a[i];
                const float y = gn::bn_apply(x, mu.a[i], rs.a[i], ga.a[i],
                                             be.a[i]);
                const float eo = __fadd_rn(fmaxf(y, 0.0f), ei.a[i]);
                const float sg = sigmoid_f32(eo);
                const float dy = y > 0.0f ? dd.a[i] : 0.0f;
                acc_dy.a[i] = __fadd_rn(
                    acc_dy.a[i],
                    __fmul_rn(dy, __fmul_rn(ga.a[i], rs.a[i])));
                acc_sg.a[i] = __fadd_rn(acc_sg.a[i],
                                        __fmul_rn(sg, dv.a[i]));
                acc_x.a[i] = __fadd_rn(acc_x.a[i], x);
            }
        });
    if (on) {
        float* out = node_u + (int64_t)u * 3 * d + f;
        vst<V>(out, acc_dy);
        vst<V>(out + d, acc_sg);
        vst<V>(out + 2 * d, acc_x);
    }
}

// Rows of ``partials`` the caller allocates for N nodes: pass 1 launches one
// block per 256 / T teams' nodes, at most one per 8 (T = 32).
int max_blocks(int n_nodes) {
    constexpr int min_teams = kTeamThreads / 32;
    return (n_nodes + min_teams - 1) / min_teams;
}

template <int T, int V>
int launch(int n_nodes, int d, const int* v_ptr, const int* v_perm,
           const int* v_nbr, const int* u_ptr, const int* u_perm,
           const int* u_nbr, const float* proj_u, int64_t ldu,
           const float* proj_v, int64_t ldv, const float* d_sum_u,
           const float* d_sum_v, const float* b3e, const float* e_in,
           const float* d_e_out, const float* bn, float* x_out,
           float* deo_out, float* node_u, float* node_v, double* partials,
           double* stats, cudaStream_t st) {
    // pass 1's ring takes more than 48 KB at V = 4: it opts in
    constexpr int smem_v = gn::Ring<V, kRowsV>::bytes(gn::kStages);
    constexpr int smem_u = gn::Ring<V, kRowsU>::bytes(gn::kStages);
    static_assert(smem_u <= 48 * 1024, "K8 pass 2 ring");
    if (cudaError_t e = gn::allow_smem(k8_pass_v<T, V>, smem_v)) return (int)e;
    constexpr int teams = kTeamThreads / T;     // one node per team
    const int blocks = (n_nodes + teams - 1) / teams;
    const dim3 grid(blocks, gn::col_chunks(d, T * V));
    const dim3 block(kTeamThreads);
    k8_pass_v<T, V><<<grid, block, smem_v, st>>>(
        n_nodes, d, v_ptr, v_perm, v_nbr, proj_u, ldu, proj_v, ldv, d_sum_u,
        d_sum_v, b3e, e_in, d_e_out, bn, x_out, deo_out, node_v, partials);
    k8_pass_u<T, V><<<grid, block, smem_u, st>>>(
        n_nodes, d, u_ptr, u_perm, u_nbr, d_sum_v, x_out, deo_out, e_in, bn,
        node_u);
    gn::launch_reduce_partials(blocks, 2 * d, partials, stats, st);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows of float64 partial sums for N nodes: the caller sizes ``partials``
// as [gn_k8_num_blocks(N), 2d].
extern "C" int gn_k8_num_blocks(int n_nodes) { return max_blocks(n_nodes); }

extern "C" int gn_k8_train_layer_bwd(
    int n_nodes, int d, const int* v_ptr, const int* v_perm,
    const int* v_nbr, const int* u_ptr, const int* u_perm, const int* u_nbr,
    const float* proj_u, int64_t ldu, const float* proj_v, int64_t ldv,
    const float* d_sum_u, const float* d_sum_v, const float* b3e,
    const float* e_in, const float* d_e_out, const float* bn, float* x_out,
    float* deo_out, float* node_u, float* node_v, double* partials,
    double* stats, void* stream) {
    if (n_nodes <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = d % 4 == 0
                     && gn::rows_16b({proj_u, proj_v, d_sum_u, d_sum_v, b3e,
                                      e_in, d_e_out, bn, x_out, deo_out,
                                      node_u, node_v}, {ldu, ldv});
#define GN_K8_LAUNCH(T, V)                                                    \
    return launch<T, V>(n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm,     \
                        u_nbr, proj_u, ldu, proj_v, ldv, d_sum_u, d_sum_v,   \
                        b3e, e_in, d_e_out, bn, x_out, deo_out, node_u,      \
                        node_v, partials, stats, st)
    const int t = gn::team_size(d, vec ? 4 : 1);
    if (vec) {
        if (t == 8) GN_K8_LAUNCH(8, 4);
        if (t == 16) GN_K8_LAUNCH(16, 4);
        GN_K8_LAUNCH(32, 4);
    }
    if (t == 8) GN_K8_LAUNCH(8, 1);
    if (t == 16) GN_K8_LAUNCH(16, 1);
    GN_K8_LAUNCH(32, 1);
#undef GN_K8_LAUNCH
}
