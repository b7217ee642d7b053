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

constexpr int kRowsV = 4, kRowsU = 2;     // rows a slot copies, per pass

template <int T, int V>
__global__ void __launch_bounds__(kTeamThreads)
k3_pass_v(int n_nodes, int d, const int* __restrict__ v_ptr,
          const int* __restrict__ v_perm, const int* __restrict__ v_nbr,
          const float* __restrict__ proj_u, int64_t ldu,
          const float* __restrict__ proj_v, int64_t ldv,
          const float* __restrict__ b3e, const float* __restrict__ e_in,
          const float* __restrict__ bn, float* __restrict__ e_out,
          float* __restrict__ sum_v) {
    extern __shared__ __align__(16) unsigned char smem[];
    const gn::Ring<V, kRowsV> ring(smem);
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
    const int v = tm.node;
    if (v >= n_nodes) return;
    Vec<V> b2 = vzero<V>(), acc_m = vzero<V>(), acc_s = vzero<V>();
    if (on) b2 = vld<V>(proj_v + (int64_t)v * ldv + f);
    gn::walk_slots<T, gn::kStages>(
        tm, v_ptr[v], v_ptr[v + 1], v_perm, v_nbr,
        [&](int st, int s, int u) {
            if (!on) return;
            const float* pu = proj_u + (int64_t)u * ldu + f;
            const int64_t row = (int64_t)s * d + f;
            ring.fetch(st, 0, pu);
            ring.fetch(st, 1, pu + d);
            ring.fetch(st, 2, b3e + row);
            ring.fetch(st, 3, e_in + row);
        },
        [&](int st, int s) {
            if (!on) return;
            const Vec<V> b1 = ring.read(st, 0), a2 = ring.read(st, 1),
                         b3 = ring.read(st, 2), ei = ring.read(st, 3);
            Vec<V> eo;
#pragma unroll
            for (int i = 0; i < V; ++i) {
                const float x = gn::gate_x(b1.a[i], b2.a[i], b3.a[i]);
                const float y = gn::bn_apply(x, mu.a[i], rs.a[i],
                                             ga.a[i], be.a[i]);
                eo.a[i] = __fadd_rn(fmaxf(y, 0.0f), ei.a[i]);
                const float sg = sigmoid_f32(eo.a[i]);
                acc_m.a[i] = __fadd_rn(acc_m.a[i], __fmul_rn(sg, a2.a[i]));
                acc_s.a[i] = __fadd_rn(acc_s.a[i], sg);
            }
            vst<V>(e_out + (int64_t)s * d + f, eo);
        });
    if (on) {
        float* out = sum_v + (int64_t)v * 2 * d + f;
        vst<V>(out, acc_m);
        vst<V>(out + d, acc_s);
    }
}

template <int T, int V>
__global__ void __launch_bounds__(kTeamThreads)
k3_pass_u(int n_nodes, int d, const int* __restrict__ u_ptr,
          const int* __restrict__ u_perm, const int* __restrict__ u_nbr,
          const float* __restrict__ proj_v, int64_t ldv,
          const float* __restrict__ e_out, float* __restrict__ sum_u) {
    extern __shared__ __align__(16) unsigned char smem[];
    const gn::Ring<V, kRowsU> ring(smem);
    const Team<T> tm;
    const int f = blockIdx.y * (T * V) + tm.lane * V;
    const bool on = f < d;
    const int u = tm.node;
    if (u >= n_nodes) return;
    Vec<V> acc_m = vzero<V>(), acc_s = vzero<V>();
    gn::walk_slots<T, gn::kStages>(
        tm, u_ptr[u], u_ptr[u + 1], u_perm, u_nbr,
        [&](int st, int s, int v) {
            if (!on) return;
            ring.fetch(st, 0, e_out + (int64_t)s * d + f);
            ring.fetch(st, 1, proj_v + (int64_t)v * ldv + d + f);
        },
        [&](int st, int) {
            if (!on) return;
            const Vec<V> eo = ring.read(st, 0), a3 = ring.read(st, 1);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                const float sg = sigmoid_f32(eo.a[i]);
                acc_m.a[i] = __fadd_rn(acc_m.a[i], __fmul_rn(sg, a3.a[i]));
                acc_s.a[i] = __fadd_rn(acc_s.a[i], sg);
            }
        });
    if (on) {
        float* out = sum_u + (int64_t)u * 2 * d + f;
        vst<V>(out, acc_m);
        vst<V>(out + d, acc_s);
    }
}

template <int T, int V>
int launch(int n_nodes, int d, const int* v_ptr, const int* v_perm,
           const int* v_nbr, const int* u_ptr, const int* u_perm,
           const int* u_nbr, const float* proj_u, int64_t ldu,
           const float* proj_v, int64_t ldv, const float* b3e,
           const float* e_in, const float* bn, float* e_out, float* sum_v,
           float* sum_u, cudaStream_t st) {
    // at most 48 KB: no opt-in needed
    constexpr int smem_v = gn::Ring<V, kRowsV>::bytes(gn::kStages);
    constexpr int smem_u = gn::Ring<V, kRowsU>::bytes(gn::kStages);
    static_assert(smem_v <= 48 * 1024 && smem_u <= 48 * 1024, "K3 ring");
    constexpr int teams = kTeamThreads / T;     // one node per team
    const dim3 grid((n_nodes + teams - 1) / teams, gn::col_chunks(d, T * V));
    const dim3 block(kTeamThreads);
    k3_pass_v<T, V><<<grid, block, smem_v, st>>>(
        n_nodes, d, v_ptr, v_perm, v_nbr, proj_u, ldu, proj_v, ldv, b3e,
        e_in, bn, e_out, sum_v);
    k3_pass_u<T, V><<<grid, block, smem_u, st>>>(
        n_nodes, d, u_ptr, u_perm, u_nbr, proj_v, ldv, e_out, sum_u);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gn_k3_edge_stage(
    int n_nodes, int d, const int* v_ptr, const int* v_perm,
    const int* v_nbr, const int* u_ptr, const int* u_perm, const int* u_nbr,
    const float* proj_u, int64_t ldu, const float* proj_v, int64_t ldv,
    const float* b3e, const float* e_in, const float* bn, float* e_out,
    float* sum_v, float* sum_u, void* stream) {
    if (n_nodes <= 0 || d <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = d % 4 == 0
                     && gn::rows_16b({proj_u, proj_v, b3e, e_in, bn, e_out,
                                      sum_v, sum_u}, {ldu, ldv});
#define GN_K3_LAUNCH(T, V)                                                     \
    return launch<T, V>(n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm,      \
                        u_nbr, proj_u, ldu, proj_v, ldv, b3e, e_in, bn,       \
                        e_out, sum_v, sum_u, st)
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

extern "C" const char* gn_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
