// K3's two passes and their launch, as templates on the part of K3 that a
// variant keeps (K3Part) and on the depth P of the cp.async ring.
// csrc/k3_edge_stage.cu instantiates K3 itself (K3Part::full at
// gn::kStages); csrc/probes/k3_ablate.cu instantiates the variants of the
// cost-split probe (gnnome_tpu_torch/probes/k3_ablate.py, the card
// counterpart of scripts/k3_ablate.py).  What the passes compute, and why,
// is told in k3_edge_stage.cu.  Every variant walks the graph as K3 does;
// the `full` body below is K3's, operation for operation, so the probe's
// `full` is bit for bit the production kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::kTeamThreads;
using gn::rnd;
using gn::Team;
using gn::Vec;
using gn::vld;
using gn::vst;
using gn::vzero;
using gn::sigmoid_f32;

constexpr int kRowsV = 4, kRowsU = 2;     // rows a slot copies, per pass

// What a variant keeps of K3.  Every variant but walk_only copies the same
// rows through the ring as K3.
enum class K3Part : int {
    full = 0,           // K3
    edge_only = 1,      // pass v computes and stores e_out only; no pass u
    sums_unstored = 2,  // both passes sum; the sums are stored only if
                        // K3Probe::store_sums (the probe passes 0)
    fixed_rows = 3,     // B1h/A2h (pass v), A3h (pass u) from the team's
                        // own node's row, not the partner's
    stream_only = 4,    // no arithmetic: e_out = ((b3e + e_in) + B1h[u])
                        // + B2h[v], each add rounded to S; no node sums
    walk_only = 5,      // no rows: per node and pass one word, the sum over
                        // its slots of (slot + partner), wrapping
};

// The arguments only the probe's variants read (K3 passes none).
struct K3Probe {
    int store_sums;       // sums_unstored: store sum_v and sum_u
    unsigned* walk_v;     // walk_only: [N] words of pass v
    unsigned* walk_u;     // walk_only: [N] words of pass u
};

// walk_only: the walk over [beg, end) with no rows; lane 0 of the first
// column chunk writes the node's word.
template <int T, int P>
__device__ __forceinline__ void walk_words(const Team<T>& tm, int beg,
                                           int end,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ nbr,
                                           unsigned* out) {
    unsigned acc = 0u;
    gn::walk_slots<T, P>(
        tm, beg, end, perm, nbr,
        [&](int, int s, int p) { acc += (unsigned)s + (unsigned)p; },
        [&](int, int) {});
    if (tm.lane == 0 && blockIdx.y == 0) *out = acc;
}

// The variants that store node sums: always, or under the probe's flag.
template <K3Part A>
__device__ __forceinline__ bool stores_sums(const K3Probe& probe) {
    if constexpr (A == K3Part::sums_unstored)
        return probe.store_sums != 0;
    else
        return A == K3Part::full || A == K3Part::fixed_rows;
}

// S: the element type of every row (float or __nv_bfloat16)
template <K3Part A, int P, int T, int V, class S>
__global__ void __launch_bounds__(kTeamThreads)
k3_pass_v(int n_nodes, int d, const int* __restrict__ v_ptr,
          const int* __restrict__ v_perm, const int* __restrict__ v_nbr,
          const S* __restrict__ proj_u, int64_t ldu,
          const S* __restrict__ proj_v, int64_t ldv,
          const S* __restrict__ b3e, const S* __restrict__ e_in,
          const S* __restrict__ bn, S* __restrict__ e_out,
          S* __restrict__ sum_v, K3Probe probe) {
    extern __shared__ __align__(16) unsigned char smem[];
    const gn::Ring<V, kRowsV, S> ring(smem);
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
    if constexpr (A == K3Part::walk_only) {
        walk_words<T, P>(tm, v_ptr[v], v_ptr[v + 1], v_perm, v_nbr,
                         probe.walk_v + v);
        return;
    }
    Vec<V> b2 = vzero<V>(), acc_m = vzero<V>(), acc_s = vzero<V>();
    if (on) b2 = vld<V>(proj_v + (int64_t)v * ldv + f);
    gn::walk_slots<T, P>(
        tm, v_ptr[v], v_ptr[v + 1], v_perm, v_nbr,
        [&](int st, int s, int u) {
            if (!on) return;
            if constexpr (A == K3Part::fixed_rows) u = v;
            const S* pu = proj_u + (int64_t)u * ldu + f;
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
            if constexpr (A == K3Part::stream_only) {
#pragma unroll
                for (int i = 0; i < V; ++i)
                    eo.a[i] = rnd<S>(__fadd_rn(
                        rnd<S>(__fadd_rn(rnd<S>(__fadd_rn(b3.a[i], ei.a[i])),
                                         b1.a[i])),
                        b2.a[i]));
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const float x = gn::gate_x<S>(b1.a[i], b2.a[i], b3.a[i]);
                    const float y = gn::bn_apply<S>(x, mu.a[i], rs.a[i],
                                                    ga.a[i], be.a[i]);
                    eo.a[i] = rnd<S>(__fadd_rn(fmaxf(y, 0.0f), ei.a[i]));
                    if constexpr (A != K3Part::edge_only) {
                        const float sg = rnd<S>(sigmoid_f32(eo.a[i]));
                        acc_m.a[i] = __fadd_rn(acc_m.a[i],
                                               rnd<S>(__fmul_rn(sg, a2.a[i])));
                        acc_s.a[i] = __fadd_rn(acc_s.a[i], sg);
                    }
                }
            }
            vst<V>(e_out + (int64_t)s * d + f, eo);
        });
    if (on && stores_sums<A>(probe)) {
        S* out = sum_v + (int64_t)v * 2 * d + f;
        vst<V>(out, acc_m);
        vst<V>(out + d, acc_s);
    }
}

template <K3Part A, int P, int T, int V, class S>
__global__ void __launch_bounds__(kTeamThreads)
k3_pass_u(int n_nodes, int d, const int* __restrict__ u_ptr,
          const int* __restrict__ u_perm, const int* __restrict__ u_nbr,
          const S* __restrict__ proj_v, int64_t ldv,
          const S* __restrict__ e_out, S* __restrict__ sum_u,
          K3Probe probe) {
    extern __shared__ __align__(16) unsigned char smem[];
    const gn::Ring<V, kRowsU, S> ring(smem);
    const Team<T> tm;
    const int f = blockIdx.y * (T * V) + tm.lane * V;
    const bool on = f < d;
    const int u = tm.node;
    if (u >= n_nodes) return;
    if constexpr (A == K3Part::walk_only) {
        walk_words<T, P>(tm, u_ptr[u], u_ptr[u + 1], u_perm, u_nbr,
                         probe.walk_u + u);
        return;
    }
    Vec<V> acc_m = vzero<V>(), acc_s = vzero<V>();
    gn::walk_slots<T, P>(
        tm, u_ptr[u], u_ptr[u + 1], u_perm, u_nbr,
        [&](int st, int s, int v) {
            if (!on) return;
            if constexpr (A == K3Part::fixed_rows) v = u;
            ring.fetch(st, 0, e_out + (int64_t)s * d + f);
            ring.fetch(st, 1, proj_v + (int64_t)v * ldv + d + f);
        },
        [&](int st, int) {
            if (!on) return;
            if constexpr (A != K3Part::stream_only) {
                const Vec<V> eo = ring.read(st, 0), a3 = ring.read(st, 1);
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const float sg = rnd<S>(sigmoid_f32(eo.a[i]));
                    acc_m.a[i] = __fadd_rn(acc_m.a[i],
                                           rnd<S>(__fmul_rn(sg, a3.a[i])));
                    acc_s.a[i] = __fadd_rn(acc_s.a[i], sg);
                }
            }
        });
    if (on && stores_sums<A>(probe)) {
        S* out = sum_u + (int64_t)u * 2 * d + f;
        vst<V>(out, acc_m);
        vst<V>(out + d, acc_s);
    }
}

template <K3Part A, int P, int T, int V, class S>
int launch(int n_nodes, int d, const int* v_ptr, const int* v_perm,
           const int* v_nbr, const int* u_ptr, const int* u_perm,
           const int* u_nbr, const S* proj_u, int64_t ldu, const S* proj_v,
           int64_t ldv, const S* b3e, const S* e_in, const S* bn, S* e_out,
           S* sum_v, S* sum_u, cudaStream_t st, K3Probe probe = {}) {
    // K3's ring (P = gn::kStages) takes at most 48 KB: no opt-in needed;
    // a deeper ring of the probe opts in
    constexpr int smem_v = gn::Ring<V, kRowsV, S>::bytes(P);
    constexpr int smem_u = gn::Ring<V, kRowsU, S>::bytes(P);
    static_assert(P != gn::kStages
                  || (smem_v <= 48 * 1024 && smem_u <= 48 * 1024), "K3 ring");
    if constexpr (smem_v > 48 * 1024) {
        const cudaError_t rc = gn::allow_smem(k3_pass_v<A, P, T, V, S>,
                                              smem_v);
        if (rc != cudaSuccess) return (int)rc;
    }
    if constexpr (smem_u > 48 * 1024) {
        const cudaError_t rc = gn::allow_smem(k3_pass_u<A, P, T, V, S>,
                                              smem_u);
        if (rc != cudaSuccess) return (int)rc;
    }
    constexpr int teams = kTeamThreads / T;     // one node per team
    const dim3 grid((n_nodes + teams - 1) / teams, gn::col_chunks(d, T * V));
    const dim3 block(kTeamThreads);
    k3_pass_v<A, P, T, V, S><<<grid, block, smem_v, st>>>(
        n_nodes, d, v_ptr, v_perm, v_nbr, proj_u, ldu, proj_v, ldv, b3e,
        e_in, bn, e_out, sum_v, probe);
    if constexpr (A != K3Part::edge_only)
        k3_pass_u<A, P, T, V, S><<<grid, block, smem_u, st>>>(
            n_nodes, d, u_ptr, u_perm, u_nbr, proj_v, ldv, e_out, sum_u,
            probe);
    return (int)cudaGetLastError();
}

}  // namespace
