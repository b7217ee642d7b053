// K6: the score predictor's first layer, fused, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k6_score_gate (body _k6_kernel).
// Per edge slot s with flip-resolved endpoints u, v and hidden width H:
//
//   z[s] = relu(pu[u] + pv[v] + be[s])
//
// where puv rows are [pu | pv] = [h @ W1[:d] | h @ W1[d:2d]] (the endpoint
// parts of the first predictor matmul, computed in node space by the caller)
// and be = e @ W1[2d:] + b1.  puv and be may be row-strided (ldp, ldb: column
// slices of wider arrays); z is dense [E, H].
//
// Bound on the card: bytes.  It reads be and writes z (2 x H floats per
// edge) plus two H-float row gathers from the [N, 2H] node table, which
// stays in L2; two adds and a max per element.
//
// Design.  The TPU kernel's windowed one-hot selects become plain row loads.
// A team of T lanes (csr_walk.cuh: 8, 16 or 32) owns a chunk of T
// consecutive slots and one column chunk of W = T * V features
// (blockIdx.y), each lane V consecutive features: at H = 64, 16 lanes with a
// float4 each, two slots per warp instruction.  Lane j loads slot j's u and
// v (one coalesced load per chunk and array) and the team takes each slot's
// pair by __shfl_sync, so no lane waits on an index load per slot.  The
// team walks its chunk S slots at a time: the three row loads of all S
// slots are issued before the first add, then the S rows of z are stored.
// be and z are streams (read and written once): they bypass L1 and are
// evicted from L2 first, which leaves the cache to the puv rows each node
// serves ~27 times.  No division per element: slot and feature come from the team's place in
// the grid.  V = 1 (one float per lane) when H % 4 != 0 or a row is not
// 16-byte aligned.  Each element takes the plain version's rounding,
// fmaxf((a + b) + be, 0) with round-to-nearest adds, so z is bit-equal to
// it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::kTeamThreads;
using gn::Team;
using gn::Vec;
using gn::vld;

constexpr int kSlotsInFlight = 4;       // S: slots whose loads precede adds

template <int T, int V>
__global__ void __launch_bounds__(kTeamThreads)
k6_score_gate_kernel(int n_edges, int h, const int* __restrict__ u_idx,
                     const int* __restrict__ v_idx,
                     const float* __restrict__ puv, int64_t ldp,
                     const float* __restrict__ be, int64_t ldb,
                     float* __restrict__ z) {
    constexpr int S = kSlotsInFlight;
    const Team<T> tm;
    const int f = blockIdx.y * (T * V) + tm.lane * V;
    const bool on = f < h;
    const int base = tm.node * T;           // the team's first slot
    if (base >= n_edges) return;            // the whole team leaves
    const int n = n_edges - base < T ? n_edges - base : T;
    const gn::SlotChunk<T> ends(tm, base, n_edges, u_idx, v_idx);
#pragma unroll
    for (int k0 = 0; k0 < T; k0 += S) {
        if (k0 >= n) break;                 // the same for the whole team
        Vec<V> a[S], b[S], c[S];
        int us[S], vs[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
            ends.get(tm, k0 + j, us[j], vs[j]);     // every lane shuffles
            if (!on || k0 + j >= n) continue;
            a[j] = vld<V>(puv + (int64_t)us[j] * ldp + f);
            b[j] = vld<V>(puv + (int64_t)vs[j] * ldp + h + f);
            c[j] = gn::vld_stream<V>(be + (int64_t)(base + k0 + j) * ldb + f);
        }
#pragma unroll
        for (int j = 0; j < S; ++j) {
            if (!on || k0 + j >= n) continue;
            Vec<V> r;
#pragma unroll
            for (int i = 0; i < V; ++i)
                r.a[i] = fmaxf(__fadd_rn(__fadd_rn(a[j].a[i], b[j].a[i]),
                                         c[j].a[i]), 0.0f);
            gn::vst_stream<V>(z + (int64_t)(base + k0 + j) * h + f, r);
        }
    }
}

template <int T, int V>
int launch(int n_edges, int h, const int* u_idx, const int* v_idx,
           const float* puv, int64_t ldp, const float* be, int64_t ldb,
           float* z, cudaStream_t st) {
    constexpr int slots = kTeamThreads;     // 256 / T teams of T slots
    const dim3 grid((n_edges + slots - 1) / slots, gn::col_chunks(h, T * V));
    k6_score_gate_kernel<T, V><<<grid, kTeamThreads, 0, st>>>(
        n_edges, h, u_idx, v_idx, puv, ldp, be, ldb, z);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gn_k6_score_gate(int64_t n_edges, int h, const int* u_idx,
                                const int* v_idx, const float* puv,
                                int64_t ldp, const float* be, int64_t ldb,
                                float* z, void* stream) {
    if (n_edges <= 0 || h <= 0) return (int)cudaSuccess;
    if (n_edges >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int e = (int)n_edges;
    const bool vec = h % 4 == 0 && gn::rows_16b({puv, be, z}, {ldp, ldb});
#define GN_K6_LAUNCH(T, V) \
    return launch<T, V>(e, h, u_idx, v_idx, puv, ldp, be, ldb, z, st)
    const int t = gn::team_size(h, vec ? 4 : 1);
    if (vec) {
        if (t == 8) GN_K6_LAUNCH(8, 4);
        if (t == 16) GN_K6_LAUNCH(16, 4);
        GN_K6_LAUNCH(32, 4);
    }
    if (t == 8) GN_K6_LAUNCH(8, 1);
    if (t == 16) GN_K6_LAUNCH(16, 1);
    GN_K6_LAUNCH(32, 1);
#undef GN_K6_LAUNCH
}
