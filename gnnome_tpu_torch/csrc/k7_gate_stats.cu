// K7: the BatchNorm batch statistics of the training gate, for Hopper (sm_90a).
//
// Replaces gnnome_tpu/ops/pallas_kernels.py:k7_gate_stats (body _k7_kernel).
// Per edge slot s with flip-resolved endpoints u, v:
//
//   x[s]  = B1h[u] + B2h[v] + B3e[s]        (csrc/edge_math.cuh, as K3)
//   out   = [sum_s x | sum_s x * x]          ([2d], float64)
//
// x is never written.  bu rows are B1h (row stride ldu), bv rows B2h (ldv):
// the gate columns of the [N, 4d] training projection, read in place.
//
// Bound on the card: bytes.  It streams b3e (d floats per edge) and two
// d-float row gathers from node tables that stay in the 50 MB L2 at E. coli
// scale; four flops per element.
//
// Design.  The TPU kernel built per-tile partial sums with a masked one-hot
// matmul and the caller added the tiles.  Here one launch does it all:
//   - a team of T lanes (csr_walk.cuh; T = 16 at d = 64) walks a contiguous
//     run of slots over one column chunk of W = T * V features
//     (blockIdx.y), each lane V consecutive features: a float4 of each row,
//     two slots per warp instruction at d = 64.  Slot indices come in
//     chunks of T: lane j loads slot j's u and v, the next chunk is loaded
//     a chunk ahead, and the team takes each slot's pair by __shfl_sync.
//     The row loads of S slots are issued before their adds.  A slot whose
//     endpoint repeats the slot before it (the dst side is sorted: a node's
//     ~27 in-edges in a row) reuses the row in registers and loads
//     nothing; b3e, read once, bypasses L1 and is evicted from L2 first;
//   - each lane adds x and x * x into float64 registers in slot order
//     (x * x of a float32 x is exact in float64, and the float64 sums keep
//     the caller's one-pass variance sum(x^2)/n - mean^2 from cancelling
//     where |mean| >> std); the block adds its teams' rows in team order
//     into one partial row;
//   - the final sum: blocks form groups of G; the last block of a group to
//     finish (an integer ticket, after __threadfence) adds the group's rows
//     in block order into a group row, and the last group to finish adds
//     the group rows in group order into ``out``.  atomicInc wraps each
//     ticket back to 0, so the tickets are ready for the next launch.
// The team size comes from d alone (V = 1 for widths not divisible by 4 or
// unaligned rows keeps it and takes more column chunks), and the runs,
// blocks and groups from E and T: the order of every float64 add is fixed
// by E and d, so the result is bitwise reproducible, the same on either
// path, with no float atomics.
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
constexpr int kRunSlots = 64;           // slots per team, aimed at
constexpr int kMaxBlocks = 2048;

// The partition for E edges at width d: T lanes per team, `blocks` blocks
// of kTeamThreads / T teams, `run` slots per team, groups of `group` blocks.
struct Plan {
    int t, blocks, run, group, groups;
    Plan(int64_t n_edges, int d) {
        t = gn::team_size(d, 4);
        const int64_t teams = kTeamThreads / t;
        int64_t b = (n_edges + teams * kRunSlots - 1) / (teams * kRunSlots);
        blocks = (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
        run = (int)((n_edges + blocks * teams - 1) / (blocks * teams));
        group = 1;
        while (group * group < blocks) ++group;        // ceil(sqrt(blocks))
        groups = (blocks + group - 1) / group;
    }
};

// dst[half * d + f] = sum over r < n of src[r * 2d + half * d + f], rows in
// order, for the column chunk c0 .. c0 + cw - 1 of both halves; reads past
// L1 (the rows were written by other blocks).  Call from every thread.
__device__ __forceinline__ void sum_rows(const double* src, int n, int cw,
                                         int c0, int d, double* dst) {
    for (int j = threadIdx.x; j < 2 * cw; j += blockDim.x) {
        const int half = j >= cw ? 1 : 0;
        const int f = c0 + j - half * cw;
        if (f >= d) continue;
        const double* p = src + half * d + f;
        double acc = 0.0;
#pragma unroll 8
        for (int r = 0; r < n; ++r) acc += __ldcg(p + (int64_t)r * 2 * d);
        dst[half * d + f] = acc;
    }
}

// True in every thread of the block that takes the ticket last of `count`
// (its writes, and those of the blocks before it, fenced first).
__device__ __forceinline__ bool last_to_finish(unsigned* ticket,
                                               unsigned count) {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicInc(ticket, count - 1) == count - 1;
    __syncthreads();
    return last;
}

template <int T, int V>
__global__ void __launch_bounds__(kTeamThreads)
k7_gate_stats_kernel(int n_edges, int d, int run, int group, int groups,
                     const int* __restrict__ u_idx,
                     const int* __restrict__ v_idx,
                     const float* __restrict__ bu, int64_t ldu,
                     const float* __restrict__ bv, int64_t ldv,
                     const float* __restrict__ b3e,
                     double* __restrict__ partials,
                     unsigned* __restrict__ tickets,
                     double* __restrict__ out) {
    constexpr int W = T * V;
    constexpr int S = kSlotsInFlight;
    __shared__ double red[(kTeamThreads / T) * 2 * W];
    const Team<T> tm;
    const int c0 = blockIdx.y * W;
    const int f = c0 + tm.lane * V;
    const bool on = f < d;
    double s1[V], s2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        s1[i] = 0.0;
        s2[i] = 0.0;
    }
    const int64_t beg64 = (int64_t)tm.node * run;
    const int beg = (int)(beg64 < n_edges ? beg64 : n_edges);
    const int end = n_edges - beg < run ? n_edges : beg + run;
    if (beg < end) {        // no return: every thread joins block_partials
        // the last group's endpoints and rows: a slot whose endpoint
        // repeats the slot before it (the dst side is sorted) reuses them
        int lu = -1, lv = -1;
        Vec<V> ra = gn::vzero<V>(), rb = gn::vzero<V>();
        gn::SlotChunk<T> cur(tm, beg, end, u_idx, v_idx);
        gn::SlotChunk<T> nxt(tm, beg + T, end, u_idx, v_idx);
        for (int base = beg; base < end; base += T) {
            const int n = end - base < T ? end - base : T;
#pragma unroll
            for (int k0 = 0; k0 < T; k0 += S) {
                if (k0 >= n) break;         // the same for the whole team
                Vec<V> a[S], b[S], c[S];
                int us[S], vs[S];
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    cur.get(tm, k0 + j, us[j], vs[j]);  // every lane shuffles
                    if (!on || k0 + j >= n) continue;
                    if (us[j] != (j ? us[j - 1] : lu))
                        a[j] = vld<V>(bu + (int64_t)us[j] * ldu + f);
                    if (vs[j] != (j ? vs[j - 1] : lv))
                        b[j] = vld<V>(bv + (int64_t)vs[j] * ldv + f);
                    c[j] = gn::vld_stream<V>(b3e + (int64_t)(base + k0 + j) * d
                                             + f);
                }
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    if (!on || k0 + j >= n) continue;
                    if (us[j] == (j ? us[j - 1] : lu)) a[j] = j ? a[j - 1] : ra;
                    if (vs[j] == (j ? vs[j - 1] : lv)) b[j] = j ? b[j - 1] : rb;
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const double x = (double)gn::gate_x(a[j].a[i],
                                                            b[j].a[i],
                                                            c[j].a[i]);
                        s1[i] += x;
                        s2[i] += x * x;
                    }
                }
                lu = us[S - 1];
                lv = vs[S - 1];
                ra = a[S - 1];
                rb = b[S - 1];
            }
            cur = nxt;
            nxt = gn::SlotChunk<T>(tm, base + 2 * T, end, u_idx, v_idx);
        }
    }
    const int team = threadIdx.x / T;
#pragma unroll
    for (int i = 0; i < V; ++i) {
        red[team * 2 * W + tm.lane * V + i] = s1[i];
        red[team * 2 * W + W + tm.lane * V + i] = s2[i];
    }
    gn::block_partials(red, kTeamThreads / T, W, c0, d, partials);

    // the final sum: this block's group, then the groups
    const int blocks = gridDim.x;
    const int g = blockIdx.x / group;
    const int in_group = blocks - g * group < group ? blocks - g * group
                                                    : group;
    unsigned* tk = tickets + blockIdx.y * (groups + 1);
    double* group_rows = partials + (int64_t)blocks * 2 * d;
    if (!last_to_finish(tk + g, in_group)) return;
    sum_rows(partials + (int64_t)g * group * 2 * d, in_group, W, c0, d,
             group_rows + (int64_t)g * 2 * d);
    if (!last_to_finish(tk + groups, groups)) return;
    sum_rows(group_rows, groups, W, c0, d, out);
}

template <int T, int V>
int launch(const Plan& p, int n_edges, int d, const int* u_idx,
           const int* v_idx, const float* bu, int64_t ldu, const float* bv,
           int64_t ldv, const float* b3e, double* partials,
           unsigned* tickets, double* out, cudaStream_t st) {
    const dim3 grid(p.blocks, gn::col_chunks(d, T * V));
    k7_gate_stats_kernel<T, V><<<grid, kTeamThreads, 0, st>>>(
        n_edges, d, p.run, p.group, p.groups, u_idx, v_idx, bu, ldu, bv, ldv,
        b3e, partials, tickets, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Scratch the caller provides for E edges at width d: ``partials`` as
// [rows, 2d] float64 (uninitialised) and ``tickets`` as `n_tickets`
// unsigned ints, zero before the first launch (each launch leaves them at
// zero).
extern "C" void gn_k7_scratch(int64_t n_edges, int d, int* rows,
                              int* n_tickets) {
    const Plan p(n_edges, d);
    *rows = p.blocks + p.groups;
    *n_tickets = gn::col_chunks(d, p.t) * (p.groups + 1);
}

extern "C" int gn_k7_gate_stats(int64_t n_edges, int d, const int* u_idx,
                                const int* v_idx, const float* bu,
                                int64_t ldu, const float* bv, int64_t ldv,
                                const float* b3e, double* partials,
                                unsigned* tickets, double* out,
                                void* stream) {
    if (d <= 0) return (int)cudaSuccess;
    if (n_edges < 0 || n_edges >= ((int64_t)1 << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Plan p(n_edges, d);
    const int e = (int)n_edges;
    const bool vec = d % 4 == 0 && gn::rows_16b({bu, bv, b3e}, {ldu, ldv});
#define GN_K7_LAUNCH(T, V)                                                     \
    return launch<T, V>(p, e, d, u_idx, v_idx, bu, ldu, bv, ldv, b3e,         \
                        partials, tickets, out, st)
    if (vec) {
        if (p.t == 8) GN_K7_LAUNCH(8, 4);
        if (p.t == 16) GN_K7_LAUNCH(16, 4);
        GN_K7_LAUNCH(32, 4);
    }
    if (p.t == 8) GN_K7_LAUNCH(8, 1);
    if (p.t == 16) GN_K7_LAUNCH(16, 1);
    GN_K7_LAUNCH(32, 1);
#undef GN_K7_LAUNCH
}
