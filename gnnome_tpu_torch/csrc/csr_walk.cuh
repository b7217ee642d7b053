// The node walk of K3 and K8: a team of T lanes (T = 8, 16 or 32) owns one
// node and one column chunk of W = T * V features, each lane V consecutive
// features (V = 4: one 16-byte vector per row and lane; V = 1: the scalar
// path for widths not divisible by 4 or rows not 16-byte aligned).  A warp
// holds 32 / T teams, so at d = 64 one warp walks two nodes, each with
// float4 rows.  blockIdx.x picks the block's nodes (one per team),
// blockIdx.y the column chunk, so any d is taken.
//
// The walk over a node's CSR segment [beg, end) (walk_slots) takes slot and
// partner indices in chunks of T: lane j loads the chunk's j-th slot number
// (perm[beg + j], or beg + j for the identity) and its partner node
// (nbr[beg + j], the partner array in CSR order, so both loads are
// contiguous and independent), and the team takes each slot's (s, partner)
// from a __shfl_sync, never from memory; the next chunk is loaded a chunk
// ahead.  The rows a slot needs go through a ring of kStages stages in
// shared memory: each lane copies its own 16 bytes of every row with
// cp.async (L1 bypassed) kStages - 1 slots ahead of the slot it uses, reads
// back only what it copied (its own wait_group orders it), and adds into
// its sums in slot order.
//
// K6 and K7 walk runs of consecutive edge slots with the same pieces: Team,
// Vec / vld / vst, team_size, rows_16b, and SlotChunk over the two endpoint
// arrays (u_idx as `perm`, v_idx as `nbr`).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace gn {
namespace {   // internal linkage: every kernel source includes this

constexpr int kTeamThreads = 256;        // threads per block of a team kernel
constexpr int kStages = 3;     // ring stages: slots in flight per team + 1

template <int V>
struct Vec {
    float a[V];
};

template <int V>
__device__ __forceinline__ Vec<V> vzero() {
    Vec<V> r;
#pragma unroll
    for (int i = 0; i < V; ++i) r.a[i] = 0.0f;
    return r;
}

template <int V>
__device__ __forceinline__ Vec<V> vld(const float* p) {
    Vec<V> r;
    if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        r.a[0] = t.x;
        r.a[1] = t.y;
        r.a[2] = t.z;
        r.a[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) r.a[i] = p[i];
    }
    return r;
}

// vld for data read once (an edge stream): cached in L2 only, evict first
template <int V>
__device__ __forceinline__ Vec<V> vld_stream(const float* p) {
    Vec<V> r;
    if constexpr (V == 4) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
        r.a[0] = t.x;
        r.a[1] = t.y;
        r.a[2] = t.z;
        r.a[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) r.a[i] = __ldcs(p + i);
    }
    return r;
}

// vst for data written once (an edge stream), evict first
template <int V>
__device__ __forceinline__ void vst_stream(float* p, const Vec<V>& x) {
    if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(x.a[0], x.a[1], x.a[2], x.a[3]));
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) __stcs(p + i, x.a[i]);
    }
}

template <int V>
__device__ __forceinline__ void vst(float* p, const Vec<V>& x) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(x.a[0], x.a[1], x.a[2],
                                                    x.a[3]);
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = x.a[i];
    }
}

// This thread's place: lane in its team, the team's lanes as a shuffle mask,
// and the team's node.
template <int T>
struct Team {
    int lane;
    unsigned mask;
    int node;
    __device__ __forceinline__ Team() {
        static_assert(T == 8 || T == 16 || T == 32, "team of 8, 16 or 32");
        lane = threadIdx.x & (T - 1);
        if constexpr (T == 32)
            mask = 0xffffffffu;
        else
            mask = ((1u << T) - 1u) << ((threadIdx.x & 31) & ~(T - 1));
        node = blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
    }
};

// One chunk of up to T slots of a CSR segment, held one per lane.
template <int T>
struct SlotChunk {
    int s, p;     // this lane's slot and partner node (0 past the segment)
    __device__ __forceinline__ SlotChunk(const Team<T>& tm, int base, int end,
                                         const int* __restrict__ perm,
                                         const int* __restrict__ nbr) {
        s = 0;
        p = 0;
        if (base + tm.lane < end) {
            s = perm ? perm[base + tm.lane] : base + tm.lane;
            p = nbr[base + tm.lane];
        }
    }
    // slot j of the chunk (j < T): every lane of the team must call
    __device__ __forceinline__ void get(const Team<T>& tm, int j, int& sj,
                                        int& pj) const {
        sj = __shfl_sync(tm.mask, s, j, T);
        pj = __shfl_sync(tm.mask, p, j, T);
    }
};

// ---- the cp.async ring: each thread copies its own V floats of every row a
// slot needs into a ring of P stages in dynamic shared memory, and reads
// back only what it copied, so the thread's own wait_group orders it.
template <int V>
using Word = std::conditional_t<V == 4, float4, float>;

template <int V>
__device__ __forceinline__ void cp_async(Word<V>* dst, const float* src) {
    static_assert(V == 1 || V == 4, "one float or one float4 per lane");
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (V == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows per slot, P slots: P * ROWS * kTeamThreads words per block,
// each thread's words kTeamThreads apart (no bank conflicts).
template <int V, int ROWS>
struct Ring {
    Word<V>* mine;
    __device__ __forceinline__ explicit Ring(unsigned char* smem)
        : mine(reinterpret_cast<Word<V>*>(smem) + threadIdx.x) {}
    // copy this lane's V floats of a row (src: its first) into the ring
    __device__ __forceinline__ void fetch(int stage, int row,
                                          const float* src) const {
        cp_async<V>(mine + (stage * ROWS + row) * kTeamThreads, src);
    }
    __device__ __forceinline__ Vec<V> read(int stage, int row) const {
        const Word<V> w = mine[(stage * ROWS + row) * kTeamThreads];
        Vec<V> r;
        if constexpr (V == 4) {
            r.a[0] = w.x;
            r.a[1] = w.y;
            r.a[2] = w.z;
            r.a[3] = w.w;
        } else {
            r.a[0] = w;
        }
        return r;
    }
    static constexpr int bytes(int stages) {
        return stages * ROWS * kTeamThreads * (int)sizeof(Word<V>);
    }
};

// Walks the slots [beg, end) of one node's CSR segment with P - 1 slots in
// flight: issue(stage, s, partner) starts the copies of a slot's rows into
// ring stage `stage`, use(stage, s) consumes them, in slot order.  Slot and
// partner indices come from two chunks of T held in registers (the current
// one and the next, loaded a chunk ahead): a slot's pair is shuffled once,
// from the chunk that holds it, when the slot is issued, and its slot
// number waits in registers until its use.  Every lane of the team runs the
// same control flow.
template <int T, int P, class Issue, class Use>
__device__ __forceinline__ void walk_slots(const Team<T>& tm, int beg,
                                           int end,
                                           const int* __restrict__ perm,
                                           const int* __restrict__ nbr,
                                           Issue&& issue, Use&& use) {
    static_assert(P >= 2 && P - 1 <= T, "ring of 2 .. T + 1 stages");
    const int n = end - beg;
    if (n <= 0) return;
    SlotChunk<T> cur(tm, beg, end, perm, nbr);
    SlotChunk<T> nxt(tm, beg + T, end, perm, nbr);
    int cbase = 0;                      // slot number of cur's first slot
    auto issue_slot = [&](int stage, int j) {   // cbase <= j < cbase + 2T
        const int k = j - cbase;        // the same for every lane of the team
        int s, p;
        (k < T ? cur : nxt).get(tm, k & (T - 1), s, p);
        issue(stage, s, p);
        return s;
    };
    int q[P - 1];                       // issued slots not yet used, in order
#pragma unroll
    for (int j = 0; j < P - 1; ++j) {
        q[j] = j < n ? issue_slot(j, j) : 0;
        cp_commit();
    }
    for (int i = 0; i < n; ++i) {
        const int j = i + P - 1;
        const int sj = j < n ? issue_slot(j % P, j) : 0;
        cp_commit();
        cp_wait<P - 1>();
        use(i % P, q[0]);
#pragma unroll
        for (int k = 0; k < P - 2; ++k) q[k] = q[k + 1];
        q[P - 2] = sj;
        if (i - cbase == T - 1) {
            cbase += T;
            cur = nxt;
            nxt = SlotChunk<T>(tm, beg + cbase + T, end, perm, nbr);
        }
    }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device (above 48 KB a kernel must opt in).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

// Lanes per team for width d: the smallest of 8, 16, 32 whose chunk holds
// the row's d / V vectors, else 32 (several chunks).
inline int team_size(int d, int v) {
    const int vecs = (d + v - 1) / v;
    return vecs <= 8 ? 8 : (vecs <= 16 ? 16 : 32);
}

// Every pointer 16-byte aligned and every row stride (in floats) a multiple
// of 4: float4 rows.
inline bool rows_16b(std::initializer_list<const void*> ptrs,
                     std::initializer_list<int64_t> strides) {
    for (const void* p : ptrs)
        if (p && (uintptr_t)p % 16) return false;
    for (int64_t s : strides)
        if (s % 4) return false;
    return true;
}

}  // namespace
}  // namespace gn
