// The node walk of K3 and K8: a team of T lanes (T = 8, 16 or 32) owns one
// node and one column chunk of W = T * V features, each lane V consecutive
// features (V = 4: one vector per row and lane, a float4 in float32 or 8
// bytes in bf16; V = 1: the scalar path for widths not divisible by 4 or
// rows not aligned to a lane's vector).  Rows are float32 or bf16 (the
// element type S of every template below); arithmetic is float32 in
// registers either way.  A warp holds 32 / T teams, so at d = 64 one warp
// walks two nodes.  blockIdx.x picks the block's nodes (one per team),
// blockIdx.y the column chunk, so any d is taken.
//
// The walk over a node's CSR segment [beg, end) (walk_slots) takes slot and
// partner indices in chunks of T: lane j loads the chunk's j-th slot number
// (perm[beg + j], or beg + j for the identity) and its partner node
// (nbr[beg + j], the partner array in CSR order, so both loads are
// contiguous and independent), and the team takes each slot's (s, partner)
// from a __shfl_sync, never from memory; the next chunk is loaded a chunk
// ahead.  The rows a slot needs go through a ring of kStages stages in
// shared memory: each lane copies its own vector of every row with
// cp.async kStages - 1 slots ahead of the slot it uses, reads
// back only what it copied (its own wait_group orders it), and adds into
// its sums in slot order.
//
// K6 and K7 walk runs of consecutive edge slots with the same pieces: Team,
// Vec / vld / vst, team_size, rows_vec, and SlotChunk over the two endpoint
// arrays (u_idx as `perm`, v_idx as `nbr`).  K9 walks a node's two CSR
// segments in lockstep through a Ring of two rows per stage.
#pragma once

#include <cuda_bf16.h>
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

// ---- row elements: float, or __nv_bfloat16 (bf16).  A lane holds V
// features as float32 in registers whatever the storage type; a bf16 lane of
// V = 4 features is one 8-byte word (a uint2: two bf16 pairs, the lower
// address in the low half), a float lane one 16-byte float4.  Loads widen
// exactly (a bf16's bits are the top half of its float32); stores round to
// nearest even (csrc/edge_math.cuh rounds at the contract's points first,
// so a stored value is already a bf16).
template <class S>
constexpr bool kBf16 = std::is_same<S, __nv_bfloat16>::value;

__device__ __forceinline__ void unpack4(uint2 w, float* a) {
    a[0] = __uint_as_float(w.x << 16);
    a[1] = __uint_as_float(w.x & 0xffff0000u);
    a[2] = __uint_as_float(w.y << 16);
    a[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint2 pack4(const float* a) {
    return make_uint2(bf16_bits(a[0]) | (bf16_bits(a[1]) << 16),
                      bf16_bits(a[2]) | (bf16_bits(a[3]) << 16));
}

__device__ __forceinline__ float widen(unsigned short b) {
    return __uint_as_float((unsigned)b << 16);
}

template <int V, class S>
__device__ __forceinline__ Vec<V> vld(const S* p) {
    Vec<V> r;
    if constexpr (kBf16<S> && V == 4) {
        unpack4(*reinterpret_cast<const uint2*>(p), r.a);
    } else if constexpr (kBf16<S>) {
#pragma unroll
        for (int i = 0; i < V; ++i) r.a[i] = __bfloat162float(p[i]);
    } else if constexpr (V == 4) {
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

// vld for data read once (an edge stream): cached in L2 only, evict first.
// bf16 also at V = 8: one 16-byte word (csrc/bn_edge_adjoint.cu)
template <int V, class S>
__device__ __forceinline__ Vec<V> vld_stream(const S* p) {
    Vec<V> r;
    if constexpr (kBf16<S> && V == 4) {
        unpack4(__ldcs(reinterpret_cast<const uint2*>(p)), r.a);
    } else if constexpr (kBf16<S> && V == 8) {
        const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
        unpack4(make_uint2(t.x, t.y), r.a);
        unpack4(make_uint2(t.z, t.w), r.a + 4);
    } else if constexpr (kBf16<S>) {
        const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int i = 0; i < V; ++i) r.a[i] = widen(__ldcs(q + i));
    } else if constexpr (V == 4) {
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
template <int V, class S>
__device__ __forceinline__ void vst_stream(S* p, const Vec<V>& x) {
    if constexpr (kBf16<S> && V == 4) {
        __stcs(reinterpret_cast<uint2*>(p), pack4(x.a));
    } else if constexpr (kBf16<S> && V == 8) {
        const uint2 lo = pack4(x.a), hi = pack4(x.a + 4);
        __stcs(reinterpret_cast<uint4*>(p),
               make_uint4(lo.x, lo.y, hi.x, hi.y));
    } else if constexpr (kBf16<S>) {
        unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
        for (int i = 0; i < V; ++i)
            __stcs(q + i, (unsigned short)bf16_bits(x.a[i]));
    } else if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(x.a[0], x.a[1], x.a[2], x.a[3]));
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) __stcs(p + i, x.a[i]);
    }
}

template <int V, class S>
__device__ __forceinline__ void vst(S* p, const Vec<V>& x) {
    if constexpr (kBf16<S> && V == 4) {
        *reinterpret_cast<uint2*>(p) = pack4(x.a);
    } else if constexpr (kBf16<S>) {
#pragma unroll
        for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(x.a[i]);
    } else if constexpr (V == 4) {
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

// ---- the cp.async ring: each thread copies its own V elements of every row
// a slot needs into a ring of P stages in dynamic shared memory, and reads
// back only what it copied, so the thread's own wait_group orders it.  A
// word is one lane's V elements: a float4 (16 bytes, cp.async.cg) or float
// (4 bytes, cp.async.ca); in bf16 a uint2 (8 bytes, cp.async.ca) or one
// 2-byte element, which cp.async cannot copy: it is loaded and stored to
// shared memory by the thread itself (the one-element fallback path only).
template <int V, class S>
using Word = std::conditional_t<
    kBf16<S>, std::conditional_t<V == 4, uint2, unsigned short>,
    std::conditional_t<V == 4, float4, float>>;

template <int V, class S>
__device__ __forceinline__ void cp_async(Word<V, S>* dst, const S* src) {
    static_assert(V == 1 || V == 4, "one element or four per lane");
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (kBf16<S> && V == 1)
        *dst = *reinterpret_cast<const unsigned short*>(src);
    else if constexpr (sizeof(Word<V, S>) == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :: "r"(s), "l"(src), "n"(sizeof(Word<V, S>))
                     : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows per slot, P slots: P * ROWS * kTeamThreads words per block,
// each thread's words kTeamThreads apart (no bank conflicts).  S: the rows'
// element type.
template <int V, int ROWS, class S = float>
struct Ring {
    Word<V, S>* mine;
    __device__ __forceinline__ explicit Ring(unsigned char* smem)
        : mine(reinterpret_cast<Word<V, S>*>(smem) + threadIdx.x) {}
    // copy this lane's V elements of a row (src: its first) into the ring
    __device__ __forceinline__ void fetch(int stage, int row,
                                          const S* src) const {
        cp_async<V, S>(mine + (stage * ROWS + row) * kTeamThreads, src);
    }
    __device__ __forceinline__ Vec<V> read(int stage, int row) const {
        const Word<V, S> w = mine[(stage * ROWS + row) * kTeamThreads];
        Vec<V> r;
        if constexpr (kBf16<S> && V == 4) {
            unpack4(w, r.a);
        } else if constexpr (kBf16<S>) {
            r.a[0] = widen(w);
        } else if constexpr (V == 4) {
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
        return stages * ROWS * kTeamThreads * (int)sizeof(Word<V, S>);
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

// Every pointer aligned to a lane's four elements (16 bytes in float, 8 in
// bf16) and every row stride (in elements) a multiple of 4: the V = 4 path.
template <class S>
inline bool rows_vec(std::initializer_list<const void*> ptrs,
                     std::initializer_list<int64_t> strides) {
    for (const void* p : ptrs)
        if (p && (uintptr_t)p % (4 * sizeof(S))) return false;
    for (int64_t s : strides)
        if (s % 4) return false;
    return true;
}

}  // namespace
}  // namespace gn
