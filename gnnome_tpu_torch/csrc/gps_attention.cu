// GraphGPS's global attention (models/zoo.py _GPSLayer, one a layer):
// softmax self-attention over the nodes of each graph of a batch, the
// graphs laid out as contiguous row ranges (block-diagonal attention,
// variable lengths), heads of 16, dropout on the normalised weights,
// float32, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no such model.  The
// published model runs torch.nn.MultiheadAttention on to_dense_batch with
// a key padding mask; here (ops/kernels.py gps_attention_*, one autograd
// Function models/zoo.py gps_attention):
//
//   forward   gps_attn_fwd_kernel         out = drop(softmax(q k^T / 4)) v per
//                                         query row and head over its unit's
//                                         keys, an online softmax in chunks of
//                                         16 keys; lse = log of the softmax's
//                                         sum, per row and head
//   backward  gps_attn_bwd_rowdot_kernel  D = rowsum(dO * O) per row and head
//             gps_attn_bwd_kernel         dQ, dK and dV in one pass over each
//                                         (query, key) pair of a unit and head
//
// The backward recomputes the probabilities p = exp2(s' - lse log2(e)) from
// the scores s' = (q log2(e) / 4) . k; nothing [n, n] is stored.  Its
// scratch is D ([N, heads]) and, only where a batch of few units is cut into
// key ranges, the later ranges' dQ (at most 31 [N, d]).
//
// Precision: plain float32 FMA (no tensor cores, no TF32), exp2f and
// log2f; sums in another order than the plain version's (ops/kernels.py
// gps_attention_*_plain), so results agree with it up to rounding.
//
// Dropout: the keep decision of (layer, head, unit-relative query row q,
// key row k) is a pure function of a 64-bit seed read from device memory
// (the step draws it from its torch.Generator, so no launch synchronises
// with the host): base = mix(mix(seed_hi) ^ seed_lo), stream = mix(base ^
// (layer * heads + head)), row(q) = mix(stream ^ q), col(k) = mix(k ^
// 0x9e3779b9), kept where mix(row(q) ^ col(k)) < keep_below, the kept
// weights scaled by keep_scale = 1 / (1 - rate).  The forward holds row(q)
// in registers and stages col(k) with the keys; the backward holds col(k)
// and stages row(q), each folded with its own shift by 16 (mix's first
// step, x ^ x >> 16, is linear), so a pair costs one xor, the rest of one
// mix and a compare.
//
// Forward design: a CTA of 64 threads owns one tile of at most 128 rows of
// one unit and one head (ops/kernels.py AttentionSegments.tiles: int4 (r0,
// r1, u0, u1) a tile, grid (tiles, heads)); a thread owns 2 rows, so each
// key staged in shared memory (64 a step, float4 rows) feeds two rows'
// arithmetic.  Rows past the tile's end compute and are not written.
//
// Backward design: a CTA of 128 threads owns one unit, one head and one
// range of the unit's keys (AttentionSegments.bwd_units: int2 (u0, u1) of
// every non-empty unit, largest first, since a unit's work grows as n^2;
// grid units x heads x splits).  Where the units and heads fill the card
// (AttentionSegments.bwd_splits: 256 CTAs) a range is the whole unit; a
// batch of few units, as one cluster a step, cuts each unit's keys into
// at most 32 ranges of whole key tiles, so that its CTAs still fill the
// SMs.  A CTA walks its keys in tiles of 256: a warp owns 64 of them, a lane 2
// (k, v and the sums dK, dV in registers; k also in shared memory; a warp
// with no key in the last tile waits at the barriers).  For each tile it
// streams the unit's queries through shared memory 32 at a time (q, dO, lse,
// D and the row's hash; the next stage's rows are fetched into registers
// while the current one is computed).  Each warp then makes two passes over
// the stage:
//   - each pair once: s, p, the keep bit, dp = dO . v, ds = p (drop(dp) -
//     D); dV += drop(p) dO and dK += ds q for the lane's keys; ds to shared
//     memory (a row of the warp's 64 keys a query);
//   - dQ's part over the warp's keys, ds K: lane i takes the stage's query i
//     and sums ds k over the 64 keys in slot order, each k a broadcast read.
// dQ without atomics: the warps' parts are added in warp order, times 1/4,
// to the range's dQ rows by a load, an add and a store that only this CTA
// makes, key tile after key tile (the first tile stores): the first range's
// rows are the unit's in d_qkv, each later range's its own in the scratch
// dq_part ([splits - 1][N][d], only where splits > 1).  The range that
// finishes last (an integer ticket, after __threadfence) adds the later
// ranges' rows in range order into d_qkv.  Every sum has one fixed order,
// set by the lengths alone, so two runs agree bit for bit.  A warp reads
// only the ds of its valid keys, so padded key slots need no masking.
//
// Bound: operations.  Per pair and head the forward does 32 FMA (q.k and
// p v), the backward 80 (s, dp, dV, dK in the first pass, dQ in the
// second: the least, 10 d a pair over the heads), with one exp2f (on the
// SFU), the rest of the hash, ds and a shared store beside them; per query
// a lane loads q, dO and its meta once for its 2 keys, and per pair the
// second pass reads ds and k from shared memory (5 loads for 16 FMA).  The
// unit's rows (q, dO, lse, D and dQ) are read again for each key tile, from
// L2 or device memory, which is far from the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kW = 16;                    // head width
constexpr int kV = kW / 4;                // float4 words a head row
constexpr int kRows = 2;                  // rows a thread owns
constexpr int kThreads = 64;
constexpr int kStage = 64;                // keys or queries staged a step
constexpr int kChunk = 16;                // keys an online-softmax update
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kScale = 0.25f;           // 1 / sqrt(kW)
constexpr float kScaleLog2 = kLog2e * kScale;
constexpr uint32_t kColSalt = 0x9E3779B9u;
// the backward's fused pass
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kKeys = 2;                  // key rows a lane owns
constexpr int kWarpKeys = 32 * kKeys;
constexpr int kKeyTile = kBwdWarps * kWarpKeys;
constexpr int kBwdStage = 32;             // queries staged a step: a lane each
                                          // in dQ's product
static_assert(kBwdStage == 32 && kBwdStage * kV == kBwdThreads,
              "a lane a staged query in dQ's product, a thread a word of "
              "the stage's q and dO");

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    return x;
}

__device__ __forceinline__ uint32_t stream_key(const int64_t* seed, int layer,
                                               int heads, int head) {
    const uint64_t s = static_cast<uint64_t>(*seed);
    const uint32_t base = mix32(mix32(static_cast<uint32_t>(s >> 32))
                                ^ static_cast<uint32_t>(s));
    return mix32(base ^ static_cast<uint32_t>(layer * heads + head));
}

__device__ __forceinline__ void unpack(const float4* src, float (&x)[kW]) {
#pragma unroll
    for (int c = 0; c < kV; ++c) {
        const float4 v = src[c];
        x[4 * c] = v.x;
        x[4 * c + 1] = v.y;
        x[4 * c + 2] = v.z;
        x[4 * c + 3] = v.w;
    }
}

__device__ __forceinline__ void load_row(const float* p, float (&x)[kW]) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int c = 0; c < kV; ++c) {
        const float4 v = __ldg(p4 + c);
        x[4 * c] = v.x;
        x[4 * c + 1] = v.y;
        x[4 * c + 2] = v.z;
        x[4 * c + 3] = v.w;
    }
}

__device__ __forceinline__ void store_row(float* p, const float (&x)[kW],
                                          float scale) {
    float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int c = 0; c < kV; ++c)
        p4[c] = make_float4(x[4 * c] * scale, x[4 * c + 1] * scale,
                            x[4 * c + 2] * scale, x[4 * c + 3] * scale);
}

__device__ __forceinline__ float dot(const float (&a)[kW],
                                     const float (&b)[kW]) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kW; ++c) s = fmaf(a[c], b[c], s);
    return s;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
gps_attn_fwd_kernel(int heads, const float* __restrict__ qkv,
                    const int4* __restrict__ tiles,
                    const int64_t* __restrict__ seed, int layer,
                    uint32_t keep_below, float keep_scale,
                    float* __restrict__ out, float* __restrict__ lse) {
    __shared__ float4 sk[kStage][kV];
    __shared__ float4 sv[kStage][kV];
    __shared__ uint32_t scol[kStage];
    const int4 t = tiles[blockIdx.x];               // (r0, r1, u0, u1)
    const int h = blockIdx.y, d = heads * kW;
    const int64_t ld = 3 * d;
    const uint32_t stream = kDrop ? stream_key(seed, layer, heads, h) : 0u;

    float q[kRows][kW], acc[kRows][kW], m[kRows], l[kRows];
    uint32_t rk[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = t.x + threadIdx.x + r * kThreads;
        if (row < t.y) {
            load_row(qkv + row * ld + h * kW, q[r]);
        } else {
#pragma unroll
            for (int c = 0; c < kW; ++c) q[r][c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < kW; ++c) {
            q[r][c] *= kScaleLog2;
            acc[r][c] = 0.f;
        }
        m[r] = -INFINITY;
        l[r] = 0.f;
        rk[r] = kDrop ? mix32(stream ^ static_cast<uint32_t>(row - t.z)) : 0u;
    }

    for (int k0 = t.z; k0 < t.w; k0 += kStage) {
        const int nk = min(kStage, t.w - k0);
        __syncthreads();
        for (int i = threadIdx.x; i < kStage * kV; i += kThreads) {
            const int key = i / kV, c = i % kV;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (key < nk) {
                const float* base = qkv + (k0 + key) * ld + h * kW + 4 * c;
                kv = ldg4(base + d);
                vv = ldg4(base + 2 * d);
            }
            sk[key][c] = kv;
            sv[key][c] = vv;
        }
        if (kDrop)
            for (int i = threadIdx.x; i < kStage; i += kThreads)
                scol[i] = mix32(static_cast<uint32_t>(k0 + i - t.z) ^ kColSalt);
        __syncthreads();

        for (int j0 = 0; j0 < nk; j0 += kChunk) {
            float s[kRows][kChunk];
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                float kk[kW];
                unpack(sk[j0 + j], kk);
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    const float a = dot(q[r], kk);
                    s[r][j] = j0 + j < nk ? a : -INFINITY;
                }
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                float mx = m[r];
#pragma unroll
                for (int j = 0; j < kChunk; ++j) mx = fmaxf(mx, s[r][j]);
                const float alpha = exp2f(m[r] - mx);
                m[r] = mx;
                l[r] *= alpha;
#pragma unroll
                for (int c = 0; c < kW; ++c) acc[r][c] *= alpha;
            }
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
                float vv[kW];
                unpack(sv[j0 + j], vv);
                const uint32_t col = kDrop ? scol[j0 + j] : 0u;
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    float p = exp2f(s[r][j] - m[r]);
                    l[r] += p;
                    if (kDrop)
                        p = mix32(rk[r] ^ col) < keep_below ? p * keep_scale
                                                            : 0.f;
#pragma unroll
                    for (int c = 0; c < kW; ++c)
                        acc[r][c] = fmaf(p, vv[c], acc[r][c]);
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int row = t.x + threadIdx.x + r * kThreads;
        if (row >= t.y) continue;
        store_row(out + static_cast<int64_t>(row) * d + h * kW, acc[r],
                  1.f / l[r]);
        lse[static_cast<int64_t>(row) * heads + h] =
            (m[r] + log2f(l[r])) * kLn2;
    }
}

// D = rowsum(dO * O) a row and head, into dvec [N, heads] (row-major, so the
// flat index is row * heads + head and the head's 16 values lie at 16 i).
// Also zeroes the fused pass's tickets (n_tickets <= n_pairs).
__global__ void __launch_bounds__(256)
gps_attn_bwd_rowdot_kernel(int64_t n_pairs, const float* __restrict__ out,
                           const float* __restrict__ d_out,
                           float* __restrict__ dvec,
                           unsigned* __restrict__ tickets, int n_tickets) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                      + threadIdx.x;
    if (i < n_tickets) tickets[i] = 0u;
    if (i >= n_pairs) return;
    float o[kW], g[kW];
    load_row(out + i * kW, o);
    load_row(d_out + i * kW, g);
    dvec[i] = dot(g, o);
}

// The fused pass's shared memory: a stage of kBwdStage queries (q log2(e) / 4,
// dO, and (-lse log2 e, D, the row's hash folded, 0)); each warp's keys k;
// each warp's ds of the stage's queries and its keys (a row of the warp's
// keys a query, one float of padding, so that the lanes' rows fall in
// different banks); each warp's dQ partials of the stage.
struct BwdShared {
    float4 q[kBwdStage][kV];
    float4 g[kBwdStage][kV];
    float4 meta[kBwdStage];
    float4 k[kBwdWarps][kWarpKeys][kV];
    float ds[kBwdWarps][kBwdStage][kWarpKeys + 1];
    float4 part[kBwdWarps][kBwdStage][kV];
};

// True in every thread of the CTA that takes the ticket last of `count`
// (its writes, and those of the CTAs before it, fenced first).
__device__ __forceinline__ bool last_to_finish(unsigned* ticket,
                                               unsigned count) {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicInc(ticket, count - 1) == count - 1;
    __syncthreads();
    return last;
}

// kSplit: splits > 1 (the ranges and the scratch; the instantiation
// without them keeps a unit's whole keys and d_qkv alone)
template <bool kDrop, bool kSplit>
__global__ void __launch_bounds__(kBwdThreads)
gps_attn_bwd_kernel(int heads, int splits, int64_t n_rows,
                    const float* __restrict__ qkv,
                    const int2* __restrict__ units,
                    const int64_t* __restrict__ seed, int layer,
                    uint32_t keep_below, float keep_scale,
                    const float* __restrict__ d_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    float* __restrict__ d_qkv, float* __restrict__ dq_part,
                    unsigned* __restrict__ tickets) {
    extern __shared__ float4 smem[];
    BwdShared& sm = *reinterpret_cast<BwdShared*>(smem);
    // unit * heads + head, unsigned as blockIdx.x: signed, the compiler
    // moves the CTA's index math off the uniform datapath (2.7% slower)
    const unsigned uh = kSplit ? blockIdx.x / splits : blockIdx.x;
    const int2 u = units[uh / heads];
    const int h = uh % heads, split = kSplit ? blockIdx.x % splits : 0;
    const int d = heads * kW;
    const int64_t ld = 3 * d;
    const int n = u.y - u.x;
    // the range's key tiles: ranges of `per` tiles, `used` of them hold keys
    const int n_tiles = n / kKeyTile + (n % kKeyTile != 0);
    const int per = kSplit ? n_tiles / splits + (n_tiles % splits != 0)
                           : n_tiles;
    const int used = kSplit ? n_tiles / per + (n_tiles % per != 0) : 1;
    if (split >= used) return;
    const int k_begin = kSplit ? split * per * kKeyTile : 0;   // < n
    const int k_end = kSplit ? static_cast<int>(min(
                          static_cast<int64_t>(n),
                          k_begin + static_cast<int64_t>(per) * kKeyTile))
                             : n;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const uint32_t stream = kDrop ? stream_key(seed, layer, heads, h) : 0u;
    const float* q_base = qkv + static_cast<int64_t>(u.x) * ld + h * kW;
    const float* g_base = d_out + static_cast<int64_t>(u.x) * d + h * kW;
    float* out_base = d_qkv + static_cast<int64_t>(u.x) * ld + h * kW;
    // dQ's sums: the first range's into d_qkv, each later one's into its
    // rows of dq_part ([splits - 1][N][d])
    const int64_t dq_ld = !kSplit || split == 0 ? ld : d;
    float* dq_base = !kSplit || split == 0
                         ? out_base
                         : dq_part + ((split - 1) * n_rows + u.x) * d + h * kW;
    // a thread's word of a stage (of q, dO and dQ): query si's word sw
    const int si = t / kV, sw = t % kV;

    // the next stage's rows, fetched while the current one is computed
    float4 fq, fg;
    float flse = 0.f, fdd = 0.f;
    auto fetch = [&](int q0) {
        const int nq = min(kBwdStage, n - q0);
        if (si < nq) {
            fq = ldg4(q_base + (q0 + si) * ld + 4 * sw);
            fg = ldg4(g_base + static_cast<int64_t>(q0 + si) * d + 4 * sw);
        }
        if (t < nq) {
            const int64_t r = static_cast<int64_t>(u.x + q0 + t) * heads + h;
            flse = __ldg(lse + r);
            fdd = __ldg(dvec + r);
        }
    };
    auto put = [&](int q0) {
        const int nq = min(kBwdStage, n - q0);
        if (si < nq) {
            sm.q[si][sw] = make_float4(fq.x * kScaleLog2, fq.y * kScaleLog2,
                                       fq.z * kScaleLog2, fq.w * kScaleLog2);
            sm.g[si][sw] = fg;
        }
        if (t < nq) {
            uint32_t ra = 0u;
            if (kDrop) {
                ra = mix32(stream ^ static_cast<uint32_t>(q0 + t));
                ra ^= ra >> 16;
            }
            sm.meta[t] = make_float4(-flse * kLog2e, fdd, __uint_as_float(ra),
                                     0.f);
        }
    };

    for (int k0 = k_begin; k0 < k_end; k0 += kKeyTile) {
        // the tile's keys: warp w owns [k0 + 64 w, + 64), its slot j the
        // key k0 + 64 w + j, held by lane j % 32 (k, v and the sums dK, dV
        // in registers) and, for dQ's product, k in shared memory; a warp
        // reads only its valid slots, so padded keys need no value
        const int n_keys = max(0, min(kWarpKeys, n - k0 - warp * kWarpKeys));
        const int n_warps = min(kBwdWarps, (n - k0 + kWarpKeys - 1)
                                           / kWarpKeys);
        float kr[kKeys][kW], v[kKeys][kW], dk[kKeys][kW], dv[kKeys][kW];
        uint32_t cb[kKeys];
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
            const int slot = r * 32 + lane, j = k0 + warp * kWarpKeys + slot;
            if (slot < n_keys) {
                const float* row = q_base + j * ld + d;
                load_row(row, kr[r]);
                load_row(row + d, v[r]);
            } else {
#pragma unroll
                for (int c = 0; c < kW; ++c) kr[r][c] = v[r][c] = 0.f;
            }
#pragma unroll
            for (int w = 0; w < kV; ++w)
                sm.k[warp][slot][w] =
                    make_float4(kr[r][4 * w], kr[r][4 * w + 1],
                                kr[r][4 * w + 2], kr[r][4 * w + 3]);
            const uint32_t col = mix32(static_cast<uint32_t>(j) ^ kColSalt);
            cb[r] = kDrop ? col ^ (col >> 16) : 0u;
#pragma unroll
            for (int c = 0; c < kW; ++c) dk[r][c] = dv[r][c] = 0.f;
        }

        fetch(0);
        for (int q0 = 0; q0 < n; q0 += kBwdStage) {
            const int nq = min(kBwdStage, n - q0);
            put(q0);
            __syncthreads();      // the stage (and the tile's k) is in
            if (q0 + kBwdStage < n) fetch(q0 + kBwdStage);
            // this stage's dQ so far (the range's earlier key tiles' sums),
            // read now and added after the passes
            float* dq_word = dq_base + (q0 + si) * dq_ld + 4 * sw;
            const float4 old = k0 > k_begin && si < nq
                                   ? *reinterpret_cast<const float4*>(dq_word)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);

            if (warp < n_warps) {
                // each pair once: s, p, the keep bit, dp, ds; dV and dK of
                // the lane's keys; ds into shared memory for dQ
#pragma unroll 2
                for (int i = 0; i < nq; ++i) {
                    const float4 mt = sm.meta[i];
                    const float nl2 = mt.x, dd = mt.y;
                    const uint32_t ra = __float_as_uint(mt.z);
                    float qq[kW], g[kW];
                    unpack(sm.q[i], qq);
                    unpack(sm.g[i], g);
#pragma unroll
                    for (int r = 0; r < kKeys; ++r) {
                        float s = nl2;
#pragma unroll
                        for (int c = 0; c < kW; ++c)
                            s = fmaf(qq[c], kr[r][c], s);
                        const float p = exp2f(s);
                        float dp = kDrop ? 0.f : -dd;
#pragma unroll
                        for (int c = 0; c < kW; ++c)
                            dp = fmaf(g[c], v[r][c], dp);
                        float pk = p, ds;
                        if (kDrop) {
                            // mix32(row(q) ^ col(k)) from its second step:
                            // ra and cb carry the first
                            uint32_t x = (ra ^ cb[r]) * 0x7FEB352Du;
                            x ^= x >> 15;
                            x *= 0x846CA68Bu;
                            const float sc = x < keep_below ? keep_scale
                                                            : 0.f;
                            pk = p * sc;
                            ds = p * fmaf(dp, sc, -dd);
                        } else {
                            ds = p * dp;
                        }
#pragma unroll
                        for (int c = 0; c < kW; ++c) {
                            dv[r][c] = fmaf(pk, g[c], dv[r][c]);
                            dk[r][c] = fmaf(ds, qq[c], dk[r][c]);
                        }
                        sm.ds[warp][i][r * 32 + lane] = ds;
                    }
                }
                __syncwarp();
                // the warp's part of dQ: lane i, the stage's query i, sums
                // ds k over the warp's keys in slot order
                if (lane < nq) {
                    float acc[kW];
#pragma unroll
                    for (int c = 0; c < kW; ++c) acc[c] = 0.f;
                    const float* dsr = sm.ds[warp][lane];
#pragma unroll 4
                    for (int j = 0; j < n_keys; ++j) {
                        const float a = dsr[j];
                        float kk[kW];
                        unpack(sm.k[warp][j], kk);
#pragma unroll
                        for (int c = 0; c < kW; ++c)
                            acc[c] = fmaf(a, kk[c], acc[c]);
                    }
#pragma unroll
                    for (int w = 0; w < kV; ++w)
                        sm.part[warp][lane][w] =
                            make_float4(acc[4 * w], acc[4 * w + 1],
                                        acc[4 * w + 2], acc[4 * w + 3]);
                }
            }
            __syncthreads();      // every warp's partials are in
            // dQ = dQ so far + (1 / 4) (the warps' parts in warp order)
            if (si < nq) {
                float4 a = sm.part[0][si][sw];
                for (int ww = 1; ww < n_warps; ++ww) {
                    const float4 b = sm.part[ww][si][sw];
                    a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z,
                                    a.w + b.w);
                }
                *reinterpret_cast<float4*>(dq_word) = make_float4(
                    fmaf(a.x, kScale, old.x), fmaf(a.y, kScale, old.y),
                    fmaf(a.z, kScale, old.z), fmaf(a.w, kScale, old.w));
            }
        }

#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
            const int slot = r * 32 + lane;
            if (slot >= n_keys) continue;
            float* row = out_base + (k0 + warp * kWarpKeys + slot) * ld;
            // the staged q carry log2(e) / 4: dK = (1 / 4) sum ds q =
            // ln 2 sum ds q'
            store_row(row + d, dk[r], kLn2);
            store_row(row + 2 * d, dv[r], 1.f);
        }
    }

    // the unit's dQ = the first range's sums + the later ranges' in range
    // order, added by the range that finishes last
    if (!kSplit || used == 1 || !last_to_finish(tickets + uh, used)) return;
    const float* part = dq_part + static_cast<int64_t>(u.x) * d + h * kW;
    for (int i = t; i < n * kV; i += kBwdThreads) {
        const int r = i / kV, w = i % kV;
        float4* dst = reinterpret_cast<float4*>(out_base + r * ld) + w;
        float4 a = __ldcg(dst);
        for (int s = 1; s < used; ++s) {
            const float4 b = __ldcg(reinterpret_cast<const float4*>(
                part + ((s - 1) * n_rows + r) * d) + w);
            a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        }
        *dst = a;
    }
}

int check_grid(int64_t n_tiles, int heads) {
    if (n_tiles < 0 || n_tiles > 0x7FFFFFFF || heads <= 0 || heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
}

}  // namespace

// out [N, d] and lse [N, heads] from qkv [N, 3d] (d = 16 heads), tiles
// [n_tiles] int4 (r0, r1, u0, u1); seed one int64 on the device, read only
// with drop != 0.
extern "C" int gn_gps_attention_forward(int64_t n_tiles, int heads,
                                        const float* qkv, const int* tiles,
                                        const int64_t* seed, int layer,
                                        int drop, uint32_t keep_below,
                                        float keep_scale, float* out,
                                        float* lse, void* stream) {
    int rc = check_grid(n_tiles, heads);
    if (rc || n_tiles == 0) return rc;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(n_tiles), heads);
    const int4* tl = reinterpret_cast<const int4*>(tiles);
    if (drop)
        gps_attn_fwd_kernel<true><<<grid, kThreads, 0, st>>>(
            heads, qkv, tl, seed, layer, keep_below, keep_scale, out, lse);
    else
        gps_attn_fwd_kernel<false><<<grid, kThreads, 0, st>>>(
            heads, qkv, tl, seed, layer, keep_below, keep_scale, out, lse);
    return static_cast<int>(cudaGetLastError());
}

// d_qkv [N, 3d] from the forward's qkv, out, lse and d_out [N, d]; units
// [n_units] int2 (u0, u1), the non-empty units largest first; dvec [N, heads]
// scratch (D = rowsum(dO * O), written by the first kernel, read by the
// second); with splits > 1 key ranges a unit and head, dq_part
// [(splits - 1) N, d] and tickets [n_units * heads] scratch (null
// otherwise).
extern "C" int gn_gps_attention_backward(int64_t n_rows, int64_t n_units,
                                         int heads, int splits,
                                         const float* qkv,
                                         const int* units,
                                         const int64_t* seed, int layer,
                                         int drop, uint32_t keep_below,
                                         float keep_scale, const float* out,
                                         const float* d_out, const float* lse,
                                         float* dvec, float* d_qkv,
                                         float* dq_part, unsigned* tickets,
                                         void* stream) {
    if (n_rows < 0 || n_rows >= (int64_t{1} << 31) || n_units < 0
        || n_units > n_rows || heads <= 0 || heads > 65535 || splits <= 0
        || splits > 65535 || n_units * heads > 0x7FFFFFFF
        || n_units * heads * splits > 0x7FFFFFFF
        || (n_rows * heads + 255) / 256 > 0x7FFFFFFF
        || (splits > 1 && (!dq_part || !tickets)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_units == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t pairs = n_rows * heads;
    const int n_tickets = splits > 1 ? static_cast<int>(n_units * heads) : 0;
    gps_attn_bwd_rowdot_kernel<<<static_cast<unsigned>((pairs + 255) / 256),
                                 256, 0, st>>>(pairs, out, d_out, dvec,
                                               tickets, n_tickets);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
    const unsigned grid = static_cast<unsigned>(n_units * heads * splits);
    const int2* un = reinterpret_cast<const int2*>(units);
    const int smem = static_cast<int>(sizeof(BwdShared));
    auto kernel = drop ? (splits > 1 ? gps_attn_bwd_kernel<true, true>
                                     : gps_attn_bwd_kernel<true, false>)
                       : (splits > 1 ? gps_attn_bwd_kernel<false, true>
                                     : gps_attn_bwd_kernel<false, false>);
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (rc) return rc;
    kernel<<<grid, kBwdThreads, smem, st>>>(heads, splits, n_rows, qkv, un,
                                            seed, layer, keep_below,
                                            keep_scale, d_out, lse, dvec,
                                            d_qkv, dq_part, tickets);
    return static_cast<int>(cudaGetLastError());
}
