// The GAT layer's work around its one-sided K2 walks, forward and adjoint,
// for Hopper (sm_90a): everything of a GATConv after its fc but the walks.
//
// Replaces no TPU kernel: the JAX package runs the GATConv's attention,
// edge softmax and messages as XLA ops around its segment sums
// (gnnome_tpu/models/zoo.py:255-282), which the port ran as ~30 PyTorch
// launches a layer over [N, H d], [E', H] and [E', H d] rows (the
// attention's products and sums, two row gathers of el / er, LeakyReLU, a
// scatter_reduce max, its gather, exp, the denominators' gather, clamp and
// divide, the gather of feat[src], the weighting) and about as many in the
// backward, and for which autograd kept the gathered feat[src] ([E', H d])
// of every layer.  The walks between these kernels stay K2's one-sided
// entry (csrc/k2_aggregate.cu gn_k2_side_sum), six a layer.
//
// Per node n and slot s of the processor graph (dst-sorted, as
// DeviceGraph.roles lists it), with u = src(s), v = dst(s), head h of H,
// width d a head, feat [N, H d] the heads side by side:
//
//   forward
//   gat_node_logits_kernel    el[n, h] = <feat[n, h], attn_l[h]>, er alike
//   gat_edge_softmax_kernel   x_sh   = leaky(el[u, h] + er[v, h])   (0.2)
//                             m_vh   = max over v's in-slots of x    (exact)
//                             expv_sh = exp(x_sh - m_vh)
//   (walk 1, width H)         D[v]   = sum over v's in-slots of expv
//   gat_messages_kernel       alpha_sh = expv_sh / max(D[v, h], 1e-9)
//                             msg_s  = alpha_sh * feat[u, h]
//   (walk 2, width H d)       out[v] = sum over v's in-slots of msg
//
//   backward, from g = d_out ([N, H d])
//   gat_message_adjoint_kernel  d_feat_s = alpha_sh * g[v, h]    ([E', H d])
//                             d_alpha_sh = <g[v, h], feat[u, h]>
//                             Dc         = max(D[v, h], 1e-9)
//                             d_expv_sh  = d_alpha_sh / Dc
//                             pay_sh     = -d_alpha_sh * (alpha_sh / Dc)
//                                          where D[v, h] >= 1e-9, else 0
//   (walk 3, width H d, into src: M; walk 4, width H, into dst: d_D)
//   gat_logit_adjoint_kernel  d_x_sh = (d_expv_sh + d_D[v, h]) * expv_sh
//                                      * leaky'(el[u, h] + er[v, h])
//   (walks 5 and 6, width H: d_x into src is d_el, into dst d_er)
//   gat_node_adjoint_kernel   d_feat[n, h] = M[n, h] + (d_el[n, h] attn_l[h]
//                                                   + d_er[n, h] attn_r[h])
//                             d_attn_l[h] = sum over n of d_el[n, h] *
//                             feat[n, h], d_attn_r alike (float64 block
//                             sums, then edge_math.cuh reduce_partials)
//
// the chain rule of the PyTorch chain they replace (models/zoo.py before
// this file; the max detached, its gradient left out), in its operations:
// the division's adjoint is autograd's -grad * ((a / b) / b), the clamp's
// passes where D >= 1e-9, LeakyReLU's takes the slope where x <= 0.
//
// Arithmetic: float32, every product and sum with a round-to-nearest
// intrinsic (no FMA contraction), the division correctly rounded, expf (not
// __expf).  Each result is the plain version's (ops/kernels.py
// gat_*_plain), bit for bit, but for the dot products (el, er, d_alpha),
// which add a lane's features in order and then the lanes' sums by a
// butterfly (torch.sum adds in another order), exp, which may differ by an
// ulp, and the attention vectors' gradients, summed in float64 and rounded
// once (the plain version sums in float32).  No atomics, and the node
// adjoint's grid is a fixed function of N: a launch repeats bit for bit.
//
// Bound: bytes.  The message kernel reads feat[u] (gathered a slot at a
// time: E' rows of H d) and writes msg; the message adjoint reads g[v] (the
// same row for a dst segment's consecutive slots, so after the first from
// L1 or L2) and feat[u] and writes d_feat_s; each also an [E', H] or two and
// the slot's indices.  The node kernels stream feat (and M, d_feat) once;
// the softmax and logit adjoint move only [E', H] rows and gathered [H]
// rows, ~1/30 of a row kernel's bytes.
//
// Design.  The row kernels (and the node logits) give each head of a slot
// (of a node) a group of G lanes (G a power of two, the least that covers
// the head's d / V vectors, at most 32), each lane V = 4 features a vector
// (a float4; V = 1 where d or a pointer does not allow it), so at d = 64 a
// slot is 3 groups of 16 lanes and consecutive lanes touch consecutive 16
// bytes of one row.  The groups lie aligned in warps, so a dot product is
// a shuffle inside the group; no lane leaves before it.  The softmax
// kernel walks each dst's CSR segment with a team of 8 lanes (csr_walk.cuh
// Team), a slot a lane, the max a shuffle; long segments (hubs) loop over
// chunks of 8 slots.  The logit adjoint is one thread a (slot, head).  The
// node adjoint gives a thread one column word and strides it over the
// nodes, keeping its float64 sums in registers.  Streams read or written
// once go evict-first (csr_walk.cuh vld_stream / vst_stream).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::Vec;

constexpr int kThreads = 256;
constexpr int kSoftmaxTeam = 8;
constexpr float kSlope = 0.2f;        // LeakyReLU's negative slope
constexpr float kDenomMin = 1e-9f;    // the denominators' clamp
constexpr int kNodeBlocks = 132 * 8;  // the node adjoint's grid, at most

__device__ __forceinline__ float leaky(float x) {
    return x > 0.0f ? x : __fmul_rn(x, kSlope);
}

// ---- forward: the edge softmax's numerators
__global__ void __launch_bounds__(kThreads)
gat_edge_softmax_kernel(int n_nodes, int heads, const int* __restrict__ ptr,
                        const int* __restrict__ src,
                        const float* __restrict__ el,
                        const float* __restrict__ er,
                        float* __restrict__ expv) {
    constexpr int T = kSoftmaxTeam;
    const gn::Team<T> tm;
    if (tm.node >= n_nodes) return;           // the whole team leaves
    const int beg = ptr[tm.node], end = ptr[tm.node + 1];
    for (int h = 0; h < heads; ++h) {
        const float r = er[(int64_t)tm.node * heads + h];
        float m = -INFINITY;
        for (int s = beg + tm.lane; s < end; s += T)
            m = fmaxf(m, leaky(__fadd_rn(el[(int64_t)src[s] * heads + h], r)));
#pragma unroll
        for (int o = T / 2; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(tm.mask, m, o, T));
        for (int s = beg + tm.lane; s < end; s += T) {
            const float x = leaky(__fadd_rn(el[(int64_t)src[s] * heads + h],
                                            r));
            expv[(int64_t)s * heads + h] = expf(__fsub_rn(x, m));
        }
    }
}

// A row kernel's lane: (slot, head) pair sh = s * heads + h and lane j < G
// of its group; live = false past the last slot
struct RowLane {
    int64_t sh, s;
    int h, j;
    bool live;
    __device__ __forceinline__ RowLane(int64_t n_pairs, int heads, int g_log2) {
        const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
        sh = t >> g_log2;
        j = (int)(t & ((1 << g_log2) - 1));
        live = sh < n_pairs;
        s = sh / heads;
        h = (int)(sh - s * heads);
    }
};

// ---- forward: alpha and the messages
template <int V>
__global__ void __launch_bounds__(kThreads)
gat_messages_kernel(int64_t n_pairs, int heads, int d, int g_log2,
                    const int* __restrict__ src, const int* __restrict__ dst,
                    const float* __restrict__ feat,
                    const float* __restrict__ expv,
                    const float* __restrict__ denom, float* __restrict__ msg,
                    float* __restrict__ alpha) {
    const RowLane ln(n_pairs, heads, g_log2);
    if (!ln.live) return;
    const int64_t w = (int64_t)heads * d;
    const float D = denom[(int64_t)dst[ln.s] * heads + ln.h];
    const float a = __fdiv_rn(expv[ln.sh], fmaxf(D, kDenomMin));
    if (ln.j == 0) gn::vst_stream<1>(alpha + ln.sh, Vec<1>{{a}});
    const float* f = feat + (int64_t)src[ln.s] * w + ln.h * d;
    float* o = msg + ln.s * w + ln.h * d;
    for (int c = ln.j * V; c < d; c += V << g_log2) {
        Vec<V> x = gn::vld<V>(f + c);
#pragma unroll
        for (int i = 0; i < V; ++i) x.a[i] = __fmul_rn(x.a[i], a);
        gn::vst_stream<V>(o + c, x);
    }
}

// ---- backward: the messages' adjoint
template <int V>
__global__ void __launch_bounds__(kThreads)
gat_message_adjoint_kernel(int64_t n_pairs, int heads, int d, int g_log2,
                           const int* __restrict__ src,
                           const int* __restrict__ dst,
                           const float* __restrict__ d_out,
                           const float* __restrict__ feat,
                           const float* __restrict__ alpha,
                           const float* __restrict__ denom,
                           float* __restrict__ d_feat,
                           float* __restrict__ d_expv,
                           float* __restrict__ pay) {
    const RowLane ln(n_pairs, heads, g_log2);
    const int64_t w = (int64_t)heads * d;
    float dot = 0.0f, a = 0.0f;
    int64_t vh = 0;
    if (ln.live) {
        a = alpha[ln.sh];
        vh = (int64_t)dst[ln.s] * heads + ln.h;
        const float* g = d_out + (int64_t)dst[ln.s] * w + ln.h * d;
        const float* f = feat + (int64_t)src[ln.s] * w + ln.h * d;
        float* o = d_feat + ln.s * w + ln.h * d;
        for (int c = ln.j * V; c < d; c += V << g_log2) {
            Vec<V> gv = gn::vld<V>(g + c);
            const Vec<V> fv = gn::vld<V>(f + c);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                dot = __fadd_rn(dot, __fmul_rn(gv.a[i], fv.a[i]));
                gv.a[i] = __fmul_rn(gv.a[i], a);
            }
            gn::vst_stream<V>(o + c, gv);
        }
    }
    // the group's lanes lie aligned inside one warp, and every lane of the
    // warp reaches this point
    for (int o = (1 << g_log2) >> 1; o > 0; o >>= 1)
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
    if (!ln.live || ln.j != 0) return;
    const float D = denom[vh];
    const float dc = fmaxf(D, kDenomMin);
    gn::vst_stream<1>(d_expv + ln.sh, Vec<1>{{__fdiv_rn(dot, dc)}});
    gn::vst_stream<1>(pay + ln.sh, Vec<1>{{
        D >= kDenomMin ? __fmul_rn(-dot, __fdiv_rn(a, dc)) : 0.0f}});
}

// ---- backward: the logits' adjoint
__global__ void __launch_bounds__(kThreads)
gat_logit_adjoint_kernel(int64_t n_pairs, int heads,
                         const int* __restrict__ src,
                         const int* __restrict__ dst,
                         const float* __restrict__ el,
                         const float* __restrict__ er,
                         const float* __restrict__ expv,
                         const float* __restrict__ d_expv,
                         const float* __restrict__ d_denom,
                         float* __restrict__ d_x) {
    const int64_t sh = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (sh >= n_pairs) return;
    const int64_t s = sh / heads;
    const int h = (int)(sh - s * heads);
    const int64_t vh = (int64_t)dst[s] * heads + h;
    const float x = __fadd_rn(el[(int64_t)src[s] * heads + h], er[vh]);
    const float de = __fmul_rn(__fadd_rn(d_expv[sh], d_denom[vh]), expv[sh]);
    d_x[sh] = x > 0.0f ? de : __fmul_rn(de, kSlope);
}

// ---- forward: el and er, the attention's node halves
template <int V>
__global__ void __launch_bounds__(kThreads)
gat_node_logits_kernel(int64_t n_pairs, int heads, int d, int g_log2,
                       const float* __restrict__ feat,
                       const float* __restrict__ attn_l,
                       const float* __restrict__ attn_r,
                       float* __restrict__ el, float* __restrict__ er) {
    const RowLane ln(n_pairs, heads, g_log2);     // s: the node
    float sl = 0.0f, sr = 0.0f;
    if (ln.live) {
        const float* f = feat + ln.s * heads * d + ln.h * d;
        for (int c = ln.j * V; c < d; c += V << g_log2) {
            const Vec<V> fv = gn::vld<V>(f + c);
            const Vec<V> al = gn::vld<V>(attn_l + ln.h * d + c);
            const Vec<V> ar = gn::vld<V>(attn_r + ln.h * d + c);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                sl = __fadd_rn(sl, __fmul_rn(fv.a[i], al.a[i]));
                sr = __fadd_rn(sr, __fmul_rn(fv.a[i], ar.a[i]));
            }
        }
    }
    for (int o = (1 << g_log2) >> 1; o > 0; o >>= 1) {
        sl = __fadd_rn(sl, __shfl_xor_sync(0xffffffffu, sl, o));
        sr = __fadd_rn(sr, __shfl_xor_sync(0xffffffffu, sr, o));
    }
    if (ln.live && ln.j == 0) {
        el[ln.sh] = sl;
        er[ln.sh] = sr;
    }
}

// ---- backward: feat's gradient through el and er, and the attention
// vectors'.  A thread owns one word of columns of a chunk of `chunk` words
// and rows r, r + R, ... of the block's share (R = kThreads / chunk rows a
// step, the grid striding over the nodes); its float64 sums of d_el * feat
// and d_er * feat stay in registers, and the block adds its rows' sums in a
// fixed order (edge_math.cuh block_partials), reduce_partials the blocks'.
template <int V>
__global__ void __launch_bounds__(kThreads)
gat_node_adjoint_kernel(int n_nodes, int heads, int d, int chunk,
                        const float* __restrict__ feat,
                        const float* __restrict__ attn_l,
                        const float* __restrict__ attn_r,
                        const float* __restrict__ d_el,
                        const float* __restrict__ d_er,
                        const float* __restrict__ acc,
                        float* __restrict__ d_feat,
                        double* __restrict__ partials) {
    __shared__ double red[kThreads * 2 * 4];
    const int w_all = heads * d;
    const int words = w_all / V, R = kThreads / chunk;
    const int r = threadIdx.x / chunk, wl = threadIdx.x % chunk;
    const int w = blockIdx.y * chunk + wl;
    const int cw = chunk * V;
    double sl[V], sr[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sl[i] = sr[i] = 0.0;
    if (r < R && w < words) {
        const int f0 = w * V, h = f0 / d;
        const Vec<V> al = gn::vld<V>(attn_l + f0);
        const Vec<V> ar = gn::vld<V>(attn_r + f0);
        for (int64_t n = (int64_t)blockIdx.x * R + r; n < n_nodes;
             n += (int64_t)gridDim.x * R) {
            const float gl = d_el[n * heads + h], gr = d_er[n * heads + h];
            const Vec<V> fv = gn::vld_stream<V>(feat + n * w_all + f0);
            Vec<V> o = gn::vld_stream<V>(acc + n * w_all + f0);
#pragma unroll
            for (int i = 0; i < V; ++i) {
                o.a[i] = __fadd_rn(o.a[i], __fadd_rn(__fmul_rn(gl, al.a[i]),
                                                     __fmul_rn(gr, ar.a[i])));
                sl[i] += (double)gl * (double)fv.a[i];
                sr[i] += (double)gr * (double)fv.a[i];
            }
            gn::vst_stream<V>(d_feat + n * w_all + f0, o);
        }
    }
    if (r < R) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            red[r * 2 * cw + wl * V + i] = sl[i];
            red[r * 2 * cw + cw + wl * V + i] = sr[i];
        }
    }
    gn::block_partials(red, R, cw, blockIdx.y * cw, w_all, partials);
}

// log2 of the group a head takes: the least power of two of lanes that
// covers its d / V vectors, at most 32
inline int group_log2(int d, int v) {
    const int vecs = (d + v - 1) / v;
    int g = 0;
    while ((1 << g) < vecs && g < 5) ++g;
    return g;
}

inline unsigned blocks_for(int64_t threads) {
    return (unsigned)((threads + kThreads - 1) / kThreads);
}

inline bool too_many(int64_t threads) {
    return (threads + kThreads - 1) / kThreads > 0x7fffffff;
}

}  // namespace

// expv [E, heads] from the dst-side row pointers ptr [n_nodes + 1], src
// [E] and el, er [*, heads]; every array contiguous
extern "C" int gn_gat_edge_softmax(int n_nodes, int heads, const int* ptr,
                                   const int* src, const float* el,
                                   const float* er, float* expv,
                                   void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    if (heads <= 0) return (int)cudaErrorInvalidValue;
    constexpr int per_block = kThreads / kSoftmaxTeam;
    gat_edge_softmax_kernel<<<(n_nodes + per_block - 1) / per_block,
                              kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        n_nodes, heads, ptr, src, el, er, expv);
    return (int)cudaGetLastError();
}

// msg [E, heads * d] and alpha [E, heads] from feat [*, heads * d], expv [E,
// heads] and denom [N, heads]; every array contiguous
extern "C" int gn_gat_messages(int64_t n_slots, int heads, int d,
                               const int* src, const int* dst,
                               const float* feat, const float* expv,
                               const float* denom, float* msg, float* alpha,
                               void* stream) {
    if (n_slots <= 0) return (int)cudaSuccess;
    if (heads <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const int v = d % 4 == 0 && gn::rows_vec<float>({feat, msg}, {}) ? 4 : 1;
    const int gl = group_log2(d, v);
    const int64_t pairs = n_slots * heads, threads = pairs << gl;
    if (too_many(threads)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (v == 4)
        gat_messages_kernel<4><<<blocks_for(threads), kThreads, 0, st>>>(
            pairs, heads, d, gl, src, dst, feat, expv, denom, msg, alpha);
    else
        gat_messages_kernel<1><<<blocks_for(threads), kThreads, 0, st>>>(
            pairs, heads, d, gl, src, dst, feat, expv, denom, msg, alpha);
    return (int)cudaGetLastError();
}

// d_feat [E, heads * d], d_expv and pay [E, heads] from d_out [N, heads *
// d], feat [*, heads * d], alpha [E, heads] and denom [N, heads]; every
// array contiguous
extern "C" int gn_gat_message_adjoint(int64_t n_slots, int heads, int d,
                                      const int* src, const int* dst,
                                      const float* d_out, const float* feat,
                                      const float* alpha, const float* denom,
                                      float* d_feat, float* d_expv,
                                      float* pay, void* stream) {
    if (n_slots <= 0) return (int)cudaSuccess;
    if (heads <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const int v = d % 4 == 0
                  && gn::rows_vec<float>({d_out, feat, d_feat}, {}) ? 4 : 1;
    const int gl = group_log2(d, v);
    const int64_t pairs = n_slots * heads, threads = pairs << gl;
    if (too_many(threads)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (v == 4)
        gat_message_adjoint_kernel<4><<<blocks_for(threads), kThreads, 0,
                                         st>>>(
            pairs, heads, d, gl, src, dst, d_out, feat, alpha, denom, d_feat,
            d_expv, pay);
    else
        gat_message_adjoint_kernel<1><<<blocks_for(threads), kThreads, 0,
                                         st>>>(
            pairs, heads, d, gl, src, dst, d_out, feat, alpha, denom, d_feat,
            d_expv, pay);
    return (int)cudaGetLastError();
}

// d_x [E, heads] from el, er [*, heads], expv and d_expv [E, heads] and
// d_denom [N, heads]; every array contiguous
extern "C" int gn_gat_logit_adjoint(int64_t n_slots, int heads,
                                    const int* src, const int* dst,
                                    const float* el, const float* er,
                                    const float* expv, const float* d_expv,
                                    const float* d_denom, float* d_x,
                                    void* stream) {
    if (n_slots <= 0) return (int)cudaSuccess;
    if (heads <= 0) return (int)cudaErrorInvalidValue;
    const int64_t pairs = n_slots * heads;
    if (too_many(pairs)) return (int)cudaErrorInvalidValue;
    gat_logit_adjoint_kernel<<<blocks_for(pairs), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        pairs, heads, src, dst, el, er, expv, d_expv, d_denom, d_x);
    return (int)cudaGetLastError();
}

// el, er [N, heads] from feat [N, heads * d] and attn_l, attn_r [heads, d];
// every array contiguous
extern "C" int gn_gat_node_logits(int64_t n_nodes, int heads, int d,
                                  const float* feat, const float* attn_l,
                                  const float* attn_r, float* el, float* er,
                                  void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    if (heads <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const int v = d % 4 == 0
                  && gn::rows_vec<float>({feat, attn_l, attn_r}, {}) ? 4 : 1;
    const int gl = group_log2(d, v);
    const int64_t pairs = n_nodes * heads, threads = pairs << gl;
    if (too_many(threads)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (v == 4)
        gat_node_logits_kernel<4><<<blocks_for(threads), kThreads, 0, st>>>(
            pairs, heads, d, gl, feat, attn_l, attn_r, el, er);
    else
        gat_node_logits_kernel<1><<<blocks_for(threads), kThreads, 0, st>>>(
            pairs, heads, d, gl, feat, attn_l, attn_r, el, er);
    return (int)cudaGetLastError();
}

// Rows of the float64 partials [rows, 2 * heads * d] the node adjoint of
// n_nodes nodes takes: a fixed number for a given node count, so its block
// sums, and their order, repeat.
extern "C" int gn_gat_node_adjoint_blocks(int n_nodes) {
    const int blocks = (n_nodes + 7) / 8;
    return blocks < 1 ? 1 : (blocks < kNodeBlocks ? blocks : kNodeBlocks);
}

// d_feat = acc + d_el (x) attn_l + d_er (x) attn_r ([N, heads * d]) and
// d_attn = [sum d_el * feat | sum d_er * feat] over the nodes ([2 * heads *
// d], float64) through partials [gn_gat_node_adjoint_blocks, 2 * heads * d];
// every array contiguous
extern "C" int gn_gat_node_adjoint(int n_nodes, int heads, int d,
                                   const float* feat, const float* attn_l,
                                   const float* attn_r, const float* d_el,
                                   const float* d_er, const float* acc,
                                   float* d_feat, double* partials,
                                   double* d_attn, void* stream) {
    if (n_nodes <= 0) return (int)cudaSuccess;
    if (heads <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const int v = d % 4 == 0
                  && gn::rows_vec<float>({feat, attn_l, attn_r, acc, d_feat},
                                         {}) ? 4 : 1;
    const int words = heads * d / v;
    const int chunk = words < kThreads ? words : kThreads;
    const int chunks = (words + chunk - 1) / chunk;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(gn_gat_node_adjoint_blocks(n_nodes), chunks);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (v == 4)
        gat_node_adjoint_kernel<4><<<grid, kThreads, 0, st>>>(
            n_nodes, heads, d, chunk, feat, attn_l, attn_r, d_el, d_er, acc,
            d_feat, partials);
    else
        gat_node_adjoint_kernel<1><<<grid, kThreads, 0, st>>>(
            n_nodes, heads, d, chunk, feat, attn_l, attn_r, d_el, d_er, acc,
            d_feat, partials);
    int rc = (int)cudaGetLastError();
    if (rc != (int)cudaSuccess) return rc;
    gn::launch_reduce_partials(grid.x, 2 * heads * d, partials, d_attn, st);
    return (int)cudaGetLastError();
}
