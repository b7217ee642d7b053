// The layer-norm edge stage of the unfused SymGatedGCN layer, forward and
// adjoint, for Hopper (sm_90a): the work between K1 and K2.
//
// Replaces no TPU kernel: the JAX package runs this stage as XLA
// elementwise ops between its K1 and K2 (gnnome_tpu/models/
// sym_gated_gcn.py:149-172, norm.py:111-115), which the port ran as ~15
// PyTorch launches forward and ~40 backward over [E, d] rows (a LayerNorm
// written out, relu, residual, sigmoid, two products, two concatenations,
// their adjoints, zero-filled slice gradients and two row gathers).
//
// Forward (ln_edge_stage_kernel), per edge row r of K1's output g3 = [gate
// | A2h[u] | A3h[v]] ([E, 3d]) and the edge state e ([E, d]):
//
//   mean  = sum(gate) / d,  var = sum((gate - mean)^2) / d       (two-pass)
//   rstd  = 1 / sqrt(var + eps)
//   y     = ((gate - mean) * rstd) * weight + bias              (LayerNorm)
//   e_out = relu(y) + e,  sigma = sigmoid(e_out)
//   pay_u = [sigma * A3h[v] | sigma],  pay_v = [sigma * A2h[u] | sigma]
//
// writing e_out [E, d], the two K2 payloads [E, 2d] and [mean, rstd]
// ([E, 2]).  The norm-free model (kNorm = false) takes y = gate.
//
// Adjoint (ln_edge_adjoint_kernel), per edge row, with du = d_sum_u[u] and
// dv = d_sum_v[v] gathered from K2's cotangents ([N, 2d], split [m | s]):
//
//   d_sigma = ((dv.m * A2h + dv.s) + du.m * A3h) + du.s    (K8's order)
//   d_e     = d_e_out + (d_sigma * sigma) * (1 - sigma)     (also the
//                                                            residual's)
//   d_y     = d_e where y > 0 (y recomputed from g3 and [mean, rstd] with
//             the forward's operations, so the mask is the forward's), else 0
//   xhat    = (gate - mean) * rstd,  g = d_y * weight
//   d_gate  = ((g - sum(g) / d) - xhat * (sum(g * xhat) / d)) * rstd
//
// writing K1's adjoint payloads [d_gate | sigma * dv.m] (summed into u by
// K2) and [d_gate | sigma * du.m] (into v) and d_e, and per block the
// float64 sums of d_y * xhat and d_y over its rows; ln_param_sums adds the
// block rows in a fixed order into d_weight and d_bias.  No atomics, so the
// adjoint is bitwise reproducible.  Norm-free: d_gate = d_e where gate > 0.
//
// Arithmetic: float32, every product and sum with a round-to-nearest
// intrinsic (no FMA contraction), the division and square root correctly
// rounded.  The row sums add each lane's features in order and then the
// lanes' sums by a butterfly, so they differ from torch.mean's order by
// rounding; every other operation is the plain version's
// (ops/kernels.py ln_edge_stage_plain, ln_edge_adjoint_plain).
//
// Bound: bytes.  The forward reads g3 and e (4 [E, d] float32 streams) and
// writes e_out and the payloads (5 streams) and 8 bytes a row; the adjoint
// reads g3, e_out, d_e_out and two gathered [2d] cotangent rows (9 streams)
// and writes the payloads and d_e (5 streams).  A few dozen operations an
// element.
//
// Design: a team of T lanes (a power of two, T <= 32) owns a row, each lane
// K vectors of V features (V = 4: one 16-byte word; V = 1 where d or a
// pointer does not allow it), so a row's sums are a shuffle inside the team
// and each lane keeps its features in registers between the two passes of
// the statistics.  At d = 64 a row is 16 lanes of float4, a warp two rows.
// All teams of a block step through rows together (a grid-stride loop over
// the block's base row), so every shuffle runs in a converged warp.  Edge
// streams are read and written evict-first (csr_walk.cuh vld_stream /
// vst_stream): each is touched once.  The adjoint's grid is capped at
// kAdjointBlocks (a multiple of the card's 132 SMs), a fixed number for a
// given row count, so its block sums, and their order, repeat.
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::Vec;

constexpr int kThreads = 256;
constexpr int kAdjointBlocks = 132 * 8;
constexpr int64_t kForwardBlocks = 1 << 20;

// Lanes and vectors of a row: K = vectors a lane, T = lanes a team
struct RowShape {
    int V, K, T;
};

inline RowShape row_shape(int d, int V) {
    const int vecs = (d + V - 1) / V;
    const int K = vecs <= 32 ? 1 : (vecs <= 64 ? 2 : (vecs <= 128 ? 4 : 0));
    int T = 1;
    if (K) {
        const int per = (vecs + K - 1) / K;
        while (T < per) T <<= 1;
    }
    return {V, K, T};
}

// the sum of s over the team's T lanes, the same bits in every lane (each
// butterfly step adds two values commutatively)
__device__ __forceinline__ float team_sum(float s, int T) {
    for (int o = T >> 1; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    return s;
}

// y = ((x - mean) * rstd) * w + b
__device__ __forceinline__ float ln_apply(float x, float mean, float rstd,
                                          float w, float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), w), b);
}

template <int V, int K>
struct Lane {
    int f[K];        // first feature of each vector
    bool on[K];      // vector inside the row
    __device__ __forceinline__ Lane(int lane, int T, int d) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            f[k] = (lane + T * k) * V;
            on[k] = f[k] < d;
        }
    }
};

template <int V, int K>
__device__ __forceinline__ void load_params(const Lane<V, K>& ln,
                                            const float* __restrict__ p,
                                            float (&out)[K][V]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) out[k][i] = ln.on[k] ? p[ln.f[k] + i] : 0.f;
}

template <int V, int K, bool kNorm>
__global__ void __launch_bounds__(kThreads)
ln_edge_stage_kernel(int64_t n_rows, int d, int T, float eps,
                     const float* __restrict__ g3,
                     const float* __restrict__ e_in,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     float* __restrict__ e_out, float* __restrict__ pay_u,
                     float* __restrict__ pay_v, float* __restrict__ stats) {
    const int teams = kThreads / T;
    const int team = threadIdx.x / T, lane = threadIdx.x % T;
    const Lane<V, K> ln(lane, T, d);
    float w[K][V], b[K][V];
    if constexpr (kNorm) {
        load_params(ln, weight, w);
        load_params(ln, bias, b);
    }
    const float fd = (float)d;
    for (int64_t base = (int64_t)blockIdx.x * teams; base < n_rows;
         base += (int64_t)gridDim.x * teams) {
        const int64_t r = base + team;
        const bool ok = r < n_rows;
        const float* row = g3 + r * 3 * d;
        Vec<V> x[K], a2[K], a3[K], e[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (ok && ln.on[k]) {
                x[k] = gn::vld_stream<V>(row + ln.f[k]);
                a2[k] = gn::vld_stream<V>(row + d + ln.f[k]);
                a3[k] = gn::vld_stream<V>(row + 2 * d + ln.f[k]);
                e[k] = gn::vld_stream<V>(e_in + r * d + ln.f[k]);
            } else {
                x[k] = gn::vzero<V>();
            }
        }
        float mean = 0.f, rstd = 1.f;
        if constexpr (kNorm) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
                for (int i = 0; i < V; ++i) s = __fadd_rn(s, x[k].a[i]);
            mean = __fdiv_rn(team_sum(s, T), fd);
            float q = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (!ln.on[k]) continue;
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const float c = __fsub_rn(x[k].a[i], mean);
                    q = __fadd_rn(q, __fmul_rn(c, c));
                }
            }
            const float var = __fdiv_rn(team_sum(q, T), fd);
            rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
        }
        if (!ok) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (!ln.on[k]) continue;
            Vec<V> eo, sg, pu, pv;
#pragma unroll
            for (int i = 0; i < V; ++i) {
                float y = x[k].a[i];
                if constexpr (kNorm)
                    y = ln_apply(y, mean, rstd, w[k][i], b[k][i]);
                const float o = __fadd_rn(y > 0.f ? y : 0.f, e[k].a[i]);
                const float s = gn::sigmoid_f32(o);
                eo.a[i] = o;
                sg.a[i] = s;
                pu.a[i] = __fmul_rn(s, a3[k].a[i]);
                pv.a[i] = __fmul_rn(s, a2[k].a[i]);
            }
            const int f = ln.f[k];
            gn::vst_stream<V>(e_out + r * d + f, eo);
            gn::vst_stream<V>(pay_u + r * 2 * d + f, pu);
            gn::vst_stream<V>(pay_u + r * 2 * d + d + f, sg);
            gn::vst_stream<V>(pay_v + r * 2 * d + f, pv);
            gn::vst_stream<V>(pay_v + r * 2 * d + d + f, sg);
        }
        if constexpr (kNorm) {
            if (lane == 0)
                __stcs(reinterpret_cast<float2*>(stats + 2 * r),
                       make_float2(mean, rstd));
        }
    }
}

template <int V, int K, bool kNorm>
__global__ void __launch_bounds__(kThreads)
ln_edge_adjoint_kernel(int64_t n_rows, int d, int T,
                       const int* __restrict__ u_idx,
                       const int* __restrict__ v_idx,
                       const float* __restrict__ d_sum_u,
                       const float* __restrict__ d_sum_v,
                       const float* __restrict__ g3,
                       const float* __restrict__ e_out,
                       const float* __restrict__ d_e_out,
                       const float* __restrict__ stats,
                       const float* __restrict__ weight,
                       const float* __restrict__ bias,
                       float* __restrict__ pay_u, float* __restrict__ pay_v,
                       float* __restrict__ d_e,
                       double* __restrict__ partials) {
    extern __shared__ double red[];               // [2d]: [sum d_y xhat | sum d_y]
    const int teams = kThreads / T;
    const int team = threadIdx.x / T, lane = threadIdx.x % T;
    const Lane<V, K> ln(lane, T, d);
    float w[K][V], b[K][V];
    double acc_w[K][V], acc_b[K][V];
    if constexpr (kNorm) {
        load_params(ln, weight, w);
        load_params(ln, bias, b);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < V; ++i) acc_w[k][i] = acc_b[k][i] = 0.0;
    }
    const float fd = (float)d;
    for (int64_t base = (int64_t)blockIdx.x * teams; base < n_rows;
         base += (int64_t)gridDim.x * teams) {
        const int64_t r = base + team;
        const bool ok = r < n_rows;
        Vec<V> x[K], a2[K], a3[K], eo[K], g[K], dum[K], dus[K], dvm[K],
            dvs[K];
        float2 ms = make_float2(0.f, 1.f);
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = gn::vzero<V>();
        if (ok) {
            const float* row = g3 + r * 3 * d;
            const float* du = d_sum_u + (int64_t)u_idx[r] * 2 * d;
            const float* dv = d_sum_v + (int64_t)v_idx[r] * 2 * d;
            if constexpr (kNorm)
                ms = __ldcs(reinterpret_cast<const float2*>(stats + 2 * r));
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (!ln.on[k]) continue;
                const int f = ln.f[k];
                x[k] = gn::vld_stream<V>(row + f);
                a2[k] = gn::vld_stream<V>(row + d + f);
                a3[k] = gn::vld_stream<V>(row + 2 * d + f);
                eo[k] = gn::vld_stream<V>(e_out + r * d + f);
                g[k] = gn::vld_stream<V>(d_e_out + r * d + f);
                dum[k] = gn::vld<V>(du + f);
                dus[k] = gn::vld<V>(du + d + f);
                dvm[k] = gn::vld<V>(dv + f);
                dvs[k] = gn::vld<V>(dv + d + f);
            }
        }
        const float mean = ms.x, rstd = ms.y;
        // per element, in place: d_e into g, the messages' adjoints into a2
        // and a3, xhat into x (kNorm); dx holds d_y * weight until the row
        // sums are in, then d_gate
        Vec<V> dx[K];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
                dx[k].a[i] = 0.f;
                if (!(ok && ln.on[k])) continue;
                const float sig = gn::sigmoid_f32(eo[k].a[i]);
                const float dsig = __fadd_rn(
                    __fadd_rn(__fadd_rn(__fmul_rn(dvm[k].a[i], a2[k].a[i]),
                                        dvs[k].a[i]),
                              __fmul_rn(dum[k].a[i], a3[k].a[i])),
                    dus[k].a[i]);
                const float de = __fadd_rn(
                    g[k].a[i],
                    __fmul_rn(__fmul_rn(dsig, sig), __fsub_rn(1.0f, sig)));
                g[k].a[i] = de;
                a2[k].a[i] = __fmul_rn(sig, dvm[k].a[i]);   // d A2h[u]
                a3[k].a[i] = __fmul_rn(sig, dum[k].a[i]);   // d A3h[v]
                const float xi = x[k].a[i];
                if constexpr (kNorm) {
                    const float xh = __fmul_rn(__fsub_rn(xi, mean), rstd);
                    const float y =
                        __fadd_rn(__fmul_rn(xh, w[k][i]), b[k][i]);
                    const float dy = y > 0.f ? de : 0.f;
                    const float gx = __fmul_rn(dy, w[k][i]);
                    s1 = __fadd_rn(s1, gx);
                    s2 = __fadd_rn(s2, __fmul_rn(gx, xh));
                    acc_w[k][i] += (double)__fmul_rn(dy, xh);
                    acc_b[k][i] += (double)dy;
                    x[k].a[i] = xh;
                    dx[k].a[i] = gx;
                } else {
                    dx[k].a[i] = xi > 0.f ? de : 0.f;
                }
            }
        }
        if constexpr (kNorm) {
            const float m1 = __fdiv_rn(team_sum(s1, T), fd);
            const float m2 = __fdiv_rn(team_sum(s2, T), fd);
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
                for (int i = 0; i < V; ++i)
                    dx[k].a[i] = __fmul_rn(
                        __fsub_rn(__fsub_rn(dx[k].a[i], m1),
                                  __fmul_rn(x[k].a[i], m2)),
                        rstd);
        }
        if (!ok) continue;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (!ln.on[k]) continue;
            const int f = ln.f[k];
            gn::vst_stream<V>(pay_u + r * 2 * d + f, dx[k]);
            gn::vst_stream<V>(pay_u + r * 2 * d + d + f, a2[k]);
            gn::vst_stream<V>(pay_v + r * 2 * d + f, dx[k]);
            gn::vst_stream<V>(pay_v + r * 2 * d + d + f, a3[k]);
            gn::vst_stream<V>(d_e + r * d + f, g[k]);
        }
    }
    if constexpr (kNorm) {
        // the block's sums: its teams' sums added in team order
        for (int t = 0; t < teams; ++t) {
            if (team == t) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    if (!ln.on[k]) continue;
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const int f = ln.f[k] + i;
                        red[f] = t ? red[f] + acc_w[k][i] : acc_w[k][i];
                        red[d + f] = t ? red[d + f] + acc_b[k][i]
                                       : acc_b[k][i];
                    }
                }
            }
            __syncthreads();
        }
        for (int j = threadIdx.x; j < 2 * d; j += kThreads)
            partials[(int64_t)blockIdx.x * 2 * d + j] = red[j];
    }
}

// out[j] = sum over b of partials[b * width + j] in a fixed order, rounded
// once to float32: a block of 8 x 32 threads per 32 columns; row r adds b =
// r, r + 8, ... in order, then the 8 row sums are added in row order
__global__ void __launch_bounds__(256)
ln_param_sums(int n_parts, int width, const double* __restrict__ partials,
              float* __restrict__ out) {
    __shared__ double rows[8][32];
    const int c = threadIdx.x & 31, r = threadIdx.x >> 5;
    const int j = blockIdx.x * 32 + c;
    double acc = 0.0;
    if (j < width) {
#pragma unroll 8
        for (int b = r; b < n_parts; b += 8)
            acc += partials[(int64_t)b * width + j];
    }
    rows[r][c] = acc;
    __syncthreads();
    if (r == 0 && j < width) {
        double s = 0.0;
        for (int k = 0; k < 8; ++k) s += rows[k][c];
        out[j] = (float)s;
    }
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
    for (const void* p : ptrs)
        if ((uintptr_t)p % 16) return false;
    return true;
}

int adjoint_blocks(int64_t n_rows, int teams) {
    const int64_t want = (n_rows + teams - 1) / teams;
    return (int)(want < kAdjointBlocks ? want : kAdjointBlocks);
}

template <int V, int K, bool kNorm>
int launch_stage(int64_t n_rows, int d, int T, float eps, const float* g3,
                 const float* e_in, const float* weight, const float* bias,
                 float* e_out, float* pay_u, float* pay_v, float* stats,
                 cudaStream_t st) {
    const int64_t want = (n_rows + kThreads / T - 1) / (kThreads / T);
    const int grid = (int)(want < kForwardBlocks ? want : kForwardBlocks);
    ln_edge_stage_kernel<V, K, kNorm><<<grid, kThreads, 0, st>>>(
        n_rows, d, T, eps, g3, e_in, weight, bias, e_out, pay_u, pay_v,
        stats);
    return (int)cudaGetLastError();
}

template <int V, int K, bool kNorm>
int launch_adjoint(int64_t n_rows, int d, int T, const int* u_idx,
                   const int* v_idx, const float* d_sum_u,
                   const float* d_sum_v, const float* g3, const float* e_out,
                   const float* d_e_out, const float* stats,
                   const float* weight, const float* bias, float* pay_u,
                   float* pay_v, float* d_e, double* partials, float* d_wb,
                   cudaStream_t st) {
    const int grid = adjoint_blocks(n_rows, kThreads / T);
    const size_t smem = kNorm ? 2 * (size_t)d * sizeof(double) : 0;
    ln_edge_adjoint_kernel<V, K, kNorm><<<grid, kThreads, smem, st>>>(
        n_rows, d, T, u_idx, v_idx, d_sum_u, d_sum_v, g3, e_out, d_e_out,
        stats, weight, bias, pay_u, pay_v, d_e, partials);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess || !kNorm) return (int)rc;
    ln_param_sums<<<(2 * d + 31) / 32, 256, 0, st>>>(grid, 2 * d, partials,
                                                     d_wb);
    return (int)cudaGetLastError();
}

// Calls CALL(V, K, kNorm) with the row shape rs and the norm flag as
// template arguments; an unsupported shape returns cudaErrorInvalidValue.
#define GN_LN_SHAPE(V_, K_, CALL)                                      \
    if (rs.V == V_ && rs.K == K_)                                      \
        return norm ? CALL(V_, K_, true) : CALL(V_, K_, false);
#define GN_LN_DISPATCH(CALL)                                           \
    GN_LN_SHAPE(4, 1, CALL)                                            \
    GN_LN_SHAPE(4, 2, CALL)                                            \
    GN_LN_SHAPE(4, 4, CALL)                                            \
    GN_LN_SHAPE(1, 1, CALL)                                            \
    GN_LN_SHAPE(1, 2, CALL)                                            \
    GN_LN_SHAPE(1, 4, CALL)                                            \
    return (int)cudaErrorInvalidValue;

}  // namespace

// e_out [n_rows, d], pay_u / pay_v [n_rows, 2d] and stats [n_rows, 2] from
// g3 [n_rows, 3d] and e_in [n_rows, d]; weight == bias == null: the
// norm-free stage (stats unwritten).  Every array float32, contiguous; d
// at most 512 (128 lane words a row; 128 where d % 4 != 0).
extern "C" int gn_ln_edge_stage(int64_t n_rows, int d, float eps,
                                const float* g3, const float* e_in,
                                const float* weight, const float* bias,
                                float* e_out, float* pay_u, float* pay_v,
                                float* stats, void* stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    if (d <= 0) return (int)cudaErrorInvalidValue;
    const bool vec = d % 4 == 0
                     && aligned16({g3, e_in, e_out, pay_u, pay_v});
    const RowShape rs = row_shape(d, vec ? 4 : 1);
    const bool norm = weight != nullptr;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_LN_STAGE(V_, K_, N_)                                           \
    launch_stage<V_, K_, N_>(n_rows, d, rs.T, eps, g3, e_in, weight, bias, \
                             e_out, pay_u, pay_v, stats, st)
    GN_LN_DISPATCH(GN_LN_STAGE)
#undef GN_LN_STAGE
}

// Rows enough for the adjoint's float64 partials ([rows, 2d]) for n_rows
// edges: its grid, whose teams are at most 32 lanes, at most this.
extern "C" int gn_ln_edge_adjoint_blocks(int64_t n_rows) {
    return adjoint_blocks(n_rows, kThreads / 32);
}

// pay_u, pay_v [n_rows, 2d] and d_e [n_rows, d]; with weight and bias (the
// layer-norm stage) also d_wb [2, d] = [d_weight | d_bias] through
// partials [gn_ln_edge_adjoint_blocks, 2d] float64.  u_idx, v_idx [n_rows]
// int32; d_sum_u, d_sum_v [N, 2d]; every array contiguous; d as for
// gn_ln_edge_stage.
extern "C" int gn_ln_edge_adjoint(int64_t n_rows, int d, const int* u_idx,
                                  const int* v_idx, const float* d_sum_u,
                                  const float* d_sum_v, const float* g3,
                                  const float* e_out, const float* d_e_out,
                                  const float* stats, const float* weight,
                                  const float* bias, float* pay_u,
                                  float* pay_v, float* d_e, double* partials,
                                  float* d_wb, void* stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    if (d <= 0) return (int)cudaErrorInvalidValue;
    const bool vec = d % 4 == 0
                     && aligned16({d_sum_u, d_sum_v, g3, e_out, d_e_out,
                                   pay_u, pay_v, d_e});
    const RowShape rs = row_shape(d, vec ? 4 : 1);
    const bool norm = weight != nullptr;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_LN_ADJOINT(V_, K_, N_)                                          \
    launch_adjoint<V_, K_, N_>(n_rows, d, rs.T, u_idx, v_idx, d_sum_u,     \
                               d_sum_v, g3, e_out, d_e_out, stats, weight, \
                               bias, pay_u, pay_v, d_e, partials, d_wb, st)
    GN_LN_DISPATCH(GN_LN_ADJOINT)
#undef GN_LN_ADJOINT
}
