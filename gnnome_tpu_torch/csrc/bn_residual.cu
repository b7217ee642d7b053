// The residual training-mode BatchNorm y = BN(a + b) of the Graph
// Transformer layer (models/zoo.py _GTLayer, four a layer), forward and
// backward, float32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the model has no JAX counterpart.  The port ran it
// as models/norm.py batch_norm_train over a + b, which autograd turns into
// ~46 PyTorch passes over the [rows, d] rows a call, forward and backward,
// and three saved [rows, d] tensors.  Here (ops/kernels.py bn_residual_*,
// one autograd Function models/norm.py residual_batch_norm):
//
//   forward   bn_residual_stats_kernel      x = a + b (written: the one
//                                           saved [rows, d] tensor) and
//                                           each block's per-column
//                                           (count, mean, M2)
//             bn_residual_finish_kernel     the blocks merged in a fixed
//                                           order: [mean | rsqrt(var + eps)]
//                                           (var biased), the running
//                                           statistics (unbiased variance,
//                                           momentum) and num_batches_tracked
//             bn_residual_normalise_kernel  y = ((x - mean) * inv) * w + b
//   backward  bn_residual_grad_sums_kernel  each block's float64 sums of g
//                                           and g * xhat per column
//             reduce_partials               the blocks' sums in a fixed
//                                           order (edge_math.cuh, as K8's
//                                           and the GAT's)
//             bn_residual_dx_kernel         dx = (w * inv) * ((g - mean(g))
//                                           - xhat * mean(g xhat)), the
//                                           gradient of a and of b; its
//                                           first blocks write d_weight =
//                                           sum g xhat and d_bias = sum g
//
// with xhat = (x - mean) * inv, each float32 product and sum rounded to
// nearest (no FMA contraction), in the order of the plain versions
// (ops/kernels.py bn_residual_forward_plain / bn_residual_backward_plain):
// given the same statistics, x, y and dx are theirs bit for bit; the
// statistics and sums differ from them by rounding (float64 here, float32
// there).
//
// Variance: a thread keeps float64 sums of (x - k) and (x - k)^2 over its
// rows, k its own first x (the shifted-data form: k lies within the data,
// so nothing cancels beyond a few digits of float64), and turns them into
// its (count, mean, M2); the block merges its threads' and the finisher the
// blocks' by Chan's formula, mean = sum(c m) / C, M2 = sum(M2_b + c (m -
// mean)^2), each in a fixed order.  No atomics: the sums, and so the
// step, repeat bit for bit.
//
// Bound: bytes.  Forward: a and b read, x and y written, four [rows, d]
// streams at least; the kernels move five (x is read back once the
// statistics are known).  Backward: g and x read, dx written, three at
// least; the kernels move five (g and x are read again once the sums are
// known).  At the cell's sizes neither x nor g fits in the 50 MB L2.  The
// [d] vectors and the partials (400 KB at d = 64) are small beside them.
//
// Design: a thread owns one 16-byte word of columns (four floats; one float
// where d is not a multiple of 4 or a row is not 16-byte aligned), so its
// column parameters stay in registers; a block of 256 threads covers 256 /
// (words a row) consecutive rows (16 at d = 64) a step, R = 4 steps a tile
// with every load of the tile issued before its first use.  The two
// reduction kernels take a fixed grid (bn_residual_blocks: at most
// kRedBlocks CTAs, striding over the tiles) so their partials, and the
// order they are added in, depend on the row count alone; the elementwise
// kernels take one tile a CTA.  Rows wider than 256 words take column
// chunks (blockIdx.y).
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::Vec;

constexpr int kThreads = 256;
constexpr int kR = 4;              // rows of its word a thread takes a step
// CTAs of a reduction kernel, at most: two a streaming multiprocessor of an
// H100, all resident at once (the statistics kernel takes 100 registers a
// thread); 1024 read no faster and left the finishers 2.5x slower
constexpr int kRedBlocks = 264;
constexpr int kFinRows = 32;       // the forward's finisher: 32 rows of 32

struct Geometry {
    int v;        // elements a thread takes a row (4 or 1)
    int chunk;    // words a step (a row's words, at most kThreads)
    int chunks;   // column chunks (blockIdx.y)
    int step;     // rows a step
};

Geometry geometry(int d, bool vec) {
    Geometry g;
    g.v = vec ? 4 : 1;
    const int words = d / g.v;
    g.chunk = words < kThreads ? words : kThreads;
    g.chunks = (words + g.chunk - 1) / g.chunk;
    g.step = kThreads / g.chunk;
    return g;
}

int64_t tiles(int64_t n_rows, const Geometry& g) {
    const int64_t tile = (int64_t)g.step * kR;
    return (n_rows + tile - 1) / tile;
}

int red_blocks(int64_t n_rows, const Geometry& g) {
    const int64_t t = tiles(n_rows, g);
    return t < 1 ? 1 : (t < kRedBlocks ? (int)t : kRedBlocks);
}

// ------------------------------------------------------------- forward
// partials [gridDim.x, 3, d]: the block's (count, mean, M2) per column
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_residual_stats_kernel(int64_t n_rows, int d, int chunk,
                         const float* __restrict__ a,
                         const float* __restrict__ b, float* __restrict__ x,
                         double* __restrict__ partials) {
    __shared__ double mu[kThreads * V], m2[kThreads * V];
    __shared__ int64_t cnt[kThreads];
    const int step = kThreads / chunk;
    const int r0 = threadIdx.x / chunk, wl = threadIdx.x % chunk;
    const int cw = chunk * V, c0 = blockIdx.y * cw;
    const int f = c0 + wl * V;
    const bool live = r0 < step && f < d;
    double s[V], q[V];
    float k[V];
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0, k[i] = 0.0f;
    if (live) {
        const int64_t tile = (int64_t)step * kR;
        for (int64_t first = blockIdx.x * tile + r0; first < n_rows;
             first += gridDim.x * tile) {
            Vec<V> av[kR], bv[kR];
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const int64_t r = first + (int64_t)j * step;
                if (r < n_rows) {
                    av[j] = gn::vld_stream<V>(a + r * d + f);
                    bv[j] = gn::vld_stream<V>(b + r * d + f);
                }
            }
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const int64_t r = first + (int64_t)j * step;
                if (r >= n_rows) break;
                Vec<V> xv;
#pragma unroll
                for (int i = 0; i < V; ++i)
                    xv.a[i] = __fadd_rn(av[j].a[i], bv[j].a[i]);
                gn::vst<V>(x + r * d + f, xv);
                if (c == 0) {
#pragma unroll
                    for (int i = 0; i < V; ++i) k[i] = xv.a[i];
                }
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const double dv = (double)xv.a[i] - (double)k[i];
                    s[i] += dv;
                    q[i] = fma(dv, dv, q[i]);
                }
                ++c;
            }
        }
    }
    if (r0 < step) {
        if (wl == 0) cnt[r0] = c;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const double m = c ? (double)k[i] + s[i] / (double)c : 0.0;
            const double v = c ? q[i] - s[i] * s[i] / (double)c : 0.0;
            mu[r0 * cw + wl * V + i] = m;
            m2[r0 * cw + wl * V + i] = v > 0.0 ? v : 0.0;
        }
    }
    __syncthreads();
    // Chan's merge of the block's rows, in row order, a thread a column
    for (int j = threadIdx.x; j < cw; j += blockDim.x) {
        if (c0 + j >= d) continue;
        double n = 0.0, sm = 0.0;
        for (int r = 0; r < step; ++r) {
            n += (double)cnt[r];
            sm += (double)cnt[r] * mu[r * cw + j];
        }
        const double mean = n > 0.0 ? sm / n : 0.0;
        double acc = 0.0;
        for (int r = 0; r < step; ++r) {
            const double dm = mu[r * cw + j] - mean;
            acc += m2[r * cw + j] + (double)cnt[r] * dm * dm;
        }
        double* p = partials + (int64_t)blockIdx.x * 3 * d + c0 + j;
        p[0] = n;
        p[d] = mean;
        p[2 * d] = acc;
    }
}

// Chan's merge of the blocks' (count, mean, M2) in a fixed order: row r of
// the block adds parts r, r + 32, ... in order, then row 0 the 32 rows in
// row order; twice (the mean, then M2 about it).  Writes stats [2, d] =
// [mean | rsqrt(var + eps)] (var = M2 / count), updates the running
// statistics as models/norm.py update_running_stats does (float32, each
// product and sum rounded) and, once, num_batches_tracked.
__global__ void __launch_bounds__(kFinRows * 32)
bn_residual_finish_kernel(int n_parts, int d,
                          const double* __restrict__ partials, double eps,
                          double momentum, float* __restrict__ stats,
                          float* __restrict__ running_mean,
                          float* __restrict__ running_var,
                          int64_t* __restrict__ tracked) {
    __shared__ double red[kFinRows][32], red2[kFinRows][32];
    __shared__ double mean_s[32];
    const int c = threadIdx.x & 31, r = threadIdx.x >> 5;
    const int j = blockIdx.x * 32 + c;
    double n = 0.0, sm = 0.0;
    if (j < d) {
#pragma unroll 8
        for (int p = r; p < n_parts; p += kFinRows) {
            const double* q = partials + (int64_t)p * 3 * d + j;
            n += q[0];
            sm += q[0] * q[d];
        }
    }
    red[r][c] = n;
    red2[r][c] = sm;
    __syncthreads();
    if (r == 0) {
        double nn = 0.0, ss = 0.0;
        for (int k = 0; k < kFinRows; ++k) nn += red[k][c], ss += red2[k][c];
        mean_s[c] = nn > 0.0 ? ss / nn : 0.0;
        red[0][c] = nn;          // row 0 is read back by this thread alone
    }
    __syncthreads();
    const double mean = mean_s[c];
    double acc = 0.0;
    if (j < d) {
#pragma unroll 8
        for (int p = r; p < n_parts; p += kFinRows) {
            const double* q = partials + (int64_t)p * 3 * d + j;
            const double dm = q[d] - mean;
            acc += q[2 * d] + q[0] * dm * dm;
        }
    }
    const double count = red[0][c];
    __syncthreads();
    red2[r][c] = acc;
    __syncthreads();
    if (r == 0 && j < d) {
        double m2 = 0.0;
        for (int k = 0; k < kFinRows; ++k) m2 += red2[k][c];
        const double var = m2 / count;
        const float mf = (float)mean, vf = (float)var;
        stats[j] = mf;
        stats[d + j] = (float)(1.0 / sqrt(var + eps));
        const float keep = (float)(1.0 - momentum), mom = (float)momentum;
        const float unbiased =
            __fmul_rn(vf, (float)(count > 1.0 ? count / (count - 1.0) : 1.0));
        running_mean[j] = __fadd_rn(__fmul_rn(keep, running_mean[j]),
                                    __fmul_rn(mom, mf));
        running_var[j] = __fadd_rn(__fmul_rn(keep, running_var[j]),
                                   __fmul_rn(mom, unbiased));
        if (j == 0) *tracked += 1;
    }
}

// y = ((x - mean) * inv) * w + b (edge_math.cuh bn_apply)
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_residual_normalise_kernel(int64_t n_rows, int d, int chunk,
                             const float* __restrict__ x,
                             const float* __restrict__ stats,
                             const float* __restrict__ weight,
                             const float* __restrict__ bias,
                             float* __restrict__ y) {
    const int step = kThreads / chunk;
    const int r0 = threadIdx.x / chunk;
    const int f = (blockIdx.y * chunk + threadIdx.x % chunk) * V;
    if (r0 >= step || f >= d) return;
    const Vec<V> mu = gn::vld<V>(stats + f), rs = gn::vld<V>(stats + d + f);
    const Vec<V> ga = gn::vld<V>(weight + f), be = gn::vld<V>(bias + f);
    const int64_t first = blockIdx.x * (int64_t)step * kR + r0;
    Vec<V> xv[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
        const int64_t r = first + (int64_t)j * step;
        if (r < n_rows) xv[j] = gn::vld_stream<V>(x + r * d + f);
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
        const int64_t r = first + (int64_t)j * step;
        if (r >= n_rows) break;
        Vec<V> o;
#pragma unroll
        for (int i = 0; i < V; ++i)
            o.a[i] = gn::bn_apply<float>(xv[j].a[i], mu.a[i], rs.a[i],
                                         ga.a[i], be.a[i]);
        gn::vst<V>(y + r * d + f, o);
    }
}

// ------------------------------------------------------------ backward
// partials [gridDim.x, 2d] = the block's [sum g | sum g * xhat], float64
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_residual_grad_sums_kernel(int64_t n_rows, int d, int chunk,
                             const float* __restrict__ g,
                             const float* __restrict__ x,
                             const float* __restrict__ stats,
                             double* __restrict__ partials) {
    __shared__ double red[kThreads * V * 2];
    const int step = kThreads / chunk;
    const int r0 = threadIdx.x / chunk, wl = threadIdx.x % chunk;
    const int cw = chunk * V, c0 = blockIdx.y * cw;
    const int f = c0 + wl * V;
    double sg[V], sx[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sg[i] = sx[i] = 0.0;
    if (r0 < step && f < d) {
        const Vec<V> mu = gn::vld<V>(stats + f);
        const Vec<V> rs = gn::vld<V>(stats + d + f);
        const int64_t tile = (int64_t)step * kR;
        for (int64_t first = blockIdx.x * tile + r0; first < n_rows;
             first += gridDim.x * tile) {
            Vec<V> gv[kR], xv[kR];
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const int64_t r = first + (int64_t)j * step;
                if (r < n_rows) {
                    gv[j] = gn::vld_stream<V>(g + r * d + f);
                    xv[j] = gn::vld_stream<V>(x + r * d + f);
                }
            }
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const int64_t r = first + (int64_t)j * step;
                if (r >= n_rows) break;
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const float xh = __fmul_rn(__fsub_rn(xv[j].a[i],
                                                         mu.a[i]), rs.a[i]);
                    sg[i] += (double)gv[j].a[i];
                    sx[i] = fma((double)gv[j].a[i], (double)xh, sx[i]);
                }
            }
        }
    }
    if (r0 < step) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            red[r0 * 2 * cw + wl * V + i] = sg[i];
            red[r0 * 2 * cw + cw + wl * V + i] = sx[i];
        }
    }
    gn::block_partials(red, step, cw, c0, d, partials);
}

// dx = (w * inv) * ((g - c1) - xhat * c2), c1 = sum g / n and c2 = sum g
// xhat / n rounded to float32 from sums [2d] = [sum g | sum g xhat]
// (float64); blockIdx.x == 0 also writes dwb [2, d] = [d_weight | d_bias]
template <int V>
__global__ void __launch_bounds__(kThreads)
bn_residual_dx_kernel(int64_t n_rows, int d, int chunk,
                      const float* __restrict__ g,
                      const float* __restrict__ x,
                      const float* __restrict__ stats,
                      const float* __restrict__ weight,
                      const double* __restrict__ sums,
                      float* __restrict__ dx, float* __restrict__ dwb) {
    const int step = kThreads / chunk;
    const int r0 = threadIdx.x / chunk;
    const int f = (blockIdx.y * chunk + threadIdx.x % chunk) * V;
    if (r0 >= step || f >= d) return;
    const Vec<V> mu = gn::vld<V>(stats + f), rs = gn::vld<V>(stats + d + f);
    const Vec<V> w = gn::vld<V>(weight + f);
    float sc[V], c1[V], c2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const double sg = sums[f + i], sx = sums[d + f + i];
        sc[i] = __fmul_rn(w.a[i], rs.a[i]);
        c1[i] = (float)(sg / (double)n_rows);
        c2[i] = (float)(sx / (double)n_rows);
        if (blockIdx.x == 0 && r0 == 0) {
            dwb[f + i] = (float)sx;
            dwb[d + f + i] = (float)sg;
        }
    }
    const int64_t first = blockIdx.x * (int64_t)step * kR + r0;
    Vec<V> gv[kR], xv[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
        const int64_t r = first + (int64_t)j * step;
        if (r < n_rows) {
            gv[j] = gn::vld_stream<V>(g + r * d + f);
            xv[j] = gn::vld_stream<V>(x + r * d + f);
        }
    }
#pragma unroll
    for (int j = 0; j < kR; ++j) {
        const int64_t r = first + (int64_t)j * step;
        if (r >= n_rows) break;
        Vec<V> o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float xh = __fmul_rn(__fsub_rn(xv[j].a[i], mu.a[i]),
                                       rs.a[i]);
            o.a[i] = __fmul_rn(sc[i],
                               __fsub_rn(__fsub_rn(gv[j].a[i], c1[i]),
                                         __fmul_rn(xh, c2[i])));
        }
        gn::vst<V>(dx + r * d + f, o);
    }
}

int check_grid(int64_t n_rows, const Geometry& g) {
    if (tiles(n_rows, g) > 0x7fffffff || g.chunks > 65535)
        return (int)cudaErrorInvalidValue;
    return (int)cudaSuccess;
}

}  // namespace

// Rows of the float64 partials the reduction kernels of n_rows rows of
// width d take (3d wide in the forward, 2d in the backward); vec: the
// 16-byte path (d % 4 == 0, every row pointer 16-byte aligned)
extern "C" int gn_bn_residual_blocks(int64_t n_rows, int d, int vec) {
    return red_blocks(n_rows, geometry(d, vec != 0));
}

// x = a + b, stats [2, d] = [mean | rsqrt(var + eps)], y = BN(x); running
// statistics and num_batches_tracked updated.  a, b, x, y [n_rows, d]
// contiguous; partials [gn_bn_residual_blocks, 3d] float64 scratch.
extern "C" int gn_bn_residual_forward(int64_t n_rows, int d, int vec,
                                      const float* a, const float* b,
                                      const float* weight, const float* bias,
                                      double eps, double momentum, float* x,
                                      float* y, float* stats,
                                      float* running_mean, float* running_var,
                                      int64_t* tracked, double* partials,
                                      void* stream) {
    if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geometry g = geometry(d, vec != 0);
    int rc = check_grid(n_rows, g);
    if (rc) return rc;
    const dim3 rgrid(red_blocks(n_rows, g), g.chunks);
    if (g.v == 4)
        bn_residual_stats_kernel<4><<<rgrid, kThreads, 0, st>>>(
            n_rows, d, g.chunk, a, b, x, partials);
    else
        bn_residual_stats_kernel<1><<<rgrid, kThreads, 0, st>>>(
            n_rows, d, g.chunk, a, b, x, partials);
    if ((rc = (int)cudaGetLastError())) return rc;
    bn_residual_finish_kernel<<<(d + 31) / 32, kFinRows * 32, 0, st>>>(
        (int)rgrid.x, d, partials, eps, momentum, stats, running_mean,
        running_var, tracked);
    if ((rc = (int)cudaGetLastError())) return rc;
    const dim3 egrid((unsigned)tiles(n_rows, g), g.chunks);
    if (g.v == 4)
        bn_residual_normalise_kernel<4><<<egrid, kThreads, 0, st>>>(
            n_rows, d, g.chunk, x, stats, weight, bias, y);
    else
        bn_residual_normalise_kernel<1><<<egrid, kThreads, 0, st>>>(
            n_rows, d, g.chunk, x, stats, weight, bias, y);
    return (int)cudaGetLastError();
}

// dx [n_rows, d] and dwb [2, d] = [d_weight | d_bias] from the upstream
// gradient g and the forward's x and stats; sums [2d] and partials
// [gn_bn_residual_blocks, 2d] float64 scratch.
extern "C" int gn_bn_residual_backward(int64_t n_rows, int d, int vec,
                                       const float* g, const float* x,
                                       const float* stats,
                                       const float* weight, float* dx,
                                       float* dwb, double* sums,
                                       double* partials, void* stream) {
    if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const Geometry gm = geometry(d, vec != 0);
    int rc = check_grid(n_rows, gm);
    if (rc) return rc;
    const dim3 rgrid(red_blocks(n_rows, gm), gm.chunks);
    if (gm.v == 4)
        bn_residual_grad_sums_kernel<4><<<rgrid, kThreads, 0, st>>>(
            n_rows, d, gm.chunk, g, x, stats, partials);
    else
        bn_residual_grad_sums_kernel<1><<<rgrid, kThreads, 0, st>>>(
            n_rows, d, gm.chunk, g, x, stats, partials);
    if ((rc = (int)cudaGetLastError())) return rc;
    gn::launch_reduce_partials((int)rgrid.x, 2 * d, partials, sums, st);
    if ((rc = (int)cudaGetLastError())) return rc;
    const dim3 egrid((unsigned)tiles(n_rows, gm), gm.chunks);
    if (gm.v == 4)
        bn_residual_dx_kernel<4><<<egrid, kThreads, 0, st>>>(
            n_rows, d, gm.chunk, g, x, stats, weight, sums, dx, dwb);
    else
        bn_residual_dx_kernel<1><<<egrid, kThreads, 0, st>>>(
            n_rows, d, gm.chunk, g, x, stats, weight, sums, dx, dwb);
    return (int)cudaGetLastError();
}
