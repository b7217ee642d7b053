// The batch-norm edge adjoint: the per-edge end of the batch-statistics
// chain of the training edge stage's backward, one pass, for Hopper
// (sm_90a).
//
// Replaces the jnp chain of gnnome_tpu/ops/message.py:549-591 (the relu
// mask recomputed from x, and d_b3e), which the port ran as eleven PyTorch
// elementwise launches over [E, w].  Per element (edge row r, feature f),
// from K8's x and d_eo and the batch-norm rows K3 and K8 took:
//
//   y     = ((x - bn[0]) * bn[1]) * bn[2] + bn[3]     (edge_math.cuh bn_apply:
//                                                      K3's mask bit for bit)
//   d_y   = d_eo where y > 0, else 0
//   d_b3e = d_y * sc[0] + (sc[1] + sc[2] * x)          (sc = [gamma * inv |
//                                                      c1 | c2], float32)
//
// every product and sum rounded to nearest float32 (no FMA contraction),
// the result rounded once to the element type: the operations of the plain
// version (ops/kernels.py bn_edge_adjoint_plain), so the two are bit-equal.
// bf16: x, d_eo, bn and d_b3e are bf16, y rounds as K3's does, the rest
// is float32, as the plain version's wide() does.
//
// Bound: bytes.  It reads x and d_eo and writes d_b3e, three [E, w]
// streams, and nine operations an element; the [4, w] and [3, w] rows are
// read once a thread.
//
// Design: a streaming pass.  A thread owns one 16-byte word of columns (four
// floats or eight bf16; one element where w does not divide into words or
// a row is not 16-byte aligned), so its seven parameter values stay in
// registers, and R rows of that word a step: a block of 256 threads covers
// 256 / (words a row) consecutive rows, R times (a tile), the R loads of x
// and of d_eo issued before the first store.  The grid strides over the
// tiles in address order, L tiles a CTA.  On the card (E = 2.41M, w = 128)
// float32 ran fastest at R = 4, L = 1 (one tile a CTA, as
// csrc/probes/stream_sum.cu found): 86-93% of the byte bound, within 7% of
// torch.add over the same three streams.  A bf16 thread holds twice the
// parameters (eight columns): at R = 4, L = 1 it took 141 registers and
// 41% of the bound, at R = 1, L = 16 80 registers and 82-83%.  Loads and
// stores are evict-first (csr_walk.cuh vld_stream / vst_stream): the
// streams are read and written once.  Rows wider than 256 words take
// column chunks (blockIdx.y).  No shared memory, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_math.cuh"

namespace {

using gn::Vec;

constexpr int kThreads = 256;

// R (rows of its word a thread takes a step) and L (tiles a CTA walks) of
// element type S
template <class S>
struct Shape {
    static constexpr int R = 4, L = 1;
};
template <>
struct Shape<__nv_bfloat16> {
    static constexpr int R = 1, L = 16;
};

template <int V, class S>
__device__ __forceinline__ void load_row(const S* p, float* a) {
#pragma unroll
    for (int i = 0; i < V; ++i) a[i] = gn::elem_f32(p[i]);
}

// S: the element type of x, d_eo, bn and d_b3e (float or __nv_bfloat16);
// V: elements a thread takes a row; words: w / V; chunk: words a step
template <class S, int V, int R>
__global__ void __launch_bounds__(kThreads)
bn_edge_adjoint_kernel(int64_t n_rows, int w, int chunk,
                       const S* __restrict__ x, const S* __restrict__ d_eo,
                       const S* __restrict__ bn, const float* __restrict__ sc,
                       S* __restrict__ out) {
    const int step = kThreads / chunk;            // rows a step
    const int r0 = threadIdx.x / chunk;
    const int f = (blockIdx.y * chunk + threadIdx.x % chunk) * V;
    if (r0 >= step || f >= w) return;
    float mu[V], rs[V], ga[V], be[V], s[V], c1[V], c2[V];
    load_row<V>(bn + f, mu);
    load_row<V>(bn + w + f, rs);
    load_row<V>(bn + 2 * w + f, ga);
    load_row<V>(bn + 3 * w + f, be);
    load_row<V>(sc + f, s);
    load_row<V>(sc + w + f, c1);
    load_row<V>(sc + 2 * w + f, c2);
    const int64_t tile = (int64_t)step * R;
    for (int64_t first = blockIdx.x * tile + r0; first < n_rows;
         first += gridDim.x * tile) {
        Vec<V> xv[R], gv[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int64_t r = first + (int64_t)j * step;
            if (r < n_rows) {
                xv[j] = gn::vld_stream<V>(x + r * w + f);
                gv[j] = gn::vld_stream<V>(d_eo + r * w + f);
            }
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int64_t r = first + (int64_t)j * step;
            if (r >= n_rows) break;
            Vec<V> o;
#pragma unroll
            for (int i = 0; i < V; ++i) {
                const float xi = xv[j].a[i];
                const float y = gn::bn_apply<S>(xi, mu[i], rs[i], ga[i],
                                                be[i]);
                const float dy = y > 0.0f ? gv[j].a[i] : 0.0f;
                o.a[i] = __fadd_rn(__fmul_rn(dy, s[i]),
                                   __fadd_rn(c1[i], __fmul_rn(c2[i], xi)));
            }
            gn::vst_stream<V>(out + r * w + f, o);
        }
    }
}

template <class S, int V>
int launch(int64_t n_rows, int w, const S* x, const S* d_eo, const S* bn,
           const float* sc, S* out, cudaStream_t st) {
    constexpr int R = Shape<S>::R, L = Shape<S>::L;
    const int words = w / V;
    const int chunk = words < kThreads ? words : kThreads;
    const int64_t tile = (int64_t)(kThreads / chunk) * R;
    const int64_t ctas = ((n_rows + tile - 1) / tile + L - 1) / L;
    const int chunks = (words + chunk - 1) / chunk;
    if (ctas > 0x7fffffff || chunks > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)ctas, chunks);
    bn_edge_adjoint_kernel<S, V, R><<<grid, kThreads, 0, st>>>(
        n_rows, w, chunk, x, d_eo, bn, sc, out);
    return (int)cudaGetLastError();
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
    for (const void* p : ptrs)
        if ((uintptr_t)p % 16) return false;
    return true;
}

template <class S>
int dispatch(int64_t n_rows, int w, const void* x, const void* d_eo,
             const void* bn, const float* sc, void* out, cudaStream_t st) {
    constexpr int kWord = 16 / sizeof(S);        // elements a 16-byte word
    const S* xs = static_cast<const S*>(x);
    const S* gs = static_cast<const S*>(d_eo);
    const S* bs = static_cast<const S*>(bn);
    S* os = static_cast<S*>(out);
    if (w % kWord == 0 && aligned16({x, d_eo, bn, sc, out}))
        return launch<S, kWord>(n_rows, w, xs, gs, bs, sc, os, st);
    return launch<S, 1>(n_rows, w, xs, gs, bs, sc, os, st);
}

}  // namespace

// d_b3e [n_rows, w] from x, d_eo [n_rows, w] and bn [4, w] (all contiguous,
// bf16 = 0: float32, bf16 = 1: __nv_bfloat16) and sc [3, w] float32.
extern "C" int gn_bn_edge_adjoint(int64_t n_rows, int w, const void* x,
                                  const void* d_eo, const void* bn,
                                  const float* sc, void* out, int bf16,
                                  void* stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    if (w <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? dispatch<__nv_bfloat16> : dispatch<float>)(
        n_rows, w, x, d_eo, bn, sc, out, st);
}
