// A streaming sum of K row blocks, for Hopper (sm_90a): the card's stream
// ceiling.
//
// Replaces scripts/dma_probe.py:run's `kern` (its pallas_call), the TPU
// probe of per-block DMA cost: out = in_0 + in_1 + ... + in_{K-1} over
// rows [rows, d], on a grid of T blocks of ET rows each
// (BlockSpec((ET, d), lambda t: (t, 0)) on a (T,) grid).  Here logical
// block t is the ET * d contiguous elements of its rows, cut into tiles of
// kThreads 16-byte words (a uint4 of 4 floats or 8 bf16): CTA (x, y) takes
// tile x of block y, one word a thread.  The adds run left to right, as
// the JAX kernel's do, in bf16 each add rounded to bf16 (`acc = acc +
// r[:]` on bf16 values), here by the packed add.rn.bf16x2, one correctly
// rounded add for two elements (float32's 24 bits are more than 2 x 8 + 2,
// so the float add then round gives the same bits).  K <= 12 input
// pointers travel in a struct by value.
//
// Bound: bytes, (K + 1) * rows * d * element size, read and written once;
// K - 1 adds per element.  The kernel has no other work, so its rate is
// what a streaming kernel reaches on the card: the yardstick behind the
// bounds of every other kernel.  What held the first design (a CTA a
// block, a stride loop over its words) at 2,403-3,075 GB/s was the order
// of its traffic: T CTAs each walking its own stretch of every input, a
// store between one load and the next.  Short CTAs that each move one
// tile, issued in address order, keep the reads in step and let the card
// overlap one CTA's stores with the next one's loads; the bytes in flight
// come from the resident CTAs (2,048 threads x K x 16 bytes an SM, more
// than Little's law asks at 3.35 TB/s).  On the card, 1,024 threads a CTA
// and one word each were the fastest of the shapes tried: 256 or 512
// threads, 2, 4 or 8 words a thread (unrolled, all loads before the first
// store), a persistent grid walking the tiles, and evict-first loads and
// stores (__ldcs, __stcs) were slower at K = 1 and no faster elsewhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxInputs = 12;
constexpr int kThreads = 1024;

struct Inputs {
    const uint4* p[kMaxInputs];
};

__device__ __forceinline__ void add_f32(uint4& acc, uint4 x) {
    acc.x = __float_as_uint(__fadd_rn(__uint_as_float(acc.x),
                                      __uint_as_float(x.x)));
    acc.y = __float_as_uint(__fadd_rn(__uint_as_float(acc.y),
                                      __uint_as_float(x.y)));
    acc.z = __float_as_uint(__fadd_rn(__uint_as_float(acc.z),
                                      __uint_as_float(x.z)));
    acc.w = __float_as_uint(__fadd_rn(__uint_as_float(acc.w),
                                      __uint_as_float(x.w)));
}

// two bf16 (the lower address in the low half) added pairwise, each sum
// rounded to bf16 (nearest, ties to even)
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

__device__ __forceinline__ void add_bf16(uint4& acc, uint4 x) {
    acc.x = add_bf16x2(acc.x, x.x);
    acc.y = add_bf16x2(acc.y, x.y);
    acc.z = add_bf16x2(acc.z, x.z);
    acc.w = add_bf16x2(acc.w, x.w);
}

// word blockIdx.x * kThreads + threadIdx.x of logical blocks blockIdx.y,
// blockIdx.y + gridDim.y, ...
template <int K, bool BF16>
__global__ void __launch_bounds__(kThreads)
stream_sum(Inputs in, uint4* __restrict__ out, int n_blocks, int64_t words) {
    const int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (w >= words) return;
    for (int64_t t = blockIdx.y; t < n_blocks; t += gridDim.y) {
        const int64_t i = t * words + w;
        uint4 x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = in.p[k][i];
        uint4 acc = x[0];
#pragma unroll
        for (int k = 1; k < K; ++k) {
            if constexpr (BF16)
                add_bf16(acc, x[k]);
            else
                add_f32(acc, x[k]);
        }
        out[i] = acc;
    }
}

template <int K, bool BF16>
int launch_k(const Inputs& in, uint4* out, int n_blocks, int64_t words,
             cudaStream_t st) {
    const int64_t tiles = (words + kThreads - 1) / kThreads;
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, n_blocks < 65535 ? n_blocks : 65535);
    stream_sum<K, BF16><<<grid, kThreads, 0, st>>>(in, out, n_blocks, words);
    return (int)cudaGetLastError();
}

template <bool BF16>
int launch(int k, const Inputs& in, uint4* out, int n_blocks, int64_t words,
           cudaStream_t st) {
    switch (k) {
#define GN_K(K)                                                               \
    case K:                                                                   \
        return launch_k<K, BF16>(in, out, n_blocks, words, st);
        GN_K(1) GN_K(2) GN_K(3) GN_K(4) GN_K(5) GN_K(6)
        GN_K(7) GN_K(8) GN_K(9) GN_K(10) GN_K(11) GN_K(12)
#undef GN_K
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// out = inputs[0] + ... + inputs[k - 1], 1 <= k <= 12, on n_blocks logical
// blocks of `words` 16-byte words each (every pointer 16-byte aligned);
// bf16 = 1: the words hold bf16, else float32.
extern "C" int gn_stream_sum(int k, const void* const* inputs, void* out,
                             int n_blocks, int64_t words, int bf16,
                             void* stream) {
    if (k < 1 || k > kMaxInputs) return (int)cudaErrorInvalidValue;
    if (n_blocks <= 0 || words <= 0) return (int)cudaSuccess;
    Inputs in{};
    for (int i = 0; i < k; ++i) in.p[i] = static_cast<const uint4*>(inputs[i]);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    uint4* o = static_cast<uint4*>(out);
    return bf16 ? launch<true>(k, in, o, n_blocks, words, st)
                : launch<false>(k, in, o, n_blocks, words, st);
}

extern "C" const char* gn_probes_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
