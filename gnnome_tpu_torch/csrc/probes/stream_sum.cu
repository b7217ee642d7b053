// A streaming sum of K row blocks, for Hopper (sm_90a): the card's stream
// ceiling.
//
// Replaces scripts/dma_probe.py:run's `kern` (its pallas_call), the TPU
// probe of per-block DMA cost: out = in_0 + in_1 + ... + in_{K-1} over
// rows [rows, d], on a grid of T blocks of ET rows each
// (BlockSpec((ET, d), lambda t: (t, 0)) on a (T,) grid).  Here block t
// takes the ET * d contiguous elements of its rows, 16 bytes a thread per
// load (a uint4 of 4 floats or 8 bf16), and adds the K inputs left to
// right, as the JAX kernel does; in bf16 each add is rounded to bf16, as
// `acc = acc + r[:]` on bf16 values is.  K <= 12 input pointers travel in
// a struct by value.
//
// Bound: bytes, (K + 1) * rows * d * element size, read and written once;
// K - 1 adds per element.  The kernel has no other work, so its rate is
// what a streaming kernel reaches on the card at this grid: the yardstick
// behind the bounds of every other kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxInputs = 12;
constexpr int kThreads = 256;

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
    const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16);
    const float hi = __uint_as_float(a & 0xffff0000u)
                     + __uint_as_float(b & 0xffff0000u);
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
           | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void add_bf16(uint4& acc, uint4 x) {
    acc.x = add_bf16x2(acc.x, x.x);
    acc.y = add_bf16x2(acc.y, x.y);
    acc.z = add_bf16x2(acc.z, x.z);
    acc.w = add_bf16x2(acc.w, x.w);
}

// Block t sums the words [t * words, (t + 1) * words) of every input.
template <int K, bool BF16>
__global__ void __launch_bounds__(kThreads)
stream_sum(Inputs in, uint4* __restrict__ out, int64_t words) {
    const int64_t base = (int64_t)blockIdx.x * words;
    for (int64_t w = threadIdx.x; w < words; w += kThreads) {
        uint4 x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = in.p[k][base + w];
        uint4 acc = x[0];
#pragma unroll
        for (int k = 1; k < K; ++k) {
            if constexpr (BF16)
                add_bf16(acc, x[k]);
            else
                add_f32(acc, x[k]);
        }
        out[base + w] = acc;
    }
}

template <bool BF16>
int launch(int k, const Inputs& in, uint4* out, int n_blocks, int64_t words,
           cudaStream_t st) {
    switch (k) {
#define GN_K(K)                                                               \
    case K:                                                                   \
        stream_sum<K, BF16><<<n_blocks, kThreads, 0, st>>>(in, out, words);   \
        break;
        GN_K(1) GN_K(2) GN_K(3) GN_K(4) GN_K(5) GN_K(6)
        GN_K(7) GN_K(8) GN_K(9) GN_K(10) GN_K(11) GN_K(12)
#undef GN_K
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// out = inputs[0] + ... + inputs[k - 1], 1 <= k <= 12, on n_blocks blocks
// of `words` 16-byte words each (every pointer 16-byte aligned); bf16 = 1:
// the words hold bf16, else float32.
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
