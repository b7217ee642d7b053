// The four operations of the Mosaic repro scripts, for Hopper (sm_90a):
// a row stack, a row gather, a segment sum and a small product.
//
// Replaces the pallas_call sites of scripts/mosaic_f32_repro.py (`run`,
// :33), mosaic_f32_repro2.py (`run`, :20), mosaic_f32_repro3.py (`run`,
// :30), mosaic_f32_repro4.py (`main`, :24, :40) and mosaic_f32_repro5.py
// (`check`, :15): kernels that bisected a TPU compiler crash.  What their
// bodies compute comes down to these four operations, which
// gnnome_tpu_torch/probes/mosaic_repro.py chains into every case:
//
//   gn_row_stack     two [h, D] row blocks (the lane halves of an [h, 2D]
//                    array, or two arrays) stacked by rows into [2h, D]
//                    (jnp.concatenate([a[:, :D], a[:, D:]], 0), and the
//                    roll, scratch and barrier variants), or side by side
//                    into [h, 2D] (the inverse, repro3's kH); optionally an
//                    accurate float32 sigmoid of each element first, as K3
//                    computes it (repro case 5).  The output may be a view
//                    with a wider row stride: kE's lane padding is the
//                    stack written into a zeroed buffer.
//   gn_row_gather    out[c, :] = table[idx[c], :], a zero row where idx[c]
//                    lies outside [0, rows): the one-hot select (iota ==
//                    idx, then a product) matches no row there.
//   gn_segment_sum   out[r, :] = sum over c with idx[c] == r of pay[c, :],
//                    the one-hot scatter-add, out-of-range indices dropped.
//                    A warp per output row scans the indices 32 at a time
//                    with a ballot and adds the matching rows in ascending
//                    c into float32 registers, rounded once to the element
//                    type: no atomics, so the sum is bitwise reproducible.
//                    The scan is n_out x n index reads (L2-resident at the
//                    scripts' 512 indices), not a sort.  An option writes
//                    the sum into both lane halves of a [rows, 2W] output
//                    (case 5's [s | s]).
//   gn_small_matmul  [M, K] @ [K, N] on CUDA cores: 16 x 16 shared-memory
//                    tiles, one output a thread, float32 FMA in ascending k.
//                    No TF32 and no tensor cores: the counterpart of a
//                    float32 HIGHEST product.  bf16 operands accumulate in
//                    float32 and the output is rounded once (DEFAULT bf16).
//
// Every entry takes float32 or bf16 (`bf16` = 1) elements, int32 indices,
// row strides in elements (the last dimension contiguous), and launches on
// the given stream.  Bound: at the scripts' shapes every operation moves
// well under 1 MB (the product 0.92 MB and 33.6 MFLOP), so each is a few
// microseconds of launch and latency against a bound below one; the
// design is the simplest that is right, and the probe records the gap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../edge_math.cuh"

namespace {

using gn::elem_f32;
using gn::f32_elem;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;    // a grid-stride loop's blocks
constexpr int kSegWarps = 4;            // segment sum: output rows a block
constexpr int kTile = 16;               // product tile

int grid_for(int64_t n) {
    const int64_t b = (n + kThreads - 1) / kThreads;
    return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Element i of the 2 h D source elements: block `half` (lo or hi), row r,
// column j; stacked to row half * h + r, or (inverse) to columns
// half * D + j of row r.
template <class S, bool SIGMOID>
__global__ void __launch_bounds__(kThreads)
row_stack(int h, int D, int inverse, const S* __restrict__ lo, int64_t ld_lo,
          const S* __restrict__ hi, int64_t ld_hi, S* __restrict__ out,
          int64_t ld_out) {
    const int64_t n = (int64_t)h * D;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < 2 * n;
         i += (int64_t)gridDim.x * kThreads) {
        const int half = i >= n;
        const int64_t k = half ? i - n : i;
        const int64_t r = k / D, j = k % D;
        S v = half ? hi[r * ld_hi + j] : lo[r * ld_lo + j];
        if constexpr (SIGMOID)
            v = f32_elem<S>(gn::sigmoid_f32(elem_f32(v)));
        S* dst = inverse ? out + r * ld_out + (int64_t)half * D
                         : out + ((int64_t)half * h + r) * ld_out;
        dst[j] = v;
    }
}

template <class S>
__global__ void __launch_bounds__(kThreads)
row_gather(int n, int rows, int W, const int* __restrict__ idx,
           const S* __restrict__ table, int64_t ld_t, S* __restrict__ out) {
    const int64_t total = (int64_t)n * W;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total;
         i += (int64_t)gridDim.x * kThreads) {
        const int64_t c = i / W, j = i % W;
        const int r = idx[c];
        out[i] = (r >= 0 && r < rows) ? table[(int64_t)r * ld_t + j]
                                      : f32_elem<S>(0.0f);
    }
}

// A warp per output row r, a column per lane (blockIdx.y: columns
// [32 y, 32 y + 32)).  The warp reads the indices 32 at a time (the next
// 32 loaded while it adds the current ones), finds those equal to r with a
// ballot and adds their rows in ascending c: the mask is the same on every
// lane, so the loop is uniform and each row's load is one coalesced line.
template <class S>
__global__ void __launch_bounds__(kSegWarps * 32)
segment_sum(int n, int n_out, int W, const int* __restrict__ idx,
            const S* __restrict__ pay, int64_t ld_p, S* __restrict__ out,
            int64_t ld_o, int dup) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
    const int j = blockIdx.y * 32 + lane;
    if (r >= n_out) return;                 // the whole warp
    float acc = 0.0f;
    int q = lane < n ? idx[lane] : -1;
    for (int base = 0; base < n; base += 32) {
        const int c_next = base + 32 + lane;
        const int q_next = c_next < n ? idx[c_next] : -1;
        unsigned m = __ballot_sync(0xffffffffu, q == r);
        while (m) {
            const int k = __ffs(m) - 1;
            m &= m - 1;
            if (j < W)
                acc = __fadd_rn(acc, elem_f32(pay[(int64_t)(base + k) * ld_p
                                                  + j]));
        }
        q = q_next;
    }
    if (j < W) {
        const S v = f32_elem<S>(acc);
        out[(int64_t)r * ld_o + j] = v;
        if (dup) out[(int64_t)r * ld_o + W + j] = v;
    }
}

template <class S>
__global__ void __launch_bounds__(kTile * kTile)
small_matmul(int M, int K, int N, const S* __restrict__ a, int64_t lda,
             const S* __restrict__ b, int64_t ldb, S* __restrict__ out,
             int64_t ldo) {
    __shared__ float sa[kTile][kTile + 1];
    __shared__ float sb[kTile][kTile + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int row = blockIdx.y * kTile + ty, col = blockIdx.x * kTile + tx;
    float acc = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kTile) {
        sa[ty][tx] = (row < M && k0 + tx < K)
                         ? elem_f32(a[(int64_t)row * lda + k0 + tx]) : 0.0f;
        sb[ty][tx] = (k0 + ty < K && col < N)
                         ? elem_f32(b[(int64_t)(k0 + ty) * ldb + col]) : 0.0f;
        __syncthreads();
        const int kk = min(kTile, K - k0);
        for (int k = 0; k < kk; ++k) acc = fmaf(sa[ty][k], sb[k][tx], acc);
        __syncthreads();
    }
    if (row < M && col < N) out[(int64_t)row * ldo + col] = f32_elem<S>(acc);
}

template <class S>
int stack_launch(int h, int D, int inverse, int sigmoid, const void* lo,
                 int64_t ld_lo, const void* hi, int64_t ld_hi, void* out,
                 int64_t ld_out, cudaStream_t st) {
    const int g = grid_for(2 * (int64_t)h * D);
    auto k = sigmoid ? row_stack<S, true> : row_stack<S, false>;
    k<<<g, kThreads, 0, st>>>(h, D, inverse, static_cast<const S*>(lo),
                              ld_lo, static_cast<const S*>(hi), ld_hi,
                              static_cast<S*>(out), ld_out);
    return (int)cudaGetLastError();
}

template <class S>
int gather_launch(int n, int rows, int W, const int* idx, const void* table,
                  int64_t ld_t, void* out, cudaStream_t st) {
    row_gather<S><<<grid_for((int64_t)n * W), kThreads, 0, st>>>(
        n, rows, W, idx, static_cast<const S*>(table), ld_t,
        static_cast<S*>(out));
    return (int)cudaGetLastError();
}

template <class S>
int segment_launch(int n, int n_out, int W, const int* idx, const void* pay,
                   int64_t ld_p, void* out, int64_t ld_o, int dup,
                   cudaStream_t st) {
    const dim3 grid((n_out + kSegWarps - 1) / kSegWarps, (W + 31) / 32);
    segment_sum<S><<<grid, kSegWarps * 32, 0, st>>>(
        n, n_out, W, idx, static_cast<const S*>(pay), ld_p,
        static_cast<S*>(out), ld_o, dup);
    return (int)cudaGetLastError();
}

template <class S>
int matmul_launch(int M, int K, int N, const void* a, int64_t lda,
                  const void* b, int64_t ldb, void* out, int64_t ldo,
                  cudaStream_t st) {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    small_matmul<S><<<grid, dim3(kTile, kTile), 0, st>>>(
        M, K, N, static_cast<const S*>(a), lda, static_cast<const S*>(b),
        ldb, static_cast<S*>(out), ldo);
    return (int)cudaGetLastError();
}

}  // namespace

// inverse = 0: out[r] = f(lo[r]), out[h + r] = f(hi[r]) for r < h, rows of
// D elements, out [2h, >= D] at row stride ld_out; inverse = 1: out[r] =
// [f(lo[r]) | f(hi[r])], out [h, >= 2D].  f is the identity, or with
// sigmoid = 1 the float32 sigmoid 1 / (1 + expf(-x)) rounded to the
// element type.
extern "C" int gn_row_stack(int h, int D, int inverse, int sigmoid,
                            const void* lo, int64_t ld_lo, const void* hi,
                            int64_t ld_hi, void* out, int64_t ld_out,
                            int bf16, void* stream) {
    if (h <= 0 || D <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? stack_launch<__nv_bfloat16> : stack_launch<float>)(
        h, D, inverse, sigmoid, lo, ld_lo, hi, ld_hi, out, ld_out, st);
}

// out [n, W] (contiguous) = table[idx] ([rows, W] at row stride ld_t), a
// zero row for an index outside [0, rows).
extern "C" int gn_row_gather(int n, int rows, int W, const int* idx,
                             const void* table, int64_t ld_t, void* out,
                             int bf16, void* stream) {
    if (n <= 0 || W <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? gather_launch<__nv_bfloat16> : gather_launch<float>)(
        n, rows, W, idx, table, ld_t, out, st);
}

// out [n_out, W] (row stride ld_o; with dup = 1 also columns W..2W-1) =
// the sums of the n rows of pay ([n, W], row stride ld_p) by idx, each in
// ascending row order in float32, rounded once; indices outside
// [0, n_out) are dropped.  Every output row is written (zero where no
// index names it).
extern "C" int gn_segment_sum(int n, int n_out, int W, const int* idx,
                              const void* pay, int64_t ld_p, void* out,
                              int64_t ld_o, int dup, int bf16, void* stream) {
    if (n_out <= 0 || W <= 0) return (int)cudaSuccess;
    if ((W + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? segment_launch<__nv_bfloat16> : segment_launch<float>)(
        n, n_out, W, idx, pay, ld_p, out, ld_o, dup, st);
}

// out [M, N] (row stride ldo) = a [M, K] (lda) @ b [K, N] (ldb), float32
// FMA in ascending k, rounded once to the element type.
extern "C" int gn_small_matmul(int M, int K, int N, const void* a,
                               int64_t lda, const void* b, int64_t ldb,
                               void* out, int64_t ldo, int bf16,
                               void* stream) {
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    if ((M + kTile - 1) / kTile > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? matmul_launch<__nv_bfloat16> : matmul_launch<float>)(
        M, K, N, a, lda, b, ldb, out, ldo, st);
}
