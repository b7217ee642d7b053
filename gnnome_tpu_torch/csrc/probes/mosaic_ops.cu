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
//   gn_small_matmul  [M, K] @ [K, N]: float32 products (no TF32: the
//                    counterpart of a float32 HIGHEST product) or bf16
//                    products, exact, summed in float32 and rounded once
//                    (DEFAULT bf16).  A block takes a 32 x 16 output tile
//                    and splits K between its 8 warps; k-tiles of 64 come
//                    through a 4-stage cp.async ring, so all of K <= 256
//                    is in flight at once.  float32 runs on CUDA cores, a
//                    k-slice a warp, 4 x 4 register tiles fed by float4
//                    reads of shared memory; bf16 on the tensor cores, a
//                    k-slice two warps, mma.sync m16n8k16 fed by ldmatrix
//                    (.trans for the row-major b).  The slices' partial
//                    tiles are added in slice order through shared
//                    memory: a fixed order for every output, no atomics,
//                    bitwise reproducible.  Two instantiations: the vector
//                    one copies 16-byte chunks (zero-filled past the
//                    matrix edge) and needs a, b and their row strides on
//                    16 bytes; the scalar one loads elements into the same
//                    tiles and takes any view.  The C entry chooses by
//                    gn_small_matmul_vector.
//
// Every entry takes float32 or bf16 (`bf16` = 1) elements, int32 indices,
// row strides in elements (the last dimension contiguous), and launches on
// the given stream.  Bound: at the scripts' shapes every operation moves
// well under 1 MB, so each is a few microseconds of launch and latency
// against a bound below one.  The product is the one with work in it
// (0.92 MB and 33.6 MFLOP at [512, 256] @ [256, 128], 0.5 us at the
// float32 peak): with one output a thread on 16 x 16 tiles it lost 1.3x to
// cuBLAS in float32 and 3x in bf16, so it fills 128 SMs at that shape,
// keeps 4 x 4 outputs a thread, loads all its k-tiles at once and takes
// the tensor cores for bf16.  wgmma is not used: at M <= 512 and
// K <= 256 the latency of a load and of a short chain of mma.sync, not the
// tensor cores' rate, sets the time.  The other three are at the launch
// floor (~0.0027 ms) and stay as simple as is right.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../edge_math.cuh"

namespace {

using gn::elem_f32;
using gn::f32_elem;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;    // a grid-stride loop's blocks
constexpr int kSegWarps = 4;            // segment sum: output rows a block

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

// ---- the product ---------------------------------------------------------
// A block computes a kMmM x kMmN output tile in kSlices k-slices: every
// k-tile of kMmK is shared out, slice s taking k-steps [s * kMmK /
// kSlices, (s + 1) * kMmK / kSlices) of each tile, and each slice holds
// the whole block tile in the registers of its warps (float32 one warp a
// slice, bf16 two).  The k-tiles arrive through a ring of kMmStages
// shared-memory stages (all of K <= 256 in flight at once): by cp.async
// with zero fill in the vector instantiation, by element loads in the
// scalar one.  At the end the slices' partial tiles are added through
// shared memory (the ring's) in slice order and rounded once.
constexpr int kMmM = 32, kMmN = 16, kMmK = 64, kMmStages = 4;
constexpr int kMmThreads = 256;        // 8 warps

template <class S>
struct MmShape;
template <>
struct MmShape<float> {                 // CUDA cores: 4 x 4 outputs a thread
    static constexpr int kSlices = 8;   // a warp each: 8 k-steps of a tile
    static constexpr int kLdA = kMmK + 4;   // floats: 16-byte rows, no conflict
    static constexpr int kLdB = kMmN;
};
template <>
struct MmShape<__nv_bfloat16> {         // tensor cores: mma.m16n8k16
    static constexpr int kSlices = 4;   // two warps each (rows 0-15, 16-31):
                                        // one k16 step of a tile
    static constexpr int kLdA = kMmK + 8;   // 144-byte rows: ldmatrix
    static constexpr int kLdB = kMmN + 8;   // 48-byte rows: conflict-free
};

template <class S>
__host__ __device__ constexpr int mm_smem() {
    using Sh = MmShape<S>;
    return kMmStages * (kMmM * Sh::kLdA + kMmK * Sh::kLdB) * (int)sizeof(S);
}
static_assert(mm_smem<float>() >= MmShape<float>::kSlices * kMmM * kMmN * 4
              && mm_smem<__nv_bfloat16>()
                     >= MmShape<__nv_bfloat16>::kSlices * kMmM * kMmN * 4,
              "the ring holds the slices' float32 partial tiles");

// the vector instantiation's condition: every row of a and b starts on 16
// bytes, so a tile row is whole 16-byte chunks
bool mm_vector(const void* a, int64_t lda, const void* b, int64_t ldb,
               int es) {
    return (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0
           && (lda * es) % 16 == 0 && (ldb * es) % 16 == 0;
}

// 16 bytes to shared memory, the first `bytes` of them from src and the
// rest zero
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + R) and columns [c0, c0 + C) of src ([rows, cols] at row
// stride ld) into dst (row stride LD), zero outside the matrix
template <class S, bool VEC, int R, int C, int LD>
__device__ __forceinline__ void mm_tile(S* dst, const S* __restrict__ src,
                                        int64_t ld, int rows, int cols,
                                        int r0, int c0) {
    constexpr int E = 16 / (int)sizeof(S);      // elements a chunk
    constexpr int Q = C / E;                    // chunks a row
#pragma unroll
    for (int i = 0; i < (R * Q + kMmThreads - 1) / kMmThreads; ++i) {
        const int c = threadIdx.x + i * kMmThreads;
        if (R * Q % kMmThreads != 0 && c >= R * Q) break;
        const int r = c / Q, q = (c % Q) * E;
        const int gr = r0 + r, gc = c0 + q;
        S* d = dst + r * LD + q;
        if constexpr (VEC) {
            const int n = gr < rows ? min(max(cols - gc, 0), E) : 0;
            cp_async_zfill(d, n ? src + (int64_t)gr * ld + gc : src,
                           n * (int)sizeof(S));
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e)
                d[e] = gr < rows && gc + e < cols
                           ? src[(int64_t)gr * ld + gc + e]
                           : f32_elem<S>(0.0f);
        }
    }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p,
                                            bool trans) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    if (trans)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                     "{%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(s));
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                     "{%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(s));
}

// c (16 x 8, float32) += a (16 x 16, row) b (16 x 8, col), bf16 operands
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// float32: lane (tm, tn) = (lane / 4, lane % 4) holds outputs rows
// 4 tm .. 4 tm + 3, columns 4 tn .. 4 tn + 3 of the 32 x 16 tile; each
// group of 4 k-steps reads 4 float4 of a and 4 of b for 64 FMA
struct MmF32 {
    float acc[4][4] = {};
    __device__ __forceinline__ void step(const float* A, const float* B,
                                         int w, int lane) {
        using Sh = MmShape<float>;
        constexpr int kSteps = kMmK / Sh::kSlices;
        const int tm = lane >> 2, tn = lane & 3;
#pragma unroll
        for (int kk = 0; kk < kSteps; kk += 4) {
            const int k = w * kSteps + kk;
            float4 av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                av[i] = *reinterpret_cast<const float4*>(
                    A + (tm * 4 + i) * Sh::kLdA + k);
                bv[i] = *reinterpret_cast<const float4*>(
                    B + (k + i) * Sh::kLdB + tn * 4);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int n = 0; n < 4; ++n)
                        acc[i][n] = fmaf(lane4(av[i], j), lane4(bv[j], n),
                                         acc[i][n]);
        }
    }
    __device__ __forceinline__ void park(float* red, int w, int lane) const {
        const int tm = lane >> 2, tn = lane & 3;
        red += w * kMmM * kMmN;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(red + (tm * 4 + i) * kMmN + tn * 4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
};

// bf16: warp w takes rows 16 (w & 1) .. + 15 of the 32 x 16 tile, two mma
// tiles of 16 x 8, in k-slice w >> 1: a from one ldmatrix.x4, b from one
// ldmatrix.x4.trans (k16 x n16)
struct MmBf16 {
    float acc[2][4] = {};
    __device__ __forceinline__ void step(const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, int w,
                                         int lane) {
        using Sh = MmShape<__nv_bfloat16>;
        const int kb = (w >> 1) * 16, m = (w & 1) * 16;
        const int r = (lane & 7) + ((lane >> 3) & 1) * 8, h = (lane >> 4) * 8;
        unsigned af[4], bf[4];
        ldmatrix_x4(af, A + (m + r) * Sh::kLdA + kb + h, false);
        ldmatrix_x4(bf, B + (kb + r) * Sh::kLdB + h, true);
        mma_bf16(acc[0], af, bf[0], bf[1]);
        mma_bf16(acc[1], af, bf[2], bf[3]);
    }
    __device__ __forceinline__ void park(float* red, int w, int lane) const {
        const int g = lane >> 2, t = (lane & 3) * 2;
        red += (w >> 1) * kMmM * kMmN + (w & 1) * 16 * kMmN;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<float2*>(red + (g + 8 * h) * kMmN + ni * 8
                                           + t) =
                    make_float2(acc[ni][2 * h], acc[ni][2 * h + 1]);
    }
};

template <class S, bool VEC>
__global__ void __launch_bounds__(kMmThreads)
small_matmul(int M, int K, int N, const S* __restrict__ a, int64_t lda,
             const S* __restrict__ b, int64_t ldb, S* __restrict__ out,
             int64_t ldo) {
    using Sh = MmShape<S>;
    extern __shared__ __align__(16) unsigned char smem[];
    S* As = reinterpret_cast<S*>(smem);                 // [stage][m][k]
    S* Bs = As + kMmStages * kMmM * Sh::kLdA;           // [stage][k][n]
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m0 = blockIdx.y * kMmM, n0 = blockIdx.x * kMmN;
    const int tiles = (K + kMmK - 1) / kMmK;
    auto fetch = [&](int t) {
        const int st = t % kMmStages;
        mm_tile<S, VEC, kMmM, kMmK, Sh::kLdA>(
            As + st * kMmM * Sh::kLdA, a, lda, M, K, m0, t * kMmK);
        mm_tile<S, VEC, kMmK, kMmN, Sh::kLdB>(
            Bs + st * kMmK * Sh::kLdB, b, ldb, K, N, t * kMmK, n0);
    };
#pragma unroll
    for (int t = 0; t < kMmStages - 1; ++t) {
        if (t < tiles) fetch(t);
        cp_commit();
    }
    std::conditional_t<std::is_same<S, float>::value, MmF32, MmBf16> mm;
    for (int t = 0; t < tiles; ++t) {
        if (t + kMmStages - 1 < tiles) fetch(t + kMmStages - 1);
        cp_commit();
        cp_wait<kMmStages - 1>();     // tile t's group has landed
        __syncthreads();
        const int st = t % kMmStages;
        mm.step(As + st * kMmM * Sh::kLdA, Bs + st * kMmK * Sh::kLdB, w,
                lane);
        if (t + kMmStages < tiles)
            __syncthreads();          // the stage is free for tile t + 4
    }
    cp_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);        // [slice][m][n]
    mm.park(red, w, lane);
    __syncthreads();
    for (int o = threadIdx.x; o < kMmM * kMmN; o += kMmThreads) {
        float s = red[o];
#pragma unroll
        for (int v = 1; v < Sh::kSlices; ++v)
            s = __fadd_rn(s, red[v * kMmM * kMmN + o]);
        const int r = m0 + o / kMmN, c = n0 + o % kMmN;
        if (r < M && c < N) out[(int64_t)r * ldo + c] = f32_elem<S>(s);
    }
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

template <class S, bool VEC>
int matmul_launch(int M, int K, int N, const void* a, int64_t lda,
                  const void* b, int64_t ldb, void* out, int64_t ldo,
                  cudaStream_t st) {
    constexpr int smem = mm_smem<S>();
    auto k = small_matmul<S, VEC>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((N + kMmN - 1) / kMmN, (M + kMmM - 1) / kMmM);
    k<<<grid, kMmThreads, smem, st>>>(
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

// The dynamic shared memory of gn_small_matmul's blocks, in bytes: the ring
// of k-tiles, reused for the slices' partial tiles.
extern "C" int gn_small_matmul_smem(int bf16) {
    return bf16 ? mm_smem<__nv_bfloat16>() : mm_smem<float>();
}

// 1 when gn_small_matmul takes its vector instantiation for these operands
// (a, b and their row strides on 16 bytes), 0 for the scalar one.
extern "C" int gn_small_matmul_vector(const void* a, int64_t lda,
                                      const void* b, int64_t ldb, int bf16) {
    return (int)mm_vector(a, lda, b, ldb, bf16 ? 2 : 4);
}

// out [M, N] (row stride ldo) = a [M, K] (lda) @ b [K, N] (ldb): float32
// FMA on CUDA cores, or bf16 products on the tensor cores summed in
// float32, each output's sum in a fixed order, rounded once to the element
// type.  The vector or the scalar instantiation, by gn_small_matmul_vector.
extern "C" int gn_small_matmul(int M, int K, int N, const void* a,
                               int64_t lda, const void* b, int64_t ldb,
                               void* out, int64_t ldo, int bf16,
                               void* stream) {
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    if ((M + kMmM - 1) / kMmM > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = gn_small_matmul_vector(a, lda, b, ldb, bf16);
    auto launch = bf16 ? (vec ? matmul_launch<__nv_bfloat16, true>
                              : matmul_launch<__nv_bfloat16, false>)
                       : (vec ? matmul_launch<float, true>
                              : matmul_launch<float, false>);
    return launch(M, K, N, a, lda, b, ldb, out, ldo, st);
}
