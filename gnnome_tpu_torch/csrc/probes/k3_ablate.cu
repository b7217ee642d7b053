// The cost split of K3: K3 with parts knocked out, for Hopper (sm_90a).
//
// Replaces scripts/k3_ablate.py:run_variant (its pallas_call, body
// make_kernel), the TPU probe that located K3's cost by knocking parts out
// of the windowed one-hot kernel.  The card's K3 has no windows and no
// one-hot products, so the variants knock out the card kernel's own parts
// (k3_edge_stage.cuh, K3Part):
//
//   full           K3 (bit for bit gn_k3_edge_stage at the same team size)
//   edge_only      no pass u, no node sums          (JAX no_scatter)
//   sums_unstored  the node stores; sums still made  (JAX noout, dma_noout)
//   fixed_rows     the random row gathers            (JAX static_in)
//   stream_only    all arithmetic and the node sums  (JAX dma_only)
//   walk_only      every row: the walk of slot numbers and partners alone
//                                                    (JAX oh_only)
//
// and sweep what the JAX probe's chunk size swept: the team size T (lanes
// per node) and the ring depth P (slots in flight + 1), on `full`.  Only
// the vector path (V = 4: d divisible by 4, rows aligned) is built, and
// only the (variant, T, P) of GN_PROBE_INSTANCES: every variant at the
// team sizes K3 takes at d = 64 and 128 (16 and 32) and P = gn::kStages,
// `full` also at T = 8 and at P = 2 and 4.  Bound: as K3's, bytes; each
// variant's bytes are counted by gnnome_tpu_torch/probes/k3_ablate.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../k3_edge_stage.cuh"

namespace {

constexpr int kNotBuilt = -1;     // no instantiation for (part, team, stages)
constexpr int kNotVector = -2;    // d or the rows do not take the V = 4 path

// X(part, team, stages) for every instantiation
#define GN_PROBE_INSTANCES(X)                                                 \
    X(full, 8, 3) X(full, 16, 3) X(full, 32, 3)                               \
    X(full, 16, 2) X(full, 16, 4) X(full, 32, 2) X(full, 32, 4)               \
    X(edge_only, 16, 3) X(edge_only, 32, 3)                                   \
    X(sums_unstored, 16, 3) X(sums_unstored, 32, 3)                           \
    X(fixed_rows, 16, 3) X(fixed_rows, 32, 3)                                 \
    X(stream_only, 16, 3) X(stream_only, 32, 3)                               \
    X(walk_only, 16, 3) X(walk_only, 32, 3)

bool built(int part, int team, int stages) {
#define GN_HAS(A, T, P)                                                       \
    if (part == (int)K3Part::A && team == T && stages == P) return true;
    GN_PROBE_INSTANCES(GN_HAS)
#undef GN_HAS
    return false;
}

template <class S>
int dispatch(int part, int team, int stages, int n_nodes, int d,
             const int* v_ptr, const int* v_perm, const int* v_nbr,
             const int* u_ptr, const int* u_perm, const int* u_nbr,
             const void* proj_u, int64_t ldu, const void* proj_v,
             int64_t ldv, const void* b3e, const void* e_in, const void* bn,
             void* e_out, void* sum_v, void* sum_u, K3Probe probe,
             cudaStream_t st) {
    if (d % 4 != 0
        || !gn::rows_vec<S>({proj_u, proj_v, b3e, e_in, bn, e_out, sum_v,
                             sum_u}, {ldu, ldv}))
        return kNotVector;
#define GN_CASE(A, T, P)                                                      \
    if (part == (int)K3Part::A && team == T && stages == P)                   \
        return launch<K3Part::A, P, T, 4, S>(                                 \
            n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm, u_nbr,           \
            static_cast<const S*>(proj_u), ldu,                               \
            static_cast<const S*>(proj_v), ldv,                               \
            static_cast<const S*>(b3e), static_cast<const S*>(e_in),          \
            static_cast<const S*>(bn), static_cast<S*>(e_out),                \
            static_cast<S*>(sum_v), static_cast<S*>(sum_u), st, probe);
    GN_PROBE_INSTANCES(GN_CASE)
#undef GN_CASE
    return kNotBuilt;
}

}  // namespace

// part: a K3Part, team and stages an instantiated pair.  Every input is
// K3's; an output a variant does not write may be null (edge_only,
// stream_only, sums_unstored unstored: the sums; walk_only: e_out and the
// sums).  Returns 0, a CUDA error, kNotBuilt or kNotVector.
extern "C" int gn_k3_ablate(
    int part, int team, int stages, int n_nodes, int d, const int* v_ptr,
    const int* v_perm, const int* v_nbr, const int* u_ptr,
    const int* u_perm, const int* u_nbr, const void* proj_u, int64_t ldu,
    const void* proj_v, int64_t ldv, const void* b3e, const void* e_in,
    const void* bn, void* e_out, void* sum_v, void* sum_u, int store_sums,
    void* walk_v, void* walk_u, int bf16, void* stream) {
    if (!built(part, team, stages)) return kNotBuilt;
    if (n_nodes <= 0 || d <= 0) return (int)cudaSuccess;
    const K3Probe probe{store_sums, static_cast<unsigned*>(walk_v),
                        static_cast<unsigned*>(walk_u)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (bf16 ? dispatch<__nv_bfloat16> : dispatch<float>)(
        part, team, stages, n_nodes, d, v_ptr, v_perm, v_nbr, u_ptr, u_perm,
        u_nbr, proj_u, ldu, proj_v, ldv, b3e, e_in, bn, e_out, sum_v, sum_u,
        probe, st);
}
