#!/usr/bin/env python3
"""Every kernel of PERF.md's kernel table timed alone on the card, beside
its least possible time.

    python3 scripts/torch_kernel_times.py [--seed N]

Shapes: the golden graph (tests/fixtures/golden_ecoli_v1.npz, N = 9,600,
E = 257,346, its real CSR) at d = H = 64, flip=False and flip=True, and at
the dual symmetry pass's width 128; K1 and K2 at the layer-norm model's
widths; the one-sided K2 walk at D = 64 and 192 into each side; K9 also on
the golden graph with its node ids relabelled by a seeded permutation; the
batch-norm edge adjoint at w = 128 and 64 on the golden graph's edge count
and the ~2.41M edges of the cell train-b64-g524k; the layer-norm edge
stage and its adjoint at d = 64 on the golden graph and at the 1.21M edge
rows over 262,144 nodes of the cell train-ln64-g262k.  float32, and bf16
where the kernel has a bf16 instantiation; inputs drawn from ``--seed``.

Per row: ``ms``, the device's time a call: CUDA events around 10 calls
queued behind a sleep kernel, median of 10 repeats after 3 warm-up calls;
``call_ms`` the same without the sleep (back-to-back calls, the host's
share included); ``plain_ms`` the kernel's plain PyTorch version;
``library_ms`` the one PyTorch call that computes the same function, where
there is one; ``bound_ms`` the larger of the least bytes (inputs read
once, outputs written once) over 3.35 TB/s and the operations over their
peak (67 TFLOP/s float32, 34 float64), ``bound_by`` which one.  The
correctness of every kernel at these shapes is the card suite's
(tests/test_torch_cuda.py).

It imports ``gnnome_tpu_torch`` from ``PYTHONPATH`` when that holds
another tree (an older commit unpacked with ``git archive`` into an
ignored directory), else from this repository, so two trees compare in one
call on one card: run it as parent, change, change, parent.  Prints one
JSON line per kernel and shape, then one with the package's path and the
card (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)          # after PYTHONPATH: another tree's package wins
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")

# H100 SXM data sheet: HBM3 bandwidth, float32 and float64 (non-tensor-core)
# peaks (the bf16 kernels' arithmetic is float32 too)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12
F4 = I4 = 4          # bytes of a float32, an int32
BF2 = 2              # bytes of a bfloat16
DUAL_D = 128         # the batch-norm step's dual pass: d = 2 x 64
BN_ADJOINT_CELL_ROWS = 2_410_000           # train-b64-g524k's edges
LN_CELL_ROWS, LN_CELL_NODES = 1_210_000, 262_144   # train-ln64-g262k's


def cuda_ms(fn, reps: int = 10, n: int = 10, warmup: int = 3,
            queued: bool = False) -> float:
    """Milliseconds per call of ``fn`` on the card: the median over ``reps``
    repeats of ``n`` back-to-back calls between two CUDA events.  With
    ``queued`` the host queues each repeat's calls while the device still
    runs a sleep kernel, so the time is the device's alone: the host's
    share of a call, which can exceed a short kernel's time, is left
    out."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], 1 << 24            # ~10 ms of sleep at 1.7 GHz
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        ahead = not queued or not a.query()     # the device still slept
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / n)
        else:                      # the host fell behind: sleep longer
            cycles *= 2
            if cycles > 1 << 32:
                raise RuntimeError("calls never queued behind a sleep kernel")
    return statistics.median(times)


def bound(nbytes: float, flops: float, flops64: float = 0.0):
    """Least time in ms: the larger of bytes over the memory rate and the
    float32 plus float64 operations over their peak rates."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / F32_FLOPS_PER_S + flops64 / F64_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# The kernels' least bytes and operations; ``es`` is the bytes of one row
# element (F4 in float32, BF2 in bf16).  Indices and row pointers are int32,
# float64 sums 8 bytes and K2's and K9's sums float32 at either element
# size.
def k3_cost(N: int, E: int, d: int, es: int = F4):
    """K3's least bytes and float32 operations: read proj_u/proj_v (used
    columns), b3e, e_in, bn, u/v indices, both row-pointer arrays and one
    slot permutation; write e_out and both [N, 2d] sums.  ~20 flops per
    (edge, feature) over the two passes (gate 2, BN 4, relu 1, residual 1,
    sigmoid ~3 twice, gated products and sums 3 twice)."""
    return (es * (2 * N * 2 * d + 3 * E * d + 4 * d + 2 * N * 2 * d)
            + I4 * (3 * E + 2 * (N + 1))), 20.0 * E * d, 0.0


def k6_cost(N: int, E: int, H: int, es: int = F4):
    """Read puv, be, u/v indices; write z; add, add, max per element."""
    return es * (N * 2 * H + 2 * E * H) + I4 * 2 * E, 3.0 * E * H, 0.0


def k7_cost(N: int, E: int, d: int, es: int = F4):
    """Read the two [N, d] gate columns, b3e, u/v indices; write [2d] f64.
    Per (edge, feature): 2 f32 adds (the gate); 3 f64 operations (sum x,
    x*x, sum x*x)."""
    return (es * (2 * N * d + E * d) + I4 * 2 * E + 8 * 2 * d,
            2.0 * E * d, 3.0 * E * d)


def k8_cost(N: int, E: int, d: int, es: int = F4):
    """Read d_sum_u/v, proj_u/v ([N, 2d] each), b3e, e_in, d_e_out, bn, u/v
    indices, both row-pointer arrays and one slot permutation; write x,
    d_eo, node_u/v ([N, 3d]) and [2d] f64.  Per (edge, feature) about 49
    float32 operations over the two passes (gate 2, BN 4 twice, relu and
    residual 2 twice, sigmoid ~4 twice, d_sigma 7, d_eo 4, d_y 1, three
    sums of 2, 2 and 1 twice) and 3 float64 (sum d_y, d_y*x, its sum)."""
    return (es * (4 * N * 2 * d + 3 * E * d + 4 * d + 2 * E * d
                  + 2 * N * 3 * d) + 8 * 2 * d + I4 * (3 * E + 2 * (N + 1)),
            49.0 * E * d, 3.0 * E * d)


def k9_cost(N: int, E: int, H: int, es: int = F4):
    """Read pay, both row-pointer arrays and one slot permutation; write
    the float32 [N, 2H] sums; one add per (edge, feature) and endpoint."""
    return (es * E * H + F4 * 2 * N * H + I4 * (E + 2 * (N + 1)),
            2.0 * E * H, 0.0)


def k1_cost(N: int, E: int, d: int, es: int = F4):
    """K1: read the used [N, 2d] halves of the projection, b3e, u/v
    indices; write [E, 3d]; two adds per (edge, feature)."""
    return (es * (2 * N * 2 * d + E * d + E * 3 * d) + I4 * 2 * E,
            2.0 * E * d, 0.0)


def k2_cost(N: int, E: int, Dp: int, es: int = F4):
    """K2: read both payloads, both row-pointer arrays and one slot
    permutation; write the two float32 [N, Dp] sums (at either element
    size); one add per element."""
    return (es * 2 * E * Dp + F4 * 2 * N * Dp + I4 * (E + 2 * (N + 1)),
            2.0 * E * Dp, 0.0)


def side_sum_cost(N: int, E: int, D: int, permuted: bool):
    """The one-sided K2 walk: read pay, the row pointers and (src side) the
    slot permutation; write [N, D]; one add per (edge, feature)."""
    return (F4 * (E * D + N * D) + I4 * ((N + 1) + (E if permuted else 0)),
            1.0 * E * D, 0.0)


def bn_adjoint_cost(E: int, w: int, es: int = F4):
    """The batch-norm edge adjoint: read x and d_eo, write d_b3e ([E, w]
    each), read the [4, w] rows and the float32 [3, w] ones; 9 operations
    an element (the affine 4, the mask 1, two products and two sums)."""
    return es * (3 * E * w + 4 * w) + F4 * 3 * w, 9.0 * E * w, 0.0


def ln_stage_cost(E: int, d: int):
    """The layer-norm edge stage: read g3 [E, 3d], e_in [E, d] and the [d]
    weight and bias; write e_out [E, d], the payloads [E, 2d] each and the
    [E, 2] statistics.  ~16 operations an element (statistics 5, the
    normalisation 4, relu and residual 2, sigmoid ~3, two products)."""
    return F4 * (4 * E * d + 2 * d + 5 * E * d + 2 * E), 16.0 * E * d, 0.0


def ln_adjoint_cost(N: int, E: int, d: int):
    """The layer-norm edge stage's adjoint: read g3 [E, 3d], e_out and
    d_e_out [E, d], the statistics [E, 2], u/v indices, the two [N, 2d]
    cotangents once, weight and bias; write the payloads [E, 2d] each, d_e
    [E, d] and [2, d]; ~30 float32 operations an element (sigmoid ~3,
    d_sigma 7, d_e 4, the normalisation 4, mask 1, the row sums 4, d_gate
    4, the messages 2) and 2 float64 adds (the parameter sums)."""
    return (F4 * (5 * E * d + 2 * E + 2 * N * 2 * d + 2 * d + 5 * E * d
                  + 2 * d) + I4 * 2 * E, 30.0 * E * d, 2.0 * E * d)


def rows(g, rel, dev, seed: int):
    """Every row of the table: ``(kernel, dtype, shape, call, plain call,
    library call or None, (bytes, flops, flops64))``.  Each row's inputs
    live until the next row is drawn."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    N, E = g.n_nodes, g.n_edges
    for dt, es in ((torch.float32, F4), (torch.bfloat16, BF2)):
        def bn_rows(d):
            """Eval BatchNorm rows [mean, rsqrt(var + eps), gamma, beta];
            in bf16 the folded affine [0, 1, scale, bias] the kernels take
            (ops/message.bn_edge_rows)."""
            if dt == torch.bfloat16:
                return torch.stack([torch.zeros(d, device=dev),
                                    torch.ones(d, device=dev), rand(d) + 0.5,
                                    randn(d) * 0.1]).to(dt)
            return torch.stack([randn(d) * 0.3, rand(d) * 1.5 + 0.5,
                                rand(d) + 0.5, randn(d) * 0.1])

        # K1 and K2 at the layer-norm model's widths: K1 on the column
        # slices of an [N, 5d] projection, K2 at the gated mean's Dp = 128
        # and the predictor gathers' adjoint's 64
        u, v, v_csr, u_csr = g.roles(False)
        proj = randn(N, 5 * 64).to(dt)
        pu, pv, b3e = proj[:, :128], proj[:, 128:256], randn(E, 64).to(dt)
        yield ("k1_gather_gate", dt, "d=64",
               lambda: K.k1_gather_gate(u, v, pu, pv, b3e),
               lambda: K.k1_gather_gate_plain(u, v, pu, pv, b3e), None,
               k1_cost(N, E, 64, es))
        for width in (128, 64):
            pay_u, pay_v = randn(E, width).to(dt), randn(E, width).to(dt)
            pay2, acc = torch.cat([pay_u, pay_v]), torch.zeros(2 * N, width,
                                                               device=dev)
            uv = torch.cat([u.long(), v.long() + N])
            yield ("k2_aggregate", dt, f"Dp={width}",
                   lambda: K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v),
                   lambda: K.k2_aggregate_plain(u, v, pay_u, pay_v, N),
                   lambda: acc.zero_().index_add_(0, uv, K.wide(pay2)),
                   k2_cost(N, E, width, es))
        # K3, K6, K7, K8, K9 at d = H = 64 at both flips, and at the dual
        # pass's 128 (flip=False); K3 on the column slices of an [N, 5d]
        # projection (as the model), K7 and K8 of the [N, 4d] training one
        for dd, flips in ((64, (False, True)), (DUAL_D, (False,))):
            proj5 = randn(N, 5 * dd).to(dt)
            proj4 = randn(N, 4 * dd).to(dt)
            b3e, e_in, d_e_out = (randn(E, dd).to(dt) for _ in range(3))
            bn = bn_rows(dd)
            d_sum_u, d_sum_v = randn(N, 2 * dd).to(dt), randn(N, 2 * dd).to(dt)
            puv, be = randn(N, 2 * dd).to(dt), randn(E, dd).to(dt)
            pay = torch.relu(randn(E, dd)).to(dt)   # about half zeros
            for flip in flips:
                u, v, v_csr, u_csr = g.roles(flip)
                shape = f"d={dd}" + (" flip=True" if flip else "")
                k3 = (u, v, v_csr, u_csr, proj5[:, :2 * dd],
                      proj5[:, 2 * dd:4 * dd], b3e, e_in, bn)
                yield ("k3_edge_stage", dt, shape,
                       lambda: K.k3_edge_stage(*k3),
                       lambda: K.k3_edge_stage_plain(*k3[:2], *k3[4:]),
                       None, k3_cost(N, E, dd, es))
                yield ("k6_score_gate", dt, shape,
                       lambda: K.k6_score_gate(u, v, puv, be),
                       lambda: K.k6_score_gate_plain(u, v, puv, be), None,
                       k6_cost(N, E, dd, es))
                bu, bv = proj4[:, :dd], proj4[:, 2 * dd:3 * dd]
                yield ("k7_gate_stats", dt, shape,
                       lambda: K.k7_gate_stats(u, v, bu, bv, b3e),
                       lambda: K.k7_gate_stats_plain(u, v, bu, bv, b3e),
                       None, k7_cost(N, E, dd, es))
                k8 = (d_sum_u, d_sum_v, proj4[:, :2 * dd], proj4[:, 2 * dd:],
                      b3e, e_in, d_e_out, bn)
                yield ("k8_train_layer_bwd", dt, shape,
                       lambda: K.k8_train_layer_bwd(u, v, v_csr, u_csr, *k8),
                       lambda: K.k8_train_layer_bwd_plain(u, v, *k8), None,
                       k8_cost(N, E, dd, es))
                # the one PyTorch call for K9's sums: index_add_ over the
                # stacked [u; v + N] and [pay; pay], with atomics
                uv = torch.cat([u.long(), v.long() + N])
                pay2 = torch.cat([pay, pay])
                acc = torch.zeros(2 * N, dd, device=dev, dtype=dt)
                yield ("k9_aggregate", dt, shape,
                       lambda: K.k9_aggregate(u, v, v_csr, u_csr, pay),
                       lambda: K.k9_aggregate_plain(u, v, pay, N),
                       lambda: acc.zero_().index_add_(0, uv, pay2),
                       k9_cost(N, E, dd, es))
            if dd == 64:
                # K6 on column slices of wider arrays (row-strided), K9 on
                # the relabelled graph (no id locality)
                puv_s = torch.zeros(N, 2 * dd + 8, device=dev,
                                    dtype=dt)[:, :2 * dd].copy_(puv)
                be_s = torch.zeros(E, dd + 8, device=dev,
                                   dtype=dt)[:, :dd].copy_(be)
                u, v, v_csr, u_csr = g.roles(False)
                yield ("k6_score_gate", dt, "d=64 column slices",
                       lambda: K.k6_score_gate(u, v, puv_s, be_s),
                       lambda: K.k6_score_gate_plain(u, v, puv_s, be_s),
                       None, k6_cost(N, E, dd, es))
                ru, rv, rv_csr, ru_csr = rel.roles(False)
                yield ("k9_aggregate", dt, "H=64 relabelled",
                       lambda: K.k9_aggregate(ru, rv, rv_csr, ru_csr, pay),
                       lambda: K.k9_aggregate_plain(ru, rv, pay, N), None,
                       k9_cost(N, E, dd, es))
        # the batch-norm edge adjoint beside torch.add of x and d_eo (the
        # same three [E, w] streams); x drawn about the mean so that y
        # straddles 0
        for n_rows, size in ((E, "golden"), (BN_ADJOINT_CELL_ROWS, "cell")):
            for w in (DUAL_D, 64):
                mean, inv = randn(w) * 0.3, rand(w) + 0.5
                gamma, beta = rand(w) + 0.5, randn(w) * 0.1
                scale = gamma * inv
                bn = (torch.stack([torch.zeros_like(scale),
                                   torch.ones_like(scale), scale,
                                   beta - mean * scale]).to(dt)
                      if dt == torch.bfloat16
                      else torch.stack([mean, inv, gamma, beta]))
                x = (randn(n_rows, w) / inv + mean).to(dt)
                adj = (x, randn(n_rows, w).to(dt), bn,
                       torch.stack([scale, randn(w) * 1e-4, randn(w) * 1e-4]))
                o = torch.empty_like(x)
                yield ("bn_edge_adjoint", dt, f"{size} rows={n_rows} w={w}",
                       lambda: K.bn_edge_adjoint(*adj),
                       lambda: K.bn_edge_adjoint_plain(*adj),
                       lambda: torch.add(adj[0], adj[1], out=o),
                       bn_adjoint_cost(n_rows, w, es))
                del x, adj, o
    # the one-sided K2 walk (the zoo's node sums, float32 only) at D = 64
    # (GCN, SAGE) and 192 (GAT's messages), beside index_add_ into one side
    _, _, by_dst, by_src = g.roles(False)
    for D in (64, 192):
        pay = randn(E, D)
        acc = torch.zeros(N, D, device=dev)
        for side, idx, csr in (("dst", g.dst, by_dst), ("src", g.src, by_src)):
            idx64 = idx.long()
            yield ("k2_side_sum", torch.float32, f"D={D} into {side}",
                   lambda: K.k2_side_sum(idx, csr, pay),
                   lambda: K.k2_side_sum_plain(idx, pay, N),
                   lambda: acc.zero_().index_add_(0, idx64, pay),
                   side_sum_cost(N, E, D, side == "src"))
    # the layer-norm edge stage and its adjoint (float32 only), LayerNorm
    # at d = 64, on the golden graph and at the ln cell's rows (random
    # endpoints); the adjoint takes the stage's statistics
    d = 64
    cell = [torch.randint(0, LN_CELL_NODES, (LN_CELL_ROWS,), device=dev,
                          generator=gen, dtype=torch.int32)
            for _ in range(2)]
    u, v, _, _ = g.roles(False)
    for size, (uu, vv, n) in (("golden", (u, v, N)),
                              ("cell", (*cell, LN_CELL_NODES))):
        rows_ = uu.shape[0]
        fwd = (randn(rows_, 3 * d), randn(rows_, d), rand(d) + 0.5,
               randn(d) * 0.1, 1e-5)
        e_out, _, _, stats = K.ln_edge_stage(*fwd)
        adj = (uu, vv, randn(n, 2 * d), randn(n, 2 * d), fwd[0], e_out,
               randn(rows_, d), stats, fwd[2], fwd[3])
        shape = f"{size} rows={rows_} d={d}"
        yield ("ln_edge_stage", torch.float32, shape,
               lambda: K.ln_edge_stage(*fwd),
               lambda: K.ln_edge_stage_plain(*fwd), None,
               ln_stage_cost(rows_, d))
        yield ("ln_edge_adjoint", torch.float32, shape,
               lambda: K.ln_edge_adjoint(*adj),
               lambda: K.ln_edge_adjoint_plain(*adj), None,
               ln_adjoint_cost(n, rows_, d))


def measure(seed: int):
    """Every row of the table, timed on the card: one dict per kernel and
    shape, as ``main`` prints them."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import DeviceGraph

    dev = torch.device("cuda")
    graph = AssemblyGraph.load(GOLDEN)
    g = DeviceGraph.from_graph(graph, dev)
    perm = np.random.default_rng(seed).permutation(graph.num_nodes)
    rel = DeviceGraph.build(perm[np.asarray(graph.src)],
                            perm[np.asarray(graph.dst)], graph.num_nodes, dev)
    for name, dt, shape, fn, plain, library, cost in rows(g, rel, dev, seed):
        ms = cuda_ms(fn, queued=True)
        b_ms, b_by = bound(*cost)
        yield {"kernel": name, "dtype": str(dt).split(".")[1], "shape": shape,
               "ms": ms, "call_ms": cuda_ms(fn), "bound_ms": b_ms,
               "bound_by": b_by, "bytes": cost[0], "share_of_bound": b_ms / ms,
               "plain_ms": cuda_ms(plain),
               "library_ms": cuda_ms(library) if library else None}


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import gnnome_tpu_torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    for row in measure(args.seed):
        print(json.dumps(row), flush=True)
    print(json.dumps({"package": os.path.dirname(gnnome_tpu_torch.__file__),
                      **card(), "seed": args.seed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
