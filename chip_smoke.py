#!/usr/bin/env python3
"""Smoke run of gnnome_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels (``build/libgnnome_kernels.so``) and the host
library (``build/libgnnome_host.so``) from the sources in the checkout, then
runs its phases, each printing one JSON line (with ``elapsed_s``, the
seconds since the script started):

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, compute capability, build seconds, the compiler's per-kernel
   register and spill report.
2. ``model``: the E. coli-scale golden graph
   (tests/fixtures/golden_ecoli_v1.npz: N=9,600, E=257,346) scored with
   ``weights/weights.npz`` (d=H=64, 8 layers) on the card; held against the
   port's own CPU run; two card runs bitwise equal; K3 launched 8 times and
   K6 once per forward; average precision against the graph's labels.
3. ``model_unfused``: the same graph scored by the layer-norm and the
   norm-free model at full width and depth (d=H=64, 8 layers, seeded init
   weights): card vs CPU, two card runs bitwise equal, exactly 8 K1, 8
   layer-norm edge stages and 8 K2 launches per forward and no other
   kernel, forward time and memory.
4. ``kernels``: K1, K2 (at Dp = 128 and 64), K3, K6, K7, K8 and K9 (each at
   both flips) at the golden graph's shapes on its real CSR, inputs from
   ``--seed``; each kernel against its plain PyTorch version on the card,
   and timed beside its least possible time and, where one PyTorch call
   computes the same function, that call's time: ``kernel_ms`` by CUDA
   events around 10 back-to-back calls (median of 10 such repeats, after
   warm-up; the host's share of a call included, which a short kernel's
   wrapper can exceed), ``device_ms`` the same with each repeat's calls
   queued behind a sleep kernel (the device alone); for K3 and K8 also the
   memory rate their device time gives the bytes they move, for K6, K7
   and K9 the rate it gives their bound's bytes.  K1 must be bit-equal to
   its plain version; K2 and K9 to theirs run on CPU copies of their
   inputs; K9 is also timed on a copy of the golden graph whose node ids
   are relabelled by a seeded random permutation.  The dual symmetry pass's widths: K3, K7,
   K8 at d = 128 and K6, K9 at H = 128 (flip=False), checked and timed
   beside their bounds.  The one-sided K2 walk (``k2_side_sum``, the
   zoo's node sums) at D = 64 and 192 into each side, timed beside
   ``index_add_`` into one side, bit-equal to its plain version on CPU
   copies (also at D = 3 and on column slices).  Then K1, K3, K6, K7 and
   K8 at d = 192 and K2, K9 at width 256 on the same graph, and K6 at H
   = 20 on its one-float path; K1 at d = 20 with an odd row stride, K2 at
   an odd width on column slices, K6 on column slices of wider arrays
   (row-strided), K9 on column slices at H = 256 and 20 (float4 rows and
   one float per lane); each against its plain version and bitwise
   reproducible.  The batch-norm edge adjoint (A below; a stream over
   [E, w], no graph) at w = 128 and 64, at the golden graph's edge count
   and at the ~2.41M edges of the benchmark cell train-b64-g524k: bit-equal
   to its plain version, timed beside its byte bound, the plain version
   and ``torch.add`` of its two inputs (the same three streams); its
   one-element path at w = 36 and on rows off a 16-byte boundary checked.
   The layer-norm edge stage and its adjoint (with LayerNorm and
   norm-free) at d = 64 on the golden graph and at the ~1.21M edge rows
   and 262,144 nodes of the benchmark cell train-ln64-g262k, at d = 6 and
   200 on the golden graph: against their plain versions on the card
   (LN_* tolerances), bitwise reproducible, timed beside their byte
   bounds and plain versions.  Every wrapper at E = 0 (a graph of 5 nodes and no edges, float32 and
   bf16): its plain version's outputs, no launch.
5. ``infer``: a synthetic dataset written in the dataset layout, then
   ``gnnome_tpu_torch.cli infer`` on the card (the eval path, with every
   launch counter set to 0 just before it); the longest contig must be an
   exact substring of the genome.
5b. ``gfa_route``: the front of the main path with the port alone.  The
   phase-5 genome's reads written as a hifiasm-dialect and a raven-dialect
   GFA; ``cli build-graph`` on each (host), then ``cli infer`` on the card
   (exactly 8 K3 + 1 K6, an exact contig); ``cli run`` with a stub
   ``hifiasm`` that copies the prepared GFA (8 K3 + 1 K6, the FASTA of
   build-graph + infer byte for byte); ``cli build-graph --training`` and
   one ``cli train --overfit`` epoch on the card (8/8/8/8/1/1
   K7/K3/K8/A/K6/K9 per unit); a host-timing build at the golden graph's
   node count (4,800 reads, 9,600 nodes, 600 kb at ~7x) in a process of
   its own: the seconds of build-graph's stages (parse, similarities,
   save) and its peak RSS.
6. ``train_step`` and ``train_step_layer``: the full-width model (d=64, 8
   layers), started from the shipped weights (batch norm) or seeded init
   weights (layer norm).  On the golden subgraph, one symmetry-loss step on
   the card against the port's CPU step (loss, every gradient, BN state);
   with batch norm the step runs both passes as one dual-width pass
   (``forward_dual``), held also against the two sequential passes
   (``forward_pair``) on the card; on the whole golden graph as one unit,
   two steps from one state bitwise equal (loss, logits, gradients,
   parameters after Adam), exactly 8 K7, 8 K3, 8 K8, 8 A, 1 K6 and 1 K9
   launches per step (layer norm: 16 K1, 16 layer-norm edge stages, 16
   of their adjoints and 34 K2), no host
   synchronisation inside a step (``torch.cuda.set_sync_debug_mode
   ("error")``), the step time and peak memory.
7. ``train``: ``gnnome_tpu_torch.cli train`` on the card with the default
   settings (the training path, counters set to 0 just before it): one
   epoch on the golden graph written as a training dataset (train = valid);
   resumed twice from its checkpoint, the two checkpoints bitwise equal;
   then an overfit run on a small synthetic dataset (12 epochs, lr 1e-3)
   whose last loss must be under 0.9x its first and whose saved model must
   score an average precision above 0.75.
8. ``cli_layer``: the layer-norm model's paths, each with the counters set
   to 0 just before it: ``cli train --set model.normalization=layer`` on
   the overfit dataset (12 epochs, lr 1e-3), which must learn as phase 7's
   run must, then ``cli infer`` with the model it saved on phase 5's
   dataset, whose longest contig must be an exact substring of the genome.
9. ``zoo``: GatedGCN, GCN, GAT and SAGE directed and GatedGCN undirected
   on the golden graph at full width (d=64, 8 layers, 3 GAT heads, seeded
   init weights): each eval forward card vs CPU, bitwise across card runs,
   exactly its one-sided K2 walks per forward; each train step (plain
   BCE) as phase 6 checks it, with its walks and one K2 per step.
10. ``cli_zoo``: ``cli train --set model.model=gcn`` (two epochs) on phase
   5's dataset, then ``cli infer`` with the model it saved, counters set
   to 0 just before each.
11. The bfloat16 compute mode of the batch-norm model (``compute.dtype=
   bfloat16``), in four phases placed after the float32 phase each one
   mirrors: ``kernels_bf16`` (after 4): the bf16 instantiations of K3, K6,
   K7, K8 and K9 against their bf16 plain versions, timed beside their
   bf16 bounds at the golden shapes (d = H = 64, both flips; the dual
   width 128), and checked at d = 192, on column slices and odd row
   strides (K6 at H = 20, K9 at 256 and 20), bitwise reproducible, and
   A as in phase 4;
   ``model_bf16`` (after 5): the golden graph in bf16, card vs the CPU's
   bf16 run (logit cosine, probabilities, AP), two card runs bitwise
   equal, 8 K3 + 1 K6 per forward, AP within 1e-4 of the JAX package's
   bf16 figure, the forward's time and memory beside phase 2's float32
   ones; ``train_step_bf16`` (after 6): phase 6's checks of the batch-norm
   dual step in bf16, against the CPU's bf16 step to the JAX package's
   bf16 bounds; ``cli_bf16`` (after 8): ``cli infer --set compute.dtype=
   bfloat16`` on phase 5's dataset (exact contig) and a bf16 overfit run
   that must learn (12 epochs of 8/8/8/8/1/1 K7/K3/K8/A/K6/K9, every launch
   bf16).
12. The bfloat16 mode of the layer-norm and norm-free models, through the
   bf16 instantiations of K1 and K2, placed as phase 11's: in
   ``kernels_bf16``, bf16 K1 (d = 64 on the column slices of a bf16
   [N, 5d] projection; d = 192, 20 and 20 with an odd row stride) and K2
   (Dp = 128 and 64; 256 and an odd width on column slices), both flips,
   K1 bit-equal to its plain version on the card and K2 on CPU copies,
   bitwise reproducible, timed beside their bf16 bounds, their plain
   versions and, for K2, ``index_add_`` into float32 sums;
   ``model_unfused_bf16`` (after ``model_bf16``): phase 3's models in
   bf16, card vs the CPU's bf16 run (logit cosine > 0.9995,
   probabilities within 0.02, AP within 5e-4), two card runs bitwise
   equal, 8 K1 + 8 K2 per forward, all bf16 (none) or one bf16 K1 (layer
   norm: float32 from its first norms on, as in the JAX package, so its
   layers 2-8 also run 7 float32 layer-norm edge stages), the
   forward's time and memory beside phase 3's; ``train_step_none`` (phase
   6 for the norm-free model) and ``train_step_layer_bf16`` /
   ``train_step_none_bf16``: phase 6's checks in bf16 against the CPU's
   bf16 step to the JAX package's bf16 bounds, 16 K1 + 34 K2 per step
   (layer norm also 14 float32 edge stages and 14 of their adjoints), of
   them bf16 16 + 34 (none) or 2 + 2 (layer norm), the step's time and
   memory beside float32's; ``cli_unfused_bf16`` (after ``cli_bf16``):
   ``cli train --set model.normalization=none --set compute.dtype=
   bfloat16`` (overfit, 12 epochs, must learn; every launch bf16), then
   ``cli infer`` with the model it saved on phase 5's dataset (exact
   contig, 8 bf16 K1 + 8 bf16 K2).
12b. ``probes`` (after ``kernels_bf16``, before the paths): the card
   probes (``gnnome_tpu_torch/probes``), their library
   (``build/libgnnome_probes.so``) built from the checkout.  Every
   instantiated K3 variant (``csrc/probes/k3_ablate.cu``: full, edge_only,
   sums_unstored, fixed_rows, stream_only, walk_only at K3's team sizes,
   full also at other team sizes and ring depths) against its plain
   version on the golden graph at d = 64 and 128, both flips, float32 and
   bf16, ``full`` bit for bit K3; ``stream_sum`` bit for bit its plain
   version at every point of the sweeps, float32 and bf16.  Then K3's
   cost split (every variant at K3's own team size and depth, full's team
   and depth sweeps; CUDA events around 10 calls queued behind a sleep
   kernel, median of 5) on the golden graph and the JAX probe's bench
   graph (``random_bench_graph(262,144, 6.0)``, 1,572,864 edges) at d = 64
   and 128 in float32 and bf16, and ``dma_probe``'s K sweep (K = 1-12 at T = 768, ET = 2048) and
   grid sweep (K = 4, T x ET constant) in bf16 and float32, 20 chained
   calls: ms, GB/s, microseconds per block and per block input, and the
   best GB/s against the nominal 3.35 TB/s.  Then the Mosaic repro probe
   (``probes/mosaic_repro.py``, ``csrc/probes/mosaic_ops.cu``: row stack,
   row gather, segment sum, small product) through its entry
   ``run_cases`` with the probe counters from 0: every case of the five
   ``scripts/mosaic_f32_repro*.py`` (42 with the dtypes) ``PASS`` against
   its plain chain and repeated bit for bit, each kernel launched, the
   rows under ``mosaic`` of the ``probes`` line; and the four kernels
   alone at the scripts' P3 shapes in float32 and bf16, where
   ``small_matmul`` must take its vector instantiation (its route
   counters, ``small_matmul.routes``); ``small_matmul`` at P3's shape
   through both instantiations (16-byte rows and views one element in),
   each against its plain version and bit for bit on repeat.  Then the two
   redesigned kernels in turns with their one-call library counterparts
   (kernel, library, library, kernel): ``small_matmul`` at P3's shape
   against ``torch.matmul`` (float32 with TF32 off, bf16), ``stream_sum``
   at T = 768, ET = 2048 against ``copy_`` (K = 1) and ``torch.add``
   (K = 2), both dtypes; and their registers, spills and shared memory
   from ``build/nvcc_probes.log`` (``resources``, ``turns`` in the
   ``probes`` line).
13. ``halo``: halo-exchange graph parallelism (``compute.mesh > 1``,
   ``gnnome_tpu_torch/parallel/``) with P ranks sharing the card over gloo,
   every message staged through pinned host memory.  The single-device
   card runs first (P = 1: forwards, steps, times), then one spawned group
   per P holds every check of that P: the JAX bench's mesh graph
   (``random_bench_graph(65,536, 6.0)``, bench.py:426-432) at P = 2 and 4,
   eval logits and one symmetry-loss step (dropout 0) against the
   single-device ones, the parameters after Adam bitwise equal on every
   rank, a bf16 step at P = 2; the golden graph at P = 2 through the
   overflow-uncapped route (AP within 1e-4 of the JAX figure, a step);
   ``random_rc_bench_graph(1,048,576, 8.0)``'s eval at P = 2 and 4; per
   rank 8 K3 + 1 K6 per forward and 16/16/16/16/2/2 K7/K3/K8/A/K6/K9 per step;
   the route, K, R, extended rows, edges, bytes and times per rank, the
   time of an idle collective.  At P = 4 also a graph of 3 RC pairs (one
   rank's block empty): eval logits within 1e-4 + 1e-4 |x| of the
   single-device card forward, one step as above, and per rank 8 K3 + 1
   K6 per forward and 16/16/16/16/2/2 per step where its block holds edges,
   no launch where it holds none.  Then ``cli infer`` and ``cli train`` with
   ``--set compute.mesh=2`` against their single-device runs (the same
   contigs; the same epoch losses within 1e-4, one checkpoint), every
   rank's launches read from the run's summary and log.
14. ``sharded``: the sharded path (``compute.mesh > 1`` inference for the
   layer-norm and norm-free SymGatedGCN and the zoo,
   ``gnnome_tpu_torch/parallel/sharded.py``), ranks sharing the card over
   gloo.  The single-device card forwards first (P = 1), then one spawned
   group per P: the golden graph at P = 2 with the layer-norm and
   norm-free SymGatedGCN and GatedGCN (directed and undirected), GCN, GAT
   and SAGE (d = 64, 8 layers, 3 GAT heads, ``init_weights(7)``), the JAX
   bench's graph (``random_bench_graph(262,144, 6.0)``, 1,572,864 edges)
   at P = 2 with the layer-norm model, and the 3-pair graph at P = 4 (one
   block empty) with the layer-norm model and GCN, whose forwards run in
   phase 13's group of 4 ranks (a spawn less): logits within 1e-4 +
   1e-4 |x| of the single-device card forward; per rank and forward 8 K1
   + 8 K2 (layer norm, none), 8 one-sided walks (GatedGCN, GCN, SAGE) or
   16 (GAT), none where the shard holds no edge; per rank the forward's
   time, its exchanges and collectives, its bytes per forward and per
   layer.  Then ``cli infer --set compute.mesh=2`` with phase 8's
   layer-norm model on its dataset: phase 8's FASTA byte for byte, 8 K1 +
   8 K2 per rank.
15. ``entry``: the entry point (``gnnome_tpu_torch/entry.py``):
   ``entry()`` on the card (the batch-norm model at full width, d = 64, 8
   layers, ``init_weights(0)``, on the 60-read synthetic graph), its
   logits within 1e-4 + 1e-4 |x| of ``entry(device="cpu")``, a second call
   bitwise equal, exactly 8 K3 + 1 K6 float32 launches; the first call's
   wall time and a warm call's time.
16. ``dryrun``: ``dryrun_multichip(2)`` on the card (gloo ranks sharing
   it): a finite loss, the parameters after Adam bitwise equal on every
   rank, 16/16/16/16/2/2 K7/K3/K8/A/K6/K9 per rank, JAX's line printed.
17. ``multihost``: two ``torch.distributed.run`` launchers of one rank
   each (127.0.0.1, a free port; the card shared over gloo) run
   scripts/torch_multihost_smoke.py's step on ``random_bench_graph(16,384,
   6.0)``: one loss, bitwise that of the same step on ``spawn``'s two
   ranks (run in phase 13's group of 2), and the same launches per rank
   (16/16/16/16/2/2).
18. ``projection``: the halo wire-cost model
   (``gnnome_tpu_torch/parallel/projection.py``), host only: its bytes and
   calls per forward (with the logits' gather) and per step at P = 2 and 4
   on phase 13's bench graph equal every rank's ``Group.sent`` and
   ``Group.calls`` there; its times from phase 13's single-device times
   and idle-collective latencies, at NVLink and InfiniBand rates, printed
   beside the times phase 13 measured, each line marked as a model.
19. ``recorded_runs``: the recorded-run scripts, each ``main`` in a
   process of its own at a reduced size (``RECORDED_*``), its JSON checked:
   ``scripts/torch_product_train_run.py --mode card --epochs 1`` (the
   three-graph masked and clustered dataset; two resumes bitwise equal and
   equal to an uninterrupted run; per epoch units x 8/8/8/8/1/1 K7/K3/K8/A/
   K6/K9 plus validation units x 0/8/0/1/0, no other kernel);
   ``scripts/torch_golden_ecoli_run.py --cached`` at full size (AP within
   1e-4 of the JAX record 0.9992886, probabilities within 1e-5 of the
   oracle's, the decode of the JAX record: 4 contigs, 5,858,100 bases,
   NG50 5,385,917; 8 K3 + 1 K6 per forward);
   ``scripts/torch_train_quality_run.py --stage build parity`` on one
   graph of a reduced spec (validation loss within 1e-5 and AP within 1e-4
   of the oracle's each of 2 epochs; 2 steps and 2 evals of launches);
   ``scripts/torch_config4_route.py`` at 65,536 / 32,768 nodes in clusters
   of 16,384 (1 and 2 epochs: finite losses, launches per unit as above).

Then one JSON line with every kernel's numbers (``ms`` its device time,
``call_ms`` its back-to-back call time, at the widths of its main path;
``launches`` from the training path of phase 7 (K3, K6, K7, K8, K9 at the
dual pass's width 128), for K1 and K2 from that of phase 8, for the
one-sided walk from that of phase 10; every path's in
``launches_by_path`` (for phase 12's paths their bf16 launches, which
are all of them; phase 13's ``cli`` and few-pairs paths per rank; phase
14's ``cli`` path and its golden and few-pairs forwards per rank; phase
5b's ``infer_gfa_hifiasm``, ``infer_gfa_raven``, ``run`` and
``train_gfa``; phases 15-17's ``entry``, ``dryrun_2`` and ``multihost``,
rank 0's, every rank's checked equal; phase 19's ``product_train_card``,
``golden_card`` (one forward), ``quality_parity``, ``config4_a`` and
``config4_b``, from the scripts' JSON); ``dtypes`` the element types it runs, and for K1, K2,
K3, K6, K7, K8 and K9 a ``bfloat16`` entry with the same numbers for the
bf16 instantiation (K3-K9 at width 128, launches from the bf16 overfit
run of phase 11; K1 and K2 at the norm-free model's widths 64 and 128,
launches from the bf16 overfit run of phase 12); the layer-norm edge
stage and its adjoint (d = 64 on the golden graph, and at the ln cell's
rows, launches from phase 8's training path); two rows for the probes'
kernels, ``k3_ablate`` (``full`` on the bench graph, d = 64, bf16, as the
JAX probe runs) and ``stream_sum`` (T = 768, ET = 2048, K = 4, bf16);
four rows for the Mosaic repro probe's kernels, ``row_stack``,
``row_gather``, ``segment_sum`` and ``small_matmul``, timed at P3's
shapes (float32, and a ``bfloat16`` entry), each ``replaces`` the
script call sites of the cases whose chains call it; ``small_matmul``'s
row also holds its launches by instantiation, both instantiations' checks
and times, its ``-Xptxas -v`` resources and its times in turns with
cuBLAS, ``stream_sum``'s its resources and turns.  Every probe row's
``launches`` counts the probe's own run (k3_ablate's and dma_probe's
sweeps, the Mosaic probe's run of every case), and its
``launches_by_path`` holds that run and those made on the system paths
after phase 12b (none: the probes lie on no path); the
``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
WORK = os.path.join(ROOT, "build", "chip_smoke")
START = time.perf_counter()

# the phase-4 dataset: an error-free 50 kb genome at ~7x; no false edges, so
# the decoded contig must be exact (with false edges the shipped weights
# follow planted chimeric edges)
INFER_GRAPH = dict(n_reads=400, genome_len=50_000, read_len=900, seed=1,
                   with_sequences=True, false_edge_frac=0.0)
INFER_LEN_THRESHOLD = 5000

# H100 SXM data sheet: HBM3 bandwidth, float32 and float64 (non-tensor-core)
# peaks (the bf16 kernels' arithmetic is float32 too)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12

# tolerances, set from the float32 arithmetic, before any card run:
# edge outputs repeat the plain version's per-op rounding (only sigmoid's
# exp may differ by an ulp); node sums add ~27 terms of |x| <~ 5 in another
# order; logits pass 8 layers of float32 matmuls in another order (CPU vs
# cuBLAS), which moves large logits by ~1e-5 relative (the JAX-vs-torch
# golden record, GOLDEN_ECOLI_r05.json: 5.5e-4 at |logit| ~ 50) and
# near-zero ones by more than the 2e-5 of the CPU parity tests
EDGE_ATOL = 1e-5
SUM_ATOL, SUM_RTOL = 1e-4, 1e-5
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
PROB_ATOL = 1e-5
JAX_GOLDEN_AP = 0.9992886          # the JAX package, CPU, same graph+weights
AP_TOL = 1e-4
# the width checks of the kernels phase: d above 128 for K3, K6, K7 and K8
# (two column chunks), payloads of 256 for K2 and K9, and K6 at H = 20 with
# odd row strides (its one-float path)
WIDE_D, WIDE_PAY, ODD_H = 192, 256, 20
# the batch-norm train step's dual pass runs K3, K7, K8 at d = 2 x 64 and
# K6, K9 at H = 2 x 64
DUAL_D = 128
# the bfloat16 compute mode (compute.dtype=bfloat16, batch norm), set before
# any card run.  Kernels: bf16 edge outputs repeat the plain version's
# operations and roundings (within one bf16 spacing, 2^-7 of the value,
# for sigmoid's exp); bf16 node sums are float32 sums in another order
# rounded once: within_sums plus one spacing.  The golden graph's AP in
# bf16 within AP_TOL of the JAX package's bf16 figure: 0.9992662 (its XLA
# backend on the CPU at dtype=bfloat16, matmul_precision=default, eval,
# flip=False, shipped weights).  Card against the port's CPU run in bf16:
# the GEMMs round in another order, and 8 layers of bf16 move single
# logits of the shipped weights by several units (tests/test_torch_bf16.py:
# the JAX package's two bf16 backends differ by up to 8.25 on the golden
# subgraph), so logits are held by their cosine, the largest probability
# change and the AP (SCORE_*), and a train step by the JAX package's bf16
# bounds between its two backends (tests_tpu/test_on_tpu_parity.py:87-123):
# the loss within 0.15 relative, gradients with cosine > 0.999 and each
# element within 0.5 x max(|g|, rms of g); BN running statistics (float32,
# from bf16 gates) within 1e-2 + 1e-2 x |x|.
BF16_SPACING = 2.0 ** -7
JAX_GOLDEN_AP_BF16 = 0.9992662
SCORE_COS, SCORE_DP, SCORE_AP = 0.995, 0.25, 5e-4
BF16_LOSS_REL, BF16_GRAD_COS, BF16_GRAD_ELEM = 0.15, 0.999, 0.5
BF16_STATE_ATOL, BF16_STATE_RTOL = 1e-2, 1e-2
# K7 / K8 global sums are float64 in another order than the plain version's:
# within 1e-9 of the summed magnitudes.  K8's x is exact (the same
# operations), d_eo within EDGE_ATOL (sigmoid), its node sums as K3's.
SUM64_RTOL = 1e-9
# one train step, card against the port's CPU step, full width, shipped
# weights, dropout 0: the loss within 1e-5 relative; gradients elementwise
# within the repository's gradient tolerance (tests/test_pallas_k4.py:81:
# 8 layers of float32 matmuls summed in another order, forward and back).
# A first bound of 1e-3 of each tensor's largest magnitude failed on the
# gate biases B1, B2, B3, whose exact gradient is zero (BatchNorm removes
# any constant added to the gate), so their values are rounding noise.
# BN running statistics as the forward outputs.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_ATOL, STEP_GRAD_RTOL = 2e-4, 5e-3
STEP_STATE_ATOL, STEP_STATE_RTOL = 1e-5, 1e-4
# the overfit run of tests/test_train.py:131-170
OVERFIT_GRAPH = dict(n_reads=120, genome_len=10000, read_len=400, seed=12,
                     with_sequences=True)
OVERFIT_LOSS_DROP, OVERFIT_MIN_AP = 0.9, 0.75
# the batch-norm symmetry-loss step runs both passes as one dual-width pass
# (forward_dual): per layer one K7 and one K3, their K8 and batch-norm edge
# adjoint; one K6, its K9
TRAIN_STEP_LAUNCHES = {"k3_edge_stage": 8, "k6_score_gate": 1,
                       "k7_gate_stats": 8, "k8_train_layer_bwd": 8,
                       "bn_edge_adjoint": 8, "k9_aggregate": 1}
# the layer-norm and norm-free model in float32: per forward one K1, one
# layer-norm edge stage and one K2 (the gated means) per layer; per
# symmetry-loss step two forwards and their backwards (per layer the
# stage's adjoint and K2 for K1's adjoint, K2 for each predictor's endpoint
# gathers)
UNFUSED_FORWARD_LAUNCHES = {"k1_gather_gate": 8, "k2_aggregate": 8,
                            "ln_edge_stage": 8}
UNFUSED_STEP_LAUNCHES = {"k1_gather_gate": 16, "k2_aggregate": 34,
                         "ln_edge_stage": 16, "ln_edge_adjoint": 16}
# the same layers through the PyTorch chain between K1 and K2 (bf16
# operands; the sharded layer of parallel/sharded.py): K1 and K2 only, two
# row gathers for each gated-mean K2 in the backward
K1K2_FORWARD_LAUNCHES = {"k1_gather_gate": 8, "k2_aggregate": 8}
K1K2_STEP_LAUNCHES = {"k1_gather_gate": 16, "k2_aggregate": 34}
UNFUSED_INIT_SEED = 7              # init_weights seed of those models
# their bf16 mode (compute.dtype=bfloat16): the norm-free model runs every
# K1 and K2 in bf16, through the chain; the layer-norm model turns float32
# at its first norms (LayerNorm's float32 weight and bias promote it, as in
# the JAX package), so only its first layer's K1 runs in bf16, and per step
# that K1's adjoint K2 too (tests/test_torch_bf16_unfused.py::
# test_dtype_flow), and its float32 layers 2-8 run the layer-norm edge
# stage.  All launches (UNFUSED_*_ALL_BF16), and those in bf16
UNFUSED_FORWARD_ALL_BF16 = {"none": K1K2_FORWARD_LAUNCHES,
                            "layer": {**K1K2_FORWARD_LAUNCHES,
                                      "ln_edge_stage": 7}}
UNFUSED_STEP_ALL_BF16 = {"none": K1K2_STEP_LAUNCHES,
                         "layer": {**K1K2_STEP_LAUNCHES, "ln_edge_stage": 14,
                                   "ln_edge_adjoint": 14}}
UNFUSED_FORWARD_BF16 = {"none": {"k1_gather_gate": 8, "k2_aggregate": 8},
                        "layer": {"k1_gather_gate": 1}}
UNFUSED_STEP_BF16 = {"none": {"k1_gather_gate": 16, "k2_aggregate": 34},
                     "layer": {"k1_gather_gate": 2, "k2_aggregate": 2}}
# card vs CPU in bf16 for those models (seeded init weights, golden graph):
# logit cosine and largest probability change, set before any card run
# from the port's CPU bf16 forward against its float32 one on the golden
# subgraph (cosine 0.99999 / 0.99994, probabilities within 0.0009 /
# 0.0026, AP 3e-5 / 7e-5 for layer norm / none) with a margin of 10x;
# the AP within SCORE_AP
UNFUSED_SCORE_COS, UNFUSED_SCORE_DP = 0.9995, 0.02
# the model zoo: the four models directed and GatedGCN undirected, seeded
# init weights.  Per eval forward the one-sided K2 walk runs once per
# sum_into (GAT: two per layer, the softmax sums and the messages); per
# step also once per gather_rows in the backward (GatedGCN two per layer,
# GCN and SAGE one, GAT four), and one K2 for the predictor's gathers
ZOO_MODELS = (("gatedgcn", True), ("gcn", True), ("gat", True),
              ("sage", True), ("gatedgcn", False))
ZOO_INIT_SEED = 7
ZOO_FORWARD_SIDE_SUMS = {"gatedgcn": 8, "gcn": 8, "gat": 16, "sage": 8}
ZOO_STEP_SIDE_SUMS = {"gatedgcn": 24, "gcn": 16, "gat": 48, "sage": 16}


# the GFA route (phase gfa_route): the phase-4 genome's reads written as a
# GFA of each dialect and built by ``cli build-graph``; the host-timing
# build at the golden graph's node count: 4,800 reads (9,600 nodes) of
# 900 bases over 600 kb, ~7x.  No kernel runs in build-graph: its times
# are host-clock seconds of its stages.
GFA_DIALECTS = ("hifiasm", "raven")
GFA_TIMING_BUILD = dict(n_reads=4800, genome_len=600_000, read_len=900,
                        seed=1)
# the batch-norm edge adjoint is timed at the golden graph's edge count and
# at the ~2.41M edges of the benchmark cell train-b64-g524k, whose dual
# pass runs it at w = 128; its one-element path checked at w = 36
BN_ADJOINT_CELL_ROWS = 2_410_000
BN_ADJOINT_ODD_W = 36
# the layer-norm edge stage and its adjoint are checked and timed at d = 64
# on the golden graph and at the ~1.21M edge rows and 262,144 nodes of the
# benchmark cell train-ln64-g262k (random endpoints), with LayerNorm and
# norm-free; d = 6 (one feature a lane) and 200 (two vectors a lane) are
# checked on the golden graph.  Against the plain version on the card: the
# forward's row mean and variance add in another order than torch.mean
# (LN_FWD_*: float32 rounding of the normalised values); the adjoint takes
# the kernel's statistics, so its relu mask is the plain version's, and
# its two row sums add in another order (LN_ADJ_*); d_weight and d_bias
# within LN_PARAM_REL of the summed magnitudes of their terms (float64
# block sums of the float32 products, the plain version sums in float32)
LN_CELL_ROWS, LN_CELL_NODES = 1_210_000, 262_144
LN_CHECK_WIDTHS = (6, 200)
LN_FWD_RTOL, LN_FWD_ATOL = 1e-5, 1e-5
LN_ADJ_RTOL, LN_ADJ_ATOL = 1e-4, 1e-5
LN_PARAM_REL = 1e-5
# kernels at E = 0 (a halo rank whose block holds no edge): a graph of
# NO_EDGE_N nodes, d = H = 64; each wrapper must return its plain version's
# empty edge rows and zero sums and statistics without a launch
NO_EDGE_N = 5
# a graph of fewer RC pairs than ranks (3 pairs at P = 4: one rank's block
# is empty) on the halo path; logits within LOGIT_ATOL + LOGIT_RTOL * |x|
# (1e-4 + 1e-4 |x|) of the single-device card forward
FEW_PAIRS_GRAPH = dict(n_reads=3, genome_len=1500, read_len=600, seed=1,
                       with_sequences=True, false_edge_frac=0.0)


def expected_launches(**counts) -> dict:
    """Every kernel's launch count: ``counts``, and 0 for the others."""
    from gnnome_tpu_torch.ops import kernels as K

    return {**{k: 0 for k in K.KERNELS}, **counts}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def make_infer_dataset(root: str):
    """Write the phase-4 synthetic graph + reads into the dataset layout
    under ``root`` (``hifiasm/processed/0.npz``, ``hifiasm/info/0_reads.npz``);
    returns (root, genome)."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, reads, _, genome = synthetic_assembly_graph(**INFER_GRAPH)
    return write_dataset(root, g, reads), genome


def average_precision(probs, labels) -> float:
    """Area under the precision-recall step curve (sklearn's
    average_precision_score; the reference's get_aps)."""
    import numpy as np

    order = np.argsort(-probs, kind="mergesort")
    p, y = probs[order], labels[order].astype(np.float64)
    last = np.r_[np.nonzero(np.diff(p))[0], p.size - 1]
    tp = np.cumsum(y)[last]
    fp = (last + 1) - tp
    precision, recall = tp / (tp + fp), tp / tp[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def cuda_ms(fn, reps: int = 10, n: int = 10, warmup: int = 3,
            queued: bool = False) -> float:
    """Milliseconds per call of ``fn`` on the card: the median over ``reps``
    repeats of ``n`` back-to-back calls between two CUDA events.  Calls
    queue ahead of the device, so the host's per-call overhead hides
    behind the kernels whenever the device is the bottleneck.  With
    ``queued`` the host queues each repeat's calls while the device still
    runs a sleep kernel, so the time is the device's alone: the host's share
    of a call, which can exceed a short kernel's time, is left out."""
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
            check(cycles <= 1 << 32, "calls queued behind a sleep kernel")
    return statistics.median(times)


def kernel_times(fn) -> dict:
    """A kernel wrapper's ``kernel_ms`` (back-to-back calls, host included)
    and ``device_ms`` (calls queued behind a sleep: the device alone)."""
    return {"kernel_ms": cuda_ms(fn), "device_ms": cuda_ms(fn, queued=True)}


def bound(nbytes: float, flops: float, flops64: float = 0.0):
    """Least time in ms: the larger of bytes over the memory rate and the
    float32 plus float64 operations over their peak rates."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / F32_FLOPS_PER_S + flops64 / F64_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


F4 = I4 = 4          # bytes of a float32, an int32
BF2 = 2              # bytes of a bfloat16


# The kernels' least bytes and operations; ``es`` is the bytes of one row
# element (F4 in float32, BF2 in bf16).  Indices and row pointers are int32,
# float64 sums 8 bytes and K9's sums float32 at either element size.
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


def adjoint_inputs(E: int, w: int, dt, randn, rand):
    """x, d_eo [E, w], the rows bn [4, w] and sc [3, w] of the batch-norm
    edge adjoint; x drawn about the mean so that y straddles 0."""
    import torch

    mean, inv = randn(w) * 0.3, rand(w) + 0.5
    gamma, beta = rand(w) + 0.5, randn(w) * 0.1
    if dt == torch.bfloat16:
        scale = gamma * inv
        bn = torch.stack([torch.zeros_like(scale), torch.ones_like(scale),
                          scale, beta - mean * scale]).to(dt)
    else:
        bn = torch.stack([mean, inv, gamma, beta])
    x = (randn(E, w) / inv + mean).to(dt)
    sc = torch.stack([gamma * inv, randn(w) * 1e-4, randn(w) * 1e-4])
    return x, randn(E, w).to(dt), bn, sc


def bn_adjoint_times(dev, seed: int, dt, golden_edges: int) -> dict:
    """The batch-norm edge adjoint in ``dt`` at w = 128 and 64, at the
    golden graph's edge count and at BN_ADJOINT_CELL_ROWS: bit-equal to its
    plain version and bitwise reproducible, timed beside its bound, the
    plain version and ``torch.add`` of x and d_eo (``add_ms``); the
    one-element path (w = 36; rows one element off a 16-byte boundary)
    checked, not timed."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=dev).manual_seed(seed + 2)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    def checked(args, what):
        got = K.bn_edge_adjoint(*args)
        check(torch.equal(got, K.bn_edge_adjoint_plain(*args)),
              f"bn edge adjoint {what}: bit-equal to its plain version")
        check(torch.equal(got, K.bn_edge_adjoint(*args)),
              f"bn edge adjoint {what}: reproducible")

    es = BF2 if dt == torch.bfloat16 else F4
    out = {"dtype": str(dt).split(".")[1]}
    for E, size in ((golden_edges, "golden"), (BN_ADJOINT_CELL_ROWS, "cell")):
        for w in (DUAL_D, 64):
            args = adjoint_inputs(E, w, dt, randn, rand)
            checked(args, f"{dt} E={E} w={w}")
            nbytes, *ops = bn_adjoint_cost(E, w, es)
            b_ms, b_by = bound(nbytes, *ops)
            t = kernel_times(lambda: K.bn_edge_adjoint(*args))
            o = torch.empty_like(args[0])
            out[f"{size} w={w}"] = {
                "rows": E, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": nbytes, **t, "share_of_bound": b_ms / t["device_ms"],
                "achieved_gbps": nbytes / t["device_ms"] / 1e6,
                "plain_ms": cuda_ms(lambda: K.bn_edge_adjoint_plain(*args)),
                "add_ms": cuda_ms(lambda: torch.add(args[0], args[1],
                                                    out=o), queued=True)}
            del args, o
    x, d_eo, bn, sc = adjoint_inputs(golden_edges, BN_ADJOINT_ODD_W, dt,
                                     randn, rand)
    checked((x, d_eo, bn, sc), f"{dt} w={BN_ADJOINT_ODD_W}")
    x, d_eo, bn, sc = adjoint_inputs(golden_edges, 64, dt, randn, rand)
    shifted = [torch.empty(t.numel() + 1, dtype=dt, device=dev)[1:]
               .view(t.shape).copy_(t) for t in (x, d_eo)]
    check(shifted[0].data_ptr() % 16 != 0, "rows off a 16-byte boundary")
    checked((*shifted, bn, sc), f"{dt} w=64 unaligned rows")
    torch.cuda.empty_cache()
    out.update(odd_width=BN_ADJOINT_ODD_W, bitwise_reproducible=True,
               tolerance={"atol": 0.0},
               add_call="torch.add(x, d_eo, out=...): the same three "
                        "[E, w] streams, PyTorch's vectorised kernel")
    return out


def check_ln_stage(u, v, n: int, d: int, norm: bool, randn, rand,
                   what: str) -> dict:
    """The layer-norm edge stage (``norm`` False: norm-free) and its adjoint
    at width ``d`` on the edge rows of endpoints ``u``, ``v`` over ``n``
    nodes, against their plain versions on the card (LN_* tolerances) and
    bitwise reproducible; returns the largest differences and the two
    calls' arguments."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    E = u.shape[0]
    w = rand(d) + 0.5 if norm else None
    b = randn(d) * 0.1 if norm else None
    fwd = (randn(E, 3 * d), randn(E, d), w, b, 1e-5)
    got = K.ln_edge_stage(*fwd)
    ref = K.ln_edge_stage_plain(*fwd)
    torch.cuda.synchronize()
    out = {"fwd_max_abs_diff": max(
        float((x - y).abs().max()) for x, y in zip(got, ref)
        if y is not None)}
    check(all(y is None or bool(((x - y).abs() <= LN_FWD_ATOL
                                 + LN_FWD_RTOL * y.abs()).all())
              for x, y in zip(got, ref)),
          f"LN edge stage {what}: vs plain (max {out['fwd_max_abs_diff']})")
    g3, e_out, stats = fwd[0], got[0], got[3]
    adj = (u, v, randn(n, 2 * d), randn(n, 2 * d), g3, e_out, randn(E, d),
           stats, w, b)
    got_a = K.ln_edge_adjoint(*adj)
    ref_a = K.ln_edge_adjoint_plain(*adj)
    torch.cuda.synchronize()
    out["adj_max_abs_diff"] = max(float((x - y).abs().max())
                                  for x, y in zip(got_a[:3], ref_a[:3]))
    check(all(bool(((x - y).abs() <= LN_ADJ_ATOL
                    + LN_ADJ_RTOL * y.abs()).all())
              for x, y in zip(got_a[:3], ref_a[:3])),
          f"LN edge adjoint {what}: vs plain (max {out['adj_max_abs_diff']})")
    if norm:
        xhat = (g3[:, :d] - stats[:, :1]) * stats[:, 1:]
        d_y = torch.where(xhat * w + b > 0, ref_a[2], 0.0)
        prods = torch.stack([d_y * xhat, d_y]).double()
        want, terms = prods.sum(1), prods.abs().sum(1)
        rel = float(((got_a[3].double() - want).abs() / terms).max())
        check(rel <= LN_PARAM_REL,
              f"LN edge adjoint {what}: parameter sums (rel {rel})")
        out["param_rel_diff"] = rel
    else:
        check(got_a[3] is None, f"LN edge adjoint {what}: no parameter sums")
    again = K.ln_edge_stage(*fwd), K.ln_edge_adjoint(*adj)
    check(all((x is None and y is None) or torch.equal(x, y)
              for x, y in zip((*got, *got_a), (*again[0], *again[1]))),
          f"LN edge stage and adjoint {what}: bitwise reproducible")
    return {**out, "args": (fwd, adj)}


def ln_stage_times(dev, seed: int, g) -> dict:
    """The layer-norm edge stage and its adjoint at d = 64 on the golden
    graph ``g`` (flip=False) and at LN_CELL_ROWS over LN_CELL_NODES (random
    endpoints), with LayerNorm (timed: each kernel beside its bound and its
    plain version, which for the forward is the PyTorch chain it
    replaced) and norm-free; the widths of LN_CHECK_WIDTHS checked on the
    golden graph."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=dev).manual_seed(seed + 3)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    d = 64
    u, v, _, _ = g.roles(False)
    cell = [torch.randint(0, LN_CELL_NODES, (LN_CELL_ROWS,), device=dev,
                          generator=gen, dtype=torch.int32)
            for _ in range(2)]
    out = {}
    for size, (uu, vv, n) in (("golden", (u, v, g.n_nodes)),
                              ("cell", (*cell, LN_CELL_NODES))):
        E = uu.shape[0]
        for norm in (True, False):
            r = check_ln_stage(uu, vv, n, d, norm, randn, rand,
                               f"{size} d={d} norm={norm}")
            fwd, adj = r.pop("args")
            if norm:
                for name, fn, plain, cost in (
                        ("ln_edge_stage", K.ln_edge_stage,
                         K.ln_edge_stage_plain, ln_stage_cost(E, d)),
                        ("ln_edge_adjoint", K.ln_edge_adjoint,
                         K.ln_edge_adjoint_plain, ln_adjoint_cost(n, E, d))):
                    args = fwd if name == "ln_edge_stage" else adj
                    b_ms, b_by = bound(*cost)
                    t = kernel_times(lambda: fn(*args))
                    r[name] = {"bound_ms": b_ms, "bound_by": b_by,
                               "bytes": cost[0], **t,
                               "share_of_bound": b_ms / t["device_ms"],
                               "plain_ms": cuda_ms(lambda: plain(*args))}
            out[f"{size} d={d} norm={norm}"] = {"rows": E, "nodes": n, **r}
            del fwd, adj
    for dw in LN_CHECK_WIDTHS:
        for norm in (True, False):
            r = check_ln_stage(u, v, g.n_nodes, dw, norm, randn, rand,
                               f"golden d={dw} norm={norm}")
            r.pop("args")
            out[f"golden d={dw} norm={norm}"] = r
    torch.cuda.empty_cache()
    out.update(bitwise_reproducible=True, tolerance={
        "fwd_rtol": LN_FWD_RTOL, "fwd_atol": LN_FWD_ATOL,
        "adj_rtol": LN_ADJ_RTOL, "adj_atol": LN_ADJ_ATOL,
        "param_rel": LN_PARAM_REL})
    return out


def golden_subgraph(g):
    """The golden-subgraph recipe of tests/test_torch_model.py:104-118: the
    band around node 0 plus bands around a few hard negatives."""
    import numpy as np

    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - 400): v + 400] = True
    return g.node_subgraph(keep)[0]


def write_dataset(root: str, graph, reads=None) -> str:
    """``graph`` (and ``reads``) in the dataset layout under ``root``."""
    for sub in ("processed", "info"):
        os.makedirs(os.path.join(root, "hifiasm", sub), exist_ok=True)
    graph.save(os.path.join(root, "hifiasm", "processed", "0.npz"))
    if reads is not None:
        reads.save(os.path.join(root, "hifiasm", "info", "0_reads.npz"))
    return root


# ------------------------------------------------------------------- phases
def phase_env():
    import torch

    from gnnome_tpu_torch import native
    from gnnome_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    K.build_kernels(force=True)
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "host library built and loaded")
    t_host = time.perf_counter() - t0
    with open(os.path.join(K.BUILD_DIR, "nvcc.log")) as f:
        ptxas = [ln.strip() for ln in f
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("env", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         build_s={"cuda_kernels": t_kernels, "host_library": t_host},
         ptxas=ptxas)


def bn_rows(d: int, randn, rand):
    """Eval/batch BatchNorm rows [mean, rsqrt(var + eps), gamma, beta]."""
    import torch

    return torch.stack([randn(d) * 0.3, rand(d) * 1.5 + 0.5, rand(d) + 0.5,
                        randn(d) * 0.1])


def within_sums(got, ref) -> bool:
    """Node sums in another order; a bf16 sum also rounded once: one bf16
    spacing more."""
    import torch

    rtol = SUM_RTOL + (BF16_SPACING if got.dtype == torch.bfloat16 else 0.0)
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= SUM_ATOL + rtol * ref.abs()).all())


def within_edges(got, ref) -> bool:
    """Edge outputs: within EDGE_ATOL in float32, one bf16 spacing in bf16."""
    import torch

    if got.dtype == torch.bfloat16:
        got, ref = got.float(), ref.float()
        return bool(((got - ref).abs() <= BF16_SPACING * ref.abs()).all())
    return float((got - ref).abs().max()) <= EDGE_ATOL


def within64(got, ref, terms) -> bool:
    """float64 sums in another order: within SUM64_RTOL of the summed
    magnitudes ``terms``."""
    return bool(((got - ref).abs() <= SUM64_RTOL * terms + 1e-12).all())


def check_k3(g, flip, proj_u, proj_v, b3e, e_in, bn, what):
    """K3 against its plain version at one flip, and a second launch bitwise
    equal to the first; returns (kernel args, max |diff| of e_out, of all)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, v_csr, u_csr = g.roles(flip)
    args = (u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    got = K.k3_edge_stage(*args)
    ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
    torch.cuda.synchronize()
    diff = [float((a.float() - b.float()).abs().max())
            for a, b in zip(got, ref)]
    check(within_edges(got[0], ref[0]),
          f"K3 {what} flip={flip} e_out diff {diff[0]}")
    for x, y in zip(got[1:], ref[1:]):
        check(within_sums(x, y), f"K3 {what} flip={flip} node sums")
    again = K.k3_edge_stage(*args)
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          f"K3 {what} flip={flip} bitwise reproducible")
    return args, diff[0], max(diff)


def check_k7(g, flip, bu, bv, b3e, what):
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, _, _ = g.roles(flip)
    got = K.k7_gate_stats(u, v, bu, bv, b3e)
    ref = K.k7_gate_stats_plain(u, v, bu, bv, b3e)
    x = (bu[u.long()] + bv[v.long()] + b3e).double()
    check(within64(got, ref, torch.cat([x.abs().sum(0), (x * x).sum(0)])),
          f"K7 {what} flip={flip} sums within tolerance")
    check(torch.equal(got, K.k7_gate_stats(u, v, bu, bv, b3e)),
          f"K7 {what} flip={flip} bitwise reproducible")
    return (float((got - ref).abs().max()),
            float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max()))


def check_k6(g, flip, puv, be, what):
    """K6 bit-equal to its plain version and bitwise reproducible; returns
    the max |diff| (0)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, _, _ = g.roles(flip)
    got = K.k6_score_gate(u, v, puv, be)
    ref = K.k6_score_gate_plain(u, v, puv, be)
    torch.cuda.synchronize()
    diff = float((got.float() - ref.float()).abs().max())
    check(diff == 0.0, f"K6 {what} flip={flip} diff {diff}")
    check(torch.equal(got, K.k6_score_gate(u, v, puv, be)),
          f"K6 {what} flip={flip} bitwise reproducible")
    return diff


def check_k8(g, flip, args, what):
    """K8 against its plain version (x exact, d_eo within EDGE_ATOL, node
    sums, float64 sums) and bitwise reproducible; returns (max |diff| of
    x, d_eo and the node sums, of d_eo)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, v_csr, u_csr = g.roles(flip)
    got = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
    ref = K.k8_train_layer_bwd_plain(u, v, *args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ref[0]), f"K8 {what} flip={flip} x exact")
    d_eo_diff = float((got[1].float() - ref[1].float()).abs().max())
    check(within_edges(got[1], ref[1]),
          f"K8 {what} flip={flip} d_eo diff {d_eo_diff}")
    for a_, b_ in zip(got[2:4], ref[2:4]):
        check(within_sums(a_, b_), f"K8 {what} flip={flip} node sums")
    deo = ref[1].double().abs()
    check(within64(got[4], ref[4], torch.cat(
        [deo.sum(0), (deo * ref[0].double().abs()).sum(0)])),
        f"K8 {what} flip={flip} global sums within tolerance")
    again = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          f"K8 {what} flip={flip} bitwise reproducible")
    return (max(float((p.float() - q.float()).abs().max())
                for p, q in zip(got[:4], ref[:4])), d_eo_diff)


def check_k9(g, flip, pay, what):
    """K9's [sum_u | sum_v] bit-equal to its plain version on CPU copies of
    the same tensors (``index_add_`` adds each node's terms in slot order
    there, as the kernel does), within the node-sum tolerance of the plain
    version on the card (atomic adds) and bitwise reproducible; returns the
    max |diff| against the CPU plain version (0) and the card's."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, v_csr, u_csr = g.roles(flip)
    got = K.k9_aggregate(u, v, v_csr, u_csr, pay)
    card = K.k9_aggregate_plain(u, v, pay, g.n_nodes)
    torch.cuda.synchronize()
    cpu = K.k9_aggregate_plain(u.cpu(), v.cpu(), pay.cpu(), g.n_nodes)
    check(got.shape == (g.n_nodes, 2 * pay.shape[1]),
          f"K9 {what} flip={flip} output [N, 2H]")
    diff = float((got.cpu() - cpu).abs().max())
    check(diff == 0.0, f"K9 {what} flip={flip} vs CPU plain: diff {diff}")
    check(within_sums(got, card), f"K9 {what} flip={flip} vs card plain")
    check(torch.equal(got, K.k9_aggregate(u, v, v_csr, u_csr, pay)),
          f"K9 {what} flip={flip} bitwise reproducible")
    return diff, float((got - card).abs().max())


def check_side_sum(idx, csr, pay, n_nodes: int, what: str) -> float:
    """The one-sided K2 walk bit-equal to its plain version on CPU copies
    (each node's rows added in slot order on both), and bitwise
    reproducible; returns the max |diff| (0)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    got = K.k2_side_sum(idx, csr, pay)
    torch.cuda.synchronize()
    cpu = K.k2_side_sum_plain(idx.cpu(), pay.cpu(), n_nodes)
    diff = float((got.cpu() - cpu).abs().max())
    check(diff == 0.0, f"K2 side sum {what}: diff {diff} vs CPU plain")
    check(torch.equal(got, K.k2_side_sum(idx, csr, pay)),
          f"K2 side sum {what}: bitwise reproducible")
    return diff


def check_k1(g, flip, proj_u, proj_v, b3e, what: str) -> float:
    """K1 bit-equal to its plain version on the card (the same rounded
    adds; copies are copies) and bitwise reproducible; returns the max
    |diff| (0)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, _, _ = g.roles(flip)
    got = K.k1_gather_gate(u, v, proj_u, proj_v, b3e)
    ref = K.k1_gather_gate_plain(u, v, proj_u, proj_v, b3e)
    torch.cuda.synchronize()
    diff = float((got.float() - ref.float()).abs().max())
    check(got.dtype == b3e.dtype and diff == 0.0,
          f"K1 {what} flip={flip} diff {diff}")
    check(torch.equal(got, K.k1_gather_gate(u, v, proj_u, proj_v, b3e)),
          f"K1 {what} flip={flip} bitwise reproducible")
    return diff


def check_k2_cpu(g, flip, pay_u, pay_v, what: str):
    """K2's float32 sums bit-equal to its plain version run on CPU copies
    (``index_add_`` adds each node's terms in slot order there, as the
    kernel does), within the node-sum tolerance of the plain version on
    the card (atomic adds) and bitwise reproducible; returns the max |diff|
    against the CPU plain version (0) and the card's."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, v_csr, u_csr = g.roles(flip)
    got = K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v)
    card = K.k2_aggregate_plain(u, v, pay_u, pay_v, g.n_nodes)
    torch.cuda.synchronize()
    cpu = K.k2_aggregate_plain(u.cpu(), v.cpu(), pay_u.cpu(), pay_v.cpu(),
                               g.n_nodes)
    check(all(t.dtype == torch.float32 for t in got),
          f"K2 {what} flip={flip} float32 sums")
    diff = max(float((a_.cpu() - b_).abs().max()) for a_, b_ in zip(got, cpu))
    check(diff == 0.0, f"K2 {what} flip={flip} vs CPU plain: diff {diff}")
    check(all(within_sums(a_, b_) for a_, b_ in zip(got, card)),
          f"K2 {what} flip={flip} vs card plain")
    again = K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v)
    check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
          f"K2 {what} flip={flip} bitwise reproducible")
    return diff, max(float((a_ - b_).abs().max()) for a_, b_ in zip(got, card))


def unfused_kernels(g, randn, bf16: bool = False) -> dict:
    """K1 (d = 64, on the column slices of an [N, 5d] projection, as the
    model calls it) and K2 (Dp = 128 and 64: the gated mean and K1's
    adjoint, the predictor gathers' adjoint) in float32 or (``bf16``)
    their bf16 instantiations, at both flips: against their plain versions
    (K1 bit-equal on the card, K2 on CPU copies), bitwise reproducible,
    timed beside their bounds, their plain versions and, for K2,
    ``index_add_`` into float32 sums over the stacked [u; v+N] rows (bf16
    payloads cast to float32 inside the timed call).  Then K1 at d =
    WIDE_D (16-byte words), ODD_H (8-byte words in bf16) and ODD_H with an
    odd row stride (one element per thread), K2 at WIDE_PAY (two column
    chunks) and at ODD_H + 1 on column slices with an odd row stride, not
    timed."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    dt, es = (torch.bfloat16, BF2) if bf16 else (torch.float32, F4)
    N, E, d = g.n_nodes, g.n_edges, 64
    proj = randn(N, 5 * d).to(dt)
    pu, pv = proj[:, :2 * d], proj[:, 2 * d:4 * d]
    b3e = randn(E, d).to(dt)
    what = f"{'bf16 ' if bf16 else ''}d={d}"
    nbytes, *ops = k1_cost(N, E, d, es)
    b_ms, b_by = bound(nbytes, *ops)
    k1 = {"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        diff = check_k1(g, flip, pu, pv, b3e, what)
        t = kernel_times(lambda: K.k1_gather_gate(u, v, pu, pv, b3e))
        k1[f"flip={flip}"] = {
            "max_abs_diff": diff, **t,
            "achieved_gbps": nbytes / t["device_ms"] / 1e6,
            "plain_ms": cuda_ms(lambda: K.k1_gather_gate_plain(u, v, pu, pv,
                                                               b3e))}
    layouts = {}
    for dd, pad in ((WIDE_D, 0), (ODD_H, 0), (ODD_H, 1)):
        pw, bw = randn(N, 5 * dd + pad).to(dt), randn(E, dd).to(dt)
        what = f"{'bf16 ' if bf16 else ''}d={dd} row stride {5 * dd + pad}"
        layouts[what] = max(check_k1(g, flip, pw[:, :2 * dd],
                                     pw[:, 2 * dd:4 * dd], bw, what)
                            for flip in (False, True))
    k1.update(layouts=layouts, bitwise_reproducible=True,
              tolerance={"atol": 0.0})

    k2 = {}
    for width in (2 * d, d):
        pay_u, pay_v = randn(E, width).to(dt), randn(E, width).to(dt)
        pay2 = torch.cat([pay_u, pay_v])
        acc = torch.zeros(2 * N, width, device=pay_u.device)
        nbytes, *ops = k2_cost(N, E, width, es)
        b_ms, b_by = bound(nbytes, *ops)
        r = {"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        for flip in (False, True):
            u, v, v_csr, u_csr = g.roles(flip)
            diff, diff_card = check_k2_cpu(
                g, flip, pay_u, pay_v, f"{'bf16 ' if bf16 else ''}Dp={width}")
            uv = torch.cat([u.long(), v.long() + N])
            t = kernel_times(lambda: K.k2_aggregate(u, v, v_csr, u_csr,
                                                    pay_u, pay_v))
            r[f"flip={flip}"] = {
                "max_abs_diff": diff, "max_abs_diff_vs_card_plain": diff_card,
                **t, "achieved_gbps": nbytes / t["device_ms"] / 1e6,
                "plain_ms": cuda_ms(lambda: K.k2_aggregate_plain(
                    u, v, pay_u, pay_v, N)),
                "library_ms": cuda_ms(lambda: acc.zero_().index_add_(
                    0, uv, K.wide(pay2)))}
        k2[f"Dp={width}"] = r
    layouts = {}
    for width, pad in ((WIDE_PAY, 0), (ODD_H + 1, 1)):
        pay_u = randn(E, width + pad).to(dt)[:, :width]
        pay_v = randn(E, width).to(dt)
        what = (f"{'bf16 ' if bf16 else ''}Dp={width} u row stride "
                f"{width + pad}")
        layouts[what] = max(check_k2_cpu(g, flip, pay_u, pay_v, what)[0]
                            for flip in (False, True))
    k2.update(layouts=layouts, bitwise_reproducible=True,
              tolerance={"vs_cpu_plain_atol": 0.0,
                         "vs_card_plain_atol": SUM_ATOL,
                         "vs_card_plain_rtol": SUM_RTOL},
              library_call="torch.Tensor.index_add_ on [u; v+N], "
                           "[pay_u; pay_v] (bf16: cast to float32)")
    return {"k1_gather_gate": k1, "k2_aggregate": k2}


def bf16_affine(d: int, randn, rand):
    """The folded BatchNorm affine the bf16 kernels take, [0, 1, scale,
    bias] in bf16 (ops/message.bn_edge_rows)."""
    import torch

    return torch.stack([torch.zeros_like(rand(d)), torch.ones_like(rand(d)),
                        rand(d) + 0.5, randn(d) * 0.1]).to(torch.bfloat16)


def width_kernel_times(g, dd: int, randn, rand, flips=(False,),
                       bf16: bool = False) -> dict:
    """K3, K7, K8 at d = ``dd`` and K6, K9 at H = ``dd``, in float32 or
    (``bf16``) their bfloat16 instantiations, at each flip of ``flips``
    (by default flip=False: the dual pass's roles): each checked against
    its plain version as at d = 64 (bitwise reproducible) and timed beside
    its bound, the plain version and, for K9, ``index_add_`` into the
    stacked [u; v+N] rows (in bf16 with bf16 sums).  Returns per kernel its
    bound and, per flip, the check and the times."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    dt, es = (torch.bfloat16, BF2) if bf16 else (torch.float32, F4)
    N, E = g.n_nodes, g.n_edges
    proj = randn(N, 4 * dd).to(dt)     # [u gate | u msg | v gate | v msg]
    pu, pv = proj[:, :2 * dd], proj[:, 2 * dd:]
    b3e, e_in, d_e_out = (randn(E, dd).to(dt) for _ in range(3))
    bn = bf16_affine(dd, randn, rand) if bf16 else bn_rows(dd, randn, rand)
    d_sum_u, d_sum_v = randn(N, 2 * dd).to(dt), randn(N, 2 * dd).to(dt)
    puv, be = randn(N, 2 * dd).to(dt), randn(E, dd).to(dt)
    pay = torch.relu(randn(E, dd)).to(dt)
    k8_args = (d_sum_u, d_sum_v, pu, pv, b3e, e_in, d_e_out, bn)
    what = f"{'bf16 ' if bf16 else ''}d={dd}"
    out = {"width": dd, "dtype": str(dt).split(".")[1]}
    for flip in flips:
        u, v, v_csr, u_csr = g.roles(flip)
        runs = {
            "k3_edge_stage": (
                check_k3(g, flip, pu, pv, b3e, e_in, bn, what)[2],
                lambda: K.k3_edge_stage(u, v, v_csr, u_csr, pu, pv, b3e,
                                        e_in, bn),
                lambda: K.k3_edge_stage_plain(u, v, pu, pv, b3e, e_in, bn),
                k3_cost(N, E, dd, es)),
            "k7_gate_stats": (
                check_k7(g, flip, pu[:, :dd], pv[:, :dd], b3e, what)[0],
                lambda: K.k7_gate_stats(u, v, pu[:, :dd], pv[:, :dd], b3e),
                lambda: K.k7_gate_stats_plain(u, v, pu[:, :dd], pv[:, :dd],
                                              b3e),
                k7_cost(N, E, dd, es)),
            "k8_train_layer_bwd": (
                check_k8(g, flip, k8_args, what)[0],
                lambda: K.k8_train_layer_bwd(u, v, v_csr, u_csr, *k8_args),
                lambda: K.k8_train_layer_bwd_plain(u, v, *k8_args),
                k8_cost(N, E, dd, es)),
            "k6_score_gate": (
                check_k6(g, flip, puv, be, what),
                lambda: K.k6_score_gate(u, v, puv, be),
                lambda: K.k6_score_gate_plain(u, v, puv, be),
                k6_cost(N, E, dd, es)),
            "k9_aggregate": (
                check_k9(g, flip, pay, what)[0],
                lambda: K.k9_aggregate(u, v, v_csr, u_csr, pay),
                lambda: K.k9_aggregate_plain(u, v, pay, N),
                k9_cost(N, E, dd, es)),
        }
        for name, (diff, fn, plain, (nbytes, *ops)) in runs.items():
            b_ms, b_by = bound(nbytes, *ops)
            t = kernel_times(fn)
            r = out.setdefault(name, {"bound_ms": b_ms, "bound_by": b_by,
                                      "bytes": nbytes})
            r[f"flip={flip}"] = {
                "max_abs_diff": diff, **t,
                "achieved_gbps": nbytes / t["device_ms"] / 1e6,
                "plain_ms": cuda_ms(plain)}
        # the one PyTorch call for K9's sums, as at H = 64
        uv = torch.cat([u.long(), v.long() + N])
        pay2 = torch.cat([pay, pay])
        acc = torch.zeros(2 * N, dd, device=pay.device, dtype=dt)
        out["k9_aggregate"][f"flip={flip}"]["library_ms"] = cuda_ms(
            lambda: acc.zero_().index_add_(0, uv, pay2))
    return out


def bf16_wide_checks(g, randn, rand) -> dict:
    """The width and layout checks of the kernels phase in bf16, both
    flips, not timed: K3, K6, K7, K8 at d = WIDE_D (two column chunks; K3
    and K8 on column slices of a [N, 5d] projection, K7 on its gate
    columns), K6 on column slices whose row strides keep the 8-byte vector
    path (H = 64 and WIDE_D) and at H = ODD_H with odd row strides (one
    element per lane), K9 dense at WIDE_PAY and on column slices at
    WIDE_PAY and ODD_H with row strides H + 8 and H + 1."""
    import torch

    bf = torch.bfloat16
    N, E = g.n_nodes, g.n_edges
    dw, wp, ho = WIDE_D, WIDE_PAY, ODD_H
    projw = randn(N, 5 * dw).to(bf)
    pu, pv = projw[:, :2 * dw], projw[:, 2 * dw:4 * dw]
    b3w, e_inw, d_e_outw = (randn(E, dw).to(bf) for _ in range(3))
    bnw = bf16_affine(dw, randn, rand)
    d_suw, d_svw = randn(N, 2 * dw).to(bf), randn(N, 2 * dw).to(bf)
    k6_args = [(randn(N, 2 * h + pad).to(bf)[:, :2 * h],
                randn(E, h + pad).to(bf)[:, :h], f"H={h} row pad {pad}")
               for h, pad in ((64, 8), (dw, 8), (ho, 1))]
    k9_pays = [randn(E, wp).to(bf)] + [randn(E, h + pad).to(bf)[:, :h]
                                       for h in (wp, ho) for pad in (8, 1)]
    out = {"d": dw, "width": wp, "k6_odd_h": ho}
    for flip in (False, True):
        r = {}
        _, _, r["k3_max_abs_diff"] = check_k3(g, flip, pu, pv, b3w, e_inw,
                                              bnw, f"bf16 d={dw}")
        r["k6_max_abs_diff"] = max(check_k6(g, flip, p, b, f"bf16 {what}")
                                   for p, b, what in k6_args)
        r["k7_max_abs_diff"], _ = check_k7(g, flip, pu[:, :dw], pv[:, :dw],
                                           b3w, f"bf16 d={dw}")
        r["k8_max_abs_diff"], _ = check_k8(
            g, flip, (d_suw, d_svw, pu, pv, b3w, e_inw, d_e_outw, bnw),
            f"bf16 d={dw}")
        r["k9_max_abs_diff"] = max(
            check_k9(g, flip, p, f"bf16 H={p.shape[1]} stride {p.stride(0)}")[0]
            for p in k9_pays)
        out[f"flip={flip}"] = r
    out["bitwise_reproducible"] = True
    return out


def phase_kernels_bf16(seed: int, dev):
    """The bf16 instantiations of K3, K6, K7, K8 and K9 against their bf16
    plain versions: timed at the golden graph's shapes (d = H = 64, both
    flips; the dual pass's 128, flip=False), then the width and layout
    checks; then those of K1 and K2 (``unfused_kernels``)."""
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import DeviceGraph

    g = DeviceGraph.from_graph(AssemblyGraph.load(GOLDEN), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    out = {"d64": width_kernel_times(g, 64, randn, rand, (False, True),
                                     bf16=True),
           "dual": width_kernel_times(g, DUAL_D, randn, rand, bf16=True),
           "wide": bf16_wide_checks(g, randn, rand),
           **unfused_kernels(g, randn, bf16=True),
           "bn_edge_adjoint": bn_adjoint_times(dev, seed, torch.bfloat16,
                                               g.n_edges)}
    emit("kernels_bf16", graph={"nodes": g.n_nodes, "edges": g.n_edges},
         seed=seed, **out,
         tolerance={"edges": "one bf16 spacing (2^-7 of the value); K1, "
                             "K6 and K8's x exact",
                    "sums_atol": SUM_ATOL,
                    "sums_rtol": SUM_RTOL + BF16_SPACING,
                    "sum64_rtol_of_magnitudes": SUM64_RTOL,
                    "k9_vs_cpu_plain_atol": 0.0})
    return out


# the probes phase: the K3 variants against their plain versions at the
# kernels phase's tolerances (edges within EDGE_ATOL in float32, one bf16
# spacing in bf16; sums within_sums; walk words exact), `full` bit for bit
# K3; stream_sum bit for bit its plain version (the same adds in the same
# order).  Timed on the JAX probes' shapes: K3's bench graph
# (scripts/k3_ablate.py: random_bench_graph(262,144, 6.0), 1,572,864
# edges) and dma_probe's K and grid sweeps (bf16, d = 64, 20 chained calls)
PROBE_BENCH = dict(num_nodes=262_144, avg_degree=6.0, seed=0)
PROBE_WIDTHS = (64, 128)
PROBE_K3_REPS, PROBE_DMA_REPS = 10, 20


def k3_variant_checks(g, dev, seed: int) -> dict:
    """Every instantiated K3 variant against its plain version on ``g`` at
    each probe width, flip and dtype; `full` at K3's own team size and
    depth bit for bit K3, sums_unstored's stored sums bit for bit `full`.
    Returns the largest |difference| per dtype and width."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.probes import k3_ablate as P

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in PROBE_WIDTHS:
            rows = P.inputs(g.n_nodes, g.n_edges, d, dtype, dev, seed)
            worst = 0.0
            for flip in (False, True):
                u, v, v_csr, u_csr = g.roles(flip)
                k3 = K.k3_edge_stage(u, v, v_csr, u_csr, *rows)
                full = P.k3_ablate("full", u, v, v_csr, u_csr, *rows)
                what = f"{dtype} d={d} flip={flip}"
                check(all(torch.equal(full[k], r) for k, r in
                          zip(("e_out", "sum_v", "sum_u"), k3)),
                      f"K3 ablate full == K3 bitwise, {what}")
                kept = P.k3_ablate("sums_unstored", u, v, v_csr, u_csr,
                                   *rows, store_sums=True)
                check(all(torch.equal(kept[k], full[k]) for k in full),
                      f"K3 ablate sums_unstored's sums == full, {what}")
                for variant, team, stages in sorted(P.INSTANCES):
                    got = P.k3_ablate(variant, u, v, v_csr, u_csr, *rows,
                                      team=team, stages=stages)
                    ref = P.k3_ablate_plain(variant, u, v, *rows)
                    torch.cuda.synchronize()
                    tag = f"K3 ablate {variant}:{team}:{stages} {what}"
                    check(set(got) == set(ref), f"{tag} outputs")
                    for k in got:
                        if k.startswith("walk"):
                            check(torch.equal(got[k], ref[k]), f"{tag} {k}")
                            continue
                        ok = (within_edges if k == "e_out"
                              else within_sums)(got[k], ref[k])
                        check(ok, f"{tag} {k}")
                        worst = max(worst, float(
                            (got[k].float() - ref[k].float()).abs().max()))
            out[f"{str(dtype).split('.')[1]} d={d}"] = worst
    return out


def stream_sum_checks(dev, seed: int) -> float:
    """stream_sum bit for bit its plain version at every point of the
    probe's sweeps, float32 and bf16, two chained calls; returns the
    largest |difference|."""
    import torch

    from gnnome_tpu_torch.probes import dma_probe

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T, ET, k in sorted(set(dma_probe.K_SWEEP + dma_probe.GRID_SWEEP)):
            xs = dma_probe.inputs(k, T * ET, 64, dtype, dev, seed)
            got = dma_probe.chain(dma_probe.stream_sum, xs, T, ET, 2)
            ref = dma_probe.chain(
                lambda ins, *_: dma_probe.stream_sum_plain(ins), xs, T, ET, 2)
            worst = max(worst, float((got.float() - ref.float()).abs().max()))
            check(torch.equal(got, ref),
                  f"stream_sum bitwise, {dtype} T={T} ET={ET} K={k}")
            del xs, got, ref
    return worst


# the Mosaic repro probe (probes/mosaic_repro.py): every case of CASES
# (the five scripts, at their shapes, in both dtypes where a script runs
# both) PASS against its plain chain on the card (stacks and gathers
# exact; segment sums within 1e-6 x the summed magnitudes, products within
# 1e-5 x sum |a||b|, bf16 also one bf16 spacing; case 6 at K3's
# tolerances) and a second chain bit for bit the first; the four kernels
# timed at P3's shapes in float32 and bf16; each chain and kernel over
# MOSAIC_REPS calls queued behind a sleep kernel, median of 5
MOSAIC_REPS = 20


def mosaic_checks(dev, seed: int) -> dict:
    """The Mosaic repro probe through its entry (``run_cases``, what
    ``python -m gnnome_tpu_torch.probes.mosaic_repro`` runs) with the probe
    counters from 0: every case PASS and each of the four kernels launched;
    then the four kernels alone at P3's shapes in float32 and bf16."""
    import torch

    from gnnome_tpu_torch import probes
    from gnnome_tpu_torch.probes import mosaic_repro as M

    probes.reset_launch_counts()
    t0 = time.perf_counter()
    cases = M.run_cases(dev, seed, reps=MOSAIC_REPS)
    run_s = time.perf_counter() - t0
    counts = probes.launch_counts()
    launches = {k: counts[k] for k in M.OPS}
    routes = {r: counts[f"small_matmul:{r}"] for r in M.MATMUL_ROUTES}
    bad = [(r["case"], r["status"], r.get("error")) for r in cases
           if r["status"] != "PASS"]
    check(not bad, f"mosaic repro cases PASS on the card: {bad}")
    check(len(cases) == len(M.CASES) == 42, "every mosaic repro case ran")
    check(all(launches.values()), f"each mosaic kernel launched by the "
                                  f"probe's run: {launches}")
    check(sum(routes.values()) == launches["small_matmul"],
          f"every small_matmul launch counted by its instantiation: "
          f"{routes}, {launches['small_matmul']}")
    before = dict(M.small_matmul.routes)
    ops = {str(dt).split(".")[1]: M.op_times(dev, dt, seed, MOSAIC_REPS)
           for dt in (torch.float32, torch.bfloat16)}
    p3_routes = {r: M.small_matmul.routes[r] - before[r]
                 for r in M.MATMUL_ROUTES}
    check(p3_routes["vector"] > 0 and p3_routes["scalar"] == 0,
          f"P3's shapes take small_matmul's vector instantiation: "
          f"{p3_routes}")
    check(all(r["status"] == "PASS" for rs in ops.values()
              for r in rs.values()), "the four mosaic kernels PASS alone")
    check(all(r.get("library_ms") for rs in ops.values()
              for r in rs.values()), "each mosaic kernel has a library call")
    return {"cases": cases, "launches": launches, "routes": routes,
            "p3_routes": p3_routes, "ops": ops, "run_s": run_s,
            "instantiations": matmul_instantiation_checks(dev, seed)}


def matmul_instantiation_checks(dev, seed: int) -> dict:
    """small_matmul at P3's shape ([512, 256] @ [256, 128]) through both
    instantiations, float32 and bf16: 16-byte rows (a column slice of a
    wider buffer: the vector one) and views one element in (the scalar
    one), each within 1e-5 x sum |a||b| of the plain version (bf16 also
    one bf16 spacing), bit for bit on repeat, counted under its own
    route, and timed."""
    import torch

    from gnnome_tpu_torch.probes import mosaic_repro as M
    from gnnome_tpu_torch.probes import time_ms

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bufs = [torch.randn(r, c + 8, generator=gen, device=dev).to(dtype)
                for r, c in ((512, 256), (256, 128))]
        for route, start in (("vector", 0), ("scalar", 1)):
            a, b = (x[:, start:start + x.shape[1] - 8] for x in bufs)
            tag = f"small_matmul {route} {dtype}"
            check(M.matmul_route(a, b) == route, f"{tag}: the C entry's "
                                                 "choice")
            before = dict(M.small_matmul.routes)
            got, again = M.small_matmul(a, b), M.small_matmul(a, b)
            check(M.small_matmul.routes[route] == before[route] + 2,
                  f"{tag}: counted under its route")
            ref = M.small_matmul_plain(a, b).float()
            tol = 1e-5 * M.small_matmul_plain(a.abs(), b.abs()).float()
            if dtype == torch.bfloat16:
                tol = tol + M.BF16_SPACING * torch.maximum(got.float().abs(),
                                                           ref.abs())
            err = (got.float() - ref).abs()
            check(bool((err <= tol).all()), f"{tag} against its plain "
                                            "version")
            check(torch.equal(got, again), f"{tag} bit for bit on repeat")
            out[f"{route} {str(dtype).split('.')[1]}"] = {
                "max_abs_diff": float(err.max()),
                "ms": time_ms(lambda: M.small_matmul(a, b), dev,
                              MOSAIC_REPS)}
    return out


# the redesigned kernels beside their one-call library counterparts, in
# turns (kernel, library, library, kernel): small_matmul at P3's shape
# against torch.matmul (float32 with TF32 off, and bf16), stream_sum at
# T = 768, ET = 2048, d = 64 against copy_ (K = 1) and torch.add (K = 2),
# in float32 and bf16
def probe_turns(dev, seed: int) -> dict:
    import torch

    from gnnome_tpu_torch.probes import dma_probe, in_turns
    from gnnome_tpu_torch.probes import mosaic_repro as M

    out = {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        a = torch.randn(512, 256, generator=gen, device=dev).to(dtype)
        b = torch.randn(256, 128, generator=gen, device=dev).to(dtype)
        res = torch.empty(512, 128, dtype=dtype, device=dev)
        with M.no_tf32():
            out[f"small_matmul {tag}"] = in_turns(
                lambda: M.small_matmul(a, b),
                lambda: torch.matmul(a, b, out=res), dev, MOSAIC_REPS)
        for k in (1, 2):
            xs = dma_probe.inputs(k, 768 * 2048, 64, dtype, dev, seed)
            t = in_turns(lambda: dma_probe.stream_sum(xs, 768, 2048),
                         dma_probe.library_call(xs), dev, PROBE_DMA_REPS)
            nbytes = dma_probe.cost(k, 768 * 2048, 64,
                                    xs[0].element_size())[0]
            t["gb_per_s"] = {w: [nbytes / ms / 1e6 for ms in t[w]]
                             for w in ("kernel_ms", "library_ms")}
            out[f"stream_sum {tag} K={k}"] = t
            del xs
    return out


def phase_probes(seed: int, dev) -> dict:
    """The card probes (``gnnome_tpu_torch/probes``): the probe library
    built, every K3 variant and stream_sum checked, then K3's cost split
    (``k3_ablate.sweep``: every variant at K3's own team size and depth,
    ``full``'s team and depth sweeps) on the golden graph and on the JAX
    probe's bench graph at d = 64 and 128 in float32 and bf16, and
    dma_probe's K and grid sweeps in bf16 and float32.  Returns the
    kernels line's numbers of both probes."""
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.graphs.synthetic import random_bench_graph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.probes import (build_probes, dma_probe,
                                         launch_counts, library,
                                         ptxas_resources,
                                         reset_launch_counts, time_ms)
    from gnnome_tpu_torch.probes import k3_ablate as P

    t0 = time.perf_counter()
    build_probes(force=True)
    build_s = time.perf_counter() - t0
    with open(os.path.join(K.BUILD_DIR, "nvcc_probes.log")) as f:
        log = f.read()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Used" in ln or "spill" in ln]
    # the redesigned kernels' registers, spills and shared memory: the
    # product's four instantiations, the stream sum's 24 (K x dtype); the
    # product's ring is dynamic shared memory, which ptxas does not see
    resources = {n: ptxas_resources(log, (n,))
                 for n in ("small_matmul", "stream_sum")}
    check(len(resources["small_matmul"]) == 4
          and len(resources["stream_sum"]) == 24
          and all(r["registers"] for rs in resources.values() for r in rs),
          f"ptxas reports every instantiation: {resources}")
    lib = library()
    resources["small_matmul_dynamic_smem"] = {
        "float32": lib.gn_small_matmul_smem(0),
        "bfloat16": lib.gn_small_matmul_smem(1)}
    golden = DeviceGraph.from_graph(AssemblyGraph.load(GOLDEN), dev)
    k3_err = k3_variant_checks(golden, dev, seed)
    dma_err = stream_sum_checks(dev, seed)
    t_checks = time.perf_counter() - t0 - build_s
    mosaic = mosaic_checks(dev, seed)
    turns = probe_turns(dev, seed)
    src, dst = random_bench_graph(PROBE_BENCH["num_nodes"],
                                  PROBE_BENCH["avg_degree"],
                                  seed=PROBE_BENCH["seed"])
    bench = DeviceGraph.build(src, dst, PROBE_BENCH["num_nodes"], dev)
    # the two probes' own runs (k3_ablate's and dma_probe's sweeps, what
    # their entries run), counted from 0
    reset_launch_counts()
    split = {}
    for gname, g in (("golden", golden), ("bench", bench)):
        for dtype in (torch.float32, torch.bfloat16):
            for d in PROBE_WIDTHS:
                split[f"{gname} {str(dtype).split('.')[1]} d={d}"] = (
                    P.sweep(g, d, dtype, P.default_specs(d), PROBE_K3_REPS,
                            seed))
    dma = {str(dt).split(".")[1]: dma_probe.sweep(dev, dt, PROBE_DMA_REPS,
                                                  seed=seed)
           for dt in (torch.bfloat16, torch.float32)}
    sweeps = launch_counts()
    check(sweeps["k3_ablate"] > 0 and sweeps["stream_sum"] > 0,
          f"the sweeps launched k3_ablate and stream_sum: {sweeps}")
    # the kernels line's rows: the JAX probes' own configurations (K3 on
    # the bench graph at d = 64 in bf16, full at K3's team size and depth;
    # stream_sum at T = 768, ET = 2048, K = 4 in bf16), with the plain
    # versions timed on the same inputs
    full = split["bench bfloat16 d=64"][0]
    check(full["variant"] == "full", "the sweep's first row is full")
    rows = P.inputs(bench.n_nodes, bench.n_edges, 64, torch.bfloat16, dev,
                    seed)
    u, v, _, _ = bench.roles(False)
    k3_plain = time_ms(lambda: P.k3_ablate_plain("full", u, v, *rows), dev,
                       PROBE_K3_REPS)
    del rows
    at = next(r for r in dma["bfloat16"]
              if (r["T"], r["ET"], r["K"]) == (768, 2048, 4))
    xs = dma_probe.inputs(4, 768 * 2048, 64, torch.bfloat16, dev, seed)
    dma_plain = time_ms(lambda: dma_probe.stream_sum_plain(xs), dev,
                        PROBE_DMA_REPS)
    del xs
    best = {dt: max(r["gb_per_s"] for r in rs) for dt, rs in dma.items()}
    emit("probes", build_s=build_s, checks_s=t_checks, ptxas=ptxas,
         resources=resources, turns=turns,
         graphs={"golden": {"nodes": golden.n_nodes, "edges": golden.n_edges},
                 "bench": {"nodes": bench.n_nodes, "edges": bench.n_edges}},
         k3_max_abs_diff=k3_err, stream_sum_max_abs_diff=dma_err,
         k3_split=split, dma=dma, stream_best_gb_per_s=best,
         mosaic=mosaic,
         stream_best_share_of_nominal={
             dt: g * 1e9 / HBM_BYTES_PER_S for dt, g in best.items()},
         tolerance={"edges": EDGE_ATOL, "bf16_edges": "one bf16 spacing",
                    "sums_atol": SUM_ATOL, "sums_rtol": SUM_RTOL,
                    "bf16_sums_rtol": SUM_RTOL + BF16_SPACING,
                    "walk_words": "exact", "stream_sum": "exact",
                    "full_vs_k3": "exact",
                    "mosaic_stack_gather": "exact",
                    "mosaic_sum_rtol_of_magnitudes": "1e-6",
                    "mosaic_product_rtol_of_magnitudes": "1e-5",
                    "mosaic_bf16": "also one bf16 spacing",
                    "mosaic_case6": "K3's (e_out 1e-5; sums 1e-4 + 1e-5 "
                                    "|x|), a second K3 bit for bit"})
    return {"k3_ablate": {"ms": full["ms"], "plain_ms": k3_plain,
                          "bound_ms": full["bound_ms"],
                          "bound_by": full["bound_by"],
                          "max_abs_err": max(k3_err.values()),
                          "width": 64, "dtype": "bfloat16",
                          "graph": "bench",
                          "launches": sweeps["k3_ablate"]},
            "stream_sum": {"ms": at["ms"], "plain_ms": dma_plain,
                           "bound_ms": at["bound_ms"],
                           "bound_by": at["bound_by"],
                           "max_abs_err": dma_err, "width": 64,
                           "dtype": "bfloat16",
                           "shape": {"T": 768, "ET": 2048, "K": 4},
                           "launches": sweeps["stream_sum"],
                           "resources": resources["stream_sum"],
                           "turns": {k: v for k, v in turns.items()
                                     if k.startswith("stream_sum")}},
            "mosaic": mosaic, "resources": resources, "turns": turns}


def relabelled(graph, seed: int, dev):
    """``graph``'s ``DeviceGraph`` with its node ids relabelled by a seeded
    random permutation: the same degrees, no id locality."""
    import numpy as np

    from gnnome_tpu_torch.ops import DeviceGraph

    perm = np.random.default_rng(seed).permutation(graph.num_nodes)
    return DeviceGraph.build(perm[np.asarray(graph.src)],
                             perm[np.asarray(graph.dst)], graph.num_nodes,
                             dev)


def no_edge_checks(dev, d: int = 64) -> dict:
    """Every wrapper at E = 0 on the card against its plain version on the
    same inputs (a graph of NO_EDGE_N nodes, no edges; float32 and bf16
    where the kernel runs bf16): equal outputs, no launch counted.
    Returns each wrapper's largest difference."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    n = NO_EDGE_N
    g = DeviceGraph.build(np.zeros(0, np.int64), np.zeros(0, np.int64), n,
                          dev)
    u, v, v_csr, u_csr = g.roles(False)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        proj = torch.randn(n, 4 * d, device=dev, generator=gen).to(dt)
        pu, pv = proj[:, :2 * d], proj[:, 2 * d:]
        dsum = torch.randn(n, 2 * d, device=dev, generator=gen).to(dt)
        bn = torch.stack([torch.zeros(d), torch.ones(d), torch.ones(d),
                          torch.zeros(d)]).to(dev, dt)

        def edges(w):
            return torch.zeros(0, w, dtype=dt, device=dev)

        calls = {
            "k1_gather_gate": ((u, v, pu, pv, edges(d)), None),
            "k2_aggregate": ((u, v, v_csr, u_csr, edges(2 * d),
                              edges(2 * d)), (u, v, edges(2 * d),
                                              edges(2 * d), n)),
            "k3_edge_stage": ((u, v, v_csr, u_csr, pu, pv, edges(d),
                               edges(d), bn), (u, v, pu, pv, edges(d),
                                               edges(d), bn)),
            "k6_score_gate": ((u, v, pu, edges(d)), None),
            "k7_gate_stats": ((u, v, pu[:, :d], pv[:, :d], edges(d)), None),
            "k8_train_layer_bwd": ((u, v, v_csr, u_csr, dsum, dsum, pu, pv,
                                    edges(d), edges(d), edges(d), bn),
                                   (u, v, dsum, dsum, pu, pv, edges(d),
                                    edges(d), edges(d), bn)),
            "k9_aggregate": ((u, v, v_csr, u_csr, edges(d)),
                             (u, v, edges(d), n)),
            "bn_edge_adjoint": ((edges(d), edges(d), bn,
                                 torch.zeros(3, d, device=dev)), None),
        }
        if dt == torch.float32:
            calls["k2_side_sum"] = ((u, u_csr, edges(d)), (u, edges(d), n))
            calls["ln_edge_stage"] = ((edges(3 * d), edges(d), bn[2],
                                       bn[3], 1e-5), None)
            calls["ln_edge_adjoint"] = ((u, v, dsum, dsum, edges(3 * d),
                                         edges(d), edges(d), edges(2),
                                         bn[2], bn[3]), None)
        for name, (args, plain_args) in calls.items():
            fn = K.KERNELS[name]
            plain = getattr(K, f"{name}_plain")
            K.reset_launch_counts()
            got = fn(*args)
            check(K.launch_counts() == expected_launches(),
                  f"{name} at E=0 ({dt}): no launch")
            want = plain(*(args if plain_args is None else plain_args))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            check(len(got) == len(want) and all(
                a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device for a, b in zip(got, want)),
                f"{name} at E=0 ({dt}): outputs' dtypes and shapes")
            diff = max((float((a.double() - b.double()).abs().max())
                        if a.numel() else 0.0) for a, b in zip(got, want))
            check(diff == 0.0, f"{name} at E=0 ({dt}): equal to its plain "
                  f"version (max {diff})")
            out.setdefault(name, 0.0)
            out[name] = max(out[name], diff)
    return out


def phase_kernels(seed: int, dev, per_forward: dict):
    """Each kernel vs its plain version at the golden graph's shapes, and
    K2, K3, K7, K8, K9 at widths above 128 on the same graph."""
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    graph = AssemblyGraph.load(GOLDEN)
    g = DeviceGraph.from_graph(graph, dev)
    N, E, d, H = g.n_nodes, g.n_edges, 64, 64
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    proj = randn(N, 5 * d)                  # [B1|A2|B2|A3|A1], as the model
    proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]
    b3e, e_in = randn(E, d), randn(E, d)
    bn = bn_rows(d, randn, rand)
    puv, be = randn(N, 2 * H), randn(E, H)
    out = {}

    k3_bytes, *k3_ops = k3_cost(N, E, d)
    k3_bound, k3_by = bound(k3_bytes, *k3_ops)
    # what the kernel moves: the bound's bytes, pass 2's re-read of e_out
    # and the second partner array (one per CSR)
    k3_moved = k3_bytes + F4 * E * d + I4 * E
    k3 = {"launches_per_forward": per_forward["k3_edge_stage"]}
    for flip in (False, True):
        args, diff_e, diff = check_k3(g, flip, proj_u, proj_v, b3e, e_in, bn,
                                      f"d={d}")
        u, v = args[:2]
        t = kernel_times(lambda: K.k3_edge_stage(*args))
        k3[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_abs_diff_e_out": diff_e, **t,
            "achieved_gbps": k3_moved / t["device_ms"] / 1e6,
            "plain_ms": cuda_ms(lambda: K.k3_edge_stage_plain(
                u, v, proj_u, proj_v, b3e, e_in, bn))}
    k3.update(bound_ms=k3_bound, bound_by=k3_by, bytes=k3_bytes,
              moved_bytes=k3_moved, bitwise_reproducible=True,
              tolerance={"e_out_atol": EDGE_ATOL, "sums_atol": SUM_ATOL,
                         "sums_rtol": SUM_RTOL})
    out["k3_edge_stage"] = k3

    k6_bytes, *k6_ops = k6_cost(N, E, H)
    k6_bound, k6_by = bound(k6_bytes, *k6_ops)
    k6 = {"launches_per_forward": per_forward["k6_score_gate"]}
    # the same values as column slices of wider arrays (row-strided)
    puv_s = torch.zeros(N, 2 * H + 8, device=dev)[:, :2 * H].copy_(puv)
    be_s = torch.zeros(E, H + 8, device=dev)[:, :H].copy_(be)
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        diff = check_k6(g, flip, puv, be, f"H={H}")
        check_k6(g, flip, puv_s, be_s, f"H={H} strided")
        t = kernel_times(lambda: K.k6_score_gate(u, v, puv, be))
        k6[f"flip={flip}"] = {
            "max_abs_diff": diff, **t,
            "achieved_gbps": k6_bytes / t["device_ms"] / 1e6,
            "strided_device_ms": cuda_ms(lambda: K.k6_score_gate(
                u, v, puv_s, be_s), queued=True),
            "plain_ms": cuda_ms(lambda: K.k6_score_gate_plain(u, v, puv,
                                                              be))}
    k6.update(bound_ms=k6_bound, bound_by=k6_by, bytes=k6_bytes,
              bitwise_reproducible=True, tolerance={"atol": 0.0})
    out["k6_score_gate"] = k6

    # ---- training kernels: the model's [N, 4d] training projection
    proj4 = randn(N, 4 * d)                 # [B1|A2|B2|A3]
    tu, tv = proj4[:, :2 * d], proj4[:, 2 * d:]
    d_e_out, d_sum_u, d_sum_v = randn(E, d), randn(N, 2 * d), randn(N, 2 * d)

    k7_bytes, *k7_ops = k7_cost(N, E, d)
    k7_bound, k7_by = bound(k7_bytes, *k7_ops)
    k7 = {}
    bu, bv = tu[:, :d], tv[:, :d]
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        diff, rel = check_k7(g, flip, bu, bv, b3e, f"d={d}")
        t = kernel_times(lambda: K.k7_gate_stats(u, v, bu, bv, b3e))
        k7[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_rel_diff": rel, **t,
            "achieved_gbps": k7_bytes / t["device_ms"] / 1e6,
            "plain_ms": cuda_ms(lambda: K.k7_gate_stats_plain(u, v, bu, bv,
                                                              b3e))}
    k7.update(bound_ms=k7_bound, bound_by=k7_by, bytes=k7_bytes,
              tolerance={"sum64_rtol_of_magnitudes": SUM64_RTOL})
    out["k7_gate_stats"] = k7

    k8 = {}
    k8_args = (d_sum_u, d_sum_v, tu, tv, b3e, e_in, d_e_out, bn)
    for flip in (False, True):
        u, v, v_csr, u_csr = g.roles(flip)
        diff, d_eo_diff = check_k8(g, flip, k8_args, f"d={d}")
        k8[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_abs_diff_d_eo": d_eo_diff,
            **kernel_times(lambda: K.k8_train_layer_bwd(
                u, v, v_csr, u_csr, *k8_args)),
            "plain_ms": cuda_ms(lambda: K.k8_train_layer_bwd_plain(
                u, v, *k8_args))}
    k8_bytes, *k8_ops = k8_cost(N, E, d)
    k8_bound, k8_by = bound(k8_bytes, *k8_ops)
    # what the kernel moves: the bound's bytes, pass 2's re-reads of x,
    # d_eo and e_in, and the second partner array
    k8_moved = k8_bytes + F4 * 3 * E * d + I4 * E
    for flip in (False, True):
        r = k8[f"flip={flip}"]
        r["achieved_gbps"] = k8_moved / r["device_ms"] / 1e6
    k8.update(bound_ms=k8_bound, bound_by=k8_by, bytes=k8_bytes,
              moved_bytes=k8_moved, bitwise_reproducible=True,
              tolerance={"x": "exact", "d_eo_atol": EDGE_ATOL,
                         "sums_atol": SUM_ATOL, "sums_rtol": SUM_RTOL,
                         "sum64_rtol_of_magnitudes": SUM64_RTOL})
    out["k8_train_layer_bwd"] = k8

    k9_bytes, *k9_ops = k9_cost(N, E, H)
    k9_bound, k9_by = bound(k9_bytes, *k9_ops)
    k9 = {}
    pay = torch.relu(randn(E, H))           # dz * (z > 0): about half zeros
    # the same degrees with node ids in random order: the two reads of a
    # payload row no longer come from nearby nodes
    g_rel = relabelled(graph, seed, dev)
    for flip in (False, True):
        u, v, v_csr, u_csr = g.roles(flip)
        diff, diff_card = check_k9(g, flip, pay, f"H={H}")
        # the one PyTorch call for the same sums: index_add_ over the
        # stacked index [u; v + N] and payload [pay; pay] (built outside
        # the timing); it adds with atomics, so its sums vary run to run
        uv = torch.cat([u.long(), v.long() + N])
        pay2 = torch.cat([pay, pay])
        acc = torch.zeros(2 * N, H, device=dev)
        t = kernel_times(lambda: K.k9_aggregate(u, v, v_csr, u_csr, pay))
        ru, rv, rv_csr, ru_csr = g_rel.roles(flip)
        check_k9(g_rel, flip, pay, f"H={H} relabelled")
        k9[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_abs_diff_vs_card_plain": diff_card,
            **t, "achieved_gbps": k9_bytes / t["device_ms"] / 1e6,
            "relabelled_device_ms": cuda_ms(lambda: K.k9_aggregate(
                ru, rv, rv_csr, ru_csr, pay), queued=True),
            "plain_ms": cuda_ms(lambda: K.k9_aggregate_plain(u, v, pay, N)),
            "library_ms": cuda_ms(lambda: acc.zero_().index_add_(0, uv,
                                                                 pay2))}
    k9.update(bound_ms=k9_bound, bound_by=k9_by, bytes=k9_bytes,
              bitwise_reproducible=True,
              tolerance={"vs_cpu_plain_atol": 0.0, "vs_card_plain_atol":
                         SUM_ATOL, "vs_card_plain_rtol": SUM_RTOL},
              library_call="torch.Tensor.index_add_ on [u; v+N], [pay; pay]")
    out["k9_aggregate"] = k9

    # ---- the layer-norm and norm-free model's kernels, K1 and K2
    out.update(unfused_kernels(g, randn))

    # ---- the dual symmetry pass: K3, K7, K8 at d = 2 * 64 and K6, K9 at
    # H = 2 * 64, flip=False, as a batch-norm train step launches them
    out["dual"] = width_kernel_times(g, DUAL_D, randn, rand)

    # ---- the one-sided K2 walk (the zoo's node sums) at D = 64 (GCN,
    # SAGE) and 192 (GAT's messages) into each side, bit-equal to its
    # plain version on CPU copies; its widths 3 (GAT's softmax sums) and a
    # column slice checked too
    _, _, by_dst, by_src = g.roles(False)
    sides = {"dst": (g.dst, by_dst), "src": (g.src, by_src)}
    side = {}
    for width in (d, 3 * d):
        pay = randn(E, width)
        acc = torch.zeros(N, width, device=dev)
        for name, (idx, csr) in sides.items():
            diff = check_side_sum(idx, csr, pay, N, f"D={width} {name}")
            check_side_sum(idx, csr, randn(E, width + 5)[:, :width], N,
                           f"D={width} {name} strided")
            nbytes, *ops = side_sum_cost(N, E, width, name == "src")
            b_ms, b_by = bound(nbytes, *ops)
            idx64 = idx.long()
            t = kernel_times(lambda: K.k2_side_sum(idx, csr, pay))
            side[f"D={width} side={name}"] = {
                "max_abs_diff": diff, **t,
                "achieved_gbps": nbytes / t["device_ms"] / 1e6,
                "plain_ms": cuda_ms(lambda: K.k2_side_sum_plain(idx, pay, N)),
                "library_ms": cuda_ms(lambda: acc.zero_().index_add_(
                    0, idx64, pay)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    for name, (idx, csr) in sides.items():
        check_side_sum(idx, csr, randn(E, 3), N, f"D=3 {name}")
    side.update(bitwise_reproducible=True, tolerance={"vs_cpu_plain_atol": 0.0},
                library_call="torch.Tensor.index_add_ into one side")
    out["k2_side_sum"] = side

    # ---- widths above 128: K3, K6, K7, K8 at d = WIDE_D (two column
    # chunks) and K9 at WIDE_PAY (K2's are unfused_kernels'), and K6 at
    # ODD_H with odd row strides (the one-float path), each against its
    # plain version and bitwise reproducible, both flips; not timed
    dw, wp, ho = WIDE_D, WIDE_PAY, ODD_H
    # K6's operands as column slices: row strides 2 * dw + 8 and dw + 8
    # (float4 rows), 2 * ho + 1 and ho + 1 (one float per lane)
    puv_w = randn(N, 2 * dw + 8)[:, :2 * dw]
    be_w = randn(E, dw + 8)[:, :dw]
    puv_o = randn(N, 2 * ho + 1)[:, :2 * ho]
    be_o = randn(E, ho + 1)[:, :ho]
    projw = randn(N, 5 * dw)
    b3w, e_inw, d_e_outw = randn(E, dw), randn(E, dw), randn(E, dw)
    bnw = bn_rows(dw, randn, rand)
    d_suw, d_svw = randn(N, 2 * dw), randn(N, 2 * dw)
    # K9's payloads: dense at H = WIDE_PAY, and column slices at WIDE_PAY
    # and ODD_H with row strides H + 8 (float4 rows) and H + 1 (one float
    # per lane)
    k9_pays = [randn(E, wp)] + [randn(E, h + pad)[:, :h] for h in (wp, ho)
                                for pad in (8, 1)]
    wide = {"d": dw, "width": wp, "k6_odd_h": ho}
    for flip in (False, True):
        pu, pv = projw[:, :2 * dw], projw[:, 2 * dw:4 * dw]
        r = {}
        _, _, r["k3_max_abs_diff"] = check_k3(g, flip, pu, pv, b3w, e_inw,
                                              bnw, f"d={dw}")
        r["k6_max_abs_diff"] = check_k6(g, flip, puv_w, be_w, f"H={dw}")
        r["k6_odd_max_abs_diff"] = check_k6(g, flip, puv_o, be_o,
                                            f"H={ho} one-float")
        r["k7_max_abs_diff"], _ = check_k7(g, flip, pu[:, :dw], pv[:, :dw],
                                           b3w, f"d={dw}")
        r["k8_max_abs_diff"], _ = check_k8(
            g, flip, (d_suw, d_svw, pu, pv, b3w, e_inw, d_e_outw, bnw),
            f"d={dw}")
        r["k9_max_abs_diff"] = max(
            check_k9(g, flip, p, f"H={p.shape[1]} stride {p.stride(0)}")[0]
            for p in k9_pays)
        wide[f"flip={flip}"] = r
    wide["bitwise_reproducible"] = True
    out["wide"] = wide
    out["bn_edge_adjoint"] = bn_adjoint_times(dev, seed, torch.float32, E)
    out["ln_edge_stage"] = ln_stage_times(dev, seed, g)
    out["no_edges"] = {"nodes": NO_EDGE_N,
                       "max_abs_diff": no_edge_checks(dev)}
    emit("kernels", graph={"nodes": N, "edges": E}, d=d, H=H, seed=seed,
         **out)
    return out


def scores_agree(lo, ref, labels, bounds=None) -> dict:
    """bf16 logits against a reference run: cosine, the largest probability
    change and the AP difference, each within ``bounds`` (min cosine, max
    probability change, max AP change; by default SCORE_*); returns
    them."""
    import numpy as np

    lo, ref = lo.astype(np.float64), ref.astype(np.float64)
    cos = float((lo * ref).sum() / (np.linalg.norm(lo) * np.linalg.norm(ref)))
    dp = float(np.abs(1 / (1 + np.exp(-lo)) - 1 / (1 + np.exp(-ref))).max())
    d_ap = abs(average_precision(1 / (1 + np.exp(-lo)), labels)
               - average_precision(1 / (1 + np.exp(-ref)), labels))
    min_cos, max_dp, max_ap = bounds or (SCORE_COS, SCORE_DP, SCORE_AP)
    check(cos > min_cos and dp < max_dp and d_ap < max_ap,
          f"bf16 logits vs reference: cosine {cos}, probability {dp}, "
          f"AP {d_ap}")
    return {"cosine": cos, "max_abs_prob_diff": dp, "ap_diff": d_ap}


def card_vs_cpu_forward(graph, new_model, dev, per_forward: dict,
                        what: str, model_cfg=None, dtype=None,
                        per_forward_bf16=None, score_bounds=None):
    """Scores ``graph`` with ``new_model(device)`` on the CPU and on the
    card (a zoo model of ``model_cfg`` on its processor graph; the
    SymGatedGCN at compute dtype ``dtype`` if given): two card forwards
    bitwise equal, each launching the kernels of ``per_forward`` that often
    and no other, of them those of ``per_forward_bf16`` (none by default)
    in their bf16 instantiation; finite logits within LOGIT_ATOL +
    LOGIT_RTOL·|x| of the CPU run (in bf16: ``scores_agree`` against the
    graph's labels, within ``score_bounds``).  Returns (card logits, CPU
    logits, a summary with the forward time and peak memory)."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.models import edge_features, node_features
    from gnnome_tpu_torch.models.zoo import processor_graph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    x_np, e_np = node_features(graph), edge_features(graph)

    def setup(device):
        g = DeviceGraph.from_graph(graph, device)
        gp = (None if model_cfg is None else processor_graph(
            model_cfg, graph.src, graph.dst, graph.num_nodes, device))
        args = (g, torch.as_tensor(x_np, device=device),
                torch.as_tensor(e_np, device=device))
        return new_model(device), args + (() if gp is None else (gp,))

    kw = {} if dtype is None else {"dtype": dtype}
    with torch.inference_mode():
        m_cpu, args_cpu = setup("cpu")
        t0 = time.perf_counter()
        lo_cpu = m_cpu(*args_cpu, **kw).reshape(-1).numpy()
        cpu_s = time.perf_counter() - t0

        model, args = setup(dev)
        model(*args, **kw)                                  # warm-up
        K.reset_launch_counts()
        runs = [model(*args, **kw).reshape(-1) for _ in range(2)]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        counts_bf16 = K.launch_counts(torch.bfloat16)
        check(counts == expected_launches(**{k: 2 * n for k, n
                                             in per_forward.items()}),
              f"{what}: per-forward launches (2 forwards): {counts}")
        check(counts_bf16 == expected_launches(**{
            k: 2 * n for k, n in (per_forward_bf16 or {}).items()}),
            f"{what}: per-forward bf16 launches (2 forwards): {counts_bf16}")
        check(torch.equal(runs[0], runs[1]),
              f"{what}: two card runs bitwise equal")
        torch.cuda.reset_peak_memory_stats(dev)
        fwd_ms = cuda_ms(lambda: model(*args, **kw), reps=5, n=5)
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    lo = runs[0].cpu().numpy()
    check(bool(np.isfinite(lo).all()) and lo.shape == (graph.num_edges,)
          and lo.dtype == np.float32, f"{what}: finite logits of shape [E]")
    dlo = np.abs(lo - lo_cpu)
    agree = {}
    if dtype == torch.bfloat16:
        agree = {"vs_cpu": scores_agree(lo, lo_cpu, graph.y, score_bounds)}
    else:
        check(bool((dlo <= LOGIT_ATOL + LOGIT_RTOL * np.abs(lo_cpu)).all()),
              f"{what}: logits vs CPU run (max {dlo.max()})")
    return lo, lo_cpu, {**agree,
        "launches_per_forward": {k: n // 2 for k, n in counts.items()},
        "launches_per_forward_bf16": {k: n // 2
                                      for k, n in counts_bf16.items()},
        "bitwise_reproducible": True,
        "max_abs_logit_diff_vs_cpu": float(dlo.max()),
        "logit_range": [float(lo.min()), float(lo.max())],
        "forward_ms": fwd_ms, "max_memory_allocated_mb": peak_mb,
        "cpu_forward_s": cpu_s}


def phase_model(dev):
    """Golden graph, shipped weights: card vs the port's CPU run."""
    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import load_model_weights

    graph = AssemblyGraph.load(GOLDEN)
    params, state = load_model_weights(WEIGHTS)
    lo, lo_cpu, fwd = card_vs_cpu_forward(
        graph, lambda device: load_model(params, state, Config(), device),
        dev, {"k3_edge_stage": 8, "k6_score_gate": 1}, "batch norm")
    sig = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))  # noqa: E731
    p, p_cpu = sig(lo), sig(lo_cpu)
    dp = float(np.abs(p - p_cpu).max())
    check(dp <= PROB_ATOL, f"probabilities vs CPU run (max {dp})")
    ap = average_precision(p, graph.y)
    check(abs(ap - JAX_GOLDEN_AP) < AP_TOL, f"AP {ap} vs {JAX_GOLDEN_AP}")
    emit("model", graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=os.path.relpath(WEIGHTS, ROOT), **fwd,
         max_abs_prob_diff_vs_cpu=dp, average_precision=ap,
         ap_delta_vs_jax=ap - JAX_GOLDEN_AP,
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL,
                    "prob_atol": PROB_ATOL, "ap": AP_TOL})
    return fwd


def phase_model_bf16(dev, fwd32: dict):
    """Golden graph, shipped weights, compute.dtype=bfloat16: card vs the
    port's CPU bf16 run, the AP against the JAX package's bf16 figure, the
    forward time and memory beside phase 2's float32 ones."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import load_model_weights

    graph = AssemblyGraph.load(GOLDEN)
    params, state = load_model_weights(WEIGHTS)
    lo, _, fwd = card_vs_cpu_forward(
        graph, lambda device: load_model(params, state, Config(), device),
        dev, {"k3_edge_stage": 8, "k6_score_gate": 1}, "batch norm bf16",
        dtype=torch.bfloat16,
        per_forward_bf16={"k3_edge_stage": 8, "k6_score_gate": 1})
    ap = average_precision(1.0 / (1.0 + np.exp(-lo.astype(np.float64))),
                           graph.y)
    check(abs(ap - JAX_GOLDEN_AP_BF16) < AP_TOL,
          f"bf16 AP {ap} vs {JAX_GOLDEN_AP_BF16}")
    emit("model_bf16",
         graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=os.path.relpath(WEIGHTS, ROOT), dtype="bfloat16", **fwd,
         average_precision=ap, ap_delta_vs_jax_bf16=ap - JAX_GOLDEN_AP_BF16,
         float32={k: fwd32[k] for k in ("forward_ms",
                                        "max_memory_allocated_mb")},
         tolerance={"score_cosine": SCORE_COS, "score_prob": SCORE_DP,
                    "score_ap": SCORE_AP, "ap": AP_TOL})


def phase_model_unfused(dev):
    """Golden graph, the layer-norm and the norm-free model at full width
    and depth with seeded init weights: card vs the port's CPU run."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.models import SymGatedGCN

    graph = AssemblyGraph.load(GOLDEN)
    out = {}
    for norm in ("layer", "none"):
        cfg = Config()
        cfg.model.normalization = norm

        def new_model(device):
            model = SymGatedGCN.from_config(cfg.model)
            return model.init_weights(UNFUSED_INIT_SEED).to(device)

        _, _, out[norm] = card_vs_cpu_forward(
            graph, new_model, dev, UNFUSED_FORWARD_LAUNCHES, norm)
    emit("model_unfused",
         graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=f"init_weights({UNFUSED_INIT_SEED})",
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL},
         **out)
    return out


def phase_model_unfused_bf16(dev, fwd32: dict):
    """``model_unfused`` at compute.dtype=bfloat16: the golden graph, the
    layer-norm and the norm-free model at full width and depth with the
    same seeded weights, card vs the port's CPU bf16 run (cosine,
    probabilities, AP), two card runs bitwise equal, 8 K1 and 8 K2 per
    forward of which bf16 every one (none) or the first layer's K1 (layer
    norm), the forward's time and memory beside ``model_unfused``'s float32
    ones (``fwd32``)."""
    import torch

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.models import SymGatedGCN

    graph = AssemblyGraph.load(GOLDEN)
    out = {}
    for norm in ("layer", "none"):
        cfg = Config()
        cfg.model.normalization = norm

        def new_model(device):
            model = SymGatedGCN.from_config(cfg.model)
            return model.init_weights(UNFUSED_INIT_SEED).to(device)

        _, _, fwd = card_vs_cpu_forward(
            graph, new_model, dev, UNFUSED_FORWARD_ALL_BF16[norm],
            f"{norm} bf16",
            dtype=torch.bfloat16, per_forward_bf16=UNFUSED_FORWARD_BF16[norm],
            score_bounds=(UNFUSED_SCORE_COS, UNFUSED_SCORE_DP, SCORE_AP))
        out[norm] = {**fwd, "float32": {k: fwd32[norm][k] for k in (
            "forward_ms", "max_memory_allocated_mb")}}
    emit("model_unfused_bf16",
         graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=f"init_weights({UNFUSED_INIT_SEED})", dtype="bfloat16",
         tolerance={"score_cosine": UNFUSED_SCORE_COS,
                    "score_prob": UNFUSED_SCORE_DP, "score_ap": SCORE_AP},
         **out)


def phase_infer():
    """The main path: ``cli infer`` on the card, counters from 0."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    ds, genome = make_infer_dataset(os.path.join(WORK, "ds"))
    build_s = time.perf_counter() - t0
    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", WEIGHTS,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}"])
    wall_s = time.perf_counter() - t0
    counts = K.launch_counts()
    check(summary["device"].startswith("cuda"), "infer ran on the card")
    check(counts == {**{k: 0 for k in K.KERNELS},
                     "k3_edge_stage": 8, "k6_score_gate": 1},
          f"eval-path launches {counts}")
    contig = exact_top_contig(
        os.path.join(savedir, "assembly", "0_assembly.fasta"), genome)
    emit("infer", dataset={k: v for k, v in INFER_GRAPH.items()},
         dataset_build_s=build_s, wall_s=wall_s, timing_s=summary["timing"],
         peak_rss_mb=summary["peak_rss_mb"], **contig, launches=counts)
    return counts


STUB_HIFIASM = """#!/bin/sh
# stub hifiasm for ``cli run``: writes the prepared GFA as
# <-o prefix>.bp.raw.r_utg.gfa, the file hifiasm --prt-raw writes
out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) shift;; esac
done
cp "{gfa}" "$out.bp.raw.r_utg.gfa"
"""

# the host-timing build, in a process of its own: writes the reads as a
# hifiasm GFA (timed apart), then ``cli build-graph``; prints one JSON line.
# Its peak RSS is sampled from /proc/self/statm every 2 ms while the build
# runs (None where statm is missing): ``cli build-graph``'s own figure,
# getrusage's ru_maxrss, survives execve, so a child of this many-GB
# process reports the parent's resident set from the fork
TIMING_BUILD = r"""
import json, os, sys, threading, time
import numpy as np
from gnnome_tpu_torch import cli
from gnnome_tpu_torch.graphs.synthetic import (
    random_genome, simulate_reads_from_genome, write_synthetic_gfa)
spec, root, threads = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
t0 = time.perf_counter()
rng = np.random.default_rng(spec["seed"])
genome = random_genome(spec["genome_len"], rng)
recs, st, en, sd = simulate_reads_from_genome(
    genome, spec["n_reads"], spec["read_len"], rng)
gfa, reads = f"{root}/g.gfa", f"{root}/reads.fasta"
write_synthetic_gfa(recs, st, en, sd, gfa, reads, dialect="hifiasm")
write_s = time.perf_counter() - t0
page, peak, done = os.sysconf("SC_PAGE_SIZE"), [0], threading.Event()
def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * page
def sample():
    while not done.is_set():
        peak[0] = max(peak[0], rss())
        done.wait(0.002)
try:
    rss()
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
except OSError:
    sampler = None
t0 = time.perf_counter()
r = cli.main(["build-graph", "--gfa", gfa, "--reads", reads, "--asm",
              "hifiasm", "--out", f"{root}/ds", "--threads", threads,
              "--training"])
wall_s = time.perf_counter() - t0
done.set()
if sampler is not None:
    sampler.join()
print(json.dumps({"write_gfa_s": write_s, "build_graph_wall_s": wall_s,
                  "stages_s": r["timing"],
                  "sampled_peak_rss_mb": peak[0] / 2 ** 20 if sampler
                  else None, "ru_maxrss_mb": r["peak_rss_mb"]}))
"""


def write_reads_gfa(root: str, dialect: str, spec=None):
    """The reads of ``synthetic_assembly_graph(**spec)`` (default: the
    phase-4 graph, INFER_GRAPH; no false edges) as a GFA of ``dialect`` and
    a FASTA under ``root``: the same genome and reads, drawn the same way
    from the seed.  Returns ``(gfa, reads, genome)``."""
    import numpy as np

    from gnnome_tpu_torch.graphs.synthetic import (random_genome,
                                                   simulate_reads_from_genome,
                                                   write_synthetic_gfa)

    spec = spec or INFER_GRAPH
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(spec["seed"])
    genome = random_genome(spec["genome_len"], rng)
    records, starts, ends, strands = simulate_reads_from_genome(
        genome, spec["n_reads"], spec["read_len"], rng)
    gfa = os.path.join(root, f"{dialect}.gfa")
    reads = os.path.join(root, f"{dialect}_reads.fasta")
    write_synthetic_gfa(records, starts, ends, strands, gfa, reads,
                        dialect=dialect)
    return gfa, reads, genome


def exact_top_contig(fasta: str, genome: str) -> dict:
    """The longest contig of ``fasta``: its length, and whether it is an
    exact substring of the genome or of its reverse complement (checked,
    with the length threshold)."""
    from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

    contigs = list(read_fastx(fasta))
    top = max(contigs, key=lambda c: len(c.seq))
    exact = top.seq in genome or top.seq in reverse_complement(genome)
    check(exact, f"{fasta}: longest contig an exact substring of the genome")
    check(len(top.seq) >= INFER_LEN_THRESHOLD, f"{fasta}: longest contig "
          f"{len(top.seq)}")
    return {"num_contigs": len(contigs), "longest_contig": len(top.seq),
            "exact_substring": exact, "genome_len": len(genome)}


def phase_gfa_route():
    """The front of the main path, with the port alone: the phase-4
    genome's reads as a hifiasm and a raven GFA, ``cli build-graph`` on
    each (host) and ``cli infer`` on the card (8 K3 + 1 K6, an exact
    contig); ``cli run`` with a stub hifiasm (the FASTA of build-graph +
    infer, byte for byte); ``cli build-graph --training`` then one ``cli
    train --overfit`` epoch on the card (8/8/8/8/1/1 K7/K3/K8/A/K6/K9 per
    unit); the host-timing build at the golden graph's node count in a
    process of its own (stage seconds, peak RSS).  Counters are set to 0
    just before each card path.  Returns those paths' launches."""
    import numpy as np

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K

    t_phase = time.perf_counter()
    root = os.path.join(WORK, "gfa_route")
    shutil.rmtree(root, ignore_errors=True)
    threads = str(min(8, os.cpu_count() or 1))
    decode = ["--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}"]
    fwd = expected_launches(k3_edge_stage=8, k6_score_gate=1)
    paths, builds, infers, gfas = {}, {}, {}, {}
    for dialect in GFA_DIALECTS:
        gfas[dialect] = write_reads_gfa(os.path.join(root, "gfa"), dialect)
        gfa, reads, genome = gfas[dialect]
        ds = os.path.join(root, f"ds_{dialect}")
        t0 = time.perf_counter()
        r = cli.main(["build-graph", "--gfa", gfa, "--reads", reads,
                      "--asm", dialect, "--out", ds, "--threads", threads])
        builds[dialect] = {"wall_s": time.perf_counter() - t0,
                           "stages_s": r["timing"]}
        savedir = os.path.join(ds, dialect)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli.main(["infer", "--data", ds, "--asm", dialect,
                            "--out", savedir, "--model", WEIGHTS, *decode])
        wall_s = time.perf_counter() - t0
        counts = K.launch_counts()
        check(summary["device"].startswith("cuda"), "infer ran on the card")
        check(counts == fwd, f"gfa {dialect} infer launches {counts}")
        paths[f"infer_gfa_{dialect}"] = counts
        infers[dialect] = {
            "wall_s": wall_s, "timing_s": summary["timing"],
            **exact_top_contig(os.path.join(savedir, "assembly",
                                            "0_assembly.fasta"), genome)}
    with np.load(os.path.join(root, "ds_hifiasm", "hifiasm", "processed",
                              "0.npz")) as g:
        graph = {"nodes": int(g["read_length"].shape[0]),
                 "edges": int(g["src"].shape[0])}

    # cli run: stub hifiasm -> build-graph -> infer
    gfa, reads, genome = gfas["hifiasm"]
    tools = os.path.join(root, "tools")
    os.makedirs(tools)
    stub = os.path.join(tools, "hifiasm")
    with open(stub, "w") as f:
        f.write(STUB_HIFIASM.format(gfa=gfa))
    os.chmod(stub, 0o755)
    out = os.path.join(root, "run")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cli.main(["run", "-r", reads, "-o", out, "-t", threads, "-m", WEIGHTS,
              "--set", f"paths.hifiasm_dir={tools}", *decode])
    run_s = time.perf_counter() - t0
    counts = K.launch_counts()
    check(counts == fwd, f"cli run launches {counts}")
    paths["run"] = counts
    fasta = os.path.join("hifiasm", "assembly", "0_assembly.fasta")
    with open(os.path.join(out, fasta), "rb") as a, open(
            os.path.join(root, "ds_hifiasm", fasta), "rb") as b:
        same = a.read() == b.read()
    check(same, "cli run: the FASTA of build-graph + infer, byte for byte")

    # build-graph --training, then one overfit epoch on the card
    ds = os.path.join(root, "ds_train")
    cli.main(["build-graph", "--gfa", gfa, "--reads", reads, "--asm",
              "hifiasm", "--out", ds, "--threads", threads, "--training"])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    best = cli.main(["train", "--train", ds, "--valid", ds, "--asm",
                     "hifiasm", "--name", "gfa", "--overfit",
                     "--set", "train.num_epochs=1",
                     "--set", f"paths.checkpoints_path={root}/ckpt",
                     "--set", f"paths.models_path={root}/models"])
    train_s = time.perf_counter() - t0
    counts = K.launch_counts()
    units = counts["k9_aggregate"]
    check(units >= 1 and counts["k7_gate_stats"] == 8 * units
          and counts["k8_train_layer_bwd"] == 8 * units
          == counts["bn_edge_adjoint"],
          f"gfa train launches {counts}")
    check(counts == expected_launches(**{k: units * n for k, n in
                                         TRAIN_STEP_LAUNCHES.items()}),
          f"gfa train launches: {units} units of {TRAIN_STEP_LAUNCHES}, "
          f"got {counts}")
    with open(os.path.join(root, "ckpt", "log_gfa_seed1.jsonl")) as f:
        log = [json.loads(line) for line in f]
    check(len(log) == 1 and np.isfinite(log[0]["train/loss"]),
          "gfa train: one epoch (--overfit: no validation), a finite loss")
    check(os.path.isfile(best), "gfa train: best model saved")
    paths["train_gfa"] = counts

    # the host-timing build, at the golden graph's node count
    big = os.path.join(root, "timing")
    os.makedirs(big)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TIMING_BUILD, json.dumps(GFA_TIMING_BUILD),
         big, threads], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    check(proc.returncode == 0, f"timing build failed: {proc.stderr[-2000:]}")
    timing = json.loads(proc.stdout.strip().splitlines()[-1])
    timing["process_s"] = time.perf_counter() - t0
    with np.load(os.path.join(big, "ds", "hifiasm", "processed",
                              "0.npz")) as g:
        timing["nodes"] = int(g["read_length"].shape[0])
        timing["edges"] = int(g["src"].shape[0])
        labelled = "y" in g.files
    check(timing["nodes"] == 2 * GFA_TIMING_BUILD["n_reads"] and labelled,
          f"timing build: {timing['nodes']} nodes with labels")
    emit("gfa_route", nvidia_smi=nvidia_smi(), threads=int(threads),
         dataset={k: v for k, v in INFER_GRAPH.items()}, graph=graph,
         build_graph=builds, infer=infers,
         run={"wall_s": run_s, "same_fasta": same},
         train={"wall_s": train_s, "units": units, "log": log[0]},
         timing_build={"spec": GFA_TIMING_BUILD, **timing},
         launches=paths, phase_s=time.perf_counter() - t_phase)
    return paths


def _step_result(model, loss, logits):
    return {"loss": loss.detach().clone(), "logits": logits.detach().clone(),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.detach().clone()
                        for n, b in model.named_buffers()}}


def train_step_checks(dev, cfg, new_model, want: dict, what: str,
                      dual_vs_pair: bool = False, want_bf16=None) -> dict:
    """Full-width training steps of the model ``new_model(device)`` builds
    for ``cfg``: one step on the card against the port's CPU step on the
    golden subgraph (dropout 0; loss, every gradient, the buffers); with
    ``dual_vs_pair`` the same card step (``forward_dual``) against the
    symmetry loss of ``forward_pair`` on the card.  On the whole golden
    graph as one unit (dropout 0.2): two steps from one state bitwise
    equal, exactly the launches ``want`` per step, of them exactly
    ``want_bf16`` (by default none) in their bf16 instantiation, no host
    synchronisation inside a step, the step time and peak memory.  Returns
    a summary."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.train.loss import symmetry_loss
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    golden = AssemblyGraph.load(GOLDEN)

    def example(graph, device):
        (unit,) = host_units(graph, cfg, np.random.default_rng(0))
        return make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                            unit.src, unit.dst, unit.n_nodes, device,
                            cfg.model)

    def one_step(graph, device, seed):
        ex = example(graph, device)
        model = new_model(device)
        opt = make_optimizer(model, cfg.train.lr)
        gen = torch.Generator(device=device).manual_seed(seed)
        loss, logits = train_step(model, opt, ex, 4.0, cfg, gen)
        return _step_result(model, loss, logits), (model, opt, ex, gen)

    def pair_step(graph, device):
        """The symmetry loss of the two sequential passes, backward."""
        ex = example(graph, device)
        model = new_model(device).train()
        lo, lr = model.forward_pair(ex.g, ex.x, ex.x_rev, ex.e, None,
                                    slot_io=True)
        loss = symmetry_loss(lo[:, 0], lr[:, 0], ex.labels, 4.0,
                             alpha=cfg.train.alpha)
        loss.backward()
        return _step_result(model, loss, lo[:, 0])

    def compare_bf16(got, ref, against: str) -> dict:
        """``got`` (card) vs ``ref`` in bf16: the loss, every gradient
        flattened into one vector, the buffers (BF16_* bounds)."""
        loss_r, loss_g = float(ref["loss"]), float(got["loss"])
        check(abs(loss_g - loss_r) < BF16_LOSS_REL * abs(loss_r),
              f"{what}: step loss {loss_g} vs {against} {loss_r}")
        names = list(ref["grads"])
        g = torch.cat([got["grads"][n].cpu().double().ravel() for n in names])
        r = torch.cat([ref["grads"][n].cpu().double().ravel() for n in names])
        rms = float(r.square().mean().sqrt()) + 1e-8
        elem = float(((g - r).abs() / r.abs().clamp_min(rms)).max())
        cos = float((g * r).sum() / (g.norm() * r.norm() + 1e-12))
        check(bool(torch.isfinite(g).all()) and cos > BF16_GRAD_COS
              and elem < BF16_GRAD_ELEM,
              f"{what}: gradients vs {against}: cosine {cos}, element {elem}")
        for name, r_ in ref["buffers"].items():
            r_, b_ = r_.cpu(), got["buffers"][name].cpu()
            ok = (bool(((b_ - r_).abs() <= BF16_STATE_ATOL
                        + BF16_STATE_RTOL * r_.abs()).all())
                  if r_.dtype.is_floating_point else torch.equal(b_, r_))
            check(ok, f"{what}: buffer {name} card vs {against}")
        return {"loss": loss_g, f"loss_{against}": loss_r,
                "grad_cosine": cos, "grad_max_element_error": elem}

    def compare(got, ref, against: str, logits: bool = False) -> dict:
        """``got`` (card) vs ``ref``: loss, gradients, buffers (and
        logits); returns the gradient differences."""
        if cfg.compute.dtype == "bfloat16":
            return compare_bf16(got, ref, against)
        loss_r, loss_g = float(ref["loss"]), float(got["loss"])
        check(abs(loss_g - loss_r) <= STEP_LOSS_RTOL * abs(loss_r),
              f"{what}: step loss {loss_g} vs {against} {loss_r}")
        grad_diff, grad_max, bad = {}, {}, []
        for name, r in ref["grads"].items():
            r = r.cpu()
            delta = (got["grads"][name].cpu() - r).abs()
            grad_diff[name] = float(delta.max())
            grad_max[name] = float(r.abs().max())
            if not bool((delta <= STEP_GRAD_ATOL
                         + STEP_GRAD_RTOL * r.abs()).all()):
                bad.append(name)
        for name, r in ref["buffers"].items():
            r, b_ = r.cpu(), got["buffers"][name].cpu()
            if r.dtype.is_floating_point:
                ok = bool(((b_ - r).abs() <= STEP_STATE_ATOL
                           + STEP_STATE_RTOL * r.abs()).all())
            else:
                ok = torch.equal(b_, r)
            check(ok, f"{what}: buffer {name} card vs {against}")
        check(not bad, f"{what}: gradients card vs {against} outside "
                       f"tolerance: {bad} "
                       f"{[(grad_diff[n], grad_max[n]) for n in bad]}")
        if logits:
            dlo = (got["logits"].cpu() - ref["logits"].cpu()).abs()
            check(bool((dlo <= LOGIT_ATOL + LOGIT_RTOL
                        * ref["logits"].cpu().abs()).all()),
                  f"{what}: logits vs {against} (max {float(dlo.max())})")
        worst = max(grad_diff, key=grad_diff.get)
        return {"loss": loss_g, f"loss_{against}": loss_r,
                "max_grad_diff": {"tensor": worst, "abs": grad_diff[worst],
                                  "tensor_max_abs": grad_max[worst]}}

    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9         # one unit per graph
    cfg.model.dropout = 0.0                            # card vs CPU
    sub = golden_subgraph(golden)
    t0 = time.perf_counter()
    ref, _ = one_step(sub, torch.device("cpu"), 0)
    cpu_s = time.perf_counter() - t0
    got, _ = one_step(sub, dev, 0)
    out = {"subgraph": {"nodes": sub.num_nodes, "edges": sub.num_edges},
           "vs_cpu": compare(got, ref, "cpu"), "cpu_step_s": cpu_s}
    if dual_vs_pair:
        out["dual_vs_pair_on_card"] = compare(got, pair_step(sub, dev),
                                              "pair", logits=True)

    # the whole golden graph as one unit, default dropout 0.2
    cfg.model.dropout = 0.2
    K.reset_launch_counts()
    a, (model, opt, ex, gen) = one_step(golden, dev, 5)
    per_step = K.launch_counts()
    per_step_bf16 = K.launch_counts(torch.bfloat16)
    b, _ = one_step(golden, dev, 5)
    check(per_step == want, f"{what}: launches per step {per_step}")
    check(per_step_bf16 == (want_bf16 or expected_launches()),
          f"{what}: bf16 launches per step {per_step_bf16}")
    for key in ("loss", "logits"):
        check(torch.equal(a[key], b[key]),
              f"{what}: two card steps: {key} bitwise")
    for key in ("grads", "params", "buffers"):
        check(all(torch.equal(a[key][n], b[key][n]) for n in a[key]),
              f"{what}: two card steps: {key} bitwise")
    check(bool(torch.isfinite(a["logits"]).all())
          and a["logits"].shape == (golden.num_edges,),
          f"{what}: finite logits of shape [E]")
    # the step never waits for the device: an operation that would
    # synchronise with the host raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(model, opt, ex, 4.0, cfg, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: train_step(model, opt, ex, 4.0, cfg, gen),
                      reps=5, n=3, warmup=2)
    out.update(graph={"nodes": golden.num_nodes, "edges": golden.num_edges},
               launches_per_step=per_step,
               launches_per_step_bf16=per_step_bf16, bitwise_reproducible=True,
               host_synchronisations_in_step=0, step_ms=step_ms,
               max_memory_allocated_mb=torch.cuda.max_memory_allocated(dev)
               / 2**20)
    return out


def phase_train_step(dev, normalization: str = "batch",
                     dtype: str = "float32", f32=None):
    """Full-width SymGatedGCN training steps (``train_step_checks``), from
    the shipped weights (batch norm: the dual pass, in float32 also held
    against the two sequential passes on the card) or seeded init weights
    (layer norm, none), at compute dtype ``dtype`` (in bf16 every launch
    of the batch-norm step is bf16, those of the other models as
    UNFUSED_STEP_BF16 says); with ``f32`` (this phase's float32 summary)
    the step time and memory are emitted beside float32's."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import SymGatedGCN, load_model_weights

    cfg = Config()
    cfg.model.normalization = normalization
    cfg.compute.dtype = dtype
    bf16 = dtype == "bfloat16"
    if normalization == "batch":
        params, state = load_model_weights(WEIGHTS)
        weights = os.path.relpath(WEIGHTS, ROOT)
        want = expected_launches(**TRAIN_STEP_LAUNCHES)
        want_bf16 = want if bf16 else None

        def new_model(device):
            return load_model(params, state, cfg, device)
    else:
        weights = f"init_weights({UNFUSED_INIT_SEED})"
        want = expected_launches(**(UNFUSED_STEP_ALL_BF16[normalization]
                                    if bf16 else UNFUSED_STEP_LAUNCHES))
        want_bf16 = (expected_launches(**UNFUSED_STEP_BF16[normalization])
                     if bf16 else None)

        def new_model(device):
            model = SymGatedGCN.from_config(cfg.model)
            return model.init_weights(UNFUSED_INIT_SEED).to(device)

    out = train_step_checks(dev, cfg, new_model, want,
                            f"{normalization} {dtype}",
                            dual_vs_pair=normalization == "batch" and not bf16,
                            want_bf16=want_bf16)
    if f32 is not None:
        out["float32"] = {k: f32[k] for k in ("step_ms",
                                              "max_memory_allocated_mb")}
    tol = ({"loss_rel": BF16_LOSS_REL, "grad_cosine": BF16_GRAD_COS,
            "grad_element": BF16_GRAD_ELEM, "state_atol": BF16_STATE_ATOL,
            "state_rtol": BF16_STATE_RTOL} if bf16 else
           {"loss_rtol": STEP_LOSS_RTOL, "grad_atol": STEP_GRAD_ATOL,
            "grad_rtol": STEP_GRAD_RTOL, "state_atol": STEP_STATE_ATOL,
            "state_rtol": STEP_STATE_RTOL, "logit_atol": LOGIT_ATOL,
            "logit_rtol": LOGIT_RTOL})
    name = ("train_step" if normalization == "batch"
            else f"train_step_{normalization}")
    emit(f"{name}_bf16" if bf16 else name, weights=weights, dtype=dtype,
         **out, tolerance=tol)
    return out


def phase_zoo(dev):
    """The model zoo on the golden graph at full width (d = 64, 8 layers,
    3 GAT heads, seeded init weights): GatedGCN, GCN, GAT and SAGE
    directed and GatedGCN undirected.  Each: the eval forward card vs CPU
    (bitwise across card runs, exact launches), and ``train_step_checks``
    (plain BCE)."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.models import get_model

    graph = AssemblyGraph.load(GOLDEN)
    out = {}
    for name, directed in ZOO_MODELS:
        cfg = Config()
        cfg.model.model = name
        cfg.model.directed = directed

        def new_model(device, cfg=cfg):
            return get_model(cfg.model).init_weights(ZOO_INIT_SEED).to(device)

        what = f"{name} {'directed' if directed else 'undirected'}"
        _, _, fwd = card_vs_cpu_forward(
            graph, new_model, dev, {"k2_side_sum": ZOO_FORWARD_SIDE_SUMS[name]},
            what, cfg.model)
        step = train_step_checks(dev, cfg, new_model, expected_launches(
            k2_side_sum=ZOO_STEP_SIDE_SUMS[name], k2_aggregate=1), what)
        out[what.replace(" ", "_")] = {"forward": fwd, "train_step": step}
    emit("zoo", graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=f"init_weights({ZOO_INIT_SEED})", d=64, layers=8,
         gat_num_heads=3, **out,
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL,
                    "loss_rtol": STEP_LOSS_RTOL,
                    "grad_atol": STEP_GRAD_ATOL, "grad_rtol": STEP_GRAD_RTOL})


def phase_cli_zoo():
    """A zoo model's paths: ``cli train --set model.model=gcn`` on phase 5's
    synthetic dataset, then ``cli infer`` with the model it saved, each on
    the card with the counters set to 0 just before it."""
    import numpy as np

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.train.metrics import get_aps
    from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

    root = os.path.join(WORK, "zoo")
    shutil.rmtree(root, ignore_errors=True)
    ds, genome = make_infer_dataset(os.path.join(root, "ds"))
    gcn = ["--set", "model.model=gcn"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    model_path = cli.main(["train", "--train", ds, "--valid", ds, "--asm",
                           "hifiasm", "--name", "gcn", *gcn,
                           "--set", "train.num_epochs=2",
                           "--set", f"paths.checkpoints_path={root}/ckpt",
                           "--set", f"paths.models_path={root}/models"])
    train_s = time.perf_counter() - t0
    train_counts = K.launch_counts()
    # U training units (16 side sums and one K2 each), V validation units
    # (8 side sums each)
    units = train_counts["k2_aggregate"]
    v_units = (train_counts["k2_side_sum"] - 16 * units) // 8
    check(units > 0 and v_units > 0 and train_counts == expected_launches(
        k2_side_sum=16 * units + 8 * v_units, k2_aggregate=units),
        f"gcn training launches {train_counts}")
    with open(os.path.join(root, "ckpt", "log_gcn_seed1.jsonl")) as f:
        log = [json.loads(line) for line in f]
    check(len(log) == 2 and all(np.isfinite(r["train/loss"]) for r in log),
          "gcn: two epochs logged, finite losses")

    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", model_path, *gcn,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}"])
    wall_s = time.perf_counter() - t0
    infer_counts = K.launch_counts()
    check(summary["device"].startswith("cuda"), "gcn infer ran on the card")
    check(infer_counts == expected_launches(
        k2_side_sum=ZOO_FORWARD_SIDE_SUMS["gcn"]),
        f"gcn eval-path launches {infer_counts}")
    logits = np.load(os.path.join(savedir, "decode", "0_predicts.npy"))
    graph = AssemblyGraph.load(os.path.join(ds, "hifiasm", "processed",
                                            "0.npz"))
    check(bool(np.isfinite(logits).all())
          and logits.shape == (graph.num_edges,), "gcn: finite logits [E]")
    contigs = list(read_fastx(os.path.join(savedir, "assembly",
                                           "0_assembly.fasta")))
    top = max(contigs, key=lambda c: len(c.seq), default=None)
    emit("cli_zoo", model="gcn", train_wall_s=train_s, log=log,
         train_launches=train_counts,
         units={"train": units, "valid": v_units},
         infer={"wall_s": wall_s, "timing_s": summary["timing"],
                "launches": infer_counts,
                "average_precision": get_aps(logits, graph.y),
                "num_contigs": len(contigs),
                "longest_contig": len(top.seq) if top else 0,
                "exact_substring": bool(top) and (
                    top.seq in genome
                    or top.seq in reverse_complement(genome))})
    return train_counts, infer_counts


def phase_train():
    """The training path: ``cli train`` on the card, counters from 0."""
    import numpy as np

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import kernels as K

    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    golden = AssemblyGraph.load(GOLDEN)
    ds = write_dataset(os.path.join(root, "golden"), golden)
    paths = ["--set", f"paths.checkpoints_path={root}/ckpt",
             "--set", f"paths.models_path={root}/models"]
    common = ["train", "--train", ds, "--valid", ds, "--asm", "hifiasm",
              "--name", "golden", *paths]

    def log_of(name):
        with open(os.path.join(root, "ckpt", f"log_{name}_seed1.jsonl")) as f:
            return [json.loads(line) for line in f]

    K.reset_launch_counts()
    t0 = time.perf_counter()
    model_path = cli.main([*common, "--set", "train.num_epochs=1"])
    wall_s = time.perf_counter() - t0
    counts = K.launch_counts()
    # U training units (8 K7, 8 K3, 8 K8, 8 edge adjoints, 1 K6, 1 K9
    # each) and V validation units (8 K3, 1 K6 each: the eval step's dual
    # pass too)
    units = counts["k9_aggregate"]
    check(units > 1 and counts["k7_gate_stats"] == 8 * units
          and counts["k8_train_layer_bwd"] == 8 * units
          == counts["bn_edge_adjoint"],
          f"training launches {counts}")
    v_units = (counts["k3_edge_stage"] - 8 * units) // 8
    check(v_units > 1 and counts["k3_edge_stage"] == 8 * (units + v_units)
          and counts["k6_score_gate"] == units + v_units,
          f"validation launches {counts}")
    log = log_of("golden")
    check([r["epoch"] for r in log] == [0], "one epoch logged")
    check(all(np.isfinite(log[0][k]) for k in ("train/loss", "valid/loss")),
          "finite losses")
    check(os.path.isfile(model_path), "best model saved")

    ckpt = os.path.join(root, "ckpt")
    resumed = []
    for i in range(2):
        cli.main([*common, "--resume", "--set", "train.num_epochs=2"])
        dst = os.path.join(ckpt, f"resumed_{i}.npz")
        os.replace(os.path.join(ckpt, "ckpt_golden_seed1_resumed-2.npz"), dst)
        resumed.append(dst)
    with np.load(resumed[0]) as a, np.load(resumed[1]) as b:
        same = a.files == b.files and all(np.array_equal(a[k], b[k])
                                          for k in a.files)
        n_arrays = len(a.files)
    check(same, "two resumes from one checkpoint bitwise equal")

    _, overfit, _ = overfit_run(root)
    emit("train", graph={"nodes": golden.num_nodes,
                         "edges": golden.num_edges},
         epoch_wall_s=wall_s, units={"train": units, "valid": v_units},
         launches=counts, log=log[0], resume_checkpoint_arrays=n_arrays,
         resume_bitwise_identical=True, overfit=overfit,
         tolerance={"loss_drop": OVERFIT_LOSS_DROP, "min_ap": OVERFIT_MIN_AP})
    return counts


def overfit_run(root: str, normalization: str = "batch",
                dtype: str = "float32"):
    """``cli train --overfit`` on the small synthetic dataset (12 epochs, lr
    1e-3, compute dtype ``dtype``) under ``root``, which must learn: the
    last loss under OVERFIT_LOSS_DROP times the first, the saved model's AP
    (scored at ``dtype``) above OVERFIT_MIN_AP.  Returns (best-model path,
    summary (with the bf16 launch counts read just after ``cli train``),
    the launch counts read just after ``cli train``)."""
    import torch

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.infer import score_graph
    from gnnome_tpu_torch.models import load_model_weights
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.train.metrics import get_aps

    g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
    small = write_dataset(os.path.join(root, "small"), g, reads)
    name = "overfit" if normalization == "batch" else f"overfit_{normalization}"
    name += "_bf16" if dtype == "bfloat16" else ""
    t0 = time.perf_counter()
    best = cli.main(["train", "--train", small, "--valid", small, "--asm",
                     "hifiasm", "--name", name, "--overfit",
                     "--set", f"paths.checkpoints_path={root}/ckpt",
                     "--set", f"paths.models_path={root}/models",
                     "--set", "train.num_epochs=12", "--set", "train.lr=1e-3",
                     "--set", "train.masking=false",
                     "--set", "train.num_nodes_per_cluster=10000",
                     "--set", f"model.normalization={normalization}",
                     "--set", f"compute.dtype={dtype}"])
    counts = K.launch_counts()
    counts_bf16 = K.launch_counts(torch.bfloat16)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(root, "ckpt", f"log_{name}_seed1.jsonl")) as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    check(losses[-1] < OVERFIT_LOSS_DROP * losses[0],
          f"{name} loss {losses[0]} -> {losses[-1]}")
    cfg = Config()
    cfg.model.normalization = normalization
    cfg.compute.dtype = dtype
    ap = get_aps(score_graph(g, *load_model_weights(best), cfg), g.y)
    check(ap > OVERFIT_MIN_AP, f"{name} AP {ap}")
    return best, {"graph": dict(OVERFIT_GRAPH), "nodes": g.num_nodes,
                  "edges": g.num_edges, "dtype": dtype, "losses": losses,
                  "ap": ap, "wall_s": wall_s,
                  "launches_bf16": counts_bf16}, counts


def phase_cli_bf16():
    """The bf16 paths of the batch-norm model, each on the card with the
    counters set to 0 just before it: ``cli infer --set compute.dtype=
    bfloat16`` with the shipped weights on phase 5's synthetic dataset
    (exact contig, 8 K3 + 1 K6), then a bf16 overfit run (``cli train
    --overfit``, 12 epochs of 8/8/8/8/1/1 K7/K3/K8/A/K6/K9), which must
    learn as phase 7's run must."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K

    root = os.path.join(WORK, "bf16")
    shutil.rmtree(root, ignore_errors=True)
    ds, genome = make_infer_dataset(os.path.join(root, "ds"))
    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", WEIGHTS,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                        "--set", "compute.dtype=bfloat16"])
    wall_s = time.perf_counter() - t0
    infer_counts = K.launch_counts()
    check(summary["device"].startswith("cuda"), "bf16 infer ran on the card")
    check(infer_counts == expected_launches(k3_edge_stage=8, k6_score_gate=1),
          f"bf16 eval-path launches {infer_counts}")
    contig = exact_top_contig(
        os.path.join(savedir, "assembly", "0_assembly.fasta"), genome)

    K.reset_launch_counts()
    _, overfit, train_counts = overfit_run(root, dtype="bfloat16")
    check(train_counts == expected_launches(**{
        k: 12 * n for k, n in TRAIN_STEP_LAUNCHES.items()})
        == overfit["launches_bf16"],
        f"bf16 training launches {train_counts}, of them bf16 "
        f"{overfit['launches_bf16']}")
    emit("cli_bf16", overfit=overfit, train_launches=train_counts,
         infer={"wall_s": wall_s, "timing_s": summary["timing"], **contig,
                "launches": infer_counts},
         tolerance={"loss_drop": OVERFIT_LOSS_DROP, "min_ap": OVERFIT_MIN_AP})
    return train_counts, infer_counts


def phase_cli_unfused_bf16():
    """The norm-free model's bf16 paths, each on the card with the counters
    set to 0 just before it: ``cli train --set model.normalization=none
    --set compute.dtype=bfloat16`` on the overfit dataset (12 epochs, lr
    1e-3, every K1 and K2 in bf16), which must learn as phase 7's run
    must, then ``cli infer`` with the model it saved on phase 5's dataset
    (8 bf16 K1 and 8 bf16 K2), whose longest contig must be an exact
    substring of the genome.  Returns the bf16 launch counts of the two
    paths."""
    import torch

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K

    root = os.path.join(WORK, "none_bf16")
    shutil.rmtree(root, ignore_errors=True)
    K.reset_launch_counts()
    best, overfit, train_counts = overfit_run(root, "none", "bfloat16")
    want = expected_launches(**{k: 12 * n for k, n
                                in K1K2_STEP_LAUNCHES.items()})
    check(train_counts == want == overfit["launches_bf16"],
          f"none bf16 training launches {train_counts}, of them bf16 "
          f"{overfit['launches_bf16']}")

    ds, genome = make_infer_dataset(os.path.join(root, "ds"))
    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", best,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                        "--set", "model.normalization=none",
                        "--set", "compute.dtype=bfloat16"])
    wall_s = time.perf_counter() - t0
    infer_counts = K.launch_counts()
    infer_bf16 = K.launch_counts(torch.bfloat16)
    check(summary["device"].startswith("cuda"), "infer ran on the card")
    check(infer_counts == expected_launches(**K1K2_FORWARD_LAUNCHES)
          == infer_bf16,
          f"none bf16 eval-path launches {infer_counts}, of them bf16 "
          f"{infer_bf16}")
    contig = exact_top_contig(
        os.path.join(savedir, "assembly", "0_assembly.fasta"), genome)
    emit("cli_unfused_bf16", normalization="none", dtype="bfloat16",
         overfit=overfit, train_launches=train_counts,
         infer={"wall_s": wall_s, "timing_s": summary["timing"], **contig,
                "launches": infer_counts, "launches_bf16": infer_bf16},
         tolerance={"loss_drop": OVERFIT_LOSS_DROP, "min_ap": OVERFIT_MIN_AP})
    return overfit["launches_bf16"], infer_bf16


def phase_cli_layer():
    """The layer-norm model's paths: ``cli train`` (overfit run) and ``cli
    infer`` with the model it saved, on the card, counters from 0 before
    each.  Returns their launches and the model, dataset and FASTA of the
    ``cli infer`` run."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K

    root = os.path.join(WORK, "layer")
    shutil.rmtree(root, ignore_errors=True)
    K.reset_launch_counts()
    best, overfit, train_counts = overfit_run(root, "layer")
    # 12 epochs of one unit, no validation (--overfit)
    check(train_counts == expected_launches(**{
        k: 12 * n for k, n in UNFUSED_STEP_LAUNCHES.items()}),
        f"layer-norm training launches {train_counts}")

    ds, genome = make_infer_dataset(os.path.join(root, "ds"))
    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", best,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                        "--set", "model.normalization=layer"])
    wall_s = time.perf_counter() - t0
    infer_counts = K.launch_counts()
    check(summary["device"].startswith("cuda"), "infer ran on the card")
    check(infer_counts == expected_launches(**UNFUSED_FORWARD_LAUNCHES),
          f"layer-norm eval-path launches {infer_counts}")
    contig = exact_top_contig(
        os.path.join(savedir, "assembly", "0_assembly.fasta"), genome)
    emit("cli_layer", overfit=overfit, train_launches=train_counts,
         infer={"wall_s": wall_s, "timing_s": summary["timing"], **contig,
                "launches": infer_counts},
         tolerance={"loss_drop": OVERFIT_LOSS_DROP, "min_ap": OVERFIT_MIN_AP})
    return train_counts, infer_counts, {
        "model": best, "data": ds,
        "fasta": os.path.join(savedir, "assembly", "0_assembly.fasta")}


# ---------------------------------------------------------------- halo phase
# Halo-exchange graph parallelism (compute.mesh = P > 1): P ranks share the
# one card over gloo, their strips staged through host memory.  Graphs: the
# JAX bench's mesh graph (bench.py:426-432: random_bench_graph(65,536, 6.0),
# z-scored degrees, seeded edge features and labels), the golden graph
# (no banded plan: the overflow-uncapped route) and random_rc_bench_graph
# (1,048,576, 8.0).  Bounds, set before any card run: eval logits within
# LOGIT_ATOL + LOGIT_RTOL·|x| of the single-device card forward (node sums
# and statistics add in another order); a train step as the card-vs-CPU
# step (STEP_*), the BN running statistics within 1e-5 + 1e-4·|x|, in bf16
# the BF16_* bounds; the parameters after Adam bitwise equal on every rank;
# the golden AP within AP_TOL of the JAX figure; `cli train` with
# compute.mesh=2 logs the single-device epoch's losses within 1e-4
# relative, `cli infer` writes the single-device contigs.  Per rank: 8 K3
# and 1 K6 per eval forward, 16/16/16/16/2/2 K7/K3/K8/A/K6/K9 per train step
# (two directional passes).
HALO_BENCH = dict(num_nodes=65_536, avg_degree=6.0, seed=0)
HALO_BIG = dict(num_nodes=1_048_576, avg_degree=8.0, seed=0)
HALO_RANKS = (2, 4)
HALO_TRAIN_LOSS_RTOL = 1e-4
HALO_FORWARD_LAUNCHES = {"k3_edge_stage": 8, "k6_score_gate": 1}
HALO_STEP_LAUNCHES = {"k3_edge_stage": 16, "k6_score_gate": 2,
                      "k7_gate_stats": 16, "k8_train_layer_bwd": 16,
                      "bn_edge_adjoint": 16, "k9_aggregate": 2}
HALO_REPS, HALO_STEP_REPS = 3, 2


def unit_features(unit):
    """The z-scored (in, out) degree features of ``unit`` (make_example)."""
    import numpy as np

    from gnnome_tpu_torch.models.features import _zscore

    return np.stack([_zscore(unit.in_deg), _zscore(unit.out_deg)], axis=1)


def halo_cfg(dev, dtype: str = "float32"):
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.compute.device = str(dev)
    cfg.compute.dtype = dtype
    cfg.model.dropout = 0.0
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9
    return cfg


def single_forward(dev, params, state, src, dst, n_nodes, x, e, reps=0,
                   cfg=None):
    """The single-device eval forward's host-order logits on ``dev`` (and
    with ``reps`` its time) of the model ``cfg.model`` names (default the
    batch-norm SymGatedGCN), a zoo model on its processor graph."""
    import torch

    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models.zoo import processor_graph
    from gnnome_tpu_torch.ops import DeviceGraph

    cfg = cfg or halo_cfg(dev)
    model = load_model(params, state, cfg, dev)
    g = DeviceGraph.build(src, dst, n_nodes, dev)
    gp = processor_graph(cfg.model, src, dst, n_nodes, dev)
    args = (g, torch.as_tensor(x, device=dev), torch.as_tensor(e, device=dev))
    args += () if gp is None else (gp,)
    with torch.inference_mode():
        lo = model(*args)[:, 0].cpu().numpy()
        ms = cuda_ms(lambda: model(*args), reps=reps, n=1) if reps else None
    return lo, ms


def single_step(dev, params, state, unit, dtype="float32", reps=0):
    """One single-device train step (its dual-width pass) from the weights:
    loss, JAX-layout gradient, parameter and state pytrees, host-order
    logits (and with ``reps`` the time of further steps)."""
    import torch

    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models.convert import numpy_from_module_state
    from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                             train_step)

    cfg = halo_cfg(dev, dtype)
    model = load_model(params, state, cfg, dev)
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, dev)
    opt = make_optimizer(model, cfg.train.lr)
    loss, lo = train_step(model, opt, ex, 1.0, cfg, None)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    out = {"loss": float(loss),
           "logits": lo.cpu().numpy()[ex.g.slot_of_eid.cpu().numpy()],
           "grads": numpy_from_module_state({**sd, **grads})[0],
           "state": numpy_from_module_state(sd)[1]}
    if reps:
        out["step_ms"] = cuda_ms(
            lambda: train_step(model, opt, ex, 1.0, cfg, None), reps=reps,
            n=1)
    return out


def tree_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def halo_logits_close(got, ref, what: str) -> float:
    import numpy as np

    check(got is not None and got.shape == ref.shape
          and bool(np.isfinite(got).all()), f"{what}: finite logits [E]")
    d = np.abs(got - ref)
    check(bool((d <= LOGIT_ATOL + LOGIT_RTOL * np.abs(ref)).all()),
          f"{what}: logits vs the single-device card forward "
          f"(max {d.max()})")
    return float(d.max())


def halo_step_close(res, ref, what: str, bf16: bool = False) -> dict:
    """A halo train step (every rank's ``checks.train_step_job`` result)
    against the single-device step ``ref``."""
    import numpy as np

    out = res[0]
    check(all(r["loss"] == out["loss"] for r in res),
          f"{what}: one loss on every rank")
    p0 = tree_leaves(out["params"])
    check(all(all(np.array_equal(tree_leaves(r["params"])[k], p0[k])
                  for k in p0) for r in res[1:]),
          f"{what}: parameters after Adam bitwise equal on every rank")
    g = tree_leaves(out["grads"])
    r = tree_leaves(ref["grads"])
    s, rs = tree_leaves(out["state"]), tree_leaves(ref["state"])
    if bf16:
        check(abs(out["loss"] - ref["loss"]) < BF16_LOSS_REL
              * abs(ref["loss"]), f"{what}: loss {out['loss']} vs "
              f"{ref['loss']}")
        a = np.concatenate([np.ravel(g[k]) for k in r]).astype(np.float64)
        b = np.concatenate([np.ravel(r[k]) for k in r]).astype(np.float64)
        rms = float(np.sqrt((b ** 2).mean())) + 1e-8
        elem = float((np.abs(a - b) / np.maximum(np.abs(b), rms)).max())
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        check(cos > BF16_GRAD_COS and elem < BF16_GRAD_ELEM,
              f"{what}: gradients: cosine {cos}, element {elem}")
        check(all(bool((np.abs(s[k] - rs[k]) <= BF16_STATE_ATOL
                        + BF16_STATE_RTOL * np.abs(rs[k])).all())
                  for k in rs), f"{what}: BN running statistics")
        return {"loss": out["loss"], "loss_single": ref["loss"],
                "grad_cosine": cos, "grad_max_element_error": elem}
    check(abs(out["loss"] - ref["loss"]) <= STEP_LOSS_RTOL
          * abs(ref["loss"]), f"{what}: loss {out['loss']} vs {ref['loss']}")
    bad = [k for k in r if not bool((np.abs(g[k] - r[k]) <= STEP_GRAD_ATOL
                                     + STEP_GRAD_RTOL * np.abs(r[k])).all())]
    check(not bad, f"{what}: gradients outside tolerance: {bad}")
    check(all(bool((np.abs(s[k] - rs[k]) <= STEP_STATE_ATOL
                    + STEP_STATE_RTOL * np.abs(rs[k])).all()) for k in rs),
          f"{what}: BN running statistics")
    d_lo = halo_logits_close(out["logits"], ref["logits"], what)
    worst = max(r, key=lambda k: float(np.abs(g[k] - r[k]).max()))
    return {"loss": out["loss"], "loss_single": ref["loss"],
            "max_abs_logit_diff": d_lo,
            "max_grad_diff": {"tensor": worst,
                              "abs": float(np.abs(g[worst] - r[worst]).max())}}


def halo_launch_check(res, want: dict, what: str) -> list:
    counts = [r["launches"] for r in res]
    check(all(c == expected_launches(**want) for c in counts),
          f"{what}: launches per rank {counts}")
    return counts


def halo_shards(res) -> dict:
    """Route, K, R, every rank's extended rows and edges."""
    r0 = res[0]
    return {"route": r0["route"], "K": r0["K"], "R": r0["R"],
            "n_ext": [r["n_ext"] for r in res] if "n_ext" in r0 else None,
            "edges_per_rank": ([r["n_edges"] for r in res]
                               if "n_edges" in r0 else None)}


def halo_bytes_per_layer(plan, d: int) -> dict:
    """Bytes one rank puts on the wire per layer of the eval forward (the
    plan's strips and overflow rows: ``halo_extend`` sends d-wide float32
    rows, ``halo_return`` 2d-wide ones), the interior ranks' figure."""
    K, R = plan.K, plan.R
    p2p = 2 * K * (d + 2 * d) * 4
    return {"p2p": p2p, "collective": R * (d + 2 * d) * 4}


def few_pairs_checks(fwd, step, ref_lo, ref_step, what: str) -> dict:
    """The halo eval and step on a graph of fewer RC pairs than ranks
    against the single-device card runs: logits within 1e-4 + 1e-4 |x|,
    the step as ``halo_step_close`` holds it (parameters after Adam
    bitwise equal on every rank); a rank whose block holds no edge
    launches nothing, the others 8 K3 + 1 K6 per forward and
    16/16/16/16/2/2 K7/K3/K8/A/K6/K9 per step."""
    edges = [r["n_edges"] for r in fwd]
    check(0 in edges and sum(edges) == ref_lo.shape[0],
          f"{what} few pairs: edges per rank {edges}")
    check([r["n_edges"] for r in step] == edges,
          f"{what} few pairs: the step's shards")
    for res, want, kind in ((fwd, HALO_FORWARD_LAUNCHES, "eval"),
                            (step, HALO_STEP_LAUNCHES, "step")):
        got = [r["launches"] for r in res]
        check(got == [expected_launches(**want) if r["n_edges"]
                      else expected_launches() for r in res],
              f"{what} few pairs {kind}: launches per rank {got}")
    return {**halo_shards(fwd), "nodes": FEW_PAIRS_GRAPH["n_reads"] * 2,
            "edges": int(ref_lo.shape[0]),
            "eval_max_abs_logit_diff": halo_logits_close(
                fwd[0]["logits"], ref_lo, f"{what} few pairs eval"),
            "step": halo_step_close(step, ref_step, f"{what} few pairs step"),
            "eval_launches_per_rank": [r["launches"] for r in fwd],
            "step_launches_per_rank": [r["launches"] for r in step]}


def phase_halo(dev, p4_jobs=(), p2_jobs=()):
    """The halo path over ranks sharing the card: the bench mesh graph at
    P = 2 and 4 (eval, a float32 train step; a bf16 step too), the golden
    graph through the uncapped route (P = 2: eval, AP, a step), the
    1,048,576-node graph's eval, each P's checks in one spawn; then ``cli
    infer`` and ``cli train`` with compute.mesh=2 against their
    single-device runs.  ``p4_jobs`` join the group of 4 ranks, ``p2_jobs``
    that of 2.  Returns the halo paths' per-rank launches, for each of
    ``p4_jobs`` and of ``p2_jobs`` every rank's result, and the bench
    graph's single-device times and, per P, every
    rank's bytes, calls and times of its forward and step and its idle
    collectives' times (``phase_projection``'s inputs)."""
    import gc

    import numpy as np
    import torch

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.graphs.synthetic import (random_bench_graph,
                                                   random_rc_bench_graph)
    from gnnome_tpu_torch.models import (edge_features, load_model_weights,
                                         node_features)
    from gnnome_tpu_torch.parallel import checks
    from gnnome_tpu_torch.parallel.group import describe, spawn
    from gnnome_tpu_torch.parallel.halo import plan_graph
    from gnnome_tpu_torch.train.metrics import get_aps
    from gnnome_tpu_torch.train.step import host_units
    from gnnome_tpu_torch.utils.fastx import read_fastx

    t_phase = time.perf_counter()
    params, state = load_model_weights(WEIGHTS)
    d = params["gnn"]["A1"]["w"].shape[-1]
    bench = checks.bench_unit(*random_bench_graph(
        HALO_BENCH["num_nodes"], HALO_BENCH["avg_degree"],
        seed=HALO_BENCH["seed"]), HALO_BENCH["num_nodes"])
    big_g = random_rc_bench_graph(HALO_BIG["num_nodes"],
                                  HALO_BIG["avg_degree"],
                                  seed=HALO_BIG["seed"])
    big = checks.bench_unit(big_g.src, big_g.dst, big_g.num_nodes)
    golden = AssemblyGraph.load(GOLDEN)
    (golden_unit,) = host_units(golden, halo_cfg(dev),
                                np.random.default_rng(0))
    few_g, _, _, _ = synthetic_assembly_graph(**FEW_PAIRS_GRAPH)
    (few_unit,) = host_units(few_g, halo_cfg(dev), np.random.default_rng(0))
    few = (few_g.src, few_g.dst, few_g.num_nodes, node_features(few_g),
           edge_features(few_g))
    graphs = {"bench": (bench.src, bench.dst, bench.n_nodes,
                        unit_features(bench), bench.e_feat),
              "golden": (golden.src, golden.dst, golden.num_nodes,
                         node_features(golden), edge_features(golden)),
              "big": (big.src, big.dst, big.n_nodes, unit_features(big),
                      big.e_feat)}

    # the single-device references on the card (P = 1), then free the card
    t0 = time.perf_counter()
    ref_lo, p1 = {}, {}
    for name, arrays in graphs.items():
        ref_lo[name], ms = single_forward(dev, params, state, *arrays,
                                          reps=HALO_REPS if name != "golden"
                                          else 0)
        if ms is not None:
            p1[f"{name}_forward_ms"] = ms
    ref_lo["few"], _ = single_forward(dev, params, state, *few)
    ref_step = {"bench": single_step(dev, params, state, bench,
                                     reps=HALO_REPS),
                "few": single_step(dev, params, state, few_unit),
                "bench_bf16": single_step(dev, params, state, bench,
                                          "bfloat16"),
                "golden": single_step(dev, params, state, golden_unit)}
    p1["bench_step_ms"] = ref_step["bench"].get("step_ms")
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    cfg32, cfg16 = halo_cfg(dev), halo_cfg(dev, "bfloat16")
    emit("halo P=1", single_device=p1, reference_s=ref_s)
    few_paths, wire = {}, {}
    for P in HALO_RANKS:
        jobs = [(checks.score_job, (*graphs["bench"], params, state, cfg32,
                                    HALO_REPS)),
                (checks.train_step_job, (bench, params, state, cfg32, 1.0,
                                         HALO_STEP_REPS)),
                (checks.score_job, (*graphs["big"], params, state, cfg32,
                                    HALO_REPS)),
                (checks.collective_job, (d, 20))]
        names = ["bench_eval", "bench_step", "big_eval", "collectives"]
        if P == 2:
            jobs += [(checks.train_step_job, (bench, params, state, cfg16,
                                              1.0)),
                     (checks.score_job, (*graphs["golden"], params, state,
                                         cfg32)),
                     (checks.train_step_job, (golden_unit, params, state,
                                              cfg32, 1.0))]
            names += ["bench_step_bf16", "golden_eval", "golden_step"]
            jobs += list(p2_jobs)
            names += [f"p2_job{i}" for i in range(len(p2_jobs))]
        else:
            jobs += [(checks.score_job, (*few, params, state, cfg32)),
                     (checks.train_step_job, (few_unit, params, state,
                                              cfg32, 1.0))]
            names += ["few_pairs_eval", "few_pairs_step"]
            jobs += list(p4_jobs)
            names += [f"p4_job{i}" for i in range(len(p4_jobs))]
        t0 = time.perf_counter()
        res = spawn(checks.run_jobs, P, jobs, device=str(dev),
                    deadline_s=900)
        spawn_s = time.perf_counter() - t0
        by_job = list(zip(*res))        # per job, every rank's result
        what = f"halo P={P}"
        fwd, step, big_fwd, coll = by_job[:4]
        wire[P] = {"forward": [{k: r[k] for k in ("rank", "bytes", "calls",
                                                  "forward")} for r in fwd],
                   "step": [{k: r[k] for k in ("rank", "bytes", "calls",
                                               "step")} for r in step],
                   "collectives": [{k: r[k] for k in ("all_reduce",
                                                      "exchange")}
                                   for r in coll]}
        row = {"spawn_s": spawn_s,
               "job_s": {name: [r["job_s"] for r in res_j] for name, res_j
                         in zip(names, by_job)},
               "collective_ms_per_rank": [
                   {k: r[k] for k in ("all_reduce", "exchange",
                                      "all_reduce_host")} for r in coll],
               "gloo_all_reduce_cuda": coll[0].get("gloo_all_reduce_cuda")}
        row["bench"] = {
            **halo_shards(fwd),
            "bytes_per_layer": halo_bytes_per_layer(
                plan_graph(bench.src, bench.dst, bench.n_nodes, P)[0], d),
            "bytes_per_forward": [r["bytes"] for r in fwd],
            "eval_max_abs_logit_diff": halo_logits_close(
                fwd[0]["logits"], ref_lo["bench"], f"{what} bench eval"),
            "eval_launches_per_rank": halo_launch_check(
                fwd, HALO_FORWARD_LAUNCHES, f"{what} bench eval"),
            "step": halo_step_close(step, ref_step["bench"],
                                    f"{what} bench step"),
            "step_launches_per_rank": halo_launch_check(
                step, HALO_STEP_LAUNCHES, f"{what} bench step"),
            "forward_ms_per_rank": [r.get("forward") for r in fwd],
            "step_ms_per_rank": [r.get("step") for r in step]}
        row["big"] = {
            **halo_shards(big_fwd),
            "nodes": big.n_nodes, "edges": int(big.src.shape[0]),
            "eval_max_abs_logit_diff": halo_logits_close(
                big_fwd[0]["logits"], ref_lo["big"], f"{what} big eval"),
            "eval_launches_per_rank": halo_launch_check(
                big_fwd, HALO_FORWARD_LAUNCHES, f"{what} big eval"),
            "forward_ms_per_rank": [r.get("forward") for r in big_fwd]}
        if P == 2:
            step16, gfwd, gstep = by_job[4:7]
            p2_res = list(by_job[7:])
            check(gfwd[0]["route"] == "overflow-uncapped",
                  f"{what}: golden route {gfwd[0]['route']}")
            ap = get_aps(gfwd[0]["logits"], golden.y)
            check(abs(ap - JAX_GOLDEN_AP) < AP_TOL, f"{what}: golden AP {ap}")
            halo_launch_check(step16, HALO_STEP_LAUNCHES, f"{what} bf16")
            check(all(r["launches_bf16"] == r["launches"] for r in step16),
                  f"{what}: every bf16 step launch in bf16")
            row["bench"]["step_bf16"] = halo_step_close(
                step16, ref_step["bench_bf16"], f"{what} bench bf16 step",
                bf16=True)
            row["golden"] = {
                **halo_shards(gfwd), "ap": ap,
                "eval_max_abs_logit_diff": halo_logits_close(
                    gfwd[0]["logits"], ref_lo["golden"], f"{what} golden"),
                "step": halo_step_close(gstep, ref_step["golden"],
                                        f"{what} golden step"),
                "step_launches_per_rank": halo_launch_check(
                    gstep, HALO_STEP_LAUNCHES, f"{what} golden step")}
        else:
            ffwd, fstep = by_job[4:6]
            p4_res = list(by_job[6:])
            row["few_pairs"] = few_pairs_checks(ffwd, fstep, ref_lo["few"],
                                                ref_step["few"], what)
            for r, (a, b) in enumerate(zip(ffwd, fstep)):
                few_paths[f"infer_halo_few_rank{r}"] = a["launches"]
                few_paths[f"train_halo_few_rank{r}"] = b["launches"]
        emit(f"halo P={P}", transport=describe(str(dev), P), **row)
        del res, by_job

    # the entry points, compute.mesh=2, against their single-device runs
    root = os.path.join(WORK, "halo")
    shutil.rmtree(root, ignore_errors=True)
    ds, _ = make_infer_dataset(os.path.join(root, "infer"))
    fasta = {}
    for name, extra in (("one", []), ("mesh", ["--set", "compute.mesh=2"])):
        savedir = os.path.join(root, f"infer_{name}")
        summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                            "--out", savedir, "--model", WEIGHTS, "--set",
                            f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                            *extra])
        fasta[name] = [r.seq for r in read_fastx(
            os.path.join(savedir, "assembly", "0_assembly.fasta"))]
    check(fasta["mesh"] == fasta["one"],
          "cli infer compute.mesh=2: the single-device contigs")
    infer_launches = summary["rank_launches"]
    check(summary["ranks"] == 2 and all(
        c == expected_launches(**HALO_FORWARD_LAUNCHES)
        for c in infer_launches), f"cli infer launches {infer_launches}")

    g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
    small = write_dataset(os.path.join(root, "small"), g, reads)
    logs = {}
    for name, extra in (("one", []), ("mesh", ["--set", "compute.mesh=2"])):
        ck = os.path.join(root, f"ckpt_{name}")
        cli.main(["train", "--train", small, "--valid", small, "--asm",
                  "hifiasm", "--name", name, "--set", "train.num_epochs=1",
                  "--set", "model.dropout=0", "--set",
                  f"paths.checkpoints_path={ck}", "--set",
                  f"paths.models_path={root}/models_{name}", *extra])
        with open(os.path.join(ck, f"log_{name}_seed1.jsonl")) as f:
            logs[name] = [json.loads(line) for line in f]
        check(sorted(os.listdir(ck)) == [f"ckpt_{name}_seed1.npz",
                                         f"log_{name}_seed1.jsonl"],
              f"cli train {name}: one checkpoint, one log")
    (one,), (mesh,) = logs["one"], logs["mesh"]
    for k in ("train/loss", "valid/loss"):
        check(abs(mesh[k] - one[k]) <= HALO_TRAIN_LOSS_RTOL * abs(one[k]),
              f"cli train compute.mesh=2: {k} {mesh[k]} vs {one[k]}")
    train_launches = mesh["halo_launches"]
    units = train_launches[0]["k9_aggregate"] // 2
    check(units >= 1 and all(
        c["k7_gate_stats"] == 16 * units == c["k8_train_layer_bwd"]
        == c["bn_edge_adjoint"] and c["k3_edge_stage"] > 16 * units
        and c["k6_score_gate"] > 2 * units
        for c in train_launches), f"cli train launches {train_launches}")
    emit("halo", cli_infer={"contigs": len(fasta["mesh"]),
                            "launches_per_rank": infer_launches},
         cli_train={"loss": {k: [mesh[k], one[k]] for k in
                             ("train/loss", "valid/loss")},
                    "routes": mesh["halo_routes"],
                    "launches_per_rank": train_launches},
         phase_s=time.perf_counter() - t_phase)
    paths = {}
    for r, c in enumerate(infer_launches):
        paths[f"infer_halo_rank{r}"] = c
    for r, c in enumerate(train_launches):
        paths[f"train_halo_rank{r}"] = c
    return ({**paths, **few_paths}, p4_res, p2_res,
            {"single_device": p1, "ranks": wire})


# ------------------------------------------------------------- sharded phase
# The sharded path (compute.mesh = P > 1 inference for every model but the
# batch-norm SymGatedGCN, gnnome_tpu_torch/parallel/sharded.py): P ranks
# share the one card over gloo.  Graphs: the golden graph at P = 2 with the
# layer-norm and the norm-free SymGatedGCN and each zoo model (d = 64, 8
# layers, 3 GAT heads, init_weights(7)); the JAX bench's graph
# (random_bench_graph(262,144, 6.0), bench.py:183-184) at P = 2 with the
# layer-norm model; the 3-pair graph at P = 4 (one block empty) with the
# layer-norm model and GCN, in the halo phase's group of 4 ranks.  Bounds, set before any card run: logits within
# LOGIT_ATOL + LOGIT_RTOL·|x| of the single-device card forward; per rank
# and forward 8 K1 + 8 K2 (layer norm, none), 8 one-sided walks (GatedGCN,
# GCN, SAGE) or 16 (GAT), none on a rank whose shard holds no edge; `cli
# infer --set compute.mesh=2` with phase 8's layer-norm model on its
# dataset writes phase 8's FASTA byte for byte.  Recorded per rank, with no
# limit: forward ms, exchanges and collectives per forward, bytes per
# forward and per layer.
SHARDED_MODELS = {"layer": ("sym_gatedgcn", "layer", True),
                  "none": ("sym_gatedgcn", "none", True),
                  "gatedgcn": ("gatedgcn", "batch", True),
                  "gatedgcn_undirected": ("gatedgcn", "batch", False),
                  "gcn": ("gcn", "batch", True),
                  "gat": ("gat", "batch", True),
                  "sage": ("sage", "batch", True)}
SHARDED_BENCH = dict(num_nodes=262_144, avg_degree=6.0, seed=0)
SHARDED_FEW = ("layer", "gcn")
SHARDED_REPS = 3


def sharded_cfg(dev, mid: str):
    from gnnome_tpu_torch.config import Config

    name, norm, directed = SHARDED_MODELS[mid]
    cfg = Config()
    cfg.compute.device = str(dev)
    cfg.model.model = name
    cfg.model.normalization = norm
    cfg.model.directed = directed
    return cfg


def sharded_weights(mid: str):
    """Model ``mid``'s seeded init weights as numpy pytrees."""
    from gnnome_tpu_torch.models import get_model, pytrees_from_model

    model = get_model(sharded_cfg("cpu", mid).model)
    return pytrees_from_model(model.init_weights(ZOO_INIT_SEED))


def few_pairs_arrays():
    """The 3-pair graph's ``(src, dst, n_nodes, x, e)``."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.models import edge_features, node_features

    g, _, _, _ = synthetic_assembly_graph(**FEW_PAIRS_GRAPH)
    return g.src, g.dst, g.num_nodes, node_features(g), edge_features(g)


def sharded_few_jobs(dev) -> list:
    """The sharded forwards of the 3-pair graph (SHARDED_FEW), which run in
    the halo phase's group of 4 ranks (a spawn of 4 ranks on the shared
    card costs ~35 s) and are checked in the sharded phase."""
    from gnnome_tpu_torch.parallel import checks

    few = few_pairs_arrays()
    return [(checks.score_job, (*few, *sharded_weights(mid),
                                sharded_cfg(dev, mid)))
            for mid in SHARDED_FEW]


def sharded_launches(mid: str) -> dict:
    name = SHARDED_MODELS[mid][0]
    if name == "sym_gatedgcn":
        return K1K2_FORWARD_LAUNCHES
    return {"k2_side_sum": ZOO_FORWARD_SIDE_SUMS[name]}


def sharded_rank_rows(res, mid: str, d: int, what: str) -> list:
    """Every rank's record of a sharded forward (``checks.score_job``):
    its launches (checked: the model's per forward, none where its shard
    holds no edge), shard sizes, exchanges and collectives, bytes per
    forward and per layer (a layer extends d-wide float32 rows of the
    processor graph's plan; the SymGatedGCN also returns 2d-wide sums),
    forward times."""
    zoo = SHARDED_MODELS[mid][0] != "sym_gatedgcn"
    rows = []
    for r in res:
        p = r["proc"] or r
        want = sharded_launches(mid) if p["n_edges"] else {}
        check(r["launches"] == expected_launches(**want),
              f"{what} rank {r['rank']}: launches {r['launches']}")
        P = len(res)
        nbrs = (r["rank"] > 0) + (r["rank"] < P - 1)
        w = 4 * (d if zoo else 3 * d)
        rows.append({"rank": r["rank"], "n_ext": r["n_ext"],
                     "edges": r["n_edges"], "proc": r["proc"],
                     "launches": {k: n for k, n in r["launches"].items()
                                  if n},
                     "calls_per_forward": r["calls"],
                     "bytes_per_forward": r["bytes"],
                     "bytes_per_layer": {"p2p": nbrs * p["K"] * w,
                                         "collective": p["R"] * w},
                     "forward_ms": r.get("forward")})
    return rows


def phase_sharded(dev, layer_run: dict, few_res: list) -> dict:
    """The sharded path over ranks sharing the card: the golden graph at
    P = 2 with every model it runs and the bench graph at P = 2 (layer
    norm) in one spawn, and the 3-pair graph at P = 4 (layer norm, GCN;
    ``few_res``: every rank's result of each ``sharded_few_jobs`` job, run
    in the halo phase's group), against the single-device card forwards;
    then ``cli infer`` with compute.mesh=2 and phase 8's layer-norm model
    against phase 8's FASTA.  Returns the sharded paths' per-rank
    launches."""
    import gc

    import numpy as np
    import torch

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.graphs.synthetic import random_bench_graph
    from gnnome_tpu_torch.models import edge_features, node_features
    from gnnome_tpu_torch.parallel import checks
    from gnnome_tpu_torch.parallel.group import describe, spawn

    t_phase = time.perf_counter()
    golden = AssemblyGraph.load(GOLDEN)
    bench = checks.bench_unit(*random_bench_graph(
        SHARDED_BENCH["num_nodes"], SHARDED_BENCH["avg_degree"],
        seed=SHARDED_BENCH["seed"]), SHARDED_BENCH["num_nodes"])
    graphs = {"golden": (golden.src, golden.dst, golden.num_nodes,
                         node_features(golden), edge_features(golden)),
              "few": few_pairs_arrays(),
              "bench": (bench.src, bench.dst, bench.n_nodes,
                        unit_features(bench), bench.e_feat)}
    weights = {mid: sharded_weights(mid) for mid in SHARDED_MODELS}
    d = weights["layer"][0]["gnn"]["A1"]["w"].shape[-1]

    # the single-device references on the card (P = 1)
    t0 = time.perf_counter()
    cases = ([("golden", mid) for mid in SHARDED_MODELS]
             + [("bench", "layer")] + [("few", mid) for mid in SHARDED_FEW])
    ref, p1 = {}, {}
    for gname, mid in cases:
        ref[gname, mid], ms = single_forward(
            dev, *weights[mid], *graphs[gname],
            reps=SHARDED_REPS if gname != "few" else 0,
            cfg=sharded_cfg(dev, mid))
        if ms is not None:
            p1[f"{gname}_{mid}_forward_ms"] = ms
    gc.collect()
    torch.cuda.empty_cache()
    emit("sharded P=1", single_device=p1,
         reference_s=time.perf_counter() - t0)

    paths = {}
    two = [c for c in cases if c[0] != "few"]
    jobs = [(checks.score_job, (*graphs[gname], *weights[mid],
                                sharded_cfg(dev, mid), SHARDED_REPS))
            for gname, mid in two]
    t0 = time.perf_counter()
    res = spawn(checks.run_jobs, 2, jobs, device=str(dev), deadline_s=600)
    groups = {2: (two, list(zip(*res)), {"spawn_s": time.perf_counter() - t0}),
              4: ([("few", mid) for mid in SHARDED_FEW], few_res,
                  {"ran_in": "the halo phase's group of 4 ranks"})}
    del res
    for P, (jobs_of, by_job, row) in groups.items():
        for (gname, mid), by_rank in zip(jobs_of, by_job):
            what = f"sharded P={P} {gname} {mid}"
            r0 = by_rank[0]
            edges = [r["n_edges"] for r in by_rank]
            check(sum(edges) == ref[gname, mid].shape[0]
                  and all(r["logits"] is None for r in by_rank[1:]),
                  f"{what}: edges per rank {edges}")
            if gname == "few":
                check(0 in edges, f"{what}: an empty rank")
            row[f"{gname}_{mid}"] = {
                "route": r0["route"], "K": r0["K"], "R": r0["R"],
                "max_abs_logit_diff": halo_logits_close(
                    r0["logits"], ref[gname, mid], what),
                "ranks": sharded_rank_rows(by_rank, mid, d, what)}
            if gname != "bench":
                for r in by_rank:
                    paths[f"infer_sharded_{gname}_{mid}_rank{r['rank']}"] = (
                        r["launches"])
        emit(f"sharded P={P}", transport=describe(str(dev), P), **row)

    # the entry point: cli infer with compute.mesh=2 against phase 8's run
    savedir = os.path.join(WORK, "sharded", "infer_mesh")
    shutil.rmtree(savedir, ignore_errors=True)
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", layer_run["data"], "--asm",
                        "hifiasm", "--out", savedir, "--model",
                        layer_run["model"], "--set",
                        f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                        "--set", "model.normalization=layer",
                        "--set", "compute.mesh=2"])
    wall_s = time.perf_counter() - t0
    with open(layer_run["fasta"], "rb") as f:
        want = f.read()
    with open(os.path.join(savedir, "assembly", "0_assembly.fasta"),
              "rb") as f:
        got = f.read()
    check(len(want) > 0 and got == want,
          "cli infer compute.mesh=2: phase 8's FASTA byte for byte")
    launches = summary["rank_launches"]
    check(summary["ranks"] == 2 and all(
        c == expected_launches(**K1K2_FORWARD_LAUNCHES)
        for c in launches), f"cli infer mesh=2 launches {launches}")
    for r, c in enumerate(launches):
        paths[f"infer_sharded_rank{r}"] = c
    emit("sharded", cli_infer={"fasta_bytes": len(got), "wall_s": wall_s,
                               "timing_s": summary["timing"],
                               "launches_per_rank": launches},
         d=d, layers=8, gat_num_heads=3,
         weights=f"init_weights({ZOO_INIT_SEED})",
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL},
         phase_s=time.perf_counter() - t_phase)
    return paths


# ------------------------------------- entry, dry run, multi-host, projection
# The entry points (gnnome_tpu_torch/entry.py), a group of ranks that
# launchers started (parallel/group.py join; scripts/torch_multihost_smoke.py)
# and the halo wire-cost model (parallel/projection.py).  Bounds, set before
# any card run: entry()'s logits within LOGIT_ATOL + LOGIT_RTOL·|x| of
# entry(device="cpu"), a second card call bitwise equal, 8 K3 + 1 K6 float32
# launches; the dry run (2 ranks sharing the card over gloo) a finite loss,
# parameters bitwise equal on every rank, 16/16/16/16/2/2 K7/K3/K8/A/K6/K9
# per rank; two launchers of one rank each (127.0.0.1, a free port, the card
# shared over gloo) on random_bench_graph(16,384, 6.0): one loss, bitwise
# spawn's at 2 ranks on the same unit, the same launches per rank; the
# model's bytes and calls per forward and step at P = 2 and 4 equal to
# Group.sent and Group.calls of the halo phase's ranks.
MULTIHOST_NODES = 16_384
MULTIHOST_LINE = re.compile(r"MULTIHOST_OK rank=(\d+) world=(\d+) "
                            r"local=(\d+) transport=(\S+) loss=(\S+) "
                            r"launches=(\S+)")


def phase_entry(dev) -> dict:
    """``entry()`` on the card once, against ``entry(device="cpu")``;
    returns its launches."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.entry import entry
    from gnnome_tpu_torch.ops.kernels import (launch_counts,
                                              reset_launch_counts)

    t0 = time.perf_counter()
    fn, args = entry(str(dev))
    setup_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    lo = fn(*args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts, counts16 = launch_counts(), launch_counts(torch.bfloat16)
    check(counts == expected_launches(**HALO_FORWARD_LAUNCHES)
          and not any(counts16.values()),
          f"entry: 8 K3 + 1 K6 float32 launches, got {counts} / {counts16}")
    check(torch.equal(lo, fn(*args)), "entry: two card calls bitwise equal")
    warm_ms = cuda_ms(lambda: fn(*args), reps=10, n=1)
    fn_cpu, args_cpu = entry("cpu")
    ref = fn_cpu(*args_cpu).numpy()
    got = lo.cpu().numpy()
    check(got.shape == ref.shape == (args[1].shape[0],)
          and bool(np.isfinite(got).all()), f"entry: logits {got.shape}")
    d = np.abs(got - ref)
    check(bool((d <= LOGIT_ATOL + LOGIT_RTOL * np.abs(ref)).all()),
          f"entry: card vs CPU logits (max {d.max()})")
    emit("entry", edges=int(got.shape[0]), nodes=int(args[0].shape[0]),
         max_abs_logit_diff=float(d.max()), launches=counts,
         setup_s=setup_s, first_forward_wall_s=wall_s,
         forward_ms=warm_ms,
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL})
    return counts


def phase_dryrun(dev) -> dict:
    """``dryrun_multichip(2)`` on the card; returns rank 0's launches."""
    import numpy as np

    from gnnome_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    res = dryrun_multichip(2, str(dev))     # raises unless params agree
    wall_s = time.perf_counter() - t0
    check(bool(np.isfinite(res["loss"])), f"dryrun: loss {res['loss']}")
    per_rank = res["launches_per_rank"]
    check(all(c == expected_launches(**HALO_STEP_LAUNCHES) for c in per_rank)
          and not any(any(c.values()) for c in res["launches_bf16_per_rank"]),
          f"dryrun: launches per rank {per_rank}")
    emit("dryrun", n=2, loss=res["loss"], K=res["K"], R=res["R"],
         route=res["route"], edges_per_rank=res["edges_per_rank"],
         launches_per_rank=per_rank, bytes_rank0=res["bytes"],
         calls_rank0=res["calls"], params_bitwise_equal_on_every_rank=True,
         wall_s=wall_s)
    return per_rank[0]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_two_hosts(n_nodes: int, timeout: float = 300) -> list:
    """Two ``torch.distributed.run`` launchers of one rank each on
    127.0.0.1 running scripts/torch_multihost_smoke.py on the card; their
    output.  Retried once on another port when the first was taken; every
    launcher is killed on a timeout."""
    from gnnome_tpu_torch.parallel.group import LAUNCH_ENV

    script = os.path.join(ROOT, "scripts", "torch_multihost_smoke.py")
    env = {k: v for k, v in os.environ.items()
           if k not in LAUNCH_ENV + ("LOCAL_WORLD_SIZE",)}
    for attempt in range(2):
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
             "--node-rank", str(i), "--nproc-per-node", "1",
             "--master-addr", "127.0.0.1", "--master-port", str(port),
             script, "--device", "cuda", "--n-nodes", str(n_nodes)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT) for i in range(2)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise RuntimeError(f"multihost launchers timed out ({timeout} s)")
        joined = "\n".join(outs)
        if all(p.returncode == 0 for p in procs):
            return outs
        if attempt == 0 and re.search(r"address already in use|EADDRINUSE",
                                      joined, re.I):
            continue
        raise RuntimeError("multihost launchers failed:\n" + joined[-3000:])


def multihost_jobs(dev) -> list:
    """The multi-host phase's reference: its step on ``spawn``'s two ranks
    (run in the halo phase's group of 2 ranks, a spawn less)."""
    from gnnome_tpu_torch.parallel import checks

    return [(checks.train_step_job,
             (*checks.multihost_inputs(MULTIHOST_NODES, 2, str(dev)), 1.0))]


def phase_multihost(dev, ref: list) -> dict:
    """One halo train step over two launchers' ranks against ``ref``, every
    rank's result of ``multihost_jobs`` on ``spawn``'s two ranks; returns
    rank 0's launches."""
    t0 = time.perf_counter()
    outs = launch_two_hosts(MULTIHOST_NODES)
    launch_s = time.perf_counter() - t0
    found = {int(m[0]): m for m in MULTIHOST_LINE.findall("\n".join(outs))}
    check(sorted(found) == [0, 1] and all(m[1] == "2" and m[2] == "0"
                                          for m in found.values()),
          f"multihost: one line per rank, world 2: {sorted(found)}")
    launches = [json.loads(found[r][5]) for r in (0, 1)]
    check(all(found[r][4] == repr(ref[r]["loss"]) for r in (0, 1)),
          f"multihost: losses {[found[r][4] for r in (0, 1)]} vs spawn's "
          f"{[repr(r['loss']) for r in ref]}")
    check(launches == [r["launches"] for r in ref] and all(
        c == expected_launches(**HALO_STEP_LAUNCHES) for c in launches),
          f"multihost: launches per rank {launches}")
    emit("multihost", nodes=MULTIHOST_NODES, loss=ref[0]["loss"],
         transport=[found[r][3] for r in (0, 1)],
         launches_per_rank=launches, K=ref[0]["K"], R=ref[0]["R"],
         launchers_wall_s=launch_s,
         reference="spawn, 2 ranks, in the halo phase's group")
    return launches[0]


def phase_projection(halo_wire: dict) -> None:
    """The halo wire-cost model on the halo phase's bench graph: its bytes
    and calls per forward (with the logits' gather) and per step at each P
    against what every rank's ``Group`` recorded, then the model's times
    beside the measured ones (host only)."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.synthetic import random_bench_graph
    from gnnome_tpu_torch.models.zoo import get_model
    from gnnome_tpu_torch.parallel.halo import plan_graph
    from gnnome_tpu_torch.parallel.projection import (LINKS, forward_traffic,
                                                      project, step_traffic)

    kind = "projection (a model, not a measurement)"
    n = HALO_BENCH["num_nodes"]
    src, dst = random_bench_graph(n, HALO_BENCH["avg_degree"],
                                  seed=HALO_BENCH["seed"])
    cfg = Config()
    d, L = cfg.model.dim_latent, cfg.model.num_gnn_layers
    n_params = sum(p.numel() for p in get_model(cfg.model).parameters())
    p1 = halo_wire["single_device"]
    t1 = {"forward": p1["bench_forward_ms"] / 1e3,
          "step": p1["bench_step_ms"] / 1e3}
    rows = []
    for P, run in sorted(halo_wire["ranks"].items()):
        plan, _ = plan_graph(src, dst, n, P)
        coll = run["collectives"]
        latency = {"p2p": max(c["exchange"]["host_ms"] for c in coll) / 1e3,
                   "collective": max(c["all_reduce"]["host_ms"]
                                     for c in coll) / 1e3}
        for what in ("forward", "step"):
            traffic = [forward_traffic(plan, r, d, L) if what == "forward"
                       else step_traffic(plan, r, d, L, n_params)
                       for r in range(P)]
            got = run[what]
            check(all(g["bytes"] == t.sent and g["calls"] == t.calls
                      for g, t in zip(got, traffic)),
                  f"projection P={P} {what}: bytes and calls "
                  f"{[(g['bytes'], g['calls']) for g in got]} vs the model "
                  f"{[(t.sent, t.calls) for t in traffic]}")
            measured = max(g[what]["host_ms"] for g in got)
            for link, rate in LINKS.items():
                pt = project(t1[what], plan, traffic, rate, latency)
                rows.append({"kind": kind, "P": P, "what": what,
                             "link": link, **pt.as_dict(),
                             "measured_shared_card_ms": measured})
                print(f"projection | {kind} | P={P} {what} {link}: "
                      f"t1/P {pt.t_compute_s * 1e3:.4f} ms + wire "
                      f"{pt.t_wire_s * 1e3:.4f} + latency "
                      f"{pt.t_latency_s * 1e3:.4f} = "
                      f"{pt.t_step_s * 1e3:.4f} ms, efficiency "
                      f"{pt.efficiency:.4f} (measured on the shared card: "
                      f"{measured:.4f} ms)", flush=True)
    emit("projection", kind=kind, graph=dict(HALO_BENCH), d=d, layers=L,
         params=n_params, t1_ms={k: v * 1e3 for k, v in t1.items()},
         latency_source="the halo phase's idle collectives (gloo, shared "
                        "card), the slower rank's median",
         bytes_and_calls_equal_the_groups=True, rows=rows)


# phase recorded_runs: each recorded-run script's ``main`` as a subprocess at
# a reduced size, its JSON checked.  The product run: the card mode's three
# graphs, 1 epoch, two resumes and an uninterrupted run of 2; the golden
# run at full size (the tracked fixture); the quality run's parity arm for
# 2 epochs on a graph of RECORDED_QUALITY_SPEC (seed 100, validation seed
# 200); the config-4 route at RECORDED_CONFIG4.  Validation loss within
# RECORDED_PARITY_LOSS and AP within RECORDED_PARITY_AP of the oracle's each
# epoch (set before any card run from the CPU runs, 1.7e-6 apart at two
# layers).
RECORDED_QUALITY_SPEC = ["genome_len=60000", "n_reads=200"]
RECORDED_CONFIG4 = ["--config4-nodes", "65536", "--both-nodes", "32768",
                    "--cluster-nodes", "16384", "--epochs-a", "1",
                    "--epochs-b", "2"]
RECORDED_PARITY_LOSS, RECORDED_PARITY_AP = 1e-5, 1e-4
RECORDED_TIMEOUT = 600


def run_recorded(script: str, args: list, out: str) -> tuple:
    """``scripts/<script>.py args --out out`` in a process of its own;
    its JSON and wall seconds.  Killed on a timeout."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     f"{script}.py"),
                        *args, "--out", out], cwd=ROOT, capture_output=True,
                       text=True, timeout=RECORDED_TIMEOUT)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"{script} rc {p.returncode}:\n"
          f"{(p.stdout + p.stderr)[-3000:]}")
    with open(out) as f:
        return json.load(f), wall


def phase_recorded_runs() -> dict:
    """The recorded-run scripts at reduced sizes (see RECORDED_*); returns
    the launches of each path, read from the scripts' JSON (every path
    runs in its script's process, whose counters start at 0)."""
    import numpy as np

    from gnnome_tpu_torch.ops import kernels as K

    root = os.path.join(WORK, "recorded")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    paths, lines = {}, {}

    def total(rows):
        return {k: sum(r[k] for r in rows) for k in K.KERNELS}

    prod, wall = run_recorded(
        "torch_product_train_run", ["--mode", "card", "--epochs", "1",
                                    "--root", os.path.join(root, "product")],
        os.path.join(root, "product.json"))
    check(prod["resume_bit_identical"] is True
          and prod["resume_equals_uninterrupted"] is True,
          "product run: resumes bitwise equal, and equal to the "
          "uninterrupted run")
    check(prod["launches_match_units"] is True,
          f"product run: launches per unit {prod['launches_per_epoch']}")
    paths["product_train_card"] = total(
        [e["launches"] for e in prod["launches_per_epoch"]])
    lines["product_train_card"] = {
        "size": "card mode (3 graphs of 600-1,400 reads), 1 epoch, 2 "
                "resumes to 2, an uninterrupted run of 2",
        "units": [[e["train_units"], e["valid_units"]]
                  for e in prod["launches_per_epoch"]],
        "peak_mb": prod["peak_mb"], "wall_s": wall,
        "checkpoint_arrays": prod["checkpoint_arrays"]}

    gold, wall = run_recorded("torch_golden_ecoli_run", ["--cached"],
                              os.path.join(root, "golden.json"))
    ap = gold["average_precision"]
    check(ap["jax_record"] is not None
          and ap["abs_diff_port_jax_record"] <= AP_TOL,
          f"golden run: AP {ap['port']} vs the JAX record {ap['jax_record']}")
    check(gold["edge_prob_parity"]["max_abs_prob_diff"] <= PROB_ATOL,
          f"golden run: probabilities vs the oracle "
          f"{gold['edge_prob_parity']}")
    check(gold["decode_equals_jax_record"] is True,
          f"golden run: decode {gold['decode']['port']}")
    fwd = gold["forward"]["launches_per_forward"]
    check(fwd == expected_launches(k3_edge_stage=8, k6_score_gate=1),
          f"golden run: launches per forward {fwd}")
    paths["golden_card"] = fwd
    lines["golden_card"] = {
        "size": "full: the tracked fixture, N=9,600, E=257,346",
        "ap": ap, "edge_prob_parity": gold["edge_prob_parity"],
        "decode": gold["decode"]["port"],
        "forward_ms": gold["forward"]["forward_ms_median"],
        "peak_mb": gold["peak_mb"], "wall_s": wall}

    qual, wall = run_recorded(
        "torch_train_quality_run",
        ["--stage", "build", "parity", "--root", os.path.join(root, "q"),
         "--parity-epochs", "2", "--train-seeds", "100", "--valid-seeds",
         "200", *sum((["--spec", kv] for kv in RECORDED_QUALITY_SPEC), [])],
        os.path.join(root, "quality.json"))
    par = qual["collapse_parity"]
    for a, b in zip(par["port"], par["torch_oracle"]):
        check(abs(a["valid_loss"] - b["valid_loss"]) <= RECORDED_PARITY_LOSS
              and abs(a["ap"] - b["ap"]) <= RECORDED_PARITY_AP,
              f"quality parity epoch {a['epoch']}: port {a} oracle {b}")
    check(len(par["port"]) == 2, "quality parity: 2 epochs")
    q_launch = par["launches"]["all"]
    check(q_launch == expected_launches(
        k7_gate_stats=16, k3_edge_stage=32, k8_train_layer_bwd=16,
        bn_edge_adjoint=16, k6_score_gate=4, k9_aggregate=2),
          f"quality parity: 2 steps and 2 evals {q_launch}")
    paths["quality_parity"] = q_launch
    lines["quality_parity"] = {
        "size": f"TRAIN_SPEC with {' '.join(RECORDED_QUALITY_SPEC)}, "
                "train seed 100, valid seed 200, 2 epochs",
        "graphs": par["graphs"], "divergence": par["divergence"],
        "wall_s": wall}

    c4, wall = run_recorded("torch_config4_route", RECORDED_CONFIG4,
                            os.path.join(root, "config4.json"))
    runs = {"config4_a": [c4["A_config4_cluster_route"]],
            "config4_b": [c4["B_convergence"]["full_graph"],
                          c4["B_convergence"]["cluster"]]}
    for name, rs in runs.items():
        for r in rs:
            check(r["launches_match_units"] is True
                  and all(np.isfinite(e["train_loss"]) for e in r["epochs"])
                  and all(np.isfinite(e.get("eval_loss", 0.0))
                          for e in r["epochs"]),
                  f"{name}: finite losses, launches per unit "
                  f"{[e['launches'] for e in r['epochs']]}")
        paths[name] = total([e["launches"] for r in rs for e in r["epochs"]]
                            + [e["eval_launches"] for r in rs
                               for e in r["epochs"] if "eval_launches" in e])
    lines["config4"] = {
        "size": " ".join(RECORDED_CONFIG4),
        "units_per_epoch": {n: [r["units_per_epoch"] for r in rs]
                            for n, rs in runs.items()},
        "gap": c4["B_convergence"][
            "eval_loss_gap_cluster_minus_full_per_epoch"],
        "peak_mb": {n: [r["peak_mb"] for r in rs] for n, rs in runs.items()},
        "wall_s": wall}
    emit("recorded_runs", **lines, launches=paths,
         tolerance={"ap": AP_TOL, "prob": PROB_ATOL,
                    "parity_loss": RECORDED_PARITY_LOSS,
                    "parity_ap": RECORDED_PARITY_AP})
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    for path in (GOLDEN, WEIGHTS):
        check(os.path.isfile(path), f"{path} present (run from a checkout)")
    from gnnome_tpu_torch.config import resolve_device

    dev = resolve_device("cuda")
    phase_env()
    fwd32 = phase_model(dev)
    unfused32 = phase_model_unfused(dev)
    k = phase_kernels(args.seed, dev, fwd32["launches_per_forward"])
    kb = phase_kernels_bf16(args.seed, dev)
    pr = phase_probes(args.seed, dev)
    from gnnome_tpu_torch import probes
    from gnnome_tpu_torch.probes import mosaic_repro as M

    probes.reset_launch_counts()
    paths = {"infer": phase_infer()}
    paths.update(phase_gfa_route())
    phase_model_bf16(dev, fwd32)
    phase_model_unfused_bf16(dev, unfused32)
    phase_train_step(dev)
    steps32 = {norm: phase_train_step(dev, norm) for norm in ("layer", "none")}
    phase_train_step(dev, "batch", "bfloat16")
    for norm in ("layer", "none"):
        phase_train_step(dev, norm, "bfloat16", steps32[norm])
    paths["train"] = phase_train()
    paths["train_layer"], paths["infer_layer"], layer_run = phase_cli_layer()
    paths["train_bf16"], paths["infer_bf16"] = phase_cli_bf16()
    # (the bf16 launches of these two paths: all of their launches)
    paths["train_none_bf16"], paths["infer_none_bf16"] = (
        phase_cli_unfused_bf16())
    phase_zoo(dev)
    paths["train_zoo"], paths["infer_zoo"] = phase_cli_zoo()
    halo_paths, few_sharded, (multihost_ref,), halo_wire = phase_halo(
        dev, sharded_few_jobs(dev), multihost_jobs(dev))
    paths.update(halo_paths)
    paths.update(phase_sharded(dev, layer_run, few_sharded))
    paths["entry"] = phase_entry(dev)
    paths["dryrun_2"] = phase_dryrun(dev)
    paths["multihost"] = phase_multihost(dev, multihost_ref)
    phase_projection(halo_wire)
    paths.update(phase_recorded_runs())

    def row(name, src, replaces, main_path, t, errs, width):
        """The summary of kernel ``name``: times ``t`` at ``width`` (the
        shapes its main path gives it), the largest error of ``errs``."""
        return {"name": name, "route": "cuda",
                "source": f"gnnome_tpu_torch/csrc/{src}",
                "replaces": f"gnnome_tpu/ops/pallas_kernels.py:{replaces}",
                "launches": paths[main_path][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": max(errs), "width": width,
                "ms": t["device_ms"], "call_ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
                "dtypes": ["float32"]}

    def at_dual(r, name):
        """Kernel ``name``'s numbers of ``width_kernel_times`` at the dual
        width (flip=False)."""
        return {**r["dual"][name]["flip=False"],
                "bound_ms": r["dual"][name]["bound_ms"],
                "bound_by": r["dual"][name]["bound_by"]}

    def bf16_row(name) -> dict:
        """Kernel ``name``'s bf16 instantiation at the dual width (the bf16
        training path), launches from that path (phase 11's overfit
        run)."""
        t, d64, wide = at_dual(kb, name), kb["d64"][name], kb["wide"]
        key = {"k3_edge_stage": "k3", "k6_score_gate": "k6",
               "k7_gate_stats": "k7", "k8_train_layer_bwd": "k8",
               "k9_aggregate": "k9"}[name] + "_max_abs_diff"
        errs = ([t["max_abs_diff"]] + [d64[f]["max_abs_diff"] for f in
                                       ("flip=False", "flip=True")]
                + [wide[f][key] for f in ("flip=False", "flip=True")])
        return {"launches": paths["train_bf16"][name],
                "max_abs_err": max(errs), "width": DUAL_D,
                "ms": t["device_ms"], "call_ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}

    def flips(r):
        return [r[f]["max_abs_diff"] for f in ("flip=False", "flip=True")]

    def unfused_errs(r) -> list:
        """The largest errors of ``unfused_kernels``' K1 or K2 summary."""
        widths = [r] if "flip=False" in r else [r["Dp=128"], r["Dp=64"]]
        return sum((flips(w) for w in widths), []) + list(
            r["layouts"].values())

    def unfused_bf16_row(name, r, width) -> dict:
        """K1's or K2's bf16 instantiation at the norm-free model's widths,
        flip=False, launches from its bf16 training path (the overfit run
        of ``cli_unfused_bf16``)."""
        errs = unfused_errs(r)
        r = r if "flip=False" in r else r[f"Dp={width}"]
        t = r["flip=False"]
        return {"launches": paths["train_none_bf16"][name],
                "max_abs_err": max(errs), "width": width,
                "ms": t["device_ms"], "call_ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": t.get("library_ms")}

    def at_d64(name):
        r = k[name]
        return {**r["flip=False"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"]}

    # K1 and K2 at the layer-norm model's widths (K2 at the gated mean's
    # Dp = 128); K3, K6, K7, K8 and K9 at the dual pass's d = H = 128 (the
    # training path; the eval path runs K3 and K6 at 64, in the kernels
    # phase line); the one-sided walk at D = 64 into dst (GCN's sums)
    k2 = k["k2_aggregate"]
    side = k["k2_side_sum"]
    k1b, k2b = kb["k1_gather_gate"], kb["k2_aggregate"]
    both = ["float32", "bfloat16"]
    rows = [
        {**row("k1_gather_gate", "k1_gather_gate.cu", 207, "train_layer",
               at_d64("k1_gather_gate"), unfused_errs(k["k1_gather_gate"]),
               64),
         "dtypes": both,
         "bfloat16": unfused_bf16_row("k1_gather_gate", k1b, 64)},
        {**row("k2_aggregate", "k2_aggregate.cu", 263, "train_layer",
               {**k2["Dp=128"]["flip=False"], **{
                   x: k2["Dp=128"][x] for x in ("bound_ms", "bound_by")}},
               unfused_errs(k2), 128),
         "dtypes": both,
         "bfloat16": unfused_bf16_row("k2_aggregate", k2b, 128)},
        row("k2_side_sum", "k2_aggregate.cu", 263, "train_zoo",
            side["D=64 side=dst"],
            [r["max_abs_diff"] for r in side.values()
             if isinstance(r, dict) and "max_abs_diff" in r], 64),
    ]
    for name, src, line in (("k3_edge_stage", "k3_edge_stage.cu", 355),
                            ("k6_score_gate", "k6_score_gate.cu", 709),
                            ("k7_gate_stats", "k7_gate_stats.cu", 457),
                            ("k8_train_layer_bwd", "k8_train_layer_bwd.cu",
                             604),
                            ("k9_aggregate", "k9_aggregate.cu", 771)):
        t = at_dual(k, name)
        rows.append({**row(name, src, line, "train", t,
                           flips(k[name]) + [t["max_abs_diff"]], DUAL_D),
                     "dtypes": ["float32", "bfloat16"],
                     "bfloat16": bf16_row(name)})
    # the batch-norm edge adjoint replaces no pallas_call but the jnp chain
    # after JAX's K8 (message.py:549-591); at the dual width, and at the
    # benchmark cell's edge count
    def adjoint_times(r) -> dict:
        t, cell = r[f"golden w={DUAL_D}"], r[f"cell w={DUAL_D}"]
        return {"ms": t["device_ms"], "call_ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "add_ms": t["add_ms"], "cell_rows": cell["rows"],
                "cell_ms": cell["device_ms"],
                "cell_bound_ms": cell["bound_ms"]}

    rows.append({"name": "bn_edge_adjoint", "route": "cuda",
                 "source": "gnnome_tpu_torch/csrc/bn_edge_adjoint.cu",
                 "replaces": "gnnome_tpu/ops/message.py:549-591 (jnp)",
                 "launches": paths["train"]["bn_edge_adjoint"],
                 "launches_by_path": {p: c["bn_edge_adjoint"]
                                      for p, c in paths.items()},
                 "max_abs_err": 0.0, "width": DUAL_D,
                 **adjoint_times(k["bn_edge_adjoint"]),
                 "dtypes": ["float32", "bfloat16"],
                 "bfloat16": {
                     "launches": paths["train_bf16"]["bn_edge_adjoint"],
                     **adjoint_times(kb["bn_edge_adjoint"])}})
    # the layer-norm edge stage and its adjoint replace no pallas_call but
    # the XLA chain between JAX's K1 and K2 (sym_gated_gcn.py:149-172); at
    # d = 64 on the golden graph and at the benchmark cell's edge rows
    ln = k["ln_edge_stage"]
    for name in ("ln_edge_stage", "ln_edge_adjoint"):
        t = ln["golden d=64 norm=True"][name]
        cell = ln["cell d=64 norm=True"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "gnnome_tpu_torch/csrc/ln_edge_stage.cu",
            "replaces": "gnnome_tpu/models/sym_gated_gcn.py:149-172 (XLA)",
            "launches": paths["train_layer"][name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            "max_abs_err": max(
                r["fwd_max_abs_diff" if name == "ln_edge_stage"
                  else "adj_max_abs_diff"]
                for r in ln.values() if isinstance(r, dict)
                and "fwd_max_abs_diff" in r),
            "width": 64, "ms": t["device_ms"], "call_ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "cell_rows": cell["rows"], "cell_ms": cell[name]["device_ms"],
            "cell_bound_ms": cell[name]["bound_ms"],
            "dtypes": ["float32"]})
    # the probes lie on no path: their launches since the probes phase
    # (every path after it, those this process runs), which must be none
    probe_launches = probes.launch_counts()
    check(not any(probe_launches.values()),
          f"no probe kernel on a path: {probe_launches}")
    # every probe row alike: ``launches`` from the probe's own run, and
    # under ``launches_by_path`` that run and the system paths (none)
    def probe_launches_of(name, probe, n) -> dict:
        return {"launches": n, "launches_by_path": {
            probe: n, "system_paths": probe_launches[name]}}

    for name, src, replaces, probe in (
            ("k3_ablate", "probes/k3_ablate.cu", "scripts/k3_ablate.py:169",
             "k3_ablate"),
            ("stream_sum", "probes/stream_sum.cu",
             "scripts/dma_probe.py:35", "dma_probe")):
        t = pr[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"gnnome_tpu_torch/csrc/{src}",
                     "replaces": replaces,
                     **probe_launches_of(name, probe, t["launches"]),
                     "max_abs_err": t["max_abs_err"], "width": t["width"],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": None, "dtypes": ["float32", "bfloat16"],
                     "timed_at": {k: t[k] for k in ("dtype", "graph", "shape")
                                  if k in t},
                     **{k: t[k] for k in ("resources", "turns") if k in t}})
    # the Mosaic repro probe's kernels: launches from the probe's own run
    # (every case through run_cases); times at P3's shapes in float32 (and
    # bf16); the call sites those of the cases whose chains call the kernel
    mo = pr["mosaic"]

    def mosaic_row(t) -> dict:
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "max_abs_err": t["max_abs_diff"], "shapes": t["shapes"]}

    for name in ("row_stack", "row_gather", "segment_sum", "small_matmul"):
        t32, t16 = mo["ops"]["float32"][name], mo["ops"]["bfloat16"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "gnnome_tpu_torch/csrc/probes/mosaic_ops.cu",
                     "replaces": M.call_sites(mo["cases"], name),
                     **probe_launches_of(name, "mosaic_repro",
                                         mo["launches"][name]),
                     **mosaic_row(t32),
                     "max_abs_err": max(t32["max_abs_diff"],
                                        t16["max_abs_diff"]),
                     "dtypes": ["float32", "bfloat16"],
                     "bfloat16": mosaic_row(t16),
                     "timed_at": "P3's shapes (scripts/mosaic_f32_repro.py)",
                     **({"routes": mo["routes"], "p3_routes": mo["p3_routes"],
                         "instantiations": mo["instantiations"],
                         "resources": pr["resources"][name],
                         "dynamic_smem": pr["resources"][
                             "small_matmul_dynamic_smem"],
                         "turns": {k: v for k, v in pr["turns"].items()
                                   if k.startswith(name)}}
                        if name == "small_matmul" else {})})
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
