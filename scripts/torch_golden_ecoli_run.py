#!/usr/bin/env python
"""The golden run at E. coli scale on the port (the counterpart of
``scripts/golden_ecoli_run.py``): edge probabilities, average precision
and greedy-decode contiguity of the port, scoring on ``--device`` (default
``cuda``), against the torch oracle (``tests/torch_ref.py``, on the CPU in
float32), both with the shipped weights, on the same graph.

The graph is the synthetic E. coli-scale assembly graph of the JAX script
(4.64 Mb genome, ~20 kb reads, 2% read errors, wrong-strand hard
negatives, planted repeats, coverage gaps).  ``--cached`` reads it from
``--fixture`` (the tracked ``tests/fixtures/golden_ecoli_v1.npz``: 9,600
nodes, 257,346 edges); without it the graph is built (about 40 minutes on
one host core) and written to ``--build-out`` (``build/golden_ecoli_v1.npz``;
the tracked fixture is never written).

Weights: ``--weights`` (``weights/weights.npz``, the reference's released
weights converted; the JAX script reads the reference's ``weights.pt``).
The oracle loads the state dict that ``models.convert.module_state_from_numpy``
makes from the same npz.

Records: the logit and probability parity (port against oracle); AP for
the port and the oracle beside the JAX package's figure for the tracked
fixture and weights (0.9992886, ``GOLDEN_ECOLI_r05.json``, cited, not
recomputed); the per-layer ``max|dh|`` and ``max|de|`` of the port's
layers stepped one at a time on ``--device`` against the oracle's
``convs[i]`` from their own encoder outputs; the greedy decode of the
port's logits, the oracle's and the labels (``rng=default_rng(--seed)``);
the forward's time, launches and peak memory on the card, with the card's
name and power limit.  ``sklearn``'s AP is recorded where sklearn is
installed, else ``null``.

Writes ``GOLDEN_ECOLI_torch.json`` at the repository root, or ``--out``.

    python scripts/torch_golden_ecoli_run.py --cached
    python scripts/torch_golden_ecoli_run.py --cached --device cpu \\
        --fixture SUBGRAPH.npz --out /tmp/golden.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
ECOLI_BP = 4_641_652
# the JAX package's AP on the tracked fixture with the shipped weights
# (GOLDEN_ECOLI_r05.json, "average_precision"."jax")
JAX_RECORD = {"ap": 0.9992885985330671, "decode": {
    "contigs": 4, "total_bases": 5_858_100, "n50": 5_385_917,
    "ng50": 5_385_917, "longest": 5_385_917},
    "source": "GOLDEN_ECOLI_r05.json (the JAX package on the CPU)"}


def oracle_model(params: dict, state: dict, model_cfg):
    """The torch oracle (``tests/torch_ref.py``) at ``model_cfg``'s sizes
    with the weights of the numpy pytrees, eval mode, on the CPU."""
    from torch_ref import RefSymGatedGCNModel

    from gnnome_tpu_torch.models.convert import module_state_from_numpy

    m = model_cfg
    model = RefSymGatedGCNModel(
        node_features=m.node_features, edge_features=m.edge_features,
        hidden_features=m.dim_latent, hidden_ne_features=m.hidden_ne_features,
        num_layers=m.num_gnn_layers, hidden_edge_scores=m.hidden_edge_scores,
        normalization=m.normalization)
    model.load_state_dict(module_state_from_numpy(params, state,
                                                  m.normalization))
    return model.eval()


def oracle_logits(model, g, x, e):
    import numpy as np
    import torch

    with torch.no_grad():
        lo = model(torch.from_numpy(g.src.astype(np.int64)),
                   torch.from_numpy(g.dst.astype(np.int64)),
                   torch.from_numpy(x), torch.from_numpy(e))
    return lo.numpy().reshape(-1).astype(np.float64)


def per_layer_diffs(model, oracle, g, x, e, device) -> list[dict]:
    """Step both stacks one GNN layer at a time, each from its own encoder
    outputs; per layer ``max|dh|`` (nodes) and ``max|de|`` (edges, host
    order) beside the oracle's largest ``|h|`` and ``|e|`` (float32
    spacing grows with them).  The port's layers run eval mode on
    ``device``."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.models.nn import mlp2
    from gnnome_tpu_torch.ops import DeviceGraph

    src = torch.from_numpy(g.src.astype(np.int64))
    dst = torch.from_numpy(g.dst.astype(np.int64))
    rows = []
    with torch.no_grad():
        xt, et = torch.from_numpy(x), torch.from_numpy(e)
        h_o = oracle.linear2_node(torch.relu(oracle.linear1_node(xt)))
        e_o = oracle.linear2_edge(torch.relu(oracle.linear1_edge(et)))
        dg = DeviceGraph.from_graph(g, device)
        h_p = mlp2(model.linear1_node, model.linear2_node, xt.to(device))
        e_p = dg.edges_to_slots(
            mlp2(model.linear1_edge, model.linear2_edge, et.to(device)))
        for i, conv in enumerate(model.gnn.convs):
            h_p, e_p = conv(dg, h_p, e_p, False)
            h_o, e_o = oracle.gnn.convs[i](src, dst, h_o, e_o)
            dh = (h_p.cpu() - h_o).abs().max().item()
            de = (dg.slots_to_edges(e_p).cpu() - e_o).abs().max().item()
            rows.append({"layer": i, "max_abs_dh": dh, "max_abs_de": de,
                         "max_abs_h": h_o.abs().max().item(),
                         "max_abs_e": e_o.abs().max().item()})
    return rows


def decode_summary(g, scores, genome_bp: int, seed: int,
                   use_labels: bool = False) -> dict:
    """Greedy decode (``load_checkpoint=False``, ``rng=default_rng(seed)``)
    of ``scores`` (logits, or the labels with ``use_labels``)."""
    import numpy as np

    from gnnome_tpu_torch.config import DecodeConfig
    from gnnome_tpu_torch.decode import (calculate_n50, calculate_ng50,
                                         decode_greedy)

    t0 = time.perf_counter()
    res = decode_greedy(g, np.asarray(scores, np.float32),
                        DecodeConfig(load_checkpoint=False),
                        rng=np.random.default_rng(seed),
                        use_labels=use_labels)
    lens = res.contigs_len
    return {"contigs": len(lens), "total_bases": int(sum(lens)),
            "n50": int(calculate_n50(lens)),
            "ng50": int(calculate_ng50(lens, genome_bp)),
            "longest": int(max(lens)) if lens else 0,
            "decode_seconds": time.perf_counter() - t0}


def card_forward(model, g, x, e, device) -> dict:
    """The eval forward alone (graph and features already on ``device``):
    its launches, and on a card its median time over 10 calls by CUDA
    events after a first call (on the CPU the first call's host-clock
    time)."""
    import statistics

    import torch

    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.utils import record

    dg = DeviceGraph.from_graph(g, device)
    xt = torch.as_tensor(x, device=device)
    et = torch.as_tensor(e, device=device)
    with torch.inference_mode():
        start = record.launches()
        t0 = time.perf_counter()
        model(dg, xt, et)
        times = [(time.perf_counter() - t0) * 1e3]
        launched = record.launches_since(start)
        if device.type == "cuda":
            times = []
            for _ in range(10):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
                a.record()
                model(dg, xt, et)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
    return {"launches_per_forward": launched["all"],
            "forward_ms_median": statistics.median(times),
            "forward_ms": times,
            "timer": "cuda events" if device.type == "cuda" else "host clock"}


def main(argv=None, logits: dict | None = None) -> dict:
    """Run, write ``--out`` and return what it holds; ``logits``, a dict,
    receives the port's and the oracle's logits (host edge order)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=4800)
    ap.add_argument("--genome", type=int, default=ECOLI_BP)  # E. coli K-12
    ap.add_argument("--read-len", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--error-rate", type=float, default=0.02)
    ap.add_argument("--hard-false-frac", type=float, default=0.10)
    ap.add_argument("--coverage-gaps", type=int, default=3)
    ap.add_argument("--repeat-pairs", type=int, default=4)
    ap.add_argument("--sim-band-frac", type=float, default=0.25)
    ap.add_argument("--fixture", default=FIXTURE,
                    help="the graph --cached reads")
    ap.add_argument("--cached", action="store_true",
                    help="read the graph from --fixture instead of "
                         "building it")
    ap.add_argument("--build-out",
                    default=os.path.join(ROOT, "build", "golden_ecoli_v1.npz"),
                    help="where a build writes the graph")
    ap.add_argument("--weights", default=WEIGHTS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "GOLDEN_ECOLI_torch.json"))
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.KEY=VALUE",
                    help="config override (model sizes of --weights)")
    args = ap.parse_args(argv)

    import numpy as np

    from gnnome_tpu_torch.config import Config, resolve_device
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.graphs.synthetic import synthetic_assembly_graph
    from gnnome_tpu_torch.infer import load_model, score_model
    from gnnome_tpu_torch.models import edge_features, node_features
    from gnnome_tpu_torch.models.checkpoint import load_model_weights
    from gnnome_tpu_torch.train.metrics import average_precision
    from gnnome_tpu_torch.utils import record

    t_all = time.perf_counter()
    cfg = Config()
    cfg.compute.device = args.device
    cfg.apply_overrides(args.overrides)
    dev = resolve_device(cfg.compute.device)
    t0 = time.perf_counter()
    if args.cached:
        g = AssemblyGraph.load(args.fixture)
        source = args.fixture
    else:
        print(f"building E. coli-scale graph ({args.reads} reads, "
              f"{args.genome / 1e6:.2f} Mb genome)...", flush=True)
        g, _, _, _ = synthetic_assembly_graph(
            n_reads=args.reads, genome_len=args.genome,
            read_len=args.read_len, seed=args.seed, with_labels=True,
            with_sequences=True, false_edge_frac=0.15,
            error_rate=args.error_rate, hard_false_frac=args.hard_false_frac,
            n_coverage_gaps=args.coverage_gaps,
            n_repeat_pairs=args.repeat_pairs,
            sim_band_frac=args.sim_band_frac)
        os.makedirs(os.path.dirname(os.path.abspath(args.build_out)),
                    exist_ok=True)
        g.save(args.build_out)
        source = args.build_out
    t_build = time.perf_counter() - t0
    tracked = (args.cached and os.path.abspath(args.fixture) == FIXTURE
               and os.path.abspath(args.weights) == WEIGHTS)
    print(f"graph {source}: {g.num_nodes} nodes / {g.num_edges} edges",
          flush=True)

    x = node_features(g)
    e = edge_features(g, cfg.data.use_similarities)
    params, state = load_model_weights(args.weights)

    # ------------------------------------------------------------ the port
    record.reset_peak(dev)
    model = load_model(params, state, cfg, dev).eval()
    t0 = time.perf_counter()
    logits_port = score_model(model, g, cfg, dev).astype(np.float64)
    t_score_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = score_model(model, g, cfg, dev).astype(np.float64)
    t_score_warm = time.perf_counter() - t0
    fwd = card_forward(model, g, x, e, dev)
    peak = record.peak_mb(dev)

    # ---------------------------------------------------------- the oracle
    oracle = oracle_model(params, state, cfg.model)
    t0 = time.perf_counter()
    logits_oracle = oracle_logits(oracle, g, x, e)
    t_oracle = time.perf_counter() - t0

    print("per-layer activation parity...", flush=True)
    per_layer = per_layer_diffs(model, oracle, g, x, e, dev)
    for row in per_layer:
        print(f"  {row}", flush=True)

    if logits is not None:
        logits.update(port=logits_port, oracle=logits_oracle)

    # ------------------------------------------------------------- parity
    probs_port = 1.0 / (1.0 + np.exp(-logits_port))
    probs_oracle = 1.0 / (1.0 + np.exp(-logits_oracle))
    dl = np.abs(logits_port - logits_oracle)
    dp = np.abs(probs_port - probs_oracle)
    y = g.y.astype(np.int32)
    ap_port = float(average_precision(probs_port, y))
    ap_oracle = float(average_precision(probs_oracle, y))
    try:
        from sklearn.metrics import average_precision_score
        ap_sklearn = float(average_precision_score(y, probs_oracle))
    except Exception:
        ap_sklearn = None

    decode = {name: decode_summary(g, sc, args.genome, args.seed)
              for name, sc in (("port", logits_port),
                               ("oracle", logits_oracle))}
    decode["labels"] = decode_summary(g, y.astype(np.float32), args.genome,
                                      args.seed, use_labels=True)
    for name, row in decode.items():
        print(f"  decode[{name}]: {row}", flush=True)

    out = {
        **record.device_record(dev),
        "graph": {"nodes": int(g.num_nodes), "edges": int(g.num_edges),
                  "positives": int(y.sum()), "genome_bp": args.genome,
                  "source": os.path.relpath(source, ROOT)
                  if source.startswith(ROOT) else source,
                  "cached_fixture": bool(args.cached),
                  "build_seconds": t_build},
        "weights": os.path.relpath(args.weights, ROOT)
        if os.path.abspath(args.weights).startswith(ROOT) else args.weights,
        "edge_prob_parity": {
            "max_abs_logit_diff": float(dl.max()),
            "max_abs_prob_diff": float(dp.max()),
            "mean_abs_prob_diff": float(dp.mean()),
            "frac_prob_diff_gt_1e-5": float((dp > 1e-5).mean()),
            "port_repeat_bitwise": bool(np.array_equal(logits_port, again)),
        },
        "average_precision": {
            "port": ap_port, "torch_oracle": ap_oracle,
            "sklearn_on_oracle": ap_sklearn,
            "abs_diff_port_oracle": abs(ap_port - ap_oracle),
            "jax_record": JAX_RECORD["ap"] if tracked else None,
            "abs_diff_port_jax_record": (abs(ap_port - JAX_RECORD["ap"])
                                         if tracked else None)},
        "jax_record": JAX_RECORD if tracked else None,
        "per_layer_max_abs_diff": per_layer,
        "decode": decode,
        "decode_equals_jax_record": (
            {k: decode["port"][k] for k in JAX_RECORD["decode"]}
            == JAX_RECORD["decode"] if tracked else None),
        "forward": fwd,
        "peak_mb": peak,
        "kernel_builds": record.kernel_builds(),
        "score_seconds": {"port_first": t_score_first,
                          "port_warm": t_score_warm,
                          "oracle_cpu": t_oracle},
        "total_seconds": time.perf_counter() - t_all,
    }
    record.write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("average_precision",
                                          "edge_prob_parity",
                                          "decode_equals_jax_record",
                                          "peak_mb")}, default=float),
          flush=True)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
